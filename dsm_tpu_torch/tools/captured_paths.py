"""The captured serving paths of one or more checkouts, in turns, on the card.

    python -m dsm_tpu_torch.tools.captured_paths [--roots .,build/parent,.]

For each checkout root in ``--roots``, in order (a parent commit unpacked
with ``git archive`` beside this one: parent and change in turns, on one
card in one call), a fresh process runs that checkout's own ``chip_smoke.py``
phases: the s2s-2b duplex engine eager and then captured at pipeline depth 2
and 1 (``phase_duplex``, ``phase_graph_duplex``), Moshi 7B's captured engine
at depth 2 (``phase_moshi_duplex``) and, at depth 1 behind a synchronise, 30
ticks of a fresh one, the stt-2.6b engine and its captured step
(``phase_stt26``, ``phase_graph``), and tts_202501's engine and its captured
tick (``phase_tts``, ``phase_graph_tts``).  Each phase prints its own lines;
the tool prints one JSON line a root (host ms, kernel ms, device launches
and busy share of each captured path), then the card's name and power
limit.  Exit 1 if a root's run fails, 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

# Run in the checkout's root with that root first on the path, so that its
# own dsm_tpu_torch and chip_smoke.py are the ones imported.
_DRIVER = r'''
import json, os, statistics, sys, tempfile, time
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as CS
from dsm_tpu_torch.ops import _build
from dsm_tpu_torch.server import builder
from dsm_tpu_torch.server import config as CFG

_build.build()
_build.lib()
dev = torch.device("cuda", 0)
card = CS.card_line()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def moshi_synchronised(tmp):
    path = os.path.join(tmp, "moshi-d1.toml")
    with open(path, "w") as f:
        f.write('[modules.duplex]\ntype = "Lm"\npath = "/api/chat"\nbatch_size = 24\n'
                "pipeline_depth = 1\nkv_quant = true\nkv_bits = 8\n")
    engine = builder.build_duplex(CFG.Config.load(path).modules["duplex"], dev)
    engine.warmup()
    for _ in range(engine.batch_size - engine.used_slots()):
        engine.open_session(lambda ev: None)
    for drv in engine.slots:
        drv.push_pcm(CS._pcm(5, 0.08 * 40, engine.mimi_cfg.frame_size))
    times = []
    with torch.inference_mode():
        for i in range(40):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.tick()
            torch.cuda.synchronize()
            if i >= 10:
                times.append((time.perf_counter() - t0) * 1e3)
    return {"step_ms": statistics.median(times), "min_ms": min(times), "max_ms": max(times)}


out = {}
eng, _, log = CS.phase_duplex(dev, card)
del eng
torch.cuda.empty_cache()
graph = CS.phase_graph_duplex(dev, card, log)
out["s2s-2b depth 2"], out["s2s-2b depth 1"] = graph["graph2"], graph["graph"]
torch.cuda.empty_cache()
with tempfile.TemporaryDirectory() as tmp:
    out["moshi depth 2"] = CS.phase_moshi_duplex(dev, card, tmp)[0]["graph"]
    torch.cuda.empty_cache()
    out["moshi depth 1, synchronised"] = moshi_synchronised(tmp)
torch.cuda.empty_cache()
eng, _ = CS.phase_stt26(dev)
cfg, params, b = eng.cfg, eng.params, eng.batch_size
del eng
torch.cuda.empty_cache()
out["stt-2.6b"] = CS.phase_graph(cfg, params, b, card, "graph-stt26", CS.PER_STEP_STT26)["graph"]
del params
torch.cuda.empty_cache()
eng, _, log = CS.phase_tts(dev, card, preset="tts_202501")
del eng
torch.cuda.empty_cache()
out["tts_202501"] = CS.phase_graph_tts(dev, card, log, preset="tts_202501")["graph"]
keys = ("step_ms", "min_ms", "max_ms", "kernel_ms", "launches", "busy")
print("CAPTURED_PATHS " + json.dumps({path: {k: v for k, v in numbers.items() if k in keys}
                                      for path, numbers in out.items()}), flush=True)
'''


def run_root(root: str, timeout_s: int = 1200) -> dict:
    """The driver in ``root``: its JSON numbers, or ``{"error": ...}``."""
    proc = subprocess.run([sys.executable, "-c", _DRIVER], cwd=root, capture_output=True,
                          text=True, timeout=timeout_s)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    for line in proc.stdout.splitlines():
        if line.startswith("CAPTURED_PATHS "):
            return json.loads(line.split(" ", 1)[1])
    return {"error": (proc.stderr or proc.stdout)[-800:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", default=".", help="comma-separated checkout roots, in turn")
    args = ap.parse_args(argv)
    roots = [os.path.abspath(r) for r in args.roots.split(",") if r]
    for root in roots:
        if not os.path.isfile(os.path.join(root, "chip_smoke.py")):
            raise ValueError(f"{root}: no chip_smoke.py")
    if not torch.cuda.is_available():
        print("captured_paths: no CUDA device; nothing was measured", file=sys.stderr)
        return 2
    failed = False
    for i, root in enumerate(roots):
        numbers = run_root(root)
        failed |= "error" in numbers
        print(json.dumps({"turn": i, "root": root, **numbers}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
