"""Decode-attention kernel tuning on the card (counterpart of
``tools/attn_kernel_tune.py``).

    python -m dsm_tpu_torch.tools.attn_kernel_tune --batch 64 \\
        [--variants base,bb2,bb4,bb8,bb4_i8s,bb4_i8sp]

Times variants of the T=1 decode attention over the stt-1b int8 rings
(``(B, 16, 768, 128)``, window 750, past the ring's wrap) against the
shipped kernel:

  base      ``decode_attn.decode_attend`` as the serving path calls it
  bbN       ``attn_tune.attn_tune``: N batch rows per block; numerics
            identical for every N
  bbN_i8s   the scores as s8 x s8 -> s32 products (q quantised per row)
  bbN_i8sp  the V dot in s32 as well (``exp * v_scale`` quantised per row)

Each variant prints one JSON line: device ms per call (CUDA events around
calls queued behind a spin kernel), achieved GB/s over the ring's bytes, and
the max error against ``attention.attend_global_split_q`` on random
committed rings (``rel_err``: as a share of that reference's largest output,
``ref_max`` in the summary).  The last line is the summary, with the floor the ring's
bytes set at the H100's 3.35 TB/s.  A variant that fails to build or launch
is reported as an error row and the tool exits with code 1; without a CUDA
device it exits with code 2 and measures nothing.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from ..models import lm as LM
from ..ops import attention as attn
from ..ops import attn_tune as AT
from ..ops import decode_attn as dattn
from ..ops import transformer as T

MEM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
DEFAULT_VARIANTS = "base,bb2,bb4,bb8,bb4_i8s,bb4_i8sp"


def parse_variant(name: str) -> dict:
    """``"base"`` -> ``{}``; ``"bbN"``, ``"bbN_i8s"``, ``"bbN_i8sp"`` -> the
    keyword arguments of ``attn_tune``."""
    if name == "base":
        return {}
    head, *flags = name.split("_")
    if not head.startswith("bb") or not head[2:].isdigit() or int(head[2:]) < 1:
        raise ValueError(f"unknown variant {name!r}")
    if any(f not in ("i8s", "i8sp") for f in flags):
        raise ValueError(f"unknown variant {name!r}")
    return {"bb": int(head[2:]), "i8s": bool(flags), "i8p": "i8sp" in flags}


def device_time_ms(fn, iters: int = 20, head_start_cycles: int = 40_000_000) -> float:
    """Device time of one call: a spin kernel goes first, so the host has
    queued all ``iters`` calls before the first starts and the events around
    them see the device run them back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(head_start_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_inputs(batch: int, device, seed: int = 0) -> dict:
    """Random committed stt-1b rings (quantised by ``quantize_kv_rows``, 8
    slots' worth tiled over the batch) and fresh rows, past the wrap."""
    cfg = LM.stt_1b_en_fr().transformer
    state = T.init_state(cfg, 1, torch.bfloat16, kv_quant=True, device=device)
    cap = state["layers"][0]["k"].shape[2]
    del state
    if batch % 8:
        raise ValueError(f"--batch must be a multiple of 8, got {batch}")
    h, hd = cfg.num_heads, cfg.hd
    g = torch.Generator(device=device).manual_seed(seed)

    def rows(n, t):
        return torch.randn(n, h, t, hd, generator=g, device=device).bfloat16()

    kq, vq, ks, vs = attn.quantize_kv_rows(rows(8, cap), rows(8, cap))

    def tile(x):
        return x.repeat(batch // 8, *([1] * (x.dim() - 1))).contiguous()

    pos = cap + 5
    return {"cfg": cfg, "cap": cap, "pos": pos, "k": tile(kq), "v": tile(vq),
            "ks": tile(ks), "vs": tile(vs), "q": rows(batch, 1), "k_new": rows(batch, 1),
            "v_new": rows(batch, 1),
            "valid": torch.ones(batch, cap, dtype=torch.bool, device=device),
            "plan": attn.global_ring_plan(pos, cap, 1, device=device)}


def variant_fn(name: str, x: dict):
    """The call that computes variant ``name`` on inputs ``x`` -> ``(B, H,
    Dh)``."""
    kw = parse_variant(name)
    window = x["cfg"].context
    if not kw:
        return lambda: dattn.decode_attend(
            x["q"], x["k"], x["v"], x["ks"], x["vs"], x["k_new"], x["v_new"], x["plan"],
            x["valid"], window=window)[:, :, 0]
    q3, kn3, vn3 = (x[key][:, :, 0].contiguous() for key in ("q", "k_new", "v_new"))
    return lambda: AT.attn_tune(q3, x["k"], x["v"], x["ks"], x["vs"], kn3, vn3, x["valid"],
                                x["pos"], window, **kw)


def reference(x: dict) -> torch.Tensor:
    return attn.attend_global_split_q(
        x["q"], x["k"], x["v"], x["ks"], x["vs"], x["k_new"], x["v_new"], x["plan"],
        x["valid"], x["cfg"].context)[:, :, 0].float()


def run(batch: int, variants, device) -> dict:
    """Every variant's row and the summary on ``device`` (a CUDA device)."""
    x = make_inputs(batch, device)
    ref = reference(x)
    ref_max = float(ref.abs().max())
    ring_bytes = sum(x[key].numel() * x[key].element_size() for key in ("k", "v", "ks", "vs"))
    rows = []
    for name in variants:
        try:
            fn = variant_fn(name, x)
            out = fn().float()
            torch.cuda.synchronize()
            ms = device_time_ms(fn)
            err = float((out - ref).abs().max())
            rows.append({"variant": name, "ms": ms, "gbps": ring_bytes / ms / 1e6,
                         "max_err": err, "rel_err": err / ref_max})
        except Exception as e:  # reported, and the tool fails
            rows.append({"variant": name, "error": str(e).split("\n")[0][:200]})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"batch": batch, "cap": x["cap"], "ring_gb": ring_bytes / 1e9, "ref_max": ref_max,
            "floor_ms": ring_bytes / MEM_BYTES_PER_S * 1e3, "floor": "3.35 TB/s (H100 SXM)",
            "card": card, "results": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--variants", default=DEFAULT_VARIANTS)
    args = ap.parse_args(argv)
    variants = [v for v in args.variants.split(",") if v]
    for name in variants:
        parse_variant(name)
    if not torch.cuda.is_available():
        print("attn_kernel_tune: no CUDA device; nothing was measured", file=sys.stderr)
        return 2
    summary = run(args.batch, variants, torch.device("cuda", 0))
    for row in summary["results"]:
        print(json.dumps(row), flush=True)
    print(json.dumps(summary), flush=True)
    return 1 if any("error" in row for row in summary["results"]) else 0


if __name__ == "__main__":
    sys.exit(main())
