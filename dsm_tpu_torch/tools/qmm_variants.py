"""Design variants of the weight-only int8 matmul ``qmm``, timed cold on the
card as the serving step meets it.

    python -m dsm_tpu_torch.tools.qmm_variants [--variants a,b,...] [--parent DIR]
    python -m dsm_tpu_torch.tools.qmm_variants --step [--variants a,b,...]
    python -m dsm_tpu_torch.tools.qmm_variants --host [--parent DIR]

The serving step streams each int8 weight once (some 2.5 GB a stt-2.6b step),
so a weight never waits in the card's 50 MB L2 between two of its calls, and
no call follows another: a norm, the attention or the MLP's gate writes x
first.  ``cold_ms`` times calls that rotate over enough distinct copies of a
weight (``COLD_BYTES`` of int8, over twice the L2) that every call finds its
weight in device memory, each behind a kernel that writes x, and takes that
kernel's own time off; ``warm_ms`` repeats one weight, which then stays in
L2.  ``chip_smoke.py`` times its qmm cases with both.

Each variant is ``csrc/qmm.cu`` with a few lines replaced (``VARIANTS``),
built with ``nvcc`` into a library of its own under ``build/qmm_variants/``
and launched through its ``dsm_qmm`` entry point on the same inputs, at the
stt-2.6b serving shapes (M = 64) and at M = 1 and 24, each at the cluster K
split ``qmm.qmm_tiling`` picks for this card; the shipped source also at
every other split (1 to 8), and back to back (no kernel between calls).  The
design variants: the stage count (``stages<=N``), the weight copies without
L2 promotion.  With ``--parent DIR``, the ``qmm`` of the checkout unpacked at
DIR (a parent commit, built there) is timed the same way, as variant
``parent``.
The diagnostics drop work and are not expected to agree: ``no-mma`` (the
wgmmas), ``no-convert`` (the int8 -> bf16 step), ``weights-only`` (no copies
of x), ``copies-only`` (no compute), ``no-copies`` (alone, without the wgmmas
or without the conversion), ``skeleton`` (neither copies nor compute),
``empty-kernel`` (set-up only), and ``timeline``, whose rows add the median
clock cycles of each phase of a block (``PHASES``), the spread of the
blocks' starts and the grid's span in ns.  (x multicast over the blocks of
a cluster is not built: the channel tile alone keeps x's bytes from L2 at
or under the weights'.)

One JSON row per shape, variant and split: the clusters of that launch the
card holds at once, device ms per call, cold (and warm for the picked
split), the byte bound at 3.35 TB/s and the share of it reached, and the max
error against ``qmm_plain``.

``--step``: the stt-2.6b engine from configs/config-stt-en.toml as shipped
(48 layers, B = 64, seeded random weights), its step with every slot active
profiled over 2 steps with every ``qmm`` through each variant in turn (the
``[stt26-profile]`` of ``chip_smoke.py``; default: the shipped source): one
JSON row a variant with the ``qmm`` kernels' device ms a step, all kernels'
and the wall time.

``--host``: the host's microseconds a ``qmm`` call costs (the wrapper's
checks, the tiling, the output's allocation, the launch), at each shape, and
of the ``dsm_qmm`` entry point alone (the tensor maps' encoding and the
launch); with ``--parent``, also of the parent's ``qmm``, in the order
parent, this, this, parent.

The last line is the card's name and power limit.  A variant that fails to
build or launch is an error row and the tool exits with code 1; without a
CUDA device it exits with code 2 and measures nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import itertools
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops import qmm as QM
from .attn_kernel_tune import MEM_BYTES_PER_S, device_time_ms

COLD_BYTES = 128 * 2**20  # int8 weight bytes a cold timing rotates over


def weight_copies(wq: torch.Tensor, min_bytes: int = COLD_BYTES) -> list:
    """Distinct copies of ``wq`` that hold at least ``min_bytes`` together
    (two at the least)."""
    n = max(2, -(-min_bytes // (wq.numel() * wq.element_size())))
    return [wq.clone() for _ in range(n)]


def _behind_ms(call, x: torch.Tensor, iters: int) -> float:
    """Device ms that ``call()`` adds behind a kernel that writes x (an exact
    ``x *= 1``): the pair's time less that kernel's alone."""
    pair = device_time_ms(lambda: (x.mul_(1), call()), iters=iters)
    return pair - device_time_ms(lambda: x.mul_(1), iters=iters)


def cold_ms(fn, x: torch.Tensor, copies: list, s, behind: bool = True) -> float:
    """Device ms of one call ``fn(x, w, s)``, each call on the next of
    ``copies`` (at least one round over all of them) and, with ``behind``,
    after a kernel that writes x; else back to back."""
    it = itertools.cycle(copies)
    iters = max(20, len(copies))
    if behind:
        return _behind_ms(lambda: fn(x, next(it), s), x, iters)
    return device_time_ms(lambda: fn(x, next(it), s), iters=iters)


def warm_ms(fn, x: torch.Tensor, w: torch.Tensor, s) -> float:
    """Device ms of one call ``fn(x, w, s)`` repeated on one weight, each
    after a kernel that writes x."""
    return _behind_ms(lambda: fn(x, w, s), x, 20)


def host_us(fn, n: int = 300, reps: int = 5) -> float:
    """Host microseconds of one call ``fn()``: the median over ``reps`` of
    the wall time of ``n`` calls with no synchronisation, queued behind a
    spin kernel so that no call waits for the device."""
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(reps):
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        got.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(got)


def load_qmm(root, alias: str = "dsm_tpu_torch_at"):
    """``ops.qmm`` of the ``dsm_tpu_torch`` package in the checkout at
    ``root`` (a parent commit), imported as package ``alias`` beside this
    one; it builds its kernels under ``root/build/``."""
    init = Path(root) / "dsm_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{alias}.ops.qmm")


_MMA = ("QmWgmma<R>::mma(acc, a[j], desc);",
        'asm volatile("" ::"r"(a[j][0]), "r"(a[j][1]), "r"(a[j][2]), "r"(a[j][3]), "l"(desc));')
_X_BYTES = ("mbar_arrive_expect_tx(&full[st], (uint32_t)L::kStage);",
            "mbar_arrive_expect_tx(&full[st], (uint32_t)(TO * 128));")
_X_COPY = ("for (int b = 0; b < 2; ++b)", "for (int b = 0; b < 0; ++b)")
_NO_COMPUTE = ("    convert(base, a);\n    issue(base, a);\n",
               "    (void)base;\n    release(c);\n    if (true) return;\n")
_NO_COPIES = [("mbar_arrive_expect_tx(&full[st], (uint32_t)L::kStage);", "mbar_arrive(&full[st]);"),
              ("tile_copy_2d(stage + L::kW,", "if (false) tile_copy_2d(stage + L::kW,"), _X_COPY]


def _constant(decl: str, value: str, new: str):
    return (f"{decl} = {value};", f"{decl} = {new};")


_TIMELINE = _constant("constexpr bool kQmTimeline", "false", "true")
_NO_CONVERT = ("  lo = *reinterpret_cast<const unsigned*>(&a);\n"
               "  hi = *reinterpret_cast<const unsigned*>(&b);", "  lo = w;\n  hi = u;")


# name -> (diagnostic, [(text of the source, its replacement), ...])
VARIANTS = {
    "shipped": (False, []),
    "stages<=2": (False, [_constant("constexpr int kQmMaxStages", "4", "2")]),
    "stages<=3": (False, [_constant("constexpr int kQmMaxStages", "4", "3")]),
    "stages<=8": (False, [_constant("constexpr int kQmMaxStages", "4", "8")]),
    "no-l2-promotion": (False, [("CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
                                 "CU_TENSOR_MAP_L2_PROMOTION_NONE")]),
    "no-mma": (True, [_MMA]),
    "no-convert": (True, [_NO_CONVERT]),
    "weights-only": (True, [_X_BYTES, _X_COPY]),
    "copies-only": (True, [_NO_COMPUTE]),
    "no-copies": (True, _NO_COPIES),
    "no-copies-no-mma": (True, _NO_COPIES + [_MMA]),
    "no-copies-no-convert": (True, _NO_COPIES + [_NO_CONVERT]),
    "skeleton": (True, _NO_COPIES + [_NO_COMPUTE]),
    "timeline": (True, [_TIMELINE]),
    "empty-kernel": (True, [("  if (ksplit > 1) cluster_arrive_relaxed();", "  if (true) return;")]),
}
# (M, O, I): the stt-2.6b matmuls at B=64 (in_proj, out_proj, the gated MLP's
# two, the text head), then a single row and the duplex batch.
SHAPES = ((64, 6144, 2048), (64, 2048, 2048), (64, 11264, 2048), (64, 2048, 5632),
          (64, 4000, 2048), (1, 2048, 2048), (24, 2048, 2048))
# The timeline build's phases, between its 8 marks (qmm.cu, kQmTimeline).
PHASES = ("set-up", "first stage", "K loop", "stage partial or write", "send", "receive",
          "sum and write")
SPLITS = tuple(range(1, 9))  # the cluster sizes the shipped source is also timed at
CONFIG = Path(__file__).resolve().parents[2] / "configs" / "config-stt-en.toml"


def variant_source(name: str) -> str:
    """``csrc/qmm.cu`` as variant ``name`` has it; every text it replaces
    must occur in the source exactly once."""
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; one of {', '.join(VARIANTS)}")
    src = (_build.CSRC / "qmm.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old[:60]!r} is not in the source once")
        src = src.replace(old, new)
    return src


def splits(m: int, o: int, i: int, resident) -> list:
    """The cluster K split ``qmm.qmm_tiling`` picks (for the clusters
    ``resident``), then every other of ``SPLITS`` that leaves no split
    empty."""
    picked = QM.qmm_tiling(m, o, i, resident).ksplit
    n_chunks = -(-i // QM._CHUNK_K)
    return [picked] + [k for k in SPLITS if k <= n_chunks and k != picked]


def build(names) -> dict:
    """Build each variant's library, one nvcc each, all started together ->
    ``{name: the loaded library or the compiler's error}``."""
    root = _build.BUILD_ROOT.parent / "qmm_variants"
    procs = {}
    for name in names:
        d = root / "".join(c if c.isalnum() or c == "-" else "_" for c in name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "qmm.cu").write_text(variant_source(name))
        shutil.copy(_build.CSRC / "tma_common.cuh", d)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "qmm.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (d, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            fns[name] = out[-500:]
            continue
        lib = ctypes.CDLL(str(d / "lib.so"))
        for entry in ("dsm_qmm", "dsm_qmm_max_clusters"):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = _build._SIGNATURES[entry]
        fns[name] = lib
    return fns


def _inputs(g, device, m, o, i):
    x = torch.randn(m, i, generator=g, device=device).bfloat16()
    wq = torch.randint(-127, 128, (o, i), generator=g, device=device, dtype=torch.int8)
    sc = (torch.rand(o, generator=g, device=device) + 0.5) / (73.3 * i ** 0.5)
    return x, wq, sc


def run(names, device, parent=None) -> list:
    fns = build(names)
    parent_qmm = load_qmm(parent) if parent else None
    resident = QM.resident_clusters(device.index or 0)
    rows = []
    g = torch.Generator(device=device).manual_seed(0)
    for m, o, i in SHAPES:
        x, wq, sc = _inputs(g, device, m, o, i)
        want = QM.qmm_plain(x, wq, sc)
        copies = weight_copies(wq)
        bound_ms = (o * i + 2 * m * i + 4 * o + 2 * m * o) / MEM_BYTES_PER_S * 1e3
        shape = f"M={m} O={o} I={i}"
        out = torch.empty(m, o, dtype=torch.bfloat16, device=device)
        for name in names:
            lib = fns[name]
            if isinstance(lib, str):
                rows.append({"shape": shape, "variant": name, "error": lib})
                continue
            tried = splits(m, o, i, resident)
            for n, ksplit in enumerate(tried if name == "shipped" else tried[:1]):
                def call(a, w, s, ksplit=ksplit):
                    err = lib.dsm_qmm(a.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
                                      m, o, i, i, ksplit, ctypes.c_void_p(_build.stream_ptr(out.device)))
                    if err:
                        raise RuntimeError(f"CUDA error {err}")

                grid = QM.qmm_grid(m, o, ksplit)
                row = {"shape": shape, "variant": name, "ksplit": ksplit,
                       "blocks": grid[0] * grid[1] * grid[2], "picked": n == 0,
                       "resident_clusters": lib.dsm_qmm_max_clusters(m, o, ksplit),
                       "diagnostic": VARIANTS[name][0]}
                try:
                    call(x, wq, sc)
                    torch.cuda.synchronize()
                    err = float((out.float() - want.float()).abs().max())
                    ms = cold_ms(call, x, copies, sc)
                    warm = warm_ms(call, x, wq, sc) if n == 0 else None
                    b2b = (cold_ms(call, x, copies, sc, behind=False)
                           if n == 0 and name == "shipped" else None)
                except Exception as e:  # reported, and the tool fails
                    row["error"] = str(e).split("\n")[0][:200]
                    rows.append(row)
                    continue
                row.update(ms=ms, warm_ms=warm, back_to_back_ms=b2b, bound_ms=bound_ms,
                           share_of_bound=bound_ms / ms, max_err=err)
                if name.startswith("timeline") and 10 * row["blocks"] <= m * o // 4:
                    call(x, wq, sc)
                    torch.cuda.synchronize()
                    marks = out.view(torch.int64).reshape(-1)[:10 * row["blocks"]]
                    marks = marks.view(-1, 10).double()
                    phases = (marks[:, 1:8] - marks[:, :7]).median(dim=0).values
                    row["phase_cycles_median"] = dict(zip(PHASES, phases.tolist()))
                    start, end = marks[:, 8], marks[:, 9]
                    row["block_start_spread_ns"] = float(start.max() - start.min())
                    row["block_ns_median"] = float((end - start).median())
                    row["grid_ns"] = float(end.max() - start.min())
                rows.append(row)
        if parent_qmm is not None:
            y = parent_qmm.qmm(x, wq, sc)
            torch.cuda.synchronize()
            rows.append({"shape": shape, "variant": "parent", "picked": True,
                         "ms": cold_ms(parent_qmm.qmm, x, copies, sc),
                         "warm_ms": warm_ms(parent_qmm.qmm, x, wq, sc),
                         "back_to_back_ms": cold_ms(parent_qmm.qmm, x, copies, sc, behind=False),
                         "bound_ms": bound_ms,
                         "max_err": float((y.float() - want.float()).abs().max())})
            rows[-1]["share_of_bound"] = bound_ms / rows[-1]["ms"]
        del copies
        torch.cuda.empty_cache()
    return rows


def _variant_launch(lib, resident):
    """A ``qmm._launch`` seam that launches variant ``lib``'s kernel."""
    def launch(x2, wq, s, ksplit):
        (m, i), o = x2.shape, wq.shape[0]
        if ksplit is None:
            ksplit = QM.qmm_tiling(m, o, i, resident).ksplit
        out = torch.empty((m, o), dtype=torch.bfloat16, device=x2.device)
        _build.check(lib.dsm_qmm(x2.data_ptr(), wq.data_ptr(), s.data_ptr(), out.data_ptr(),
                                 m, o, i, wq.stride(0), ksplit,
                                 ctypes.c_void_p(_build.stream_ptr(x2.device))), "qmm")
        return out
    return launch


def run_step(names, device) -> list:
    """The stt-2.6b engine step, its ``qmm`` through each variant in turn."""
    from ..server import builder
    from ..server import config as CFG

    fns = build(list(dict.fromkeys(names)))
    bad = [{"variant": n, "error": e} for n, e in fns.items() if isinstance(e, str)]
    if bad:
        return bad
    resident = QM.resident_clusters(device.index or 0)
    engine = builder.build_batched_asr(CFG.Config.load(str(CONFIG)).modules["asr"], device)
    b = engine.batch_size
    pcm = (np.random.default_rng(7).standard_normal((b, 1, engine.frame_size)) * 0.1
           ).astype(np.float32)
    on, off = np.ones(b, bool), np.zeros(b, bool)
    cuda = torch.autograd.DeviceType.CUDA
    rows, shipped = [], QM._launch
    try:
        with torch.inference_mode():
            engine._invoke_step(pcm, on, on)  # every slot fresh
            for name in names:
                QM._launch = _variant_launch(fns[name], resident)
                engine._invoke_step(pcm, on, off)
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(2):
                        engine._invoke_step(pcm, on, off)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) / 2 * 1e3
                ev = [e for e in prof.key_averages() if e.device_type == cuda]
                qmm = [e for e in ev if "qmm_kernel" in e.key]
                rows.append({"variant": name,
                             "qmm_ms_per_step": sum(e.self_device_time_total for e in qmm) / 2e3,
                             "qmm_launches_per_step": sum(e.count for e in qmm) / 2,
                             "kernel_ms_per_step": sum(e.self_device_time_total
                                                       for e in ev) / 2e3,
                             "wall_ms_per_step": wall})
    finally:
        QM._launch = shipped
    return rows


def run_host(parent, device) -> list:
    """Host microseconds of a ``qmm`` call at each shape (warm weights)."""
    qms = {"this": QM}
    if parent:
        qms["parent"] = load_qmm(parent)
    order = ["parent", "this", "this", "parent"] if parent else ["this", "this"]
    lib = _build.lib()
    resident = QM.resident_clusters(device.index or 0)
    g = torch.Generator(device=device).manual_seed(0)
    rows = []
    for m, o, i in SHAPES:
        x, wq, sc = _inputs(g, device, m, o, i)
        out = torch.empty(m, o, dtype=torch.bfloat16, device=device)
        ksplit = QM.qmm_tiling(m, o, i, resident).ksplit
        row = {"shape": f"M={m} O={o} I={i}", "host_us": {}}
        for who in order:
            row["host_us"].setdefault(who, []).append(
                host_us(lambda q=qms[who]: q.qmm(x, wq, sc)))
        row["host_us"]["dsm_qmm alone"] = [host_us(lambda: lib.dsm_qmm(
            x.data_ptr(), wq.data_ptr(), sc.data_ptr(), out.data_ptr(), m, o, i, i, ksplit,
            ctypes.c_void_p(_build.stream_ptr(x.device))))]
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=None)
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="also time the qmm of the checkout unpacked at DIR")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--step", action="store_true",
                      help="the stt-2.6b engine step with its qmm through each variant")
    mode.add_argument("--host", action="store_true", help="host microseconds a call")
    args = ap.parse_args(argv)
    default = "shipped" if args.step else ",".join(VARIANTS)
    names = [v for v in (args.variants or default).split(",") if v]
    for name in names:
        variant_source(name)  # raises for an unknown name or a stale replacement
    if not torch.cuda.is_available():
        print("qmm_variants: no CUDA device; nothing was measured", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if args.step:
        rows = run_step(names, device)
    elif args.host:
        rows = run_host(args.parent, device)
    else:
        rows = run(names, device, args.parent)
    for row in rows:
        print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 1 if any("error" in row for row in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
