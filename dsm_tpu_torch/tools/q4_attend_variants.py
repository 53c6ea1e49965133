"""Design variants of the packed-int4 ``decode_attend`` kernel, timed on the
card.

    python -m dsm_tpu_torch.tools.q4_attend_variants [--variants a,b,...] [--parent DIR]

Each variant is ``csrc/decode_attn.cu`` with a few lines replaced
(``VARIANTS``), built with ``nvcc`` into a library of its own under
``build/``, and launched through its ``dsm_decode_attend`` entry point on the
same packed-int4 rings: the stt-1b, stt-2.6b and s2s-2b serving rings past
their wrap, the same rings nearly empty (pos 40), and the full rings at
batches of 1 to 8.  The design variants change the stages of the copy ring,
the bytes of a tile, the blocks an SM the persistent grid is sized for (so
the items a block takes), the consumer warps, and the fold where the ring is
split (after the grid instead of a programmatic dependent launch); the
shipped build is also timed at the spans ``SPLITS`` (its pick first:
``decode_attn.card_split``, from the tile rows and the card's SMs, both
printed in every row).  The diagnostics drop work:
``no-unpack`` (the mma reads the raw words), ``no-mma`` (the unpacked values
go nowhere; ``no-mma-k`` and ``no-mma-v`` in one pass), ``no-arithmetic``
(neither), ``mma-twice`` (every mma issued once more, into registers
nobody reads), ``copies-alone`` (the consumers only wait for the tiles and
hand them back) and ``empty-launch`` (every block returns at once).  Beside them, on the same
(B, H, C), the int8 ``decode_attend`` of this checkout over int8 rings, and
with ``--parent DIR`` the ``decode_attend`` of the checkout unpacked at DIR
(a parent commit, built there) on the same packed rings, at its own split
and at one span.

One JSON row per shape, variant and split: device ms per call (CUDA events
around calls queued behind a spin kernel), the byte bound of the rows the
mask lets in at 3.35 TB/s and the share of it reached, and the max error
against ``decode_attend_plain`` at the same split (the diagnostics are not
expected to agree).  The last line is the card's name and power limit.  A
variant that fails to build or launch is an error row and the tool exits
with code 1; without a CUDA device it exits with code 2 and measures nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build
from ..ops import attention
from ..ops import decode_attn as DA
from .attn_kernel_tune import MEM_BYTES_PER_S, device_time_ms

_MMA = ('  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "\n'
        '      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"\n'
        '      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])\n'
        '      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));',
        '  asm volatile("" : "+f"(d[0]) : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));')
_UNPACK = ('  const uint32_t r = (x & 0x000F000Fu) | 0x43004300u;\n  uint32_t d;\n'
           '  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(r), "r"(0x3F803F80u), '
           '"r"(0xC308C308u));\n  return d;',
           "  return x;")
_K_LOOP = ("      for (int r0 = lo / (32 * kQ4Warps) * (32 * kQ4Warps) + 16 * warp; r0 < hi;\n"
           "           r0 += 32 * kQ4Warps) {")
_V_LOOP = ("      for (int r0 = lo / (16 * kQ4Warps) * (16 * kQ4Warps) + 16 * warp; r0 < hi;\n"
           "           r0 += 16 * kQ4Warps) {")
_K_MMA = ("            q4_mma(acc[u], ra[0], rb[0], ra[1], rb[1], qf[4 * x], qf[4 * x + 1]);\n"
          "            q4_mma(acc[u], ra[2], rb[2], ra[3], rb[3], qf[4 * x + 2], qf[4 * x + 3]);",
          '            asm volatile("" : "+f"(acc[u][0]) : "r"(ra[0]), "r"(rb[0]), "r"(ra[1]), '
          '"r"(rb[1]), "r"(ra[2]), "r"(rb[2]), "r"(ra[3]), "r"(rb[3]));')
_V_MMA = ("            q4_mma(acc[grp][j], ra[2 * j], ra[2 * j + 1], rb[2 * j], rb[2 * j + 1], "
          "b0, b1);",
          '            asm volatile("" : "+f"(acc[grp][j][0]) : "r"(ra[2 * j]), '
          '"r"(ra[2 * j + 1]), "r"(rb[2 * j]), "r"(rb[2 * j + 1]), "r"(b0), "r"(b1));')
_START = "  launch_dependents();\n  const int tid = threadIdx.x;\n  const int lane = tid & 31;"


def _constant(decl: str, value: str, new: str):
    return (f"{decl} = {value};", f"{decl} = {new};")


def _skip(loop: str):
    return (loop, "      if (false)\n" + loop)


_GRID = "  *blocks = max(1, per_sm) * sms;"
_FOLD = ("  return launch_fold<DH>((unsigned)bh, s, q, k_new, v_new, part, out, n_split, scale, "
         "nullptr,\n                         nullptr, nullptr, nullptr, h, c, kv_sb, kv_sh, pos);")
_FOLD_AFTER = ("  decode_attend_combine_kernel<DH><<<(unsigned)bh, DH, 0, s>>>(\n"
               "      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_new, "
               "(const __nv_bfloat16*)v_new,\n"
               "      (const float*)part, (__nv_bfloat16*)out, n_split, scale, nullptr, nullptr, "
               "nullptr,\n      nullptr, h, c, kv_sb, kv_sh, pos);\n  return cudaGetLastError();")
_STAGES = "  static constexpr int kStages = DH == 64 ? 3 : 4;"
_TILE = "  static constexpr int kTileBytes = DH == 64 ? 12288 : 8192;"


def _at_every_width(text: str, value: int):
    """A per-head-width choice ``text`` set to ``value`` at every head width."""
    return (text, text.split("=")[0] + f"= {value};")


# name -> (diagnostic, [(text of the source, its replacement), ...])
VARIANTS = {
    "shipped": (False, []),
    "stages=2": (False, [_at_every_width(_STAGES, 2)]),
    "stages=3": (False, [_at_every_width(_STAGES, 3)]),
    "stages=4": (False, [_at_every_width(_STAGES, 4)]),
    "stages=6": (False, [_at_every_width(_STAGES, 6)]),
    "tile=4KB": (False, [_at_every_width(_TILE, 4096)]),
    "tile=8KB": (False, [_at_every_width(_TILE, 8192)]),
    "tile=12KB": (False, [_at_every_width(_TILE, 12288)]),
    "tile=8KB+stages=4": (False, [_at_every_width(_TILE, 8192), _at_every_width(_STAGES, 4)]),
    "blocks-per-sm=2": (False, [(_GRID, _GRID.replace("per_sm", "min(per_sm, 2)"))]),
    "blocks-per-sm=3": (False, [(_GRID, _GRID.replace("per_sm", "min(per_sm, 3)"))]),
    "fold-after-grid": (False, [(_FOLD, _FOLD_AFTER)]),
    "consumer-warps=8": (False, [_constant("constexpr int kQ4Warps", "4", "8")]),
    "no-unpack": (True, [_UNPACK]),
    "no-mma": (True, [_MMA]),
    "no-mma-k": (True, [_K_MMA]),
    "no-mma-v": (True, [_V_MMA]),
    "no-arithmetic": (True, [_UNPACK, _MMA]),
    "mma-twice": (True, [(_MMA[0], _MMA[0] + "\n  float e[4] = {0.f, 0.f, 0.f, 0.f};\n"
                          + _MMA[0].replace("asm(", "asm volatile(").replace("d[", "e["))]),
    "copies-alone": (True, [_skip(_K_LOOP), _skip(_V_LOOP)]),
    "empty-launch": (True, [(_START, _START.replace("\n  const int tid", "\n  if (true) return;"
                                                                       "\n  const int tid"))]),
}
# (label, B, H, C, Dh, pos, window, valid share)
# The serving rings at their batch sizes, then the same rings at batches an
# operator may set lower (B*H under two items an SM: the packed pick splits
# them).
SHAPES = (("stt1b-kv4 pos=3000", 64, 16, 768, 128, 3000, 750, 1.0),
          ("stt26-kv4 pos=3000", 64, 32, 384, 64, 3000, 375, 1.0),
          ("duplex-kv4 pos=10000", 24, 20, 3072, 128, 10000, 3000, 1.0),
          ("stt1b-kv4 pos=40", 64, 16, 768, 128, 40, 750, 0.9),
          ("stt26-kv4 pos=40", 64, 32, 384, 64, 40, 375, 0.9),
          ("duplex-kv4 pos=40", 24, 20, 3072, 128, 40, 3000, 0.7),
          ("stt1b-kv4 B=8 pos=3000", 8, 16, 768, 128, 3000, 750, 1.0),
          ("stt1b-kv4 B=1 pos=3000", 1, 16, 768, 128, 3000, 750, 1.0),
          ("stt26-kv4 B=1 pos=3000", 1, 32, 384, 64, 3000, 375, 1.0),
          ("duplex-kv4 B=4 pos=10000", 4, 20, 3072, 128, 10000, 3000, 1.0),
          ("duplex-kv4 B=1 pos=10000", 1, 20, 3072, 128, 10000, 3000, 1.0))
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24)  # spans the shipped build is also timed at


def variant_source(name: str) -> str:
    """``csrc/decode_attn.cu`` as variant ``name`` has it; every text it
    replaces must occur in the source exactly once."""
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; one of {', '.join(VARIANTS)}")
    src = (_build.CSRC / "decode_attn.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old[:60]!r} is not in the source once")
        src = src.replace(old, new)
    return src


def splits(pick: int, c: int) -> list:
    """The packed pick, then the other ``SPLITS`` that leave no span but the
    last empty."""
    rest = [n for n in SPLITS
            if n != pick and n <= c and DA.span_rows(c, n) * (n - 1) < c]
    return [pick, *rest]


def build(names, source=variant_source, root_name: str = "q4_attend_variants") -> dict:
    """Build each variant's library (``source(name)``: its text of
    ``csrc/decode_attn.cu``) under ``build/<root_name>/``, one nvcc each,
    all started together -> ``{name: dsm_decode_attend or the compiler's
    error}``."""
    root = _build.BUILD_ROOT.parent / root_name
    procs = {}
    for name in names:
        d = root / name.replace("=", "_").replace("+", "_").replace("/", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "decode_attn.cu").write_text(source(name))
        for header in ("attn_common.cuh", "tma_common.cuh"):
            shutil.copy(_build.CSRC / header, d)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "decode_attn.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (d, proc) in procs.items():
        out = proc.communicate()[0]
        (d / "build.log").write_text(out)
        if proc.returncode != 0:
            fns[name] = out[-500:]
            continue
        fn = ctypes.CDLL(str(d / "lib.so")).dsm_decode_attend
        fn.argtypes, fn.restype = _build._SIGNATURES["dsm_decode_attend"]
        fns[name] = fn
    return fns


def load_decode_attn(root, alias: str = "dsm_tpu_torch_at"):
    """``ops.decode_attn`` of the ``dsm_tpu_torch`` package in the checkout
    at ``root`` (a parent commit), imported as package ``alias`` beside this
    one; it builds its kernels under ``root/build/``."""
    init = Path(root) / "dsm_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{alias}.ops.decode_attn")


def _inputs(g, b, h, c, dh, valid_share, device, packed=True):
    q, k_new, v_new = ((torch.randn(b, h, dh, generator=g, device=device) * 0.5).bfloat16()
                       for _ in range(3))
    if packed:
        k, v = (torch.randint(0, 256, (b, h, c, dh // 2), generator=g, device=device,
                              dtype=torch.uint8) for _ in range(2))
    else:
        k, v = (torch.randint(-127, 128, (b, h, c, dh), generator=g, device=device,
                              dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(b, h, c, generator=g, device=device) * 0.019 + 0.001 for _ in range(2))
    valid = torch.rand(b, c, generator=g, device=device) < valid_share
    return q, k, v, ks, vs, k_new, v_new, valid


def run(names, device, parent=None) -> list:
    fns = build(names)
    parent_da = load_decode_attn(parent) if parent else None
    rows = []
    g = torch.Generator(device=device).manual_seed(0)
    for label, b, h, c, dh, pos, window, share in SHAPES:
        pick = DA.card_split(b * h, c, dh, True, device)
        tile_rows, sms = DA.ring_card(device.index or 0, dh, True)
        args = _inputs(g, b, h, c, dh, share, device)
        q, k, v, ks, vs, k_new, v_new, valid = args
        w = pos % c
        plan = attention.global_ring_plan(pos, c, 1, device=device)
        j = torch.arange(c, device=device)
        dist = torch.remainder(w - j, c)
        attended = int((((dist != 0) & (dist <= pos) & (dist < window))[None] & valid).sum())
        bound_ms = ((attended * h * (dh + 8) + b * c + 8 * b * h * dh)
                    / MEM_BYTES_PER_S * 1e3)
        want = {}

        def plain(n_split):
            if n_split not in want:
                want[n_split] = DA.decode_attend_plain(q, k, v, ks, vs, k_new, v_new, valid,
                                                       pos, w, window, n_split)
            return want[n_split]

        def record(name, n_split, fn, got=None, diagnostic=False, bound=bound_ms):
            row = {"shape": label, "variant": name, "n_split": n_split, "pick": pick,
                   "tile_rows": tile_rows, "sms": sms}
            try:
                ms = device_time_ms(fn)
                y = got() if got else None
                torch.cuda.synchronize()
            except Exception as e:  # reported, and the tool fails
                row["error"] = str(e).split("\n")[0][:200]
                rows.append(row)
                return
            row.update(ms=ms, bound_ms=bound, share_of_bound=bound / ms, diagnostic=diagnostic)
            if y is not None and not diagnostic:
                row["max_err"] = float((y.float() - plain(n_split).float()).abs().max())
            rows.append(row)

        for name in names:
            fn = fns[name]
            if isinstance(fn, str):
                rows.append({"shape": label, "variant": name, "error": fn})
                continue
            for n_split in (splits(pick, c) if name == "shipped"
                            else sorted({pick, 3 if name == "fold-after-grid" else 1})):
                part = torch.empty((b * h, n_split, dh + 2), dtype=torch.float32, device=device)
                out = torch.empty((b, h, dh), dtype=torch.bfloat16, device=device)

                def call(fn=fn, n_split=n_split, part=part, out=out):
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
                             vs.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), valid.data_ptr(),
                             part.data_ptr(), out.data_ptr(), b, h, c, dh, 1, n_split,
                             k.stride(0), k.stride(1), ks.stride(0), ks.stride(1),
                             plan["pos"].data_ptr(), window, 1.0 / math.sqrt(dh),
                             ctypes.c_void_p(_build.stream_ptr(q.device)))
                    if err:
                        raise RuntimeError(f"CUDA error {err}")

                record(name, n_split, call, lambda out=out: out, VARIANTS[name][0])

        q4 = [x[:, :, None] for x in (q, k_new, v_new)]
        if parent_da is not None:
            for n_split in sorted({parent_da.pick_split(b * h, c), 1}):
                def parent_call(n_split=n_split):
                    return parent_da.decode_attend(q4[0], k, v, ks, vs, q4[1], q4[2], plan, valid,
                                                   window=window, n_split=n_split)[:, :, 0]

                record("parent", n_split, parent_call, parent_call)
        i8 = _inputs(g, b, h, c, dh, share, device, packed=False)
        i8_bound = ((attended * h * (2 * dh + 8) + b * c + 8 * b * h * dh)
                    / MEM_BYTES_PER_S * 1e3)
        i8_split = DA.card_split(b * h, c, dh, False, device)

        def int8_call():
            return DA.decode_attend(i8[0][:, :, None], *i8[1:5], i8[5][:, :, None],
                                    i8[6][:, :, None], plan, i8[7], window=window)

        record("int8 decode_attend", i8_split, int8_call, bound=i8_bound)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="also time the decode_attend of the checkout unpacked at DIR")
    args = ap.parse_args(argv)
    names = [v for v in args.variants.split(",") if v]
    for name in names:
        variant_source(name)  # raises for an unknown name or a stale replacement
    if not torch.cuda.is_available():
        print("q4_attend_variants: no CUDA device; nothing was measured", file=sys.stderr)
        return 2
    rows = run(names, torch.device("cuda", 0), args.parent)
    for row in rows:
        print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 1 if any("error" in row for row in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
