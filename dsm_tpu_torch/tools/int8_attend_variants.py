"""Design variants of the int8 ``decode_attend`` kernel (the split
pipeline's attention over int8 rings), timed on the card.

    python -m dsm_tpu_torch.tools.int8_attend_variants [--variants a,b,...] [--parent DIR]

Each variant is ``csrc/decode_attn.cu`` with a few lines replaced
(``VARIANTS``), built with ``nvcc`` into a library of its own under
``build/``, and launched through its ``dsm_decode_attend`` entry point on the
same int8 rings (``SHAPES``): the stt-2.6b, tts_202501, stt-1b (the split
route), s2s-2b and Moshi 7B serving rings past their wrap, the s2s-2b
dp x tp shard and the tp = 4 stt-1b shard, and each serving ring nearly empty
(pos 40).  The design variants change the stages of the copy ring, the
bytes of a tile, the blocks an SM the persistent grid is sized for (so the
items a block takes), the consumer warps, the dot route's conversion of
int8 values (``int-to-float``: I2F in place of the byte permute) and the
fold where the ring is split (after the grid instead of a programmatic
dependent launch); the shipped build is also timed at the spans of
``q4_attend_variants.SPLITS`` (its pick first: ``decode_attn.card_split``,
from the tile rows and the card's SMs, both printed in every row).  The
diagnostics drop work: ``copies-alone`` (the consumers only wait for the
tiles and hand them back: what no dot route can beat) and ``empty-launch``
(every block returns at once).  With ``--parent DIR``, the ``decode_attend``
of the checkout unpacked at DIR (a parent commit, built there) on the same
rings, at its own split and at one span.

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
import json
import math
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import attention
from ..ops import decode_attn as DA
from . import q4_attend_variants as QV
from .attn_kernel_tune import MEM_BYTES_PER_S, device_time_ms

_STAGES = "constexpr int kQ8Stages = 2;"
_TILE = "constexpr int kQ8TileBytes = 16384;"
_SMALL = "constexpr int kQ8SmallTileBytes = 8192;"
_BLOCKS = "constexpr int q8_min_blocks(int dh) { return dh == 64 ? 8 : 6; }"
_K_LOAD = "unpack_i8(*reinterpret_cast<const int4*>(tile + sub * 16 + r * DH), kv);"
_V_LOAD = "unpack_i8(*reinterpret_cast<const int4*>(tile + sub * 16 + r * DH), vv);"
_LOOP = "      for (int r0 = lo / STEP * STEP + warp * RPW; r0 < hi; r0 += STEP) {\n"
_K_LOOP = _LOOP + "        const int r = r0 + rsub;\n        float acc = 0.f;"
_V_LOOP = _LOOP + "        const int r = r0 + rsub;\n        if (r >= hi) continue;"
_START = "  launch_dependents();\n  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;"
_PER_BLOCK = "  const long long per_block = (items + resident - 1) / resident;"
_K_DOT = "          for (int e = 0; e < 16; ++e) acc += qf[e] * kv[e];"
_K_DOT2 = ("          float acc2 = 0.f;\n"
           "          for (int e = 0; e < 16; e += 2) {\n"
           "            acc += qf[e] * kv[e];\n"
           "            acc2 += qf[e + 1] * kv[e + 1];\n"
           "          }\n"
           "          acc += acc2;")


def _set(text: str, value):
    """A line ``... = x;`` of the source set to ``... = value;``."""
    return (text, text.split("=")[0] + f"= {value};")


def _blocks(n: int):
    """The int8 kernel's blocks an SM set to ``n`` at both head widths."""
    return (_BLOCKS, _BLOCKS.split("{")[0] + f"{{ return {n}; }}")


def _skip(loop: str):
    return (loop, "      if (false)\n" + loop)


# name -> (diagnostic, [(text of the source, its replacement), ...])
VARIANTS = {
    "shipped": (False, []),
    "stages=3": (False, [_set(_STAGES, 3)]),
    "tiles=8KB": (False, [_set(_TILE, 8192)]),
    "tiles=16KB": (False, [_set(_SMALL, 16384)]),
    "tiles=12KB/8KB": (False, [_set(_TILE, 12288)]),
    "tiles=32KB/8KB": (False, [_set(_TILE, 32768)]),
    "tiles=16KB/4KB": (False, [_set(_SMALL, 4096)]),
    "min-blocks=1": (False, [_blocks(1)]),
    "min-blocks=6": (False, [_blocks(6)]),
    "min-blocks=8": (False, [_blocks(8)]),
    "per-block=1": (False, [_set(_PER_BLOCK, 1)]),
    "k-chains=2": (False, [(_K_DOT, _K_DOT2)]),
    "blocks-per-sm=2": (False, [(QV._GRID, QV._GRID.replace("per_sm", "min(per_sm, 2)"))]),
    "blocks-per-sm=3": (False, [(QV._GRID, QV._GRID.replace("per_sm", "min(per_sm, 3)"))]),
    "consumer-warps=8": (False, [("constexpr int kQ8Warps = 4;", "constexpr int kQ8Warps = 8;")]),
    "int-to-float": (False, [(_K_LOAD, _K_LOAD.replace("unpack_i8", "unpack_load")),
                             (_V_LOAD, _V_LOAD.replace("unpack_i8", "unpack_load"))]),
    "fold-after-grid": (False, [(QV._FOLD, QV._FOLD_AFTER)]),
    "copies-alone": (True, [_skip(_K_LOOP), _skip(_V_LOOP)]),
    "empty-launch": (True, [(_START, _START.replace("\n  const int tid", "\n  if (true) return;"
                                                                       "\n  const int tid"))]),
}
# (label, B, H, C, Dh, pos, window, valid share): the serving rings past
# their wrap, the tp shards the mesh phases run, then the serving rings
# nearly empty.
SHAPES = (("stt26 pos=3000", 64, 32, 384, 64, 3000, 375, 1.0),
          ("tts202501 pos=3000", 64, 32, 512, 64, 3000, 500, 1.0),
          ("stt1b pos=3000", 64, 16, 768, 128, 3000, 750, 1.0),
          ("duplex pos=10000", 24, 20, 3072, 128, 10000, 3000, 1.0),
          ("moshi pos=10000", 24, 32, 3072, 128, 10000, 3000, 1.0),
          ("duplex tp shard pos=5000", 12, 10, 3072, 128, 5000, 3000, 0.7),
          ("stt1b tp4 shard pos=3000", 32, 4, 768, 128, 3000, 750, 1.0),
          ("stt26 pos=40", 64, 32, 384, 64, 40, 375, 0.7),
          ("tts202501 pos=40", 64, 32, 512, 64, 40, 500, 0.9),
          ("stt1b pos=40", 64, 16, 768, 128, 40, 750, 0.9),
          ("duplex pos=40", 24, 20, 3072, 128, 40, 3000, 0.7),
          ("moshi pos=40", 24, 32, 3072, 128, 40, 3000, 0.7))


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


def bound_ms(b, h, c, dh, pos, window, valid) -> float:
    """The byte bound at 3.35 TB/s: each attended row's K and V and their
    scales for every head, the validity rows, q, the fresh rows and the
    output once."""
    j = torch.arange(c, device=valid.device)
    dist = torch.remainder(pos % c - j, c)
    attended = int((((dist != 0) & (dist <= pos) & (dist < window))[None] & valid).sum())
    return (attended * h * (2 * dh + 8) + b * c + 8 * b * h * dh) / MEM_BYTES_PER_S * 1e3


def run(names, device, parent=None) -> list:
    fns = QV.build(names, variant_source, "int8_attend_variants")
    parent_da = QV.load_decode_attn(parent) if parent else None
    rows = []
    g = torch.Generator(device=device).manual_seed(0)
    for label, b, h, c, dh, pos, window, share in SHAPES:
        pick = DA.card_split(b * h, c, dh, False, device)
        tile_rows, sms = DA.ring_card(device.index or 0, dh, False)
        q, k, v, ks, vs, k_new, v_new, valid = QV._inputs(g, b, h, c, dh, share, device,
                                                          packed=False)
        w = pos % c
        plan = attention.global_ring_plan(pos, c, 1, device=device)
        bound = bound_ms(b, h, c, dh, pos, window, valid)
        want = {}

        def plain(n_split):
            if n_split not in want:
                want[n_split] = DA.decode_attend_plain(q, k, v, ks, vs, k_new, v_new, valid,
                                                       pos, w, window, n_split)
            return want[n_split]

        def record(name, n_split, fn, got=None, diagnostic=False):
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
            for n_split in (QV.splits(pick, c) if name == "shipped"
                            else sorted({pick, 3 if name == "fold-after-grid" else pick})):
                part = torch.empty((b * h, n_split, dh + 2), dtype=torch.float32, device=device)
                out = torch.empty((b, h, dh), dtype=torch.bfloat16, device=device)

                def call(fn=fn, n_split=n_split, part=part, out=out):
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
                             vs.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), valid.data_ptr(),
                             part.data_ptr(), out.data_ptr(), b, h, c, dh, 0, n_split,
                             k.stride(0), k.stride(1), ks.stride(0), ks.stride(1),
                             plan["pos"].data_ptr(), window, 1.0 / math.sqrt(dh),
                             ctypes.c_void_p(_build.stream_ptr(q.device)))
                    if err:
                        raise RuntimeError(f"CUDA error {err}")

                record(name, n_split, call, lambda out=out: out, VARIANTS[name][0])

        if parent_da is not None:
            q4 = [x[:, :, None] for x in (q, k_new, v_new)]
            for n_split in sorted({parent_da.pick_split(b * h, c), 1}):
                def parent_call(n_split=n_split):
                    return parent_da.decode_attend(q4[0], k, v, ks, vs, q4[1], q4[2], plan, valid,
                                                   window=window, n_split=n_split)[:, :, 0]

                record("parent", n_split, parent_call, parent_call)
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
        print("int8_attend_variants: no CUDA device; nothing was measured", file=sys.stderr)
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
