"""Design variants of the fused pipeline's TMA-staged attention kernel, timed
on the card.

    python -m dsm_tpu_torch.tools.fused_commit_variants [--variants a,b,...]

Each variant is ``csrc/decode_attn.cu`` with a few lines replaced
(``VARIANTS``), built with ``nvcc`` into a library of its own under
``build/``, and launched through its ``dsm_decode_attend_commit`` entry point
on the same inputs, at the stt-1b, stt-2.6b and tts-1.6b rings past their
wrap and at a nearly empty stt-1b ring (what a launch costs with next to no
bytes).  Beside them, on the same inputs, the split pipeline's
``ring_commit_q`` + ``decode_attend``.

One JSON row per shape and variant: device ms per call (CUDA events around
calls queued behind a spin kernel), the byte bound of the rows the mask
lets in at 3.35 TB/s and the share of it reached, and the max error against
``decode_attend_commit_plain`` in the kernel's span order (the variants
marked ``diagnostic`` drop work and are not expected to agree).  The last
line is the card's name and power limit.  A variant that fails to build or
launch is an error row and the tool exits with code 1; without a CUDA device
it exits with code 2 and measures nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import attention as attn
from ..ops import decode_attn as dattn
from ..ops import ring_kernels as rk
from .attn_kernel_tune import MEM_BYTES_PER_S, device_time_ms

_LOAD = "*reinterpret_cast<const int4*>(tile + r * DH + sub * 16)"
_K_DOT = ("      if (r < rows) {\n        float kv[16];",
          "      if (r < 0) {\n        float kv[16];")
_V_DOT = (f"      unpack_i8({_LOAD}, vv);",
          "      for (int e = 0; e < 16; ++e) vv[e] = 0.f;")
_OUT = ("  float* out = part + ((int64_t)bh * n_split + sp) * (DH + 2);\n"
        "  const long long pos = *pos_p;\n  const int w = (int)(pos % c);\n\n  if (tid == 0) {\n")
_EMPTY = ("  float* out = part + ((int64_t)bh * n_split + sp) * (DH + 2);\n"
          "  const long long pos = *pos_p;\n  const int w = (int)(pos % c);\n"
          "  if (tid < DH) out[tid] = 0.f;\n"
          "  if (tid == 0) { out[DH] = -INFINITY; out[DH + 1] = 0.f; }\n"
          "  if (true) return;\n\n  if (tid == 0) {\n")
_FOLD = "  err = launch_fold<DH>((unsigned)bh, s, q, k_new, v_new, part, out, n_split, scale,"
_OVERLAP = ("attr.val.programmaticStreamSerializationAllowed = 1;",
            "attr.val.programmaticStreamSerializationAllowed = 0;")


def _constant(name: str, value: int, new: int):
    return (f"constexpr int {name} = {value};", f"constexpr int {name} = {new};")


# name -> (diagnostic, [(text of the source, its replacement), ...])
VARIANTS = {
    "shipped": (False, []),
    "int-to-float": (False, [(f"{lead}unpack_i8({_LOAD}, {x});",
                              f"{lead}unpack_load({_LOAD}, {x});")
                             for lead, x in (("        ", "kv"), ("      ", "vv"))]),
    "stages=3": (False, [_constant("kStages", 2, 3)]),
    "stages=4": (False, [_constant("kStages", 2, 4)]),
    "stages=6": (False, [_constant("kStages", 2, 6)]),
    "tile=4KB": (False, [_constant("kTileBytes", 8192, 4096)]),
    "tile=16KB": (False, [_constant("kTileBytes", 8192, 16384)]),
    "consumer-warps=8": (False, [_constant("kConsumerWarps", 4, 8)]),
    "fold-after-partials": (False, [_OVERLAP]),
    "no-compute": (True, [_K_DOT, _V_DOT]),
    "no-fold": (True, [(_FOLD, "  if (0) " + _FOLD.lstrip())]),
    "empty-partial": (True, [(_OUT, _EMPTY)]),
}
# (label, B, H, C, Dh, pos, window, valid share)
SHAPES = (("stt-1b pos=3000", 64, 16, 768, 128, 3000, 750, 1.0),
          ("stt-2.6b pos=3000", 64, 32, 384, 64, 3000, 375, 1.0),
          ("tts-1.6b pos=5000 valid=0.7", 64, 16, 1024, 128, 5000, 1024, 0.7),
          ("stt-1b pos=40", 64, 16, 768, 128, 40, 750, 1.0))


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


def build(names) -> dict:
    """Build each variant's library, one nvcc each, all started together ->
    ``{name: dsm_decode_attend_commit or the compiler's error}``."""
    root = _build.BUILD_ROOT.parent / "fused_commit_variants"
    procs = {}
    for name in names:
        d = root / name.replace("=", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "decode_attn.cu").write_text(variant_source(name))
        for header in ("attn_common.cuh", "tma_common.cuh"):
            shutil.copy(_build.CSRC / header, d)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "decode_attn.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (d, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            fns[name] = out[-500:]
            continue
        fn = ctypes.CDLL(str(d / "lib.so")).dsm_decode_attend_commit
        fn.argtypes, fn.restype = _build._SIGNATURES["dsm_decode_attend_commit"]
        fns[name] = fn
    return fns


def _inputs(g, b, h, c, dh, valid_share, device):
    q, k_new, v_new = ((torch.randn(b, h, 1, dh, generator=g, device=device) * 0.5).bfloat16()
                       for _ in range(3))
    k, v = (torch.randint(-127, 128, (b, h, c, dh), generator=g, device=device,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(b, h, c, generator=g, device=device) * 0.019 + 0.001
              for _ in range(2))
    valid = torch.rand(b, c, generator=g, device=device) < valid_share
    return q, k_new, v_new, k, v, ks, vs, valid


def run(names, device) -> list:
    fns = build(names)
    rows = []
    g = torch.Generator(device=device).manual_seed(0)
    for label, b, h, c, dh, pos, window, share in SHAPES:
        q, k_new, v_new, k, v, ks, vs, valid = _inputs(g, b, h, c, dh, share, device)
        kq, vq, ksn, vsn = attn.quantize_kv_rows(k_new, v_new)
        plan = attn.global_ring_plan(pos, c, 1, device=device)
        pos_t, w = plan["pos"], pos % c
        r3 = [x[:, :, 0].contiguous() for x in (q, kq, vq, k_new, v_new)]
        n_split = dattn.pick_split(b * h, c)
        want = dattn.decode_attend_commit_plain(r3[0], k.clone(), v.clone(), ks, vs, *r3[1:],
                                                valid, pos, w, window, n_split)
        j = torch.arange(c, device=device)
        dist = torch.remainder(w - j, c)
        attended = int((((dist != 0) & (dist <= pos) & (dist < window))[None] & valid).sum())
        bound_ms = (attended * h * (2 * dh + 8) + b * c + 8 * b * h * dh) / MEM_BYTES_PER_S * 1e3
        part = torch.empty((b * h, n_split, dh + 2), dtype=torch.float32, device=device)
        out = torch.empty((b, h, dh), dtype=torch.bfloat16, device=device)

        def record(name, fn, got=None, diagnostic=False):
            row = {"shape": label, "variant": name, "n_split": n_split}
            try:
                ms = device_time_ms(fn)
                y = got() if got else None
                torch.cuda.synchronize()
            except Exception as e:  # reported, and the tool fails
                row["error"] = str(e).split("\n")[0][:200]
                rows.append(row)
                return
            row.update(ms=ms, bound_ms=bound_ms, share_of_bound=bound_ms / ms,
                       diagnostic=diagnostic)
            if y is not None:
                row["max_err"] = float((y.float() - want.float()).abs().max())
            rows.append(row)

        for name in names:
            fn = fns[name]
            if isinstance(fn, str):
                rows.append({"shape": label, "variant": name, "error": fn})
                continue

            def call(fn=fn):
                err = fn(r3[0].data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
                         vs.data_ptr(), r3[1].data_ptr(), r3[2].data_ptr(), r3[3].data_ptr(),
                         r3[4].data_ptr(), valid.data_ptr(), part.data_ptr(), out.data_ptr(),
                         b, h, c, dh, n_split, pos_t.data_ptr(), window, 1.0 / math.sqrt(dh),
                         ctypes.c_void_p(_build.stream_ptr(k.device)))
                if err:
                    raise RuntimeError(f"CUDA error {err}")

            record(name, call, lambda: out, VARIANTS[name][0])

        sk, sv, sks, svs = k.clone(), v.clone(), ks.clone(), vs.clone()

        def split_pair():
            rk.ring_commit(sk, sv, kq, vq, pos_t, sks, svs, ksn, vsn)
            return dattn.decode_attend(q, sk, sv, sks, svs, k_new, v_new, plan, valid,
                                       window=window)[:, :, 0]

        record("ring_commit_q + decode_attend", split_pair, split_pair)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    names = [v for v in args.variants.split(",") if v]
    for name in names:
        variant_source(name)  # raises for an unknown name or a stale replacement
    if not torch.cuda.is_available():
        print("fused_commit_variants: no CUDA device; nothing was measured", file=sys.stderr)
        return 2
    rows = run(names, torch.device("cuda", 0))
    for row in rows:
        print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 1 if any("error" in row for row in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
