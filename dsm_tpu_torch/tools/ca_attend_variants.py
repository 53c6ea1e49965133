"""Design variants of the ``ca_decode_attend`` kernel (the TTS voice
cross-attention), timed on the card.

    python -m dsm_tpu_torch.tools.ca_attend_variants [--variants a,b,...]
        [--clusters 1,2,...] [--parent DIR]

Each variant is ``csrc/ca_attn.cu`` with a few lines replaced (``VARIANTS``),
built with ``nvcc`` into a library of its own under ``build/``, and launched
through its ``dsm_ca_decode_attend`` entry point on the same voice sources:
tts-1.6b's and tts_202501's serving shapes, a tp = 2 shard of the TTS mesh,
and one session of each (``SHAPES``).  The design variants change the
stages of the copy ring, the bytes of a tile (a block of one's, a
cluster's), the consumer warps, the score's two chains of multiply-adds in
place of one, a launch with the cluster attribute also for clusters of one
block, the cluster's exchange by bulk copies in place of st.async stores,
and the conversion of int8 values (``i2f-convert``: the int-to-float conversion of
the kernel before the redesign, in place of the byte permute).  The shipped
build is timed at every cluster size of ``--clusters`` (the pick first:
``decode_attn.pick_ca_cluster`` from the card's SMs, printed in every row),
warm (20 calls on one source) and cold (each call on another of copies of
the source that together exceed twice the 50 MB L2); the others at the pick.
The diagnostics drop work: ``no-convert`` (the raw words go to the
multiply-adds), ``copies-alone`` (the consumers only wait for the tiles and
hand them back) and ``empty-launch`` (every block returns at once).  With
``--parent DIR``, the ``ca_decode_attend`` of the checkout unpacked at DIR (a
parent commit, built there) on the same sources.

One JSON row per shape, variant and cluster size: device ms per call (CUDA
events around calls queued behind a spin kernel), the byte bound (each
real source row and its scales read once, q read and the output written
once, at 3.35 TB/s) and the share of it reached, and the max error against
``ca_decode_attend_plain`` (the diagnostics are not expected to agree).  The
last line is the card's name and power limit.  A variant that fails to build
or launch is an error row and the tool exits with code 1; without a CUDA
device it exits with code 2 and measures nothing.
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
from ..ops import decode_attn as DA
from .attn_kernel_tune import MEM_BYTES_PER_S, device_time_ms
from .q4_attend_variants import load_decode_attn

_UNPACK = ("      out[4 * i + b] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7440u | b)) "
           "- 8388736.f;")
_K_LOOP = "    for (int r0 = warp * RPW; r0 < rows; r0 += kCaWarps * RPW) {"
_V_LOOP = "    for (int r = warp * RPW + rsub; r < rows; r += kCaWarps * RPW) {"
_START = "  const int bh = blockIdx.x / n_cl;"


def _constant(name: str, value: str, new: str):
    return (f"constexpr int {name} = {value};", f"constexpr int {name} = {new};")


def _skip(loop: str):
    return (loop, "    if (false)\n" + loop)


_STAGES3 = _constant("kCaStages", "2", "3")
_STAGES4 = _constant("kCaStages", "2", "4")
_ONE_CHAIN = ("        for (int e = 0; e < 16; ++e) acc += qf[e] * kv[e];",
              """        for (int e = 0; e < 16; e += 2) {
          acc += qf[e] * kv[e];
          odd += qf[e + 1] * kv[e + 1];
        }
        acc += odd;""")
_ODD = ("        float kv[16];\n        ca_unpack(", "        float kv[16], odd = 0.f;\n        ca_unpack(")
_ATTRS = ("  cfg.numAttrs = n_cl > 1 ? 1 : 0;", "  cfg.numAttrs = 1;")
# The cluster's exchange as bulk copies between shared memories (16 bytes a
# maximum, a 16-byte aligned partial), with a second cluster barrier before a
# block may leave, in place of 4-byte st.async stores.
_BULK_EXCHANGE = [
    ("    return cluster(span) + (n_cl > 1 ? 4 * kCaMaxCluster + 4 * kPart * n_cl : 0);",
     "    return cluster(span) + (n_cl > 1 ? 16 * kCaMaxCluster + 16 + 4 * kPart * (n_cl + 1) "
     ": 0);"),
    ("  float* recv = maxima + kCaMaxCluster;  // rank r's partial at [r kPart]",
     "  float* mine = maxima + 4 * kCaMaxCluster;\n  float* part = mine + 4;\n"
     "  float* recv = part + L::kPart;"),
    ("      mbar_arrive_expect_tx(max_bar, (uint32_t)(4 * (n_cl - 1)));",
     "      mbar_arrive_expect_tx(max_bar, (uint32_t)(16 * (n_cl - 1)));"),
    ("      if (rank == 0) mbar_arrive_expect_tx(part_bar, (uint32_t)(4 * (DH + 1) * (n_cl - 1)));",
     "      if (rank == 0) mbar_arrive_expect_tx(part_bar, (uint32_t)(4 * L::kPart * (n_cl - 1)));"),
    ("""    if (tid < n_cl && tid != rank)
      store_to_peer(cluster_addr(maxima + rank, tid), m, cluster_addr(max_bar, tid));""",
     """    if (tid == 0) {
      mine[0] = m;
      fence_proxy_async_smem();
      for (int p = 0; p < n_cl; ++p) {
        if (p != rank)
          bulk_copy_to_peer(cluster_addr(maxima + 4 * rank, p), mine, 16,
                            cluster_addr(max_bar, p));
      }
    }"""),
    ("      if (p != rank) m = fmaxf(m, maxima[p]);", "      if (p != rank) m = fmaxf(m, maxima[4 * p]);"),
    ("""    if (tid < DH)
      store_to_peer(cluster_addr(recv + rank * L::kPart + tid, 0), o, cluster_addr(part_bar, 0));
    if (tid == 0)
      store_to_peer(cluster_addr(recv + rank * L::kPart + DH, 0), den,
                    cluster_addr(part_bar, 0));
    return;""",
     """    if (tid < DH) part[tid] = o;
    if (tid == 0) part[DH] = den;
    fence_proxy_async_smem();
    bar_sync_1(kCaConsumers);
    if (tid == 0)
      bulk_copy_to_peer(cluster_addr(recv + rank * L::kPart, 0), part, 4 * L::kPart,
                        cluster_addr(part_bar, 0));
    cluster_arrive();
    cluster_wait();
    return;"""),
    ("""  mbar_wait(part_bar, 0);
  if (tid < DH) {""", """  mbar_wait(part_bar, 0);
  cluster_arrive();
  if (tid < DH) {"""),
    ("""    out[(int64_t)bh * DH + tid] = __float2bfloat16(o / den);
  }
}""", """    out[(int64_t)bh * DH + tid] = __float2bfloat16(o / den);
  }
  cluster_wait();
}"""),
]

# name -> (diagnostic, [(text of the source, its replacement), ...])
VARIANTS = {
    "shipped": (False, []),
    "stages=3": (False, [_STAGES3]),
    "stages=4": (False, [_STAGES4]),
    "tile=8KB-alone": (False, [_constant("kCaTileAlone", "4096", "8192")]),
    "tile=4KB-clustered": (False, [_constant("kCaTileCluster", "8192", "4096")]),
    "tile=16KB-clustered": (False, [_constant("kCaTileCluster", "8192", "16384")]),
    "consumer-warps=8": (False, [_constant("kCaWarps", "4", "8"),
                                 _constant("kCaMinBlocks", "8", "4")]),
    "registers-unbounded": (False, [_constant("kCaMinBlocks", "8", "1")]),
    "two-chains": (False, [_ODD, _ONE_CHAIN]),
    "cluster-launch-always": (False, [_ATTRS]),
    "bulk-exchange": (False, _BULK_EXCHANGE),
    "i2f-convert": (False, [(_UNPACK, "      out[4 * i + b] = (float)(signed char)"
                                      "((w[i] ^ 0x80808080u) >> (8 * b));")]),
    "no-convert": (True, [(_UNPACK, "      out[4 * i + b] = __uint_as_float(w[i] >> b);")]),
    "copies-alone": (True, [_skip(_K_LOOP), _skip(_V_LOOP)]),
    "empty-launch": (True, [(_START, "  if (true) return;\n" + _START)]),
    "empty-launch+cluster-launch-always": (True, [(_START, "  if (true) return;\n" + _START),
                                                   _ATTRS]),
}
# (label, B, H, S_pad, s_len, Dh): the serving shapes, a tp = 2 shard of the
# TTS mesh (half the batch, half the heads), and one session.
SHAPES = (("tts-1.6b", 64, 16, 640, 625, 128),
          ("tts_202501", 64, 32, 640, 625, 64),
          ("tts-1.6b tp shard", 32, 8, 640, 625, 128),
          ("tts-1.6b B=1", 1, 16, 640, 625, 128),
          ("tts_202501 B=1", 1, 32, 640, 625, 64))
CLUSTERS = (1, 2, 3, 4, 6, 8)  # cluster sizes the shipped build is timed at
COLD_BYTES = 128 * 2**20  # source copies a cold timing cycles through, at least


def variant_source(name: str) -> str:
    """``csrc/ca_attn.cu`` as variant ``name`` has it; every text it replaces
    must occur in the source exactly once."""
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; one of {', '.join(VARIANTS)}")
    src = (_build.CSRC / "ca_attn.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old[:60]!r} is not in the source once")
        src = src.replace(old, new)
    return src


def parse_clusters(text: str) -> list:
    """``--clusters`` as sizes of 1 to 8."""
    sizes = [int(x) for x in text.split(",") if x]
    if not sizes or any(not 1 <= n <= 8 for n in sizes):
        raise ValueError(f"--clusters takes sizes of 1 to 8, got {text!r}")
    return sizes


def clusters(pick: int, sizes, s_len: int) -> list:
    """The pick, then the other ``sizes`` that leave no span but the last
    empty."""
    rest = [n for n in sizes if n != pick and DA.span_rows(s_len, n) * (n - 1) < s_len]
    return [pick, *rest]


def bound_ms(b, h, s_len, dh) -> float:
    return (b * h * s_len * (2 * dh + 8) + 2 * b * h * dh * 2) / MEM_BYTES_PER_S * 1e3


def build(names) -> dict:
    """Build each variant's library, one nvcc each, all started together ->
    ``{name: dsm_ca_decode_attend or the compiler's error}``."""
    root = _build.BUILD_ROOT.parent / "ca_attend_variants"
    procs = {}
    for name in names:
        d = root / name.replace("=", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "ca_attn.cu").write_text(variant_source(name))
        shutil.copy(_build.CSRC / "tma_common.cuh", d)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "ca_attn.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (d, proc) in procs.items():
        out = proc.communicate()[0]
        (d / "build.log").write_text(out)
        if proc.returncode != 0:
            fns[name] = out[-500:]
            continue
        fn = ctypes.CDLL(str(d / "lib.so")).dsm_ca_decode_attend
        fn.argtypes, fn.restype = _build._SIGNATURES["dsm_ca_decode_attend"]
        fns[name] = fn
    return fns


def _inputs(g, b, h, s_pad, dh, device):
    q = (torch.randn(b, h, dh, generator=g, device=device) * 0.5).bfloat16()
    k, v = (torch.randint(-127, 128, (b, h, s_pad, dh), generator=g, device=device,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(b, h, s_pad, generator=g, device=device) * 0.019 + 0.001
              for _ in range(2))
    return q, k, v, ks, vs


def _copies(src: tuple) -> list:
    """Copies of a source (K, V and their scales) that together hold at
    least ``COLD_BYTES``, at least three."""
    each = sum(x.numel() * x.element_size() for x in src)
    return [src] + [tuple(x.clone() for x in src)
                    for _ in range(max(2, -(-COLD_BYTES // each) - 1))]


def run(names, device, sizes=CLUSTERS, parent=None) -> list:
    fns = build(names)
    parent_da = load_decode_attn(parent, alias="dsm_tpu_torch_ca_parent") if parent else None
    sms = DA.card_sms(device.index or 0)
    rows = []
    g = torch.Generator(device=device).manual_seed(0)
    for label, b, h, s_pad, s_len, dh in SHAPES:
        pick = DA.pick_ca_cluster(b * h, s_len, dh, sms)
        q, k, v, ks, vs = _inputs(g, b, h, s_pad, dh, device)
        want = DA.ca_decode_attend_plain(q, k, v, ks, vs, s_len)
        bound = bound_ms(b, h, s_len, dh)

        def record(name, n_cluster, fn, got=None, diagnostic=False, **extra):
            row = {"shape": label, "variant": name, "n_cluster": n_cluster, "pick": pick,
                   "sms": sms, **extra}
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
                row["max_err"] = float((y.float() - want.float()).abs().max())
            rows.append(row)

        for name in names:
            fn = fns[name]
            if isinstance(fn, str):
                rows.append({"shape": label, "variant": name, "error": fn})
                continue
            out = torch.empty((b, h, dh), dtype=torch.bfloat16, device=device)

            def call(n_cluster, src=(k, v, ks, vs), fn=fn, out=out):
                ck, cv, cks, cvs = src
                err = fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), cks.data_ptr(),
                         cvs.data_ptr(), out.data_ptr(), b, h, s_len, dh, q.stride(0),
                         q.stride(1), ck.stride(0), ck.stride(1), cks.stride(0), cks.stride(1),
                         n_cluster, 1.0 / math.sqrt(dh),
                         ctypes.c_void_p(_build.stream_ptr(q.device)))
                if err:
                    raise RuntimeError(f"CUDA error {err}")

            for n_cluster in (clusters(pick, sizes, s_len) if name == "shipped" else [pick]):
                record(name, n_cluster, lambda n=n_cluster: call(n), lambda out=out: out,
                       VARIANTS[name][0])
            if name == "shipped":  # cold: each call on another copy of the source
                copies = _copies((k, v, ks, vs))
                turn = iter(range(10**9))

                def cold():
                    call(pick, copies[next(turn) % len(copies)])

                record(name, pick, cold, cold=True, copies=len(copies))
        if parent_da is not None:
            def parent_call():
                return parent_da.ca_decode_attend(q[:, :, None], k, v, ks, vs, s_len)[:, :, 0]

            record("parent", 1, parent_call, parent_call)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--clusters", default=",".join(map(str, CLUSTERS)),
                    help="cluster sizes the shipped build is timed at (1 to 8)")
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="also time the ca_decode_attend of the checkout unpacked at DIR")
    args = ap.parse_args(argv)
    names = [v for v in args.variants.split(",") if v]
    for name in names:
        variant_source(name)  # raises for an unknown name or a stale replacement
    sizes = parse_clusters(args.clusters)
    if not torch.cuda.is_available():
        print("ca_attend_variants: no CUDA device; nothing was measured", file=sys.stderr)
        return 2
    rows = run(names, torch.device("cuda", 0), sizes, args.parent)
    for row in rows:
        print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 1 if any("error" in row for row in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
