"""Build and load the port's CUDA kernels (``dsm_tpu_torch/csrc``).

The sources are compiled with ``nvcc`` at first use, one process per
``.cu`` file, all started together (a single ``nvcc`` call compiles its
files one after another), into a scratch directory beside the library;
the objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``, and the scratch directory is removed.  The library
lands in ``build/dsm_tpu_torch/<hash>/`` at the root of the checkout
(listed in ``.gitignore``), keyed by a hash of the sources and flags, so a
changed source builds anew and an unchanged one is built once.

Nothing here runs when the module is imported: CPU-only machines import
every module of the port and never build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dsm_tpu_torch"
LIB_NAME = "libdsm_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "dsm_error_string": ([_I], ctypes.c_char_p),
    # The ring and attention kernels take ``pos``, a device pointer to the
    # step's int32 tick (they derive w = pos % C), never a host value.
    # k_cache, v_cache, k_new, v_new, elem_bytes, b, h, t, c, dh, pos, stream
    "dsm_ring_commit": ([_P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _P, _P], _I),
    # gk, gv, gk_old, gv_old, gk_new, gv_new, elem_bytes, b, h, t, c, dh, pos, stream
    "dsm_ring_commit_backward": ([_P] * 6 + [_I, _LL, _I, _I, _I, _I, _P, _P], _I),
    # k_cache, v_cache, ks_cache, vs_cache, k_new, v_new, ks_new, vs_new,
    # b, h, t, c, dh, pos, stream
    "dsm_ring_commit_q": ([_P] * 8 + [_LL, _I, _I, _I, _I, _P, _P], _I),
    # ks_cache, vs_cache, ks_new, vs_new, b, h, t, c, pos, stream
    "dsm_scale_commit": ([_P, _P, _P, _P, _LL, _I, _I, _I, _P, _P], _I),
    # k, v, k strides (b, h), v strides (b, h), kq, vq, q_pane, q_row, ks, vs,
    # b, h, c, dh, packed4, pos, stream
    "dsm_quantize_commit": (
        [_P, _P] + [_LL] * 4 + [_P, _P, _LL, _LL, _P, _P, _LL, _I, _I, _I, _I, _P, _P], _I
    ),
    # q, k, v, their (b, h, t) strides, cos, sin, cos batch stride, q_out,
    # k_out, k_cache, v_cache, b, h, t, dh, c, pos, x_bytes, r_bytes, stream
    "dsm_rope_commit": (
        [_P] * 3 + [_LL] * 9 + [_P, _P, _LL] + [_P] * 4 + [_LL] + [_I] * 4 + [_P, _I, _I, _P],
        _I
    ),
    "dsm_decode_attend_commit_smem_bytes": ([_I, _I], _LL),
    # q, k_cache, v_cache, k_scale, v_scale, kq_new, vq_new, k_new, v_new,
    # valid, part, out, b, h, c, dh, n_split, pos, window, scale, stream
    "dsm_decode_attend_commit": (
        [_P] * 12 + [_LL, _I, _I, _I, _I, _P, _I, ctypes.c_float, _P], _I
    ),
    # span rows, dh, packed4
    "dsm_decode_attend_smem_bytes": ([_I, _I, _I], _LL),
    # dh, packed4
    "dsm_decode_attend_tile_rows": ([_I, _I], _I),
    # q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, valid, part, out,
    # b, h, c, dh, packed4, n_split, k/v strides (b, h) in bytes, scale
    # strides (b, h), pos, window, scale, stream
    "dsm_decode_attend": (
        [_P] * 10 + [_LL, _I, _I, _I, _I, _I] + [_LL] * 4 + [_P, _I, ctypes.c_float, _P], _I
    ),
    # span rows, dh, n_cluster
    "dsm_ca_decode_attend_smem_bytes": ([_I, _I, _I], _LL),
    # q, k_src, v_src, k_scale, v_scale, out, b, h, s_len, dh, q strides
    # (b, h), k/v strides (b, h), scale strides (b, h), n_cluster, scale, stream
    "dsm_ca_decode_attend": (
        [_P] * 6 + [_LL, _I, _I, _I] + [_LL] * 6 + [_I, ctypes.c_float, _P], _I
    ),
    "dsm_attn_tune_smem_bytes": ([_I, _I], _LL),
    # q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, valid, out, b, h,
    # c, dh, bb, i8s, i8p, pos, window, scale, stream
    "dsm_attn_tune": (
        [_P] * 9 + [_LL, _I, _I, _I, _I, _I, _I, _LL, _I, ctypes.c_float, _P], _I
    ),
    # x, wq, s, out, m, o, i, weight row stride, ksplit, stream
    "dsm_qmm": ([_P] * 4 + [_LL, _I, _I, _LL, _I, _P], _I),
    # m, o, ksplit
    "dsm_qmm_max_clusters": ([_LL, _I, _I], _I),
}


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels build only where the CUDA "
        "toolkit is installed"
    )


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the kernels if this hash has no library yet; return its path.

    The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills of each kernel) is kept beside the library as ``build.log``."""
    lib = lib_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=lib.parent) as objdir:
        procs = []
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = os.path.join(objdir, f"{src.stem}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out = proc.communicate()[0]
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{src.name} (code {proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = os.path.join(objdir, LIB_NAME)
        res = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *(o for _, o, _ in procs)],
                             capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed with code {res.returncode}:\n{res.stdout}{res.stderr}"
            )
        (lib.parent / "build.log").write_text("".join(log) + res.stdout + res.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return lib


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    handle = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return handle


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib().dsm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    """The current stream of ``device`` (a ``torch.device`` or index): the
    stream a kernel on that device's tensors goes to, whichever device is
    current."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def launch(fn, device, *args) -> int:
    """Call the library's launch function ``fn`` with ``args`` and the
    current stream of ``device`` last, with ``device`` current (the card the
    kernel runs on; switched to only when another is current) -> its CUDA
    error code.  Every wrapper launches through here with its tensors'
    device."""
    import torch

    stream = ctypes.c_void_p(stream_ptr(device))
    if device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)
