"""Build and load the port's CUDA kernels (``dsm_tpu_torch/csrc``).

The sources are compiled with ``nvcc`` into one shared library with a
plain C interface, at first use, and loaded with ``ctypes``.  The library
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
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dsm_tpu_torch"
LIB_NAME = "libdsm_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "dsm_error_string": ([_I], ctypes.c_char_p),
    # k_cache, v_cache, k_new, v_new, elem_bytes, b, h, t, c, dh, w, stream
    "dsm_ring_commit": ([_P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _P], _I),
    # ks_cache, vs_cache, ks_new, vs_new, b, h, t, c, w, stream
    "dsm_scale_commit": ([_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P], _I),
    "dsm_decode_attend_smem_bytes": ([_I, _I], _LL),
    # q, k_cache, v_cache, k_scale, v_scale, kq_new, vq_new, k_new, v_new,
    # valid, out, b, h, c, dh, pos, w, window, scale, stream
    "dsm_decode_attend_commit": (
        [_P] * 11 + [_LL, _I, _I, _I, _LL, _I, _I, ctypes.c_float, _P], _I
    ),
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
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(p) for p in sources()
                                                    if p.suffix == ".cu"]]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {res.returncode}:\n{res.stdout}{res.stderr}"
        )
    (lib.parent / "build.log").write_text(res.stdout + res.stderr)
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


def stream_ptr() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
