"""ctypes bindings of the native frame packer (counterpart of
``dsm_tpu/server/native.py``).

The source is the port's own copy, ``dsm_tpu_torch/csrc/packer.cpp``.  It is
built at first use with ``g++ -O3 -shared -fPIC -std=c++17`` into
``build/dsm_tpu_torch/<hash>/libdsm_packer.so`` at the root of the checkout,
keyed by a hash of the source and the flags as ``ops/_build.py`` keys the
kernels, so a changed source builds anew and an unchanged one is built once.
Nothing is built when the module is imported.  Where no compiler builds it,
:func:`load_lib` returns None and the engines keep their Python mailboxes.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops._build import BUILD_ROOT

log = logging.getLogger("dsm.torch.native")

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "packer.cpp"
LIB_NAME = "libdsm_packer.so"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the packer if this hash has no library yet -> its path; raises
    if there is no compiler or the compile fails."""
    lib = lib_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on the PATH")
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmpdir:
        tmp = os.path.join(tmpdir, LIB_NAME)
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed with code {res.returncode}:\n{res.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return lib


def load_lib() -> Optional[ctypes.CDLL]:
    """The loaded packer library, built first if needed; None where it does
    not build (the failure is logged once)."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except Exception as e:  # no compiler, or it refused the source
            log.warning("native packer build failed: %s", e)
            _failed = True
            return None
        lib.packer_create.restype = ctypes.c_void_p
        lib.packer_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.packer_destroy.argtypes = [ctypes.c_void_p]
        lib.packer_reset_slot.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.packer_push.restype = ctypes.c_int64
        lib.packer_push.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.packer_available.restype = ctypes.c_int64
        lib.packer_available.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.packer_pack.restype = ctypes.c_int
        lib.packer_pack.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return lib


class FramePacker:
    """Per-slot SPSC pcm rings and single-pass batch packing, GIL-free: one
    producer a slot (its connection) and one consumer (the engine's tick).
    ``frames`` is the ``(batch, frame)`` array that :meth:`pack` fills."""

    def __init__(self, batch: int, frame: int, capacity_frames: int = 64):
        lib = load_lib()
        if lib is None:
            raise RuntimeError("native packer unavailable")
        self._lib = lib
        self._h = lib.packer_create(batch, frame, capacity_frames)
        self.batch = batch
        self.frame = frame
        self.frames = np.zeros((batch, frame), np.float32)
        self._mask = np.zeros(batch, np.uint8)
        self._active = np.zeros(batch, np.uint8)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.packer_destroy(self._h)
            self._h = None

    def reset_slot(self, slot: int) -> None:
        self._lib.packer_reset_slot(self._h, slot)

    def push(self, slot: int, pcm: np.ndarray) -> int:
        """Samples accepted: fewer than given once the slot's ring is full."""
        pcm = np.ascontiguousarray(pcm, np.float32)
        return self._lib.packer_push(
            self._h, slot, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pcm))

    def available(self, slot: int) -> int:
        return self._lib.packer_available(self._h, slot)

    def pack(self, active: np.ndarray):
        """active (B,) bool -> (frames (B, frame) f32, mask (B,) bool, n): a
        frame from each active slot that holds one, zeros elsewhere."""
        self._active[:] = active
        n = self._lib.packer_pack(
            self._h,
            self._active.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.frames.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return self.frames, self._mask.astype(bool), n
