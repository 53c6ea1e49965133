"""In-place KV ring commits (counterpart of ``dsm_tpu/ops/ring_kernels.py``).

Two kernels, CUDA C++ in ``csrc/ring_attn.cu``:

``ring_commit`` replaces ``dsm_tpu/ops/ring_kernels.py:_ring_commit``: it
writes T new K/V rows ``(B, H, T, Dh)`` into the bf16 or f32 rings
``(B, H, C, Dh)`` at row ``w``.  On the serving path it appends the Mimi
codec transformer's 2 rows per step, ``(64, 8, 2, 64)`` into
``(64, 8, 256, 64)`` bf16 at B=64: 2 x 131 KB copied.
``scale_commit`` replaces ``_scale_commit``: it writes T fresh per-row KV
scales ``(B, H, T)`` f32 into the scale rings ``(B, H, C)``; at stt-1b B=64
that is 2 x 4 KB, once per LM layer.

What bounds them on the H100: a few hundred KB moved at most, so each is
bound by its launch and the latency of one round of stores, not by
bandwidth.  The design does nothing clever about it: one thread per
element copied, offsets computed from ``w`` and the shape, K and V in one
launch (``blockIdx.y``), no synchronisation.  The TPU kernel streamed the
aligned row block through VMEM to avoid partial-tile DMAs; a GPU store of
one element needs no such block.

Contract, as in the JAX package: ``w % T == 0`` and ``w + T <= C`` (the
ring capacity is a multiple of T, so a fixed-cadence append never wraps);
anything else raises.  The rings are updated in place, where the JAX
package aliases its outputs to its inputs.

Each wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors, counting the launch in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention import ring_write_global


def _check_rows(w: int, t: int, c: int) -> None:
    if t < 1 or w < 0 or w % t or w + t > c:
        raise ValueError(
            f"ring commit needs w % T == 0 and w + T <= C, got w={w} T={t} C={c}"
        )


def _check_cuda(name: str, tensors: dict) -> None:
    for label, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{name}: {label} is on {x.device}, not CUDA")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous")


# ---------------------------------------------------------------------------
# ring_commit
# ---------------------------------------------------------------------------


def ring_commit_plain(k_cache, v_cache, k_new, v_new, w: int) -> None:
    """Plain PyTorch version of :func:`ring_commit` (any device)."""
    _check_rows(w, k_new.shape[2], k_cache.shape[2])
    ring_write_global(k_cache, v_cache, k_new, v_new, w)


def ring_commit(k_cache: torch.Tensor, v_cache: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor, w: int) -> None:
    """Write ``k_new/v_new (B, H, T, Dh)`` into the rings ``(B, H, C, Dh)``
    at row ``w``, in place."""
    b, h, t, dh = k_new.shape
    c = k_cache.shape[2]
    _check_rows(w, t, c)
    if k_cache.device.type == "cpu":
        ring_commit_plain(k_cache, v_cache, k_new, v_new, w)
        return
    if k_cache.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ring_commit takes bf16 or f32 rings, got {k_cache.dtype}")
    if v_cache.dtype != k_cache.dtype or v_cache.shape != k_cache.shape:
        raise ValueError("ring_commit: K and V rings differ in dtype or shape")
    if k_cache.shape != (b, h, c, dh) or v_new.shape != k_new.shape:
        raise ValueError(
            f"ring_commit: rows {tuple(k_new.shape)} do not fit ring "
            f"{tuple(k_cache.shape)}"
        )
    k_new = k_new.to(k_cache.dtype).contiguous()
    v_new = v_new.to(k_cache.dtype).contiguous()
    _check_cuda("ring_commit", {"k_cache": k_cache, "v_cache": v_cache,
                                "k_new": k_new, "v_new": v_new})
    err = _build.lib().dsm_ring_commit(
        k_cache.data_ptr(), v_cache.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), k_cache.element_size(), b, h, t, c, dh, w,
        ctypes.c_void_p(_build.stream_ptr()),
    )
    _build.check(err, "ring_commit")
    ring_commit.launches += 1


ring_commit.launches = 0


# ---------------------------------------------------------------------------
# scale_commit
# ---------------------------------------------------------------------------


def scale_commit_plain(ks_cache, vs_cache, ks_new, vs_new, w: int) -> None:
    """Plain PyTorch version of :func:`scale_commit` (any device)."""
    t = ks_new.shape[2]
    _check_rows(w, t, ks_cache.shape[2])
    ks_cache[:, :, w:w + t] = ks_new.to(ks_cache.dtype)
    vs_cache[:, :, w:w + t] = vs_new.to(vs_cache.dtype)


def scale_commit(ks_cache: torch.Tensor, vs_cache: torch.Tensor,
                 ks_new: torch.Tensor, vs_new: torch.Tensor, w: int) -> None:
    """Write the fresh per-row scales ``(B, H, T)`` into the f32 scale
    rings ``(B, H, C)`` at row ``w``, in place."""
    b, h, t = ks_new.shape
    c = ks_cache.shape[2]
    _check_rows(w, t, c)
    if ks_cache.device.type == "cpu":
        scale_commit_plain(ks_cache, vs_cache, ks_new, vs_new, w)
        return
    if ks_cache.dtype != torch.float32 or vs_cache.dtype != torch.float32:
        raise ValueError("scale_commit takes f32 scale rings")
    if (ks_cache.shape != (b, h, c) or vs_cache.shape != ks_cache.shape
            or vs_new.shape != ks_new.shape):
        raise ValueError(
            f"scale_commit: rows {tuple(ks_new.shape)} do not fit ring "
            f"{tuple(ks_cache.shape)}"
        )
    ks_new = ks_new.float().contiguous()
    vs_new = vs_new.float().contiguous()
    _check_cuda("scale_commit", {"ks_cache": ks_cache, "vs_cache": vs_cache,
                                 "ks_new": ks_new, "vs_new": vs_new})
    err = _build.lib().dsm_scale_commit(
        ks_cache.data_ptr(), vs_cache.data_ptr(), ks_new.data_ptr(),
        vs_new.data_ptr(), b, h, t, c, w, ctypes.c_void_p(_build.stream_ptr()),
    )
    _build.check(err, "scale_commit")
    scale_commit.launches += 1


scale_commit.launches = 0
