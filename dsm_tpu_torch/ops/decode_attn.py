"""Fused decode attention + ring commit (counterpart of
``dsm_tpu/ops/decode_attn.py:decode_attend_commit``).

``decode_attend_commit`` replaces the Pallas kernel
``dsm_tpu/ops/decode_attn.py:_decode_attend_commit_q_4d``: T=1 decode
attention of bf16 queries over the PRE-commit int8 K/V ring with per-row
f32 scales, with this step's fresh bf16 K/V row joining the softmax
exactly, followed by the write of the fresh int8 row into ring row ``w``.
The kernel is CUDA C++ in ``csrc/ring_attn.cu``; the scale rings are
committed beforehand (``ring_kernels.scale_commit``).

What bounds it on the H100: bytes.  At stt-1b B=64 one call reads the
int8 K and V rings, 2 x 64 x 16 x 768 x 128 B = 201 MB, about 60 us at
3.35 TB/s, so about 1 ms per step over 16 layers; its arithmetic is two
multiply-adds per byte.  What the design does about it: one block per
(b, h) reads each ring row once, as one 128-byte load per warp at Dh=128,
keeps the row scores in shared memory (C floats), and skips the rows the
mask excludes in both passes, so a ring that is not yet full is not read
past its valid rows.  The output is written once, bf16.  No tensor cores:
a query of one row against C rows is a matrix-vector product.

The wrapper runs the plain version for CPU tensors and launches the
kernel for CUDA tensors, counting the launch in ``decode_attend_commit
.launches``.  Shapes it launches for: any B and H, Dh in {64, 128}, bf16
queries and fresh rows, int8 rings, and C up to 11,264 rows (the scores
and partial outputs fit the 48 KB of shared memory a block gets without
an opt-in); anything else raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .attention import NEG_INF

_MAX_SMEM = 48 * 1024  # dynamic shared memory without an opt-in attribute


def decode_attend_commit_plain(q, k_cache, v_cache, k_scale, v_scale, kq_new,
                               vq_new, k_new, v_new, valid, pos: int, w: int,
                               window: int) -> torch.Tensor:
    """Plain PyTorch version (any device) over 3-D rows: ``q, k_new, v_new,
    kq_new, vq_new (B, H, Dh)``, rings ``(B, H, C, Dh)`` int8, scales
    ``(B, H, C)`` f32, ``valid (B, C)`` bool.  Returns ``(B, H, Dh)`` in
    ``q.dtype`` and writes ring row ``w`` in place."""
    c, dh = k_cache.shape[2], k_cache.shape[3]
    scale = 1.0 / math.sqrt(dh)
    j = torch.arange(c, dtype=torch.int64, device=k_cache.device)
    k_pos = pos - torch.remainder(w - j, c)
    ok = (k_pos >= 0) & (pos - k_pos < window) & (j != w)
    ok = ok[None, :] & valid  # (B, C)
    scores = torch.einsum("bhd,bhcd->bhc", q.float(), k_cache.float())
    scores = scores * (k_scale * scale)
    scores = torch.where(ok[:, None, :], scores, NEG_INF)
    s_new = (q.float() * k_new.float()).sum(-1) * scale
    m = torch.maximum(scores.amax(-1), s_new)
    e_c = torch.exp(scores - m[..., None])
    e_n = torch.exp(s_new - m)
    denom = e_c.sum(-1) + e_n
    p_c = (e_c * v_scale).to(torch.bfloat16).float()
    out_c = torch.einsum("bhc,bhcd->bhd", p_c, v_cache.float())
    res = (out_c + e_n[..., None] * v_new.float()) / denom[..., None]
    k_cache[:, :, w] = kq_new
    v_cache[:, :, w] = vq_new
    return res.to(q.dtype)


def _launch(q, k_cache, v_cache, k_scale, v_scale, kq_new, vq_new, k_new,
            v_new, valid, pos: int, w: int, window: int) -> torch.Tensor:
    b, h, c, dh = k_cache.shape
    if dh not in (64, 128):
        raise ValueError(f"decode_attend_commit kernel takes Dh 64 or 128, got {dh}")
    if not 0 <= w < c:
        raise ValueError(f"decode_attend_commit: w={w} outside ring of {c}")
    want = {
        "q": ((b, h, dh), torch.bfloat16), "k_new": ((b, h, dh), torch.bfloat16),
        "v_new": ((b, h, dh), torch.bfloat16), "kq_new": ((b, h, dh), torch.int8),
        "vq_new": ((b, h, dh), torch.int8), "k_cache": ((b, h, c, dh), torch.int8),
        "v_cache": ((b, h, c, dh), torch.int8), "k_scale": ((b, h, c), torch.float32),
        "v_scale": ((b, h, c), torch.float32), "valid": ((b, c), torch.bool),
    }
    args = {"q": q, "k_new": k_new, "v_new": v_new, "kq_new": kq_new,
            "vq_new": vq_new, "k_cache": k_cache, "v_cache": v_cache,
            "k_scale": k_scale, "v_scale": v_scale, "valid": valid}
    for name, x in args.items():
        shape, dtype = want[name]
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"decode_attend_commit: {name} is {tuple(x.shape)} {x.dtype}, "
                f"kernel takes {shape} {dtype}"
            )
        if not x.is_cuda or not x.is_contiguous():
            raise ValueError(f"decode_attend_commit: {name} must be a contiguous CUDA tensor")
    lib = _build.lib()
    if lib.dsm_decode_attend_smem_bytes(c, dh) > _MAX_SMEM:
        raise ValueError(f"decode_attend_commit: ring of {c} rows exceeds shared memory")
    out = torch.empty((b, h, dh), dtype=torch.bfloat16, device=q.device)
    err = lib.dsm_decode_attend_commit(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), kq_new.data_ptr(), vq_new.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), valid.data_ptr(), out.data_ptr(),
        b, h, c, dh, pos, w, window, 1.0 / math.sqrt(dh),
        ctypes.c_void_p(_build.stream_ptr()),
    )
    _build.check(err, "decode_attend_commit")
    decode_attend_commit.launches += 1
    return out


def decode_attend_commit(q, k_cache, v_cache, ks_committed, vs_committed,
                         kq_new, vq_new, k_new, v_new, plan, valid_old, *,
                         window: int):
    """Attend ``q (B, H, 1, Dh)`` over the pre-commit int8 ring and this
    step's fresh row, then commit the quantised fresh row ``kq_new/vq_new
    (B, H, 1, Dh)`` into ring row ``plan["w"][0]`` in place.  The scale
    rings must already hold this step's scales.  Returns
    ``(y (B, H, 1, Dh), k_cache, v_cache)``, the rings being the inputs,
    updated."""
    if q.shape[2] != 1:
        raise ValueError("decode_attend_commit takes T=1 steps")
    pos, w = int(plan["q_pos"][0]), int(plan["w"][0])
    rows = [x[:, :, 0, :].contiguous() for x in (q, kq_new, vq_new, k_new, v_new)]
    q3, kq3, vq3, kn3, vn3 = rows
    if k_cache.device.type == "cpu":
        y = decode_attend_commit_plain(
            q3, k_cache, v_cache, ks_committed, vs_committed, kq3, vq3, kn3,
            vn3, valid_old, pos, w, window)
    else:
        y = _launch(q3, k_cache, v_cache, ks_committed, vs_committed, kq3, vq3,
                    kn3, vn3, valid_old, pos, w, window)
    return y[:, :, None, :], k_cache, v_cache


decode_attend_commit.launches = 0
