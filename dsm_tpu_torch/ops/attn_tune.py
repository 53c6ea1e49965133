"""Variants of the decode attention for the tuning tool (counterpart of
``tools/attn_kernel_tune.py:build_4d``).

``attn_tune`` replaces the Pallas kernel ``build_4d.call``: T=1 attention of
bf16 queries over the COMMITTED 4-D int8 ring with per-row f32 scales, the
fresh bf16 row joining the softmax exactly, in three variations of the
shipped kernel's arithmetic:

  ``bb``   batch rows one block works through (numerics identical for
           every ``bb``);
  ``i8s``  q quantised per (b, h) row, the scores as s8 x s8 -> s32 products;
  ``i8p``  ``exp * v_scale`` quantised per row of scores, the V dot in s32.

The kernel is CUDA C++ in ``csrc/attn_tune.cu``; what bounds it and what the
variants probe is written there.  It keeps one span per (b, h): ``i8p``'s
scale is the maximum over the whole ring row, so kernel and plain version
share one definition (a split ring would make the scale span-local).  The
tool's ``base`` is ``decode_attn.decode_attend`` itself.

The wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors, counting the launch in ``attn_tune.launches``.  Shapes it
launches for: any B that ``bb`` divides, any H, Dh in {64, 128}, contiguous
int8 rings ``(B, H, C, Dh)`` of up to 11,264 rows; anything else raises.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .attention import mul_recip, no_backward

_MAX_SMEM = 48 * 1024  # dynamic shared memory without an opt-in attribute
# How far the int8-dot variants may lie from the bf16 variant, as a share of
# its largest output: q (and p) are rounded to 1/127 of their row's maximum.
I8_FROM_BF16 = 5e-2


def _quantize_rows(x: torch.Tensor, floor: float):
    """Per-row symmetric int8: ``(round(x / s) clipped to +-127, s)`` with
    ``s = max(max|x| * fl(1/127), floor)`` over the last dim, kept: the jitted
    tool's division by 127.0."""
    s = torch.clamp(mul_recip(x.abs().amax(dim=-1, keepdim=True), 127.0), min=floor)
    return torch.clamp(torch.round(x / s), -127, 127), s


def attn_tune_plain(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, valid,
                    pos: int, window: int, bb: int = 1, i8s: bool = False,
                    i8p: bool = False) -> torch.Tensor:
    """Plain PyTorch version (any device), in the kernel's order: ``q, k_new,
    v_new (B, H, Dh)``, rings ``(B, H, C, Dh)`` int8, scales ``(B, H, C)``
    f32, ``valid (B, C)`` bool -> ``(B, H, Dh)`` in ``q.dtype``.  The integer
    dots are taken in f32 on exact integers (their sums stay below 2**24)."""
    b, _, c, dh = k_cache.shape
    if bb < 1 or b % bb:
        raise ValueError(f"attn_tune: bb={bb} does not divide the batch of {b}")
    scale = 1.0 / math.sqrt(dh)
    w = pos % c
    j = torch.arange(c, dtype=torch.int64, device=k_cache.device)
    dist = torch.remainder(w - j, c)
    ok = (dist != 0) & (dist <= pos) & (dist < window)
    ok = (ok[None, :] & valid)[:, None, :]  # (B, 1, C)
    qf = q.float()
    if i8s:
        qq, qs = _quantize_rows(qf, 1e-8)
        acc = torch.einsum("bhd,bhcd->bhc", qq, k_cache.float())
        scores = acc * (k_scale * (qs * scale))
    else:
        scores = torch.einsum("bhd,bhcd->bhc", qf, k_cache.float()) * (k_scale * scale)
    scores = torch.where(ok, scores, float("-inf"))
    s_new = (qf * k_new.float()).sum(-1) * scale
    m = torch.maximum(scores.amax(-1), s_new)
    e = torch.exp(scores - m[..., None])  # 0 at masked rows
    e_new = torch.exp(s_new - m)
    denom = e.sum(-1) + e_new
    pv = torch.where(e > 0, e * v_scale, 0.0)
    if i8p:
        pq, pa = _quantize_rows(pv, 1e-12)
        out = torch.einsum("bhc,bhcd->bhd", pq, v_cache.float()) * pa
    else:
        out = torch.einsum("bhc,bhcd->bhd", pv.to(torch.bfloat16).float(), v_cache.float())
    out = (out + e_new[..., None] * v_new.float()) / denom[..., None]
    return out.to(q.dtype)


def _launch(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, valid, pos: int,
            window: int, bb: int, i8s: bool, i8p: bool) -> torch.Tensor:
    b, h, c, dh = k_cache.shape
    if dh not in (64, 128):
        raise ValueError(f"attn_tune kernel takes Dh 64 or 128, got {dh}")
    if bb < 1 or b % bb:
        raise ValueError(f"attn_tune: bb={bb} does not divide the batch of {b}")
    if pos < 0:
        raise ValueError(f"attn_tune: pos={pos}")
    want = {
        "q": ((b, h, dh), torch.bfloat16), "k_new": ((b, h, dh), torch.bfloat16),
        "v_new": ((b, h, dh), torch.bfloat16), "k_cache": ((b, h, c, dh), torch.int8),
        "v_cache": ((b, h, c, dh), torch.int8), "k_scale": ((b, h, c), torch.float32),
        "v_scale": ((b, h, c), torch.float32), "valid": ((b, c), torch.bool),
    }
    args = {"q": q, "k_new": k_new, "v_new": v_new, "k_cache": k_cache,
            "v_cache": v_cache, "k_scale": k_scale, "v_scale": v_scale, "valid": valid}
    for name, x in args.items():
        shape, dtype = want[name]
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"attn_tune: {name} is {tuple(x.shape)} {x.dtype}, "
                             f"kernel takes {shape} {dtype}")
        if not x.is_cuda or not x.is_contiguous():
            raise ValueError(f"attn_tune: {name} must be a contiguous CUDA tensor")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("attn_tune: ring rows must be 16-byte aligned")
    lib = _build.lib()
    if lib.dsm_attn_tune_smem_bytes(c, dh) > _MAX_SMEM:
        raise ValueError(f"attn_tune: ring of {c} rows exceeds shared memory")
    out = torch.empty((b, h, dh), dtype=torch.bfloat16, device=q.device)
    err = _build.launch(lib.dsm_attn_tune, q.device,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), valid.data_ptr(),
        out.data_ptr(), b, h, c, dh, bb, int(i8s), int(i8p), pos, window,
        1.0 / math.sqrt(dh),
    )
    _build.check(err, "attn_tune")
    attn_tune.launches += 1
    return out


def attn_tune(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, valid, pos: int,
              window: int, bb: int = 1, i8s: bool = False, i8p: bool = False
              ) -> torch.Tensor:
    """One variant of the decode attention over the committed int8 ring at
    tick ``pos`` (ring row ``pos % C`` is this step's, masked): ``q, k_new,
    v_new (B, H, Dh)`` -> ``(B, H, Dh)``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (counted in
    ``attn_tune.launches``) or raise."""
    no_backward("attn_tune", q, k_scale, v_scale, k_new, v_new)
    fn = attn_tune_plain if k_cache.device.type == "cpu" else _launch
    return fn(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, valid, int(pos),
              int(window), int(bb), bool(i8s), bool(i8p))


attn_tune.launches = 0
