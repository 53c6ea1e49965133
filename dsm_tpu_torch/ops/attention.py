"""Streaming attention over fixed ring-buffer KV caches (counterpart of
``dsm_tpu/ops/attention.py``).

One ring per layer, ``(B, H, C, Dh)``, shared write index for every slot:

  write index   w      = pos % C
  key position  k_pos[j] = p_last - ((w_last - j) mod C)
  validity      k_pos >= 0, k_pos <= q_pos, q_pos - k_pos < window,
                and the slot's bit in the ``(B, C)`` validity bitmap

``pos`` is a 0-d int32 tensor on the rings' device, as in the JAX package:
the plan's write rows and query positions are device tensors, and the
kernels read the position from device memory (the Pallas kernels'
scalar-prefetched ``w``), so a step reads nothing back to the host and can
be captured in a CUDA graph.  Rings are updated in place (the JAX package
gets the same effect from buffer donation and aliasing).

The attention functions compute dot products in f32.  A bf16 x bf16 or
bf16 x int8 product is exact in f32, so this equals JAX's bf16 dots with
``preferred_element_type=f32`` up to the order of the sums.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# Rotary embeddings (interleaved pairs)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _libm():
    """The C library's ``cosf`` and ``sinf``, which XLA's CPU code calls."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("cosf", "sinf"):
        getattr(lib, name).argtypes = [ctypes.c_float]
        getattr(lib, name).restype = ctypes.c_float
    return lib


def _libm_map(name: str, x: torch.Tensor) -> torch.Tensor:
    fn = getattr(_libm(), name)
    return torch.tensor([fn(v) for v in x.reshape(-1).tolist()],
                        dtype=torch.float32).reshape(x.shape)


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, max_period: float, device: torch.device) -> torch.Tensor:
    """The rope's frequencies ``(Dh/2,)`` f32, made once per shape and device:
    the constant XLA folds, ``1 / max_period ** e`` in f64 on the f32
    exponents ``e = 2i / Dh``, rounded once to f32 (f32 ``pow`` differs from
    it in about a third of the frequencies)."""
    with torch.inference_mode(False):  # a plain tensor, usable in and out of inference mode
        e = 2.0 * torch.arange(head_dim // 2, dtype=torch.float32) / head_dim
        return (1.0 / torch.pow(float(max_period), e.double())).float().to(device)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, max_period: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (B, T) int -> cos, sin (B, T, Dh/2) f32.

    Rounded as the jitted JAX step computes them: the frequencies of
    :func:`_inv_freq`; on the CPU, cos and sin are the C library's ``cosf``
    and ``sinf``, which XLA calls there (PyTorch's own vectorised ones differ
    from them in the last bit for some 3 % of angles; a step takes ``T *
    Dh/2`` of each).  On the card they are PyTorch's."""
    inv_freq = _inv_freq(head_dim, float(max_period), positions.device)
    angles = positions.float()[..., None] * inv_freq
    if angles.device.type == "cpu":
        return _libm_map("cosf", angles), _libm_map("sinf", angles)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, T, Dh) with interleaved rotary pairs (x0,x1),(x2,x3),...

    Rounded as the jitted JAX step contracts it: ``o1 = fma(x1, c, -(x2*s))``
    and ``o2 = fma(x1, s, x2*c)``, the second product rounded to f32, the
    first fused.  Here the first product is taken in f64, where the product
    of a bf16 or f32 value and an f32 value is exact (at most 48 bits), the
    sum is taken in f64 and rounded once to f32.  That sum is the fused one
    unless the rounded term is finer than 2**-29 of the product, where the
    exact sum needs more than 53 bits and could round twice."""
    b, h, t, d = x.shape
    xf = x.float().reshape(b, h, t, d // 2, 2)
    x1, x2 = xf[..., 0].double(), xf[..., 1]
    c = cos[:, None, :, :]
    s = sin[:, None, :, :]
    o1 = (x1 * c.double() - (x2 * s).double()).float()
    o2 = (x1 * s.double() + (x2 * c).double()).float()
    return torch.stack([o1, o2], dim=-1).reshape(b, h, t, d).to(x.dtype)


# ---------------------------------------------------------------------------
# Global ring plan, writes and validity
# ---------------------------------------------------------------------------


def global_ring_plan(pos, context: int, t_new: int, device=None) -> dict:
    """Plan for appending ``t_new`` frames at the shared tick ``pos``.

    ``pos``: a 0-d integer tensor (the step's, on the rings' device) or, for
    a caller that holds one, an int made into an int32 tensor on ``device``.
    Returns ``pos`` (0-d int32), ``w`` and ``q_pos (T,)``, ``k_pos (C,)``
    and ``new_pos = pos + T``, int32 tensors on ``pos``'s device, as the JAX
    function's; nothing is read back to the host."""
    if isinstance(pos, torch.Tensor):
        pos = pos.to(torch.int32)
    else:
        pos = torch.tensor(pos, dtype=torch.int32, device=device)
    t_idx = torch.arange(t_new, dtype=torch.int32, device=pos.device)
    w = (pos + t_idx) % context
    q_pos = pos + t_idx
    p_last = pos + (t_new - 1)
    j = torch.arange(context, dtype=torch.int32, device=pos.device)
    k_pos = p_last - torch.remainder(p_last % context - j, context)
    return {"pos": pos, "w": w, "q_pos": q_pos, "k_pos": k_pos, "new_pos": pos + t_new}


def check_tick(name: str, pos, device: torch.device) -> None:
    """A kernel wrapper's position: the step's 0-d int32 tensor on the rings'
    ``device``, never a host int (a kernel reads it from device memory)."""
    if not (isinstance(pos, torch.Tensor) and pos.dim() == 0 and pos.dtype == torch.int32):
        raise ValueError(f"{name} takes the position as a 0-d int32 tensor on the rings' "
                         f"device, got {pos!r}")
    if pos.device != device:
        raise ValueError(f"{name}: the position is on {pos.device}, the rings on {device}")


def no_backward(name: str, *tensors) -> None:
    """Raise where ``name``, a kernel with no backward, is reached under
    autograd: grad mode on and an input that requires a gradient.  Its
    result would carry no gradient, or a wrong one, without a word."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in tensors):
        raise RuntimeError(f"{name} has no backward: call it without autograd "
                           f"(torch.no_grad or torch.inference_mode)")


def ring_rows(pos, c: int, t: int, device) -> torch.Tensor:
    """The ring rows ``(T,)`` int64 on ``device`` that an append of ``t``
    rows at the shared tick ``pos`` writes: ``pos % c + 0 .. t-1``.  ``pos``
    a 0-d tensor on ``device`` (read there, not on the host) or an int (no
    host-to-device copy either)."""
    if isinstance(pos, torch.Tensor):
        return (pos.to(torch.int64) % c) + torch.arange(t, dtype=torch.int64, device=device)
    w = int(pos) % c
    return torch.arange(w, w + t, dtype=torch.int64, device=device)


def ring_write_global(k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor, pos) -> None:
    """Write ``T`` new rows ``(B, H, T, Dh)`` into the rings at row ``pos %
    C`` (``pos`` a 0-d tensor or an int), in place, by an index copy: no host
    read.  ``init_state`` makes the capacity a multiple of T, so a
    fixed-cadence append lands at ``w % T == 0`` and never wraps."""
    rows = ring_rows(pos, k_cache.shape[2], k_new.shape[2], k_cache.device)
    k_cache.index_copy_(2, rows, k_new.to(k_cache.dtype))
    v_cache.index_copy_(2, rows, v_new.to(v_cache.dtype))


def update_valid_bitmap(valid: torch.Tensor, w: torch.Tensor,
                        mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Copy of ``valid (B, C)`` with the rows ``w (T,)`` (the plan's, a
    device tensor) written this step set to the slot's mask (False for
    inactive slots: their rows hold garbage), by one index copy."""
    b = valid.shape[0]
    m = mask if mask is not None else torch.ones(b, dtype=torch.bool, device=valid.device)
    return valid.index_copy(1, w.to(torch.int64), m[:, None].expand(b, w.shape[0]))


@functools.lru_cache(maxsize=None)
def _constant(value: float, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):  # a plain tensor, usable in and out of inference mode
        return torch.full((), value, dtype=torch.float32, device=device)


def div_ieee(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` rounded as IEEE division, on every device, as numpy
    divides (``quantize_weights``).  ATen multiplies a CUDA tensor divided
    by a Python number by the f32 reciprocal (``div_true_kernel_cuda``); a
    0-dim tensor on the device divides.  The divisor is made once per value
    and device, so the division costs no launch more."""
    return x / _constant(float(value), x.device)


def mul_recip(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` as the jitted JAX step computes a division by a
    constant: XLA folds it into ``x * fl(1/value)``, the f32 reciprocal of
    the f32 constant, on every device.  A true division differs in about one
    value in twenty; the reciprocal is made once per value and device."""
    recip = torch.ones((), dtype=torch.float32) / torch.tensor(value, dtype=torch.float32)
    return x * _constant(float(recip), x.device)


def quantize_kv_rows(k_new: torch.Tensor, v_new: torch.Tensor):
    """Per-row symmetric int8 quantisation of fresh K/V rows.

    Returns ``(kq, vq int8, ks, vs (B, H, T) f32)``; bit-exact with the JAX
    version under ``jax.jit`` (the scale times fl(1/127), the values a true
    division by it, both rounded half to even)."""

    def one(x):
        xf = x.float()
        amax = xf.abs().amax(dim=-1)
        scale = mul_recip(torch.clamp(amax, min=1e-8), 127.0)
        q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
        return q.to(torch.int8), scale

    kq, ks = one(k_new)
    vq, vs = one(v_new)
    return kq, vq, ks, vs


def pack4(q: torch.Tensor) -> torch.Tensor:
    """int4 values in [-7, 7] (last dim even) -> uint8 nibbles, excess-8
    (stored = q + 8).  The layout is DEINTERLEAVED: byte ``d`` holds dims
    ``(d, d + Dh/2)``, the low nibble the first half of the feature dim."""
    d = q.shape[-1]
    u = q.to(torch.int32) + 8
    return (u[..., : d // 2] | (u[..., d // 2:] << 4)).to(torch.uint8)


def unpack4(p: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack4`: uint8 nibbles -> values, ``[low nibbles,
    high nibbles]`` along the last dim."""
    pi = p.to(torch.int32)
    return torch.cat([(pi & 15) - 8, (pi >> 4) - 8], dim=-1).to(dtype)


def quantize_kv_rows_packed4(k_new: torch.Tensor, v_new: torch.Tensor):
    """Per-row symmetric int4 quantisation of fresh K/V rows, nibble-packed
    (:func:`pack4`): ``(kq, vq (B, H, T, Dh/2) uint8, ks, vs (B, H, T) f32)``,
    half the int8 ring's bytes.  Bit-exact with the JAX version under
    ``jax.jit`` (the scale times fl(1/7), the values a true f32 division by
    it, both rounded half to even)."""

    def one(x):
        xf = x.float()
        scale = mul_recip(torch.clamp(xf.abs().amax(dim=-1), min=1e-8), 7.0)
        q = torch.clamp(torch.round(xf / scale[..., None]), -7, 7)
        return pack4(q), scale

    kq, ks = one(k_new)
    vq, vs = one(v_new)
    return kq, vq, ks, vs


# ---------------------------------------------------------------------------
# Split attention: old ring + this step's fresh rows
# ---------------------------------------------------------------------------


def _ring_ok(plan: dict, valid_old: torch.Tensor, window: int) -> torch.Tensor:
    """(B, T, C) mask of ring rows each query may attend, from the plan's
    device tensors: the rows written this step are stale for every query."""
    k_pos = plan["k_pos"][None, :]
    q_pos = plan["q_pos"][:, None]
    j = torch.arange(k_pos.shape[1], dtype=torch.int32, device=k_pos.device)
    stale = (j[None, :] == plan["w"][:, None]).any(0)
    ok = (k_pos >= 0) & (k_pos <= q_pos) & (q_pos - k_pos < window) & ~stale[None, :]
    return ok[None] & valid_old[:, None, :]


def _fresh_scores(q, k_new, scale):
    t = q.shape[2]
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k_new.float()) * scale
    intra = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
    return torch.where(intra[None, None], s, NEG_INF)


def attend_global_split_q(q, k_cache_old, v_cache_old, k_scale, v_scale,
                          k_new, v_new, plan, valid_old, window: int):
    """:func:`attend_global_split` over an int8 ring with per-row f32
    scales ``(B, H, C)``: scores times ``k_scale``, probs times
    ``v_scale`` and rounded to bf16 before the V dot."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    c = k_cache_old.shape[2]
    scores_c = torch.einsum("bhtd,bhcd->bhtc", q.float(), k_cache_old.float())
    scores_c = scores_c * (k_scale[:, :, None, :] * scale)
    ok = _ring_ok(plan, valid_old, window)
    scores_c = torch.where(ok[:, None], scores_c, NEG_INF)
    scores_s = _fresh_scores(q, k_new, scale)
    probs = torch.softmax(torch.cat([scores_c, scores_s], dim=-1), dim=-1)
    pc, ps = probs[..., :c], probs[..., c:]
    pc = (pc * v_scale[:, :, None, :]).to(torch.bfloat16).float()
    out = torch.einsum("bhtc,bhcd->bhtd", pc, v_cache_old.float())
    out = out + torch.einsum(
        "bhts,bhsd->bhtd", ps.to(v_new.dtype).float(), v_new.float())
    return out.to(q.dtype)


def attend_global_split_q4(q, k_cache_old, v_cache_old, k_scale, v_scale,
                           k_new, v_new, plan, valid_old, window: int):
    """:func:`attend_global_split_q` over a nibble-packed int4 ring ``(B, H,
    C, Dh/2)`` uint8: unpack (the halves concatenate in feature order), then
    the same math, at any T."""
    return attend_global_split_q(
        q, unpack4(k_cache_old, torch.bfloat16), unpack4(v_cache_old, torch.bfloat16),
        k_scale, v_scale, k_new, v_new, plan, valid_old, window)


def _ring_f32(ring: torch.Tensor, dtype) -> torch.Tensor:
    """The ring rounded to ``dtype``, in f32, for a product.  Under autograd
    a copy where that is the ring itself (an f32 ring): the product saves
    its operands, and the next step's commit overwrites the ring in place."""
    x = ring.to(dtype).float()
    if x is ring and torch.is_grad_enabled() and ring.requires_grad:
        x = ring.clone()
    return x


def attend_global_split(q, k_cache_old, v_cache_old, k_new, v_new, plan,
                        valid_old, window: int):
    """Attention of ``q (B, H, T, Dh)`` over the ring plus this step's fresh
    ``k_new/v_new``.  Ring rows written this step are masked, so the ring
    may be read before or after the commit with the same result."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    c = k_cache_old.shape[2]
    scores_c = torch.einsum(
        "bhtd,bhcd->bhtc", q.float(), _ring_f32(k_cache_old, q.dtype)) * scale
    ok = _ring_ok(plan, valid_old, window)
    scores_c = torch.where(ok[:, None], scores_c, NEG_INF)
    scores_s = _fresh_scores(q, k_new, scale)
    probs = torch.softmax(torch.cat([scores_c, scores_s], dim=-1), dim=-1)
    pc, ps = probs[..., :c], probs[..., c:]
    out = torch.einsum(
        "bhtc,bhcd->bhtd", pc.to(v_cache_old.dtype).float(),
        _ring_f32(v_cache_old, v_cache_old.dtype))
    out = out + torch.einsum(
        "bhts,bhsd->bhtd", ps.to(v_new.dtype).float(), v_new.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Cross attention over a static source (TTS voice conditioning)
# ---------------------------------------------------------------------------


def cross_attend(q: torch.Tensor, ca_k: torch.Tensor, ca_v: torch.Tensor) -> torch.Tensor:
    """``q (B, H, T, Dh)`` over static source K/V ``(B, H, S, Dh)``, no mask:
    f32 scores and softmax, probs rounded to the source dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), ca_k.to(q.dtype).float())
    probs = torch.softmax(scores * scale, dim=-1)
    out = torch.einsum("bhts,bhsd->bhtd", probs.to(ca_v.dtype).float(), ca_v.float())
    return out.to(q.dtype)


def cross_attend_q(q, k_src, v_src, k_scale, v_scale, s_len: int) -> torch.Tensor:
    """:func:`cross_attend` over an int8 source ``(B, H, S_pad, Dh)`` with
    per-row f32 scales ``(B, H, S_pad)``; rows ``>= s_len`` are padding.
    The order of ``dsm_tpu.ops.attention.cross_attend_q``: normalised probs
    times ``v_scale``, rounded to ``q.dtype``, then the V dot."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = k_src.shape[2]
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k_src.to(q.dtype).float())
    scores = scores * (k_scale[:, :, None, :] * scale)
    ok = torch.arange(s, device=q.device) < s_len
    scores = torch.where(ok[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1) * v_scale[:, :, None, :]
    out = torch.einsum("bhts,bhsd->bhtd", probs.to(q.dtype).float(),
                       v_src.to(q.dtype).float())
    return out.to(q.dtype)
