"""Streaming attention over fixed ring-buffer KV caches (counterpart of
``dsm_tpu/ops/attention.py``).

One ring per layer, ``(B, H, C, Dh)``, shared write index for every slot:

  write index   w      = pos % C
  key position  k_pos[j] = p_last - ((w_last - j) mod C)
  validity      k_pos >= 0, k_pos <= q_pos, q_pos - k_pos < window,
                and the slot's bit in the ``(B, C)`` validity bitmap

``pos`` is a host int: the plan's write rows and query positions are
Python ints, so the kernels take ``w`` as a scalar argument and nothing
waits on the device.  Rings are updated in place (the JAX package gets
the same effect from buffer donation and aliasing).

The attention functions compute dot products in f32.  A bf16 x bf16 or
bf16 x int8 product is exact in f32, so this equals JAX's bf16 dots with
``preferred_element_type=f32`` up to the order of the sums.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# Rotary embeddings (interleaved pairs)
# ---------------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, head_dim: int, max_period: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (B, T) int -> cos, sin (B, T, Dh/2) f32."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / torch.pow(float(max_period), 2.0 * idx / head_dim)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, T, Dh) with interleaved rotary pairs (x0,x1),(x2,x3),..."""
    b, h, t, d = x.shape
    xf = x.float().reshape(b, h, t, d // 2, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    c = cos[:, None, :, :]
    s = sin[:, None, :, :]
    o1 = x1 * c - x2 * s
    o2 = x1 * s + x2 * c
    return torch.stack([o1, o2], dim=-1).reshape(b, h, t, d).to(x.dtype)


# ---------------------------------------------------------------------------
# Global ring plan, writes and validity
# ---------------------------------------------------------------------------


def global_ring_plan(pos: int, context: int, t_new: int, device=None) -> dict:
    """Plan for appending ``t_new`` frames at the shared tick ``pos``.

    Returns ``w`` and ``q_pos`` as lists of ``t_new`` ints, ``k_pos (C,)``
    int64 on ``device`` and ``new_pos`` int."""
    pos = int(pos)
    w = [(pos + t) % context for t in range(t_new)]
    q_pos = [pos + t for t in range(t_new)]
    p_last = pos + t_new - 1
    w_last = p_last % context
    j = torch.arange(context, dtype=torch.int64, device=device)
    k_pos = p_last - torch.remainder(w_last - j, context)
    return {"w": w, "q_pos": q_pos, "k_pos": k_pos, "new_pos": pos + t_new}


def ring_write_global(k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor, w0: int) -> None:
    """Write ``T`` new rows ``(B, H, T, Dh)`` into the rings at ``w0``, in
    place.  The rows must not wrap: ``init_state`` makes the capacity a
    multiple of T, so a fixed-cadence append lands at ``w0 % T == 0``."""
    t_new = k_new.shape[2]
    if w0 + t_new > k_cache.shape[2]:
        raise ValueError(f"append of {t_new} rows at {w0} wraps the ring")
    k_cache[:, :, w0:w0 + t_new] = k_new.to(k_cache.dtype)
    v_cache[:, :, w0:w0 + t_new] = v_new.to(v_cache.dtype)


def update_valid_bitmap(valid: torch.Tensor, w: list,
                        mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Copy of ``valid (B, C)`` with the rows written this step set to the
    slot's mask (False for inactive slots: their rows hold garbage)."""
    out = valid.clone()
    m = mask if mask is not None else torch.ones(
        valid.shape[0], dtype=torch.bool, device=valid.device)
    for r in w:
        out[:, r] = m
    return out


def quantize_kv_rows(k_new: torch.Tensor, v_new: torch.Tensor):
    """Per-row symmetric int8 quantisation of fresh K/V rows.

    Returns ``(kq, vq int8, ks, vs (B, H, T) f32)``; bit-exact with the JAX
    version (both round half to even)."""

    def one(x):
        xf = x.float()
        amax = xf.abs().amax(dim=-1)
        scale = torch.clamp(amax, min=1e-8) / 127.0
        q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
        return q.to(torch.int8), scale

    kq, ks = one(k_new)
    vq, vs = one(v_new)
    return kq, vq, ks, vs


# ---------------------------------------------------------------------------
# Split attention: old ring + this step's fresh rows
# ---------------------------------------------------------------------------


def _ring_ok(plan: dict, valid_old: torch.Tensor, window: int) -> torch.Tensor:
    """(B, T, C) mask of ring rows each query may attend."""
    k_pos = plan["k_pos"][None, :]
    dev = k_pos.device
    t = len(plan["q_pos"])
    # Built on the device from host ints: no host-to-device copy, no sync.
    q_pos = (torch.arange(t, dtype=torch.int64, device=dev)
             + plan["q_pos"][0])[:, None]
    ok = (k_pos >= 0) & (k_pos <= q_pos) & (q_pos - k_pos < window)
    for r in plan["w"]:
        ok[:, r] = False  # rows being overwritten this step are stale
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


def attend_global_split(q, k_cache_old, v_cache_old, k_new, v_new, plan,
                        valid_old, window: int):
    """Attention of ``q (B, H, T, Dh)`` over the ring plus this step's fresh
    ``k_new/v_new``.  Ring rows written this step are masked, so the ring
    may be read before or after the commit with the same result."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    c = k_cache_old.shape[2]
    scores_c = torch.einsum(
        "bhtd,bhcd->bhtc", q.float(), k_cache_old.to(q.dtype).float()) * scale
    ok = _ring_ok(plan, valid_old, window)
    scores_c = torch.where(ok[:, None], scores_c, NEG_INF)
    scores_s = _fresh_scores(q, k_new, scale)
    probs = torch.softmax(torch.cat([scores_c, scores_s], dim=-1), dim=-1)
    pc, ps = probs[..., :c], probs[..., c:]
    out = torch.einsum(
        "bhtc,bhcd->bhtd", pc.to(v_cache_old.dtype).float(), v_cache_old.float())
    out = out + torch.einsum(
        "bhts,bhsd->bhtd", ps.to(v_new.dtype).float(), v_new.float())
    return out.to(q.dtype)
