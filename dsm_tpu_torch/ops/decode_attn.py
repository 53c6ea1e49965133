"""Decode attention over the int8 KV ring (counterpart of
``dsm_tpu/ops/decode_attn.py``): the fused ``decode_attend_commit`` of the
short rings, ``decode_attend`` of the split pipeline (further down, with
the shape rule that picks between them), and the voice cross-attention
``ca_decode_attend``.

``decode_attend_commit`` replaces the Pallas kernels
``dsm_tpu/ops/decode_attn.py:_decode_attend_commit_q_4d`` and, at h = 32
and Dh = 64, ``_decode_attend_commit_q``: T=1 decode attention of bf16
queries over the PRE-commit int8 K/V ring with per-row f32 scales, with
this step's fresh bf16 K/V row joining the softmax exactly, followed by the
write of the fresh int8 row into ring row ``w``.  The scale rings are
committed beforehand (``ring_kernels.scale_commit``).

The kernel is CUDA C++ in ``csrc/decode_attn.cu``, beside the split
pipeline's: the ring is reduced in ``n_split`` spans (:func:`pick_split`),
each by a block whose producer warp brings the span's K and V tiles into
shared memory with TMA bulk copies while four warps compute on the tiles
already there; a second small kernel folds the spans' partials and the
fresh row in a fixed order and writes the committed row ``w``.  One wrapper
call, two launches.  What bounds it is bytes (the int8 rings, about 60 us a
call at stt-1b B=64 at 3.35 TB/s; two multiply-adds a byte); the note at
the top of the source says what the design does about that.  Its order of
operations is :func:`decode_attend_plain`'s at the same ``n_split``.

The wrapper runs the plain version for CPU tensors, in the whole-ring order
the CPU route has always had (``n_split`` None), and launches the kernel
for CUDA tensors, counting the call in ``decode_attend_commit.launches``.
Both attention wrappers take the plan's ``"pos"``, the step's 0-d int32
tick on the rings' device, and the kernels read it from device memory (w =
pos % C), as the Pallas kernels read their scalar-prefetched position: no
host read, so the step can be captured in a CUDA graph.  The plain versions
compute with the position as a tensor too.
Shapes it launches for: any B and H, Dh in {64, 128}, bf16 queries and
fresh rows, contiguous int8 rings of a multiple of 4 rows, 16-byte
aligned, f32 scales, and spans whose scores fit the shared memory a block
may opt in to (some 50,000 rows); anything else raises.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from . import _build
from .attention import NEG_INF, check_tick, no_backward, unpack4

_MAX_SMEM_OPT_IN = 232448  # an H100 block's shared memory with the opt-in


def _row_index(w, device) -> torch.Tensor:
    """Ring row ``w`` (an int or a 0-d tensor on ``device``) as a (1,) int64
    index on ``device``, for an index copy that reads nothing back to the
    host and copies nothing to the device."""
    if isinstance(w, torch.Tensor):
        return w.to(torch.int64).reshape(1)
    return torch.full((1,), int(w), dtype=torch.int64, device=device)


def decode_attend_commit_plain(q, k_cache, v_cache, k_scale, v_scale, kq_new,
                               vq_new, k_new, v_new, valid, pos, w,
                               window: int, n_split: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version (any device) over 3-D rows: ``q, k_new, v_new,
    kq_new, vq_new (B, H, Dh)``, rings ``(B, H, C, Dh)`` int8, scales
    ``(B, H, C)`` f32, ``valid (B, C)`` bool; ``pos`` and ``w = pos % C`` ints
    or 0-d tensors.  Returns ``(B, H, Dh)`` in ``q.dtype`` and writes ring row
    ``w`` in place.

    ``n_split`` None: one softmax over the whole ring (masked rows -1e9), the
    CPU route's order.  An integer: the kernel's order at that split, which
    is :func:`decode_attend_plain` over the committed ring (row ``w`` is
    masked there, so it reads the same rows)."""
    row = _row_index(w, k_cache.device)
    if n_split is not None:
        k_cache.index_copy_(2, row, kq_new[:, :, None])
        v_cache.index_copy_(2, row, vq_new[:, :, None])
        return decode_attend_plain(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                                   valid, pos, w, window, n_split)
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
    k_cache.index_copy_(2, row, kq_new[:, :, None])
    v_cache.index_copy_(2, row, vq_new[:, :, None])
    return res.to(q.dtype)


def _launch(q, k_cache, v_cache, k_scale, v_scale, kq_new, vq_new, k_new, v_new,
            valid, pos: torch.Tensor, window: int, n_split: int) -> torch.Tensor:
    """The kernel at ``n_split`` spans; ``pos`` the device tick, w = pos % C."""
    b, h, c, dh = k_cache.shape
    if dh not in (64, 128):
        raise ValueError(f"decode_attend_commit kernel takes Dh 64 or 128, got {dh}")
    check_tick("decode_attend_commit", pos, k_cache.device)
    if c % 4:
        raise ValueError(f"decode_attend_commit: a ring of {c} rows, not a multiple of 4")
    if not 1 <= n_split <= c:
        raise ValueError(f"decode_attend_commit: n_split={n_split} for a ring of {c}")
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
    for name in ("k_cache", "v_cache", "k_scale", "v_scale"):
        if args[name].data_ptr() % 16:
            raise ValueError(f"decode_attend_commit: {name} must be 16-byte aligned")
    lib = _build.lib()
    span = span_rows(c, n_split)
    if lib.dsm_decode_attend_commit_smem_bytes(span, dh) > _MAX_SMEM_OPT_IN:
        raise ValueError(f"decode_attend_commit: spans of {span} rows exceed shared memory")
    part = torch.empty((b * h, n_split, dh + 2), dtype=torch.float32, device=q.device)
    out = torch.empty((b, h, dh), dtype=torch.bfloat16, device=q.device)
    err = _build.launch(lib.dsm_decode_attend_commit, q.device,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), kq_new.data_ptr(), vq_new.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), valid.data_ptr(), part.data_ptr(),
        out.data_ptr(), b, h, c, dh, n_split, pos.data_ptr(), window, 1.0 / math.sqrt(dh),
    )
    _build.check(err, "decode_attend_commit")
    decode_attend_commit.launches += 1
    return out


def decode_attend_commit(q, k_cache, v_cache, ks_committed, vs_committed,
                         kq_new, vq_new, k_new, v_new, plan, valid_old, *,
                         window: int):
    """Attend ``q (B, H, 1, Dh)`` over the pre-commit int8 ring and this
    step's fresh row, then commit the quantised fresh row ``kq_new/vq_new
    (B, H, 1, Dh)`` into ring row ``plan["pos"] % C`` in place.  The scale
    rings must already hold this step's scales.  Returns
    ``(y (B, H, 1, Dh), k_cache, v_cache)``, the rings being the inputs,
    updated.  On the card the ring is reduced in :func:`pick_split`'s
    spans; on the CPU in the whole-ring order."""
    no_backward("decode_attend_commit", q, ks_committed, vs_committed, k_new, v_new)
    if q.shape[2] != 1:
        raise ValueError("decode_attend_commit takes T=1 steps")
    pos = plan["pos"]
    rows = [x[:, :, 0, :].contiguous() for x in (q, kq_new, vq_new, k_new, v_new)]
    q3, kq3, vq3, kn3, vn3 = rows
    b, h, c, _ = k_cache.shape
    if k_cache.device.type == "cpu":
        y = decode_attend_commit_plain(
            q3, k_cache, v_cache, ks_committed, vs_committed, kq3, vq3, kn3,
            vn3, valid_old, pos, pos % c, window)
    else:
        y = _launch(q3, k_cache, v_cache, ks_committed, vs_committed, kq3, vq3,
                    kn3, vn3, valid_old, pos, window, pick_split(b * h, c))
    return y[:, :, None, :], k_cache, v_cache


decode_attend_commit.launches = 0


# ---------------------------------------------------------------------------
# The split pipeline's attention (counterpart of decode_attn.decode_attend)
# ---------------------------------------------------------------------------
#
# ``decode_attend`` replaces the Pallas kernels
# ``dsm_tpu/ops/decode_attn.py:_decode_attend_q_flash``, ``_decode_attend_q_4d``
# and, head-major, ``_decode_attend_q``: T=1 attention of bf16 queries over
# the COMMITTED int8 ring (``ring_kernels.quantize_commit`` has written this
# step's row and its scales, and the row is masked from the ring read), the
# fresh bf16 row joining the softmax exactly.  The same wrapper serves the
# packed-int4 rings (``kv_bits = 4``): uint8 rings ``(B, H, C, Dh/2)``, byte d
# holding dims (d, d + Dh/2) excess-8 (``attention.pack4``), for the Pallas
# kernels ``_decode_attend_q4_4d`` and, head-major, ``_decode_attend_q4``.
# The kernels are CUDA C++ in ``csrc/decode_attn.cu``, one for each ring type,
# addressed through (b, h) strides, so both layouts are the same launch:
# persistent blocks take (b, h, span) items in turn, a copy warp brings each
# item's attended rows into shared memory by TMA bulk copies, and at one span
# the block folds the fresh row itself (one launch, no scratch); where the
# ring is split (:func:`card_split`) a fold kernel follows.  What bounds them
# and what the design does about that is written there.  Shapes they launch
# for: any B and H, Dh in {64, 128}, bf16 queries and fresh rows, rings of a
# multiple of 4 rows whose rows, scales and (b, h) strides lie on 16 bytes, K
# and V (and their scales) in one layout, validity rows on 4 bytes, spans
# whose scores fit a block's shared memory; anything else raises.

_TARGET_BLOCKS = 1056  # 8 blocks of 256 threads on each of the 132 SMs
_MIN_SPAN = 256        # ring rows a block should at least have to reduce


def _mono_ok(h: int, c: int, dh: int) -> bool:
    """The JAX package's whole-ring-per-block shapes (``h % 8 == 0`` and an
    int8 ring of at most 2.5 MB per slot): a pure shape predicate, kept
    because the dispatch between the fused and the split pipeline follows
    it."""
    return h % 8 == 0 and h * c * dh <= 2_500_000


def _legacy_4d(h: int, dh: int) -> bool:
    """The shapes the JAX package serves with its 4-D kernel bodies."""
    return dh == 128 and h % 8 == 0 and h <= 16


def fused_commit_supported(q, k_cache, plan, fused_attn: Optional[bool] = None) -> bool:
    """The shape rule of ``dsm_tpu.ops.decode_attn.fused_commit_supported``
    without its tiling terms: T=1 over an int8 ring that ``_mono_ok`` and
    ``_legacy_4d`` take goes to ``scale_commit`` + ``decode_attend_commit``;
    every other int8 ring to ``ring_commit`` with the scales, then
    :func:`decode_attend`.

    ``fused_attn`` (``TransformerConfig.fused_attn``) is the explicit form of
    the JAX package's ``DSM_FUSED_ATTN`` switch: True takes the fused
    pipeline at every ``_mono_ok`` int8 ring, the head-major shapes (h = 32,
    Dh = 64) included; False takes the split pipeline everywhere."""
    if q.dim() != 4 or q.shape[2] != 1 or k_cache.dtype != torch.int8:
        return False
    if len(plan["w"]) != 1 or fused_attn is False:
        return False
    h, dh = q.shape[1], q.shape[3]
    if not _mono_ok(h, k_cache.shape[2], dh):
        return False
    return fused_attn is True or _legacy_4d(h, dh)


def supported(q, k_cache, plan) -> bool:
    """T=1 decode over an int8 ring, or a packed-int4 uint8 ring of ``Dh/2``
    bytes a row, with a head width the kernel takes
    (``dsm_tpu.ops.decode_attn.supported`` without its tiling terms: ring
    length and head count are free here, for both ring types).  A pure shape
    predicate: nothing routes on it, :func:`decode_attend` on the card
    launches or raises."""
    if q.dim() != 4 or q.shape[2] != 1:
        return False
    if k_cache.dtype == torch.uint8:
        if 2 * k_cache.shape[3] != q.shape[3]:
            return False
    elif k_cache.dtype != torch.int8:
        return False
    return q.shape[3] in (64, 128) and len(plan["w"]) == 1


def _ring_values(ring: torch.Tensor) -> torch.Tensor:
    """Ring rows as f32 values: int8 as they are, packed-int4 unpacked."""
    return unpack4(ring) if ring.dtype == torch.uint8 else ring.float()


def span_rows(c: int, n_split: int) -> int:
    """Ring rows of each of the ``n_split`` spans: ``ceil(c / n_split)``
    rounded up to a multiple of 4, so that a span's first row and first
    scale lie on 16 bytes (the trailing spans may be short or empty).  The
    kernels of both pipelines cut the ring so."""
    return -(-(-(-c // n_split)) // 4) * 4


def pick_split(bh: int, c: int) -> int:
    """Blocks per (b, h) of the fused pipeline's kernel: enough that
    B*H*n_split fills the card's 132 SMs with a few blocks each, while a
    block keeps at least ``_MIN_SPAN`` ring rows to reduce (stt-1b at B=64:
    2 spans of 384).  The split pipeline takes it for int8 rings on the CPU,
    the order every CPU comparison with the JAX package was made in."""
    return max(1, min(-(-_TARGET_BLOCKS // max(bh, 1)), c // _MIN_SPAN))


# (b, h, span) items a split ring gives each SM: packed-int4 rings
# (tools/q4_attend_variants.py), int8 rings (tools/int8_attend_variants.py).
_ITEMS_PER_SM = {True: 2, False: 3}


def pick_split_card(bh: int, c: int, tile_rows: int, sms: int, items_per_sm: int = 2) -> int:
    """Spans per (b, h) of the split pipeline's kernels on the card: their
    blocks are persistent and take (b, h, span) items in turn, so a ring is
    split only where its B*H items give the card's ``sms`` SMs fewer than
    ``items_per_sm`` each, into the fewest spans that do, of whole tiles of
    ``tile_rows`` rows (a span that ends inside a tile pays a tile's fixed
    cost for a part of it); no span but the last is empty.  On the H100 (132
    SMs): 1 at every serving ring (stt-1b 1,024 items, stt-2.6b and
    tts_202501 2,048, s2s-2b 480, Moshi 7B 768); packed-int4 rings (two
    items an SM; ``tools/q4_attend_variants.py`` at B = 1-8) 6 at one stt-1b
    stream, 3 at eight, 12 at one s2s-2b stream, 4 at four; int8 rings
    (three) 4 at the s2s-2b dp x tp shard (12,10,3072,128), 3 at the tp = 4
    stt-1b shard (32,4,768,128)."""
    tiles = -(-c // tile_rows)
    n = max(1, min(-(-items_per_sm * sms // max(bh, 1)), c // tile_rows))
    n = -(-tiles // -(-tiles // n))  # the fewest spans of as many whole tiles
    while n > 1 and span_rows(c, n) * (n - 1) >= c:
        n -= 1
    return n


@functools.lru_cache(maxsize=None)
def card_sms(device_index: int) -> int:
    """The SMs of card ``device_index``."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def ring_card(device_index: int, dh: int, packed: bool) -> Tuple[int, int]:
    """(rows of a tile of the split pipeline's kernel at head width ``dh``
    over packed-int4 or int8 rings, SMs of card ``device_index``): what
    :func:`pick_split_card` takes."""
    tile_rows = _build.lib().dsm_decode_attend_tile_rows(dh, int(packed))
    if tile_rows < 1:
        raise ValueError(f"decode_attend kernel takes Dh 64 or 128, got {dh}")
    return tile_rows, card_sms(device_index)


def card_split(bh: int, c: int, dh: int, packed: bool, device: torch.device) -> int:
    """The split :func:`decode_attend` takes for a ring of B*H = ``bh``
    on ``device``: :func:`pick_split_card` for the card and its kernel; on
    the CPU one span for a packed-int4 ring (the order of the kernel's every
    serving shape) and :func:`pick_split` for an int8 one."""
    if device.type != "cuda":
        return 1 if packed else pick_split(bh, c)
    return pick_split_card(bh, c, *ring_card(device.index or 0, dh, packed),
                           _ITEMS_PER_SM[packed])


def decode_attend_plain(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new,
                        valid, pos, w, window: int,
                        n_split: int = 1) -> torch.Tensor:
    """Plain PyTorch version (any device) over 3-D rows: ``q, k_new, v_new
    (B, H, Dh)``, committed rings ``(B, H, C, Dh)`` int8 or ``(B, H, C,
    Dh/2)`` packed-int4 uint8, scales ``(B, H, C)`` f32, ``valid (B, C)``
    bool, ``pos`` and ``w = pos % C`` ints or 0-d tensors -> ``(B, H, Dh)``
    in ``q.dtype``.

    The kernel's order of operations, its split included: each of the
    ``n_split`` spans takes its own maximum ``m_i``, rounds the unnormalised
    ``exp(s - m_i) * v_scale`` to bf16 before the V dot, and the spans and
    the fresh row are folded with ``exp(m_i - m)``; the division comes last.
    A span with no attended row contributes nothing.  Over a packed-int4
    ring the ring scores take q rounded to bf16, as the Pallas bodies do (on
    the card q is bf16 already); the fresh row's score takes q as it is."""
    c, dh = k_cache.shape[2], q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    j = torch.arange(c, dtype=torch.int64, device=k_cache.device)
    dist = torch.remainder(w - j, c)
    ok = (dist != 0) & (dist <= pos) & (dist < window)
    ok = (ok[None, :] & valid)[:, None, :]  # (B, 1, C)
    qf = q.float()
    s_new = (qf * k_new.float()).sum(-1) * scale  # (B, H)
    if k_cache.dtype == torch.uint8:
        qf = q.to(torch.bfloat16).float()
    span = span_rows(c, n_split)
    parts = []
    for s0 in range(0, c, span):
        sl = slice(s0, min(c, s0 + span))
        sc = torch.einsum("bhd,bhcd->bhc", qf, _ring_values(k_cache[:, :, sl]))
        sc = sc * (k_scale[:, :, sl] * scale)
        sc = torch.where(ok[:, :, sl], sc, float("-inf"))
        m_i = sc.amax(-1)
        m_safe = torch.where(torch.isinf(m_i), 0.0, m_i)
        e = torch.exp(sc - m_safe[..., None])  # 0 at masked rows
        p = torch.where(e > 0, e * v_scale[:, :, sl], 0.0).to(torch.bfloat16).float()
        acc = torch.einsum("bhc,bhcd->bhd", p, _ring_values(v_cache[:, :, sl]))
        parts.append((m_i, e.sum(-1), acc))
    m = s_new
    for m_i, _, _ in parts:
        m = torch.maximum(m, m_i)
    e_new = torch.exp(s_new - m)
    denom = e_new
    out = e_new[..., None] * v_new.float()
    for m_i, l_i, acc in parts:
        corr = torch.exp(m_i - m)  # 0 for a span with no attended row
        denom = denom + l_i * corr
        out = out + acc * corr[..., None]
    return (out / denom[..., None]).to(q.dtype)


def _attend_launch(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, valid,
                   pos: torch.Tensor, window: int, n_split: int) -> torch.Tensor:
    b, h, c, row_bytes = k_cache.shape
    dh = q.shape[-1]
    packed4 = k_cache.dtype == torch.uint8
    if dh not in (64, 128):
        raise ValueError(f"decode_attend kernel takes Dh 64 or 128, got {dh}")
    if row_bytes != (dh // 2 if packed4 else dh):
        raise ValueError(f"decode_attend: ring rows of {row_bytes} bytes for Dh {dh} "
                         f"({k_cache.dtype})")
    ring_dtype = torch.uint8 if packed4 else torch.int8
    check_tick("decode_attend", pos, k_cache.device)
    if not 1 <= n_split <= c:
        raise ValueError(f"decode_attend: n_split={n_split} for a ring of {c}")
    want = {
        "q": ((b, h, dh), torch.bfloat16), "k_new": ((b, h, dh), torch.bfloat16),
        "v_new": ((b, h, dh), torch.bfloat16), "k_cache": ((b, h, c, row_bytes), ring_dtype),
        "v_cache": ((b, h, c, row_bytes), ring_dtype), "k_scale": ((b, h, c), torch.float32),
        "v_scale": ((b, h, c), torch.float32), "valid": ((b, c), torch.bool),
    }
    args = {"q": q, "k_new": k_new, "v_new": v_new, "k_cache": k_cache,
            "v_cache": v_cache, "k_scale": k_scale, "v_scale": v_scale, "valid": valid}
    for name, x in args.items():
        shape, dtype = want[name]
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"decode_attend: {name} is {tuple(x.shape)} {x.dtype}, "
                             f"kernel takes {shape} {dtype}")
        if not x.is_cuda:
            raise ValueError(f"decode_attend: {name} is on {x.device}, not CUDA")
    for name in ("q", "k_new", "v_new", "valid"):
        if not args[name].is_contiguous():
            raise ValueError(f"decode_attend: {name} must be contiguous")
    if k_cache.stride() != v_cache.stride() or k_scale.stride() != v_scale.stride():
        raise ValueError("decode_attend: K and V (or their scales) differ in layout")
    if k_cache.stride(3) != 1 or k_cache.stride(2) != row_bytes or k_scale.stride(2) != 1:
        raise ValueError("decode_attend: ring rows of one (b, h) must be contiguous")
    if (k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16
            or k_cache.stride(0) % 16 or k_cache.stride(1) % 16):
        raise ValueError("decode_attend: ring rows must be 16-byte aligned")
    # The scales are bulk copies too: 4 rows (16 bytes) at a time.
    if c % 4:
        raise ValueError(f"decode_attend: a ring of {c} rows, not a multiple of 4")
    if (k_scale.data_ptr() % 16 or v_scale.data_ptr() % 16
            or k_scale.stride(0) % 4 or k_scale.stride(1) % 4):
        raise ValueError("decode_attend: the rings' scales must be 16-byte aligned")
    if valid.data_ptr() % 4:
        raise ValueError("decode_attend: the validity rows must be 4-byte aligned")
    lib = _build.lib()
    span = span_rows(c, n_split)
    if lib.dsm_decode_attend_smem_bytes(span, dh, int(packed4)) > _MAX_SMEM_OPT_IN:
        raise ValueError(f"decode_attend: spans of {span} rows exceed shared memory")
    part = None  # at one span the kernel folds the fresh row in its one launch
    if n_split > 1:
        part = torch.empty((b * h, n_split, dh + 2), dtype=torch.float32, device=q.device)
    out = torch.empty((b, h, dh), dtype=torch.bfloat16, device=q.device)
    err = _build.launch(lib.dsm_decode_attend, q.device,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), valid.data_ptr(),
        None if part is None else part.data_ptr(), out.data_ptr(), b, h, c, dh, int(packed4),
        n_split, k_cache.stride(0),
        k_cache.stride(1), k_scale.stride(0), k_scale.stride(1), pos.data_ptr(), window,
        1.0 / math.sqrt(dh),
    )
    _build.check(err, "decode_attend")
    decode_attend.launches += 1
    return out


def decode_attend(q, k_cache, v_cache, k_scale, v_scale, k_new, v_new, plan,
                  valid_old, *, window: int, n_split: Optional[int] = None):
    """Attend ``q (B, H, 1, Dh)`` over the committed int8 (or packed-int4
    uint8) ring and this step's fresh bf16 row ``k_new/v_new (B, H, 1, Dh)``
    -> ``(B, H, 1, Dh)``: ``attention.attend_global_split_q`` (``_q4``) at
    T=1 in the kernel's order.
    ``n_split`` (default :func:`card_split`) is the number of spans the
    ring is reduced in.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``decode_attend.launches``) or raise."""
    no_backward("decode_attend", q, k_cache, v_cache, k_scale, v_scale, k_new, v_new)
    if q.shape[2] != 1:
        raise ValueError("decode_attend takes T=1 steps")
    b, h, c, _ = k_cache.shape
    pos = plan["pos"]
    if n_split is None:
        n_split = card_split(b * h, c, q.shape[-1], k_cache.dtype == torch.uint8,
                             k_cache.device)
    q3, kn3, vn3 = (x[:, :, 0, :].contiguous() for x in (q, k_new, v_new))
    if k_cache.device.type == "cpu":
        y = decode_attend_plain(q3, k_cache, v_cache, k_scale, v_scale, kn3, vn3, valid_old,
                                pos, pos % c, window, n_split)
    else:
        y = _attend_launch(q3, k_cache, v_cache, k_scale, v_scale, kn3, vn3, valid_old, pos,
                           window, n_split)
    return y[:, :, None, :]


decode_attend.launches = 0


# ---------------------------------------------------------------------------
# Voice cross-attention (counterpart of decode_attn.ca_decode_attend)
# ---------------------------------------------------------------------------
#
# ``ca_decode_attend`` replaces the Pallas kernels
# ``dsm_tpu/ops/decode_attn.py:_ca_decode_attend_q_4d`` and, head-major,
# ``_ca_decode_attend_q``: T=1 cross-attention of bf16 queries over the int8
# voice source of the TTS LM, with per-row f32 scales and padding rows
# ``j >= s_len`` never read.  The kernel is CUDA C++ in ``csrc/ca_attn.cu``:
# the real rows of a (b, h) are split over a thread-block cluster of
# :func:`pick_ca_cluster` blocks, which share the global maximum and sum
# their partials on rank 0 in rank order; what bounds it and what its design
# does about that is written there.  Shapes it launches for: any B and H, Dh
# in {64, 128}, bf16 queries, int8 sources whose rows are contiguous and
# 16-byte aligned, f32 scales, and spans whose scales and scores fit the
# shared memory a block may opt in to (some 17,000 rows a span, eight spans
# a (b, h)); anything else raises.

_CA_MAX_CLUSTER = 8     # blocks of a cluster (the portable size)
_CA_BLOCKS_PER_SM = 2   # blocks the cluster split gives each SM, where the rows allow
_CA_MIN_ROWS = 64       # source rows a span keeps at least (a tile at Dh=128)
# csrc/ca_attn.cu's CaLayout<DH, TB>: the copy ring's stages of a 4 KB tile
# for a block of one, 8 KB in a cluster; the barriers; the warps'
# reductions; 12 bytes a row of the span; then, in a cluster of n > 1
# blocks, the ranks' maxima and partials.
_CA_STAGES = 2
_CA_WARPS = 4


def ca_smem_bytes(span: int, dh: int, n_cluster: int = 1) -> int:
    """Dynamic shared memory of a ``ca_decode_attend`` block whose span
    holds ``span`` rows, in a cluster of ``n_cluster``
    (``dsm_ca_decode_attend_smem_bytes``)."""
    tile = 4096 if n_cluster == 1 else 8192
    fixed = _CA_STAGES * tile + 48 + 4 * _CA_WARPS * dh + 8 * _CA_WARPS
    exchange = 4 * _CA_MAX_CLUSTER + 4 * (dh + 4) * n_cluster if n_cluster > 1 else 0
    return fixed + 12 * span + exchange


def pick_ca_cluster(bh: int, s_len: int, dh: int, sms: int) -> int:
    """Blocks of the cluster that splits a (b, h)'s ``s_len`` source rows:
    enough that the B*H clusters give the card's ``sms`` SMs
    ``_CA_BLOCKS_PER_SM`` blocks each, while a span keeps ``_CA_MIN_ROWS``
    rows and no span but the last is empty; more where a span's scales and
    scores would not fit a block's shared memory; at most 8.  On the H100
    (132 SMs) at 625 rows: 1 at the serving batches (B*H 1,024 and 2,048),
    2 at a tp shard's 256, 8 at B=1."""
    n = max(1, min(_CA_MAX_CLUSTER, -(-_CA_BLOCKS_PER_SM * sms // max(bh, 1)),
                   s_len // _CA_MIN_ROWS))
    while n > 1 and span_rows(s_len, n) * (n - 1) >= s_len:
        n -= 1
    while n < _CA_MAX_CLUSTER and ca_smem_bytes(span_rows(s_len, n), dh, n) > _MAX_SMEM_OPT_IN:
        n += 1
    return n


def ca_supported(q, k_src) -> bool:
    """T=1 decode over an int8 static source at shapes the kernel order is
    served for (``dsm_tpu.ops.decode_attn.ca_supported``)."""
    if q.dim() != 4 or q.shape[2] != 1 or k_src.dtype != torch.int8:
        return False
    h, dh = q.shape[1], q.shape[3]
    s = k_src.shape[2]
    return s >= 128 and s % 128 == 0 and dh % 64 == 0 and dh <= 128 and h % 8 == 0


def ca_decode_attend_plain(q, k_src, v_src, k_scale, v_scale, s_len: int) -> torch.Tensor:
    """Plain PyTorch version (any device), in the kernel's order: scores
    times ``k_scale``, unnormalised exp times ``v_scale`` rounded to bf16,
    the V dot, then the division.  ``q (B, H, Dh)`` -> ``(B, H, Dh)``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    k, v = k_src[:, :, :s_len].float(), v_src[:, :, :s_len].float()
    scores = torch.einsum("bhd,bhsd->bhs", q.float(), k)
    scores = scores * (k_scale[:, :, :s_len] * scale)
    m = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m)
    denom = e.sum(-1, keepdim=True)
    p = (e * v_scale[:, :, :s_len]).to(torch.bfloat16).float()
    out = torch.einsum("bhs,bhsd->bhd", p, v) / denom
    return out.to(q.dtype)


def _ca_launch(q, k_src, v_src, k_scale, v_scale, s_len: int,
               n_cluster: Optional[int] = None) -> torch.Tensor:
    """The kernel's launch; ``n_cluster`` (tests and tools) forces the
    cluster size, else :func:`pick_ca_cluster` picks it for the card."""
    b, h, dh = q.shape
    s = k_src.shape[2]
    if dh not in (64, 128):
        raise ValueError(f"ca_decode_attend kernel takes Dh 64 or 128, got {dh}")
    if not 1 <= s_len <= s:
        raise ValueError(f"ca_decode_attend: s_len={s_len} outside source of {s} rows")
    want = {"q": ((b, h, dh), torch.bfloat16), "k_src": ((b, h, s, dh), torch.int8),
            "v_src": ((b, h, s, dh), torch.int8), "k_scale": ((b, h, s), torch.float32),
            "v_scale": ((b, h, s), torch.float32)}
    args = {"q": q, "k_src": k_src, "v_src": v_src, "k_scale": k_scale,
            "v_scale": v_scale}
    for name, x in args.items():
        shape, dtype = want[name]
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"ca_decode_attend: {name} is {tuple(x.shape)} {x.dtype}, "
                             f"kernel takes {shape} {dtype}")
        if not x.is_cuda:
            raise ValueError(f"ca_decode_attend: {name} is on {x.device}, not CUDA")
        if x.stride(-1) != 1 or x.data_ptr() % 4:
            raise ValueError(f"ca_decode_attend: {name} rows must be contiguous and aligned")
    if k_src.stride() != v_src.stride() or k_scale.stride() != v_scale.stride():
        raise ValueError("ca_decode_attend: K and V (or their scales) differ in layout")
    if k_src.stride(2) != dh or k_scale.stride(2) != 1:
        raise ValueError("ca_decode_attend: source rows of one (b, h) must be contiguous")
    if (k_src.data_ptr() | v_src.data_ptr()) % 16 or any(
            k_src.stride(d) % 16 for d in (0, 1) if k_src.shape[d] > 1):
        raise ValueError("ca_decode_attend: each (b, h)'s source must start on 16 bytes")
    if n_cluster is None:
        n_cluster = pick_ca_cluster(b * h, s_len, dh, card_sms(q.device.index or 0))
    if not 1 <= n_cluster <= _CA_MAX_CLUSTER:
        raise ValueError(f"ca_decode_attend: cluster of {n_cluster} blocks, not 1-8")
    lib = _build.lib()
    if lib.dsm_ca_decode_attend_smem_bytes(span_rows(s_len, n_cluster), dh,
                                           n_cluster) > _MAX_SMEM_OPT_IN:
        raise ValueError(f"ca_decode_attend: {s_len} rows over {n_cluster} blocks exceed "
                         "shared memory")
    out = torch.empty((b, h, dh), dtype=torch.bfloat16, device=q.device)
    err = _build.launch(lib.dsm_ca_decode_attend, q.device,
        q.data_ptr(), k_src.data_ptr(), v_src.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), b, h, s_len, dh, q.stride(0),
        q.stride(1), k_src.stride(0), k_src.stride(1), k_scale.stride(0),
        k_scale.stride(1), n_cluster, 1.0 / math.sqrt(dh),
    )
    _build.check(err, "ca_decode_attend")
    ca_decode_attend.launches += 1
    return out


def ca_decode_attend(q, k_src, v_src, k_scale, v_scale, s_len: int) -> torch.Tensor:
    """Cross-attention of ``q (B, H, 1, Dh)`` over the int8 source
    ``(B, H, S_pad, Dh)`` with per-row scales ``(B, H, S_pad)`` ->
    ``(B, H, 1, Dh)``.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (counted in ``ca_decode_attend.launches``) or raise."""
    no_backward("ca_decode_attend", q, k_scale, v_scale)
    if q.shape[2] != 1:
        raise ValueError("ca_decode_attend takes T=1 steps")
    q3 = q[:, :, 0, :]
    s_len = int(s_len)
    if k_src.device.type == "cpu":
        y = ca_decode_attend_plain(q3, k_src, v_src, k_scale, v_scale, s_len)
    else:
        y = _ca_launch(q3, k_src, v_src, k_scale, v_scale, s_len)
    return y[:, :, None, :]


ca_decode_attend.launches = 0
