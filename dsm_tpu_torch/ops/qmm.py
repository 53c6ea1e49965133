"""Int8-weight matmuls (counterpart of ``dsm_tpu/ops/qmm.py``): the
weight-only W8A16 product :func:`qmm` and the W8A8 product :func:`mm_w8a8`.
``transformer.mm`` picks between them by the profile the weight carries.

``qmm`` replaces the Pallas kernel ``dsm_tpu/ops/qmm.py:_qmm``: ``x (..., I)
@ wq (O, I).T * s (O,)`` with the int8 weight made the activation's type
exactly, the products accumulated in f32 over the whole of I, the sum scaled
in f32 and rounded once to the activation's type.  The kernel is CUDA C++ in
``csrc/qmm.cu`` (bf16 ``mma.sync`` with the int8 -> bf16 step in registers;
what bounds it and what its design does about that is written there).  The
wrapper runs :func:`qmm_plain` for CPU tensors and launches the kernel for
CUDA tensors, counting the launch in ``qmm.launches``.  Shapes it launches
for: any M >= 1 and any O (channels past a tile are guarded), bf16
activations, an int8 weight whose rows are contiguous and 16-byte aligned
(``I % 16 == 0``; a row stride, so a slice of a stacked weight is taken as it
is), f32 scales; anything else raises.  Of the TPU kernel's ``supported``
only the semantic terms are kept (a 2-D int8 weight whose width is the
activation's); its tiling terms are not.

``mm_w8a8``: the JAX package computes it as an XLA int8 dot, outside Pallas,
so the port uses PyTorch's int8 GEMM (``torch._int_mm``).  On CUDA that wants
M > 16 and K, N multiples of 8.  At stt-1b every K and N is a multiple of 8,
but M is the batch.  Rows are padded with zeros up to ``_MIN_ROWS`` and the
result is sliced back: a zero row leaves the other rows' int32 sums
unchanged.  A K or N that is not a multiple of 8 raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_MIN_ROWS = 17

_TILE_O = 64      # output channels a block of the kernel owns
_CHUNK_K = 256    # k values the kernel stages per step
_TARGET_BLOCKS = 132  # one block for each of the card's SMs
_MAX_KSPLIT = 8


def mm_w8a8(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x (..., I) @ wq (O, I).T * s (O,)`` with per-row dynamic int8
    activation quantisation: ``y = (round(x/xs) @ wq.T) * xs * s``."""
    lead = x.shape[:-1]
    i = x.shape[-1]
    o = wq.shape[0]
    if i % 8 or o % 8:
        raise ValueError(
            f"mm_w8a8 needs K and N multiples of 8, got K={i} N={o}"
        )
    x2 = x.reshape(-1, i).float()
    xs = torch.clamp(x2.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    xq = torch.clamp(torch.round(x2 / xs), -127, 127).to(torch.int8)
    m = xq.shape[0]
    if m < _MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros((_MIN_ROWS - m, i))])
    acc = torch._int_mm(xq, wq.t())[:m]
    y = acc.float() * xs * s.float()[None, :]
    return y.to(x.dtype).reshape(*lead, o)


def supported(x: torch.Tensor, wq: torch.Tensor) -> bool:
    """The semantic terms of ``dsm_tpu.ops.qmm.supported``: a 2-D int8
    weight whose width is the activation's."""
    return (x.dim() >= 1 and wq.dim() == 2 and wq.dtype == torch.int8
            and x.shape[-1] == wq.shape[1])


def qmm_plain(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any device), in the kernel's order: the int8
    weight in the activation's type (exact), f32 products and sums, the f32
    scale, one rounding."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    acc = x2.float() @ wq.to(x.dtype).float().T
    return (acc * s.float()[None, :]).to(x.dtype).reshape(*lead, wq.shape[0])


def pick_ksplit(m: int, o: int, i: int) -> Tuple[int, int]:
    """``(ksplit, chunks_per_split)`` for the kernel: K is split across
    blocks only while the grid stays within ``_TARGET_BLOCKS`` blocks (a
    split costs a second pass over the partials), every split keeps at least
    two of the ``ceil(I / 256)`` chunks (one to compute while the next is on
    its way) and no split is empty.  O = 2048, I = 2048 at M = 64: 32
    channel tiles x 4 splits of 2 chunks; O = 6144 or more: no split."""
    tiles = -(-o // _TILE_O) * -(-m // 64)
    n_chunks = -(-i // _CHUNK_K)
    want = max(1, min(_TARGET_BLOCKS // max(tiles, 1), n_chunks // 2, _MAX_KSPLIT))
    per = -(-n_chunks // want)
    return -(-n_chunks // per), per


def _launch(x2: torch.Tensor, wq: torch.Tensor, s: torch.Tensor,
            ksplit: Optional[int]) -> torch.Tensor:
    m, i = x2.shape
    o = wq.shape[0]
    for name, t, dtype in (("x", x2, torch.bfloat16), ("wq", wq, torch.int8),
                           ("s", s, torch.float32)):
        if not t.is_cuda:
            raise ValueError(f"qmm: {name} is on {t.device}, not CUDA")
        if t.dtype != dtype:
            raise ValueError(f"qmm: {name} is {t.dtype}, kernel takes {dtype}")
    if tuple(s.shape) != (o,) or not s.is_contiguous():
        raise ValueError(f"qmm: s is {tuple(s.shape)}, kernel takes a contiguous ({o},)")
    if i % 16:
        raise ValueError(f"qmm: kernel takes I a multiple of 16, got {i}")
    if wq.stride(1) != 1 or wq.stride(0) < i or wq.stride(0) % 16 or wq.data_ptr() % 16:
        raise ValueError("qmm: weight rows must be contiguous and 16-byte aligned")
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError("qmm: x rows must be contiguous and 16-byte aligned")
    n_chunks = -(-i // _CHUNK_K)
    if ksplit is None:
        ksplit, per = pick_ksplit(m, o, i)
    else:
        if not 1 <= ksplit <= n_chunks:
            raise ValueError(f"qmm: ksplit={ksplit} for {n_chunks} chunks of K")
        per = -(-n_chunks // ksplit)
        ksplit = -(-n_chunks // per)
    out = torch.empty((m, o), dtype=torch.bfloat16, device=x2.device)
    if m == 0 or o == 0:
        return out
    part = (torch.empty((ksplit, m, o), dtype=torch.float32, device=x2.device)
            if ksplit > 1 else out)
    err = _build.lib().dsm_qmm(
        x2.data_ptr(), wq.data_ptr(), s.data_ptr(), part.data_ptr(), out.data_ptr(),
        m, o, i, wq.stride(0), ksplit, per, ctypes.c_void_p(_build.stream_ptr()))
    _build.check(err, "qmm")
    qmm.launches += 1
    return out


def qmm(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor, *,
        ksplit: Optional[int] = None) -> torch.Tensor:
    """``x (..., I) @ wq (O, I).T * s (O,)`` -> ``(..., O)`` in ``x.dtype``,
    the weight dequantised on the way (W8A16).  CPU tensors take the plain
    version; CUDA tensors launch the kernel (counted in ``qmm.launches``) or
    raise.  ``ksplit`` (default :func:`pick_ksplit`): the number of blocks K
    is split across."""
    if not supported(x, wq):
        raise ValueError(f"qmm: x {tuple(x.shape)} {x.dtype} against weight "
                         f"{tuple(wq.shape)} {wq.dtype}")
    if x.device.type == "cpu":
        return qmm_plain(x, wq, s)
    lead = x.shape[:-1]
    y = _launch(x.reshape(-1, x.shape[-1]).contiguous(), wq, s, ksplit)
    return y.reshape(*lead, wq.shape[0])


qmm.launches = 0
