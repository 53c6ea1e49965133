"""Int8-weight matmuls (counterpart of ``dsm_tpu/ops/qmm.py``): the
weight-only W8A16 product :func:`qmm` and the W8A8 product :func:`mm_w8a8`.
``transformer.mm`` picks between them by the profile the weight carries.

``qmm`` replaces the Pallas kernel ``dsm_tpu/ops/qmm.py:_qmm``: ``x (..., I)
@ wq (O, I).T * s (O,)`` with the int8 weight made the activation's type
exactly, the products accumulated in f32 over the whole of I, the sum scaled
in f32 and rounded once to the activation's type.  The kernel is CUDA C++ in
``csrc/qmm.cu`` (a copy warp feeding TMA stages, bf16 ``wgmma`` with the
int8 -> bf16 step in registers, K split over a thread-block cluster and
summed through its shared memory: one launch a call, no scratch; what bounds
it and what its design does about that is written there).  The wrapper runs
:func:`qmm_plain` for CPU tensors and launches the kernel for CUDA tensors,
tiled by :func:`qmm_tiling`, counting the launch in ``qmm.launches``.  Shapes
it launches for: any M >= 1 and any O (channels past a tile are guarded), bf16
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

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .attention import mul_recip, no_backward

_MIN_ROWS = 17

TILE_O = 128     # output channels a block of the kernel owns
_CHUNK_K = 128   # k values the kernel stages per step
_MAX_SPLIT = 8   # blocks of a cluster (the portable cluster size)
# What a wave of blocks costs beyond its bytes (setting a block up and its
# first stage's round trip, some 2 us), and what the exchange of a cluster's
# partials costs (some 1.3 us), each counted as the weight bytes an SM's
# share of 3.35 TB/s (25 GB/s) streams meanwhile (NVIDIA H100 80GB HBM3 at
# 700 W, the timeline of dsm_tpu_torch/tools/qmm_variants.py).
_WAVE_BYTES = 48 * 1024
_SPLIT_BYTES = 32 * 1024


class QmmTiling(NamedTuple):
    """What the kernel launches: K split over the ``ksplit`` blocks of a
    cluster, and the grid (tiles of ``TILE_O`` channels, ``ksplit``, row
    tiles)."""

    ksplit: int
    grid: Tuple[int, int, int]


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
    xs = torch.clamp(mul_recip(x2.abs().amax(dim=-1, keepdim=True), 127.0), min=1e-8)
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


def _rows_tile(m: int) -> int:
    """Rows of x a block takes: 8, 16, 32 or 64."""
    return 8 if m <= 8 else 16 if m <= 16 else 32 if m <= 32 else 64


def qmm_grid(m: int, o: int, ksplit: int) -> Tuple[int, int, int]:
    """The kernel's grid: (channel tiles, ``ksplit``, row tiles)."""
    return (-(-o // TILE_O), ksplit, -(-m // _rows_tile(m)))


@functools.lru_cache(maxsize=None)
def qmm_tiling(m: int, o: int, i: int, resident: Tuple[int, ...]) -> QmmTiling:
    """The kernel's tiling for an ``(m, i) x (o, i)`` product: of the cluster
    K splits the kernel takes (rank r of a cluster of KS takes the chunks of
    128 k [r * n / KS, (r + 1) * n / KS) of the n = ceil(I / 128), at least
    one, so no split is empty), the one whose longest block has the fewest
    weight bytes to stream, counted over waves of the clusters the card
    holds at once (``resident[k - 1]``: clusters of k blocks, as
    :func:`resident_clusters` reads them) with ``_WAVE_BYTES`` more a wave
    and ``_SPLIT_BYTES`` more for a split; then fewer waves, more blocks
    (more SMs pulling bytes), a smaller cluster.  At M = 64 on the H100:
    (6144, 2048) 2 splits, 96 blocks; (2048, 2048) 6, 96; (11264, 2048) 1,
    88; (2048, 5632) 6, 96; (4000, 2048) 3, 96: one wave each.  Cached: the
    wrapper asks at every call."""
    n_chunks = -(-i // _CHUNK_K)
    best = None
    for ksplit in range(1, min(_MAX_SPLIT, n_chunks) + 1):
        grid = qmm_grid(m, o, ksplit)
        clusters = grid[0] * grid[2]
        waves = -(-clusters // resident[ksplit - 1])
        longest = -(-n_chunks // ksplit) * _CHUNK_K * TILE_O
        cost = waves * (longest + _WAVE_BYTES) + (ksplit > 1) * _SPLIT_BYTES
        key = (cost, waves, -clusters * ksplit, ksplit)
        if best is None or key < best[0]:
            best = (key, QmmTiling(ksplit, grid))
    return best[1]


@functools.lru_cache(maxsize=None)
def resident_clusters(device_index: int) -> Tuple[int, ...]:
    """Clusters of 1, 2, ..., 8 blocks of the kernel that the card holds at
    once, as the card reports them (a cluster's blocks share one GPC)."""
    lib = _build.lib()
    with torch.cuda.device(device_index):
        got = tuple(lib.dsm_qmm_max_clusters(64, 2048, k) for k in range(1, _MAX_SPLIT + 1))
    if min(got) < 1:
        raise RuntimeError(f"qmm: the card holds no cluster of some size: {got}")
    return got


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
    if ksplit is None:
        ksplit = qmm_tiling(m, o, i, resident_clusters(x2.device.index or 0)).ksplit
    n_chunks = -(-i // _CHUNK_K)
    if not 1 <= ksplit <= min(_MAX_SPLIT, n_chunks):
        raise ValueError(f"qmm: ksplit={ksplit} for {n_chunks} chunks of 128 k "
                         f"(a cluster holds at most {_MAX_SPLIT} blocks)")
    out = torch.empty((m, o), dtype=torch.bfloat16, device=x2.device)
    if m == 0 or o == 0:
        return out
    err = _build.launch(_build.lib().dsm_qmm, x2.device,
        x2.data_ptr(), wq.data_ptr(), s.data_ptr(), out.data_ptr(), m, o, i, wq.stride(0),
        ksplit)
    _build.check(err, "qmm")
    qmm.launches += 1
    return out


def qmm(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor, *,
        ksplit: Optional[int] = None) -> torch.Tensor:
    """``x (..., I) @ wq (O, I).T * s (O,)`` -> ``(..., O)`` in ``x.dtype``,
    the weight dequantised on the way (W8A16).  CPU tensors take the plain
    version; CUDA tensors launch the kernel once (counted in
    ``qmm.launches``) or raise.  ``ksplit`` (the blocks of a cluster that
    split K) defaults to :func:`qmm_tiling`'s."""
    no_backward("qmm", x, s)
    if not supported(x, wq):
        raise ValueError(f"qmm: x {tuple(x.shape)} {x.dtype} against weight "
                         f"{tuple(wq.shape)} {wq.dtype}")
    if x.device.type == "cpu":
        return qmm_plain(x, wq, s)
    lead = x.shape[:-1]
    y = _launch(x.reshape(-1, x.shape[-1]).contiguous(), wq, s, ksplit)
    return y.reshape(*lead, wq.shape[0])


qmm.launches = 0
