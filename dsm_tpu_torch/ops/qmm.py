"""W8A8 matmul (counterpart of ``dsm_tpu/ops/qmm.py:mm_w8a8``).

The JAX package computes this as an XLA int8 dot, outside Pallas, so the
port uses PyTorch's int8 GEMM (``torch._int_mm``).  The Pallas W8A16
kernel ``qmm._qmm`` (opt-in ``DSM_QMM=1``) is not ported yet (ROADMAP).

``torch._int_mm`` on CUDA wants M > 16 and K, N multiples of 8.  At stt-1b
every K and N is a multiple of 8, but M is the batch.  Rows are padded
with zeros up to ``_MIN_ROWS`` and the result is sliced back: a zero row
leaves the other rows' int32 sums unchanged.  A K or N that is not a
multiple of 8 raises.
"""

from __future__ import annotations

import torch

_MIN_ROWS = 17


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
