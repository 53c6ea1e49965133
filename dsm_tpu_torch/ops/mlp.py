"""Transformer feed-forward blocks (counterpart of ``dsm_tpu/ops/mlp.py``).

  * gated (SiLU GLU): ``linear_in: d -> 2*hidden``, split, ``silu(a) * b``,
    ``linear_out: hidden -> d``; hidden = ``11*d//4`` when ``ff == 4*d``
    (5632 at stt-1b), else ``2*ff//3``.
  * plain: ``linear1 -> gelu(erf) -> linear2``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gating_hidden(d_model: int, dim_feedforward: int) -> int:
    if dim_feedforward == 4 * d_model:
        return 11 * d_model // 4
    return 2 * dim_feedforward // 3


def linear_init(gen: torch.Generator, in_d: int, out_d: int, dtype) -> torch.Tensor:
    """``(out_d, in_d)`` uniform in ``±1/sqrt(in_d)``, on ``gen``'s device."""
    scale = 1.0 / math.sqrt(in_d)
    w = torch.empty((out_d, in_d), dtype=torch.float32, device=gen.device)
    return w.uniform_(-scale, scale, generator=gen).to(dtype)


def init(gen: torch.Generator, d_model: int, dim_feedforward: int, gating: bool,
         dtype=torch.float32) -> dict:
    if gating:
        hidden = gating_hidden(d_model, dim_feedforward)
        return {
            "linear_in": linear_init(gen, d_model, 2 * hidden, dtype),
            "linear_out": linear_init(gen, hidden, d_model, dtype),
        }
    return {
        "linear1": linear_init(gen, d_model, dim_feedforward, dtype),
        "linear2": linear_init(gen, dim_feedforward, d_model, dtype),
    }


def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    from .transformer import mm  # transformer imports this module

    if "linear_in" in params:
        y = mm(x, params["linear_in"])
        a, b = torch.chunk(y, 2, dim=-1)
        return mm(F.silu(a) * b, params["linear_out"])
    y = F.gelu(mm(x, params["linear1"]), approximate="none")
    return mm(y, params["linear2"])
