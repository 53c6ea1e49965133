"""Causal streaming 1-D convolutions (counterpart of ``dsm_tpu/ops/conv.py``).

Every step consumes a fixed number of samples divisible by the stride, so
the carry is a fixed ``K_eff - stride`` sample buffer per slot, zeros at
start (constant padding) or copies of the first sample (replicate
padding, tracked by the per-slot ``first`` flag).

Layout: activations ``(B, C, T)``; weights ``(out_c, in_c/groups, k)``,
the layout of ``F.conv1d``.  Transposed convs belong to Mimi decode and
are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ConvConfig:
    in_c: int
    out_c: int
    k: int
    stride: int = 1
    dilation: int = 1
    groups: int = 1
    bias: bool = True
    pad_mode: str = "constant"  # "constant" | "replicate"

    @property
    def k_eff(self) -> int:
        return (self.k - 1) * self.dilation + 1

    @property
    def padding_total(self) -> int:
        return self.k_eff - self.stride


def init(cfg: ConvConfig, gen: torch.Generator, dtype=torch.float32) -> dict:
    fan_in = cfg.in_c // cfg.groups * cfg.k
    scale = 1.0 / math.sqrt(fan_in)
    w = torch.empty((cfg.out_c, cfg.in_c // cfg.groups, cfg.k), device=gen.device)
    params = {"w": w.uniform_(-scale, scale, generator=gen).to(dtype)}
    if cfg.bias:
        b = torch.empty((cfg.out_c,), device=gen.device)
        params["b"] = b.uniform_(-scale, scale, generator=gen).to(dtype)
    return params


def _conv(cfg: ConvConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    y = F.conv1d(x, params["w"].to(x.dtype), stride=cfg.stride,
                 dilation=cfg.dilation, groups=cfg.groups)
    if cfg.bias:
        y = y + params["b"].to(x.dtype)[None, :, None]
    return y


def _where_slot(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    return torch.where(mask.reshape(-1, *([1] * (new.dim() - 1))), new, old)


def init_state(cfg: ConvConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    state = {"buf": torch.zeros((batch, cfg.in_c, cfg.padding_total),
                                dtype=dtype, device=device)}
    if cfg.pad_mode == "replicate" and cfg.padding_total > 0:
        state["first"] = torch.ones((batch,), dtype=torch.bool, device=device)
    return state


def reset_state(state: dict, reset_mask: torch.Tensor) -> dict:
    """Per-slot reset of the carry (zeros, and the replicate-pad flag)."""
    out = {"buf": _where_slot(reset_mask, torch.zeros_like(state["buf"]), state["buf"])}
    if "first" in state:
        out["first"] = state["first"] | reset_mask
    return out


def step(cfg: ConvConfig, params: dict, state: dict, x: torch.Tensor,
         mask: Optional[torch.Tensor] = None):
    """One streaming step over ``x (B, C, L)``, L a multiple of the stride.

    Returns ``(y (B, out_c, L/stride), state')``.  Slots where ``mask`` is
    False emit garbage (callers discard it) and keep their carry."""
    if x.shape[-1] % cfg.stride != 0:
        raise ValueError(
            f"step length {x.shape[-1]} not a multiple of stride {cfg.stride}")
    if cfg.padding_total == 0:
        return _conv(cfg, params, x), state
    buf = state["buf"]
    if "first" in state:
        rep = x[..., :1].expand_as(buf)
        buf = _where_slot(state["first"], rep, buf)
    xs = torch.cat([buf, x], dim=-1)
    y = _conv(cfg, params, xs)
    new_buf = xs[..., x.shape[-1]:]
    new_state = dict(state)
    if mask is None:
        new_state["buf"] = new_buf.contiguous()
        if "first" in state:
            new_state["first"] = torch.zeros_like(state["first"])
    else:
        new_state["buf"] = _where_slot(mask, new_buf, state["buf"])
        if "first" in state:
            new_state["first"] = state["first"] & ~mask
    return y, new_state


def downsample_cfg(stride: int, dim: int) -> ConvConfig:
    return ConvConfig(in_c=dim, out_c=dim, k=2 * stride, stride=stride,
                      bias=False, pad_mode="replicate")
