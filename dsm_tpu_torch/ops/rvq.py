"""Residual vector quantisation, encode side (counterpart of
``dsm_tpu/ops/rvq.py``).

Nearest codebook entry as ``argmin(c2 - x.e^T)`` with ``c2 = |e|^2 / 2``,
distances in f32; ``torch.argmin`` keeps the first minimum, as
``jnp.argmin`` does.  Decode waits for Mimi decode (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class RvqConfig:
    dim: int  # codebook dim (256 for Mimi)
    input_dim: int  # encoder dim (512)
    output_dim: int  # decoder dim (512)
    n_q: int
    bins: int


@dataclasses.dataclass(frozen=True)
class SplitRvqConfig:
    dim: int
    input_dim: int
    output_dim: int
    n_q: int
    bins: int

    @property
    def first(self) -> RvqConfig:
        return RvqConfig(self.dim, self.input_dim, self.output_dim, 1, self.bins)

    @property
    def rest(self) -> RvqConfig:
        return RvqConfig(self.dim, self.input_dim, self.output_dim,
                         self.n_q - 1, self.bins)


def init(cfg: RvqConfig, gen: torch.Generator, dtype=torch.float32) -> dict:
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    return {
        "embed": normal(cfg.n_q, cfg.bins, cfg.dim).to(dtype),
        "input_proj": (normal(cfg.dim, cfg.input_dim)
                       / math.sqrt(cfg.input_dim)).to(dtype),
        "output_proj": (normal(cfg.output_dim, cfg.dim)
                        / math.sqrt(cfg.dim)).to(dtype),
    }


def split_init(cfg: SplitRvqConfig, gen: torch.Generator, dtype=torch.float32) -> dict:
    params = {"rvq_first": init(cfg.first, gen, dtype)}
    if cfg.n_q > 1:
        params["rvq_rest"] = init(cfg.rest, gen, dtype)
    return params


def encode(cfg: RvqConfig, params: dict, xs: torch.Tensor) -> torch.Tensor:
    """``xs (B, D_in, T)`` -> codes ``(B, n_q, T)`` int32."""
    proj = params["input_proj"]
    dt = torch.promote_types(xs.dtype, proj.dtype)
    x = torch.einsum("bdt,cd->btc", xs.to(dt), proj.to(dt))  # (B, T, dim)
    embed = params["embed"].float()
    c2 = 0.5 * torch.sum(embed * embed, dim=-1)  # (n_q, bins)
    residual = x.float()
    codes = []
    for e, c2_q in zip(embed, c2):
        dots = residual @ e.T
        idx = torch.argmin(c2_q[None, None, :] - dots, dim=-1)
        residual = residual - e[idx]
        codes.append(idx)
    return torch.stack(codes, dim=1).to(torch.int32)


def split_encode(cfg: SplitRvqConfig, params: dict, xs: torch.Tensor) -> torch.Tensor:
    """Semantic codebook and acoustic codebooks, both encoding ``xs``."""
    codes = encode(cfg.first, params["rvq_first"], xs)
    if cfg.n_q > 1:
        rest = encode(cfg.rest, params["rvq_rest"], xs)
        codes = torch.cat([codes, rest], dim=1)
    return codes
