"""Normalisation layers (counterpart of ``dsm_tpu/ops/norm.py``).

RmsNorm eps 1e-8, LayerNorm eps 1e-5, statistics in f32 whatever the
activation dtype, result cast back.  The eps values are passed explicitly:
torch's own defaults differ.
"""

from __future__ import annotations

import torch

RMS_EPS = 1e-8
LN_EPS = 1e-5


def rms_norm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"alpha": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(params: dict, x: torch.Tensor, eps: float = RMS_EPS) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["alpha"].float()).to(x.dtype)


def layer_norm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {
        "alpha": torch.ones((d,), dtype=dtype, device=device),
        "bias": torch.zeros((d,), dtype=dtype, device=device),
    }


def layer_norm(params: dict, x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["alpha"].float() + params["bias"].float()
    return y.to(x.dtype)


def norm_init(kind: str, d: int, dtype=torch.float32, device=None) -> dict:
    if kind == "rms_norm":
        return rms_norm_init(d, dtype, device)
    if kind == "layer_norm":
        return layer_norm_init(d, dtype, device)
    raise ValueError(f"unknown norm kind {kind!r}")


def apply_norm(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rms_norm":
        return rms_norm(params, x)
    if kind == "layer_norm":
        return layer_norm(params, x)
    raise ValueError(f"unknown norm kind {kind!r}")
