"""Normalisation layers (counterpart of ``dsm_tpu/ops/norm.py``).

RmsNorm eps 1e-8, LayerNorm eps 1e-5, statistics in f32 whatever the
activation dtype, result cast back.  The eps values are passed explicitly:
torch's own defaults differ.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import mul_recip

RMS_EPS = 1e-8
LN_EPS = 1e-5


def rms_norm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"alpha": torch.ones((d,), dtype=dtype, device=device)}


_WINDOW = 32  # XLA:CPU's reduction window


def _xla_cpu_row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(-1)`` in the order XLA:CPU sums a row under ``jax.jit``: while
    more than 32 values are left, they are zero-padded to a multiple of 32
    (the padding split between both ends, the smaller half first) and each
    window of 32 is summed in order from 0; then the rest, in order."""
    while x.shape[-1] > _WINDOW:
        pad = -x.shape[-1] % _WINDOW
        x = F.pad(x, (pad // 2, pad - pad // 2)).unflatten(-1, (-1, _WINDOW))
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(_WINDOW):
            acc = acc + x[..., i]
        x = acc
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def mean_square(xf: torch.Tensor) -> torch.Tensor:
    """The mean of ``xf * xf`` over the last dim, kept: on the CPU summed in
    XLA:CPU's order and scaled by the f32 reciprocal of the width, as the
    jitted JAX step computes it; the card keeps its own reduction."""
    if xf.device.type == "cpu":
        return mul_recip(_xla_cpu_row_sum(xf * xf), xf.shape[-1])[..., None]
    return torch.mean(xf * xf, dim=-1, keepdim=True)


def rms_norm(params: dict, x: torch.Tensor, eps: float = RMS_EPS) -> torch.Tensor:
    """The jitted JAX step's ``rsqrt`` on the CPU (the x86 approximation
    refined by two Newton steps) is not reproduced: ``torch.rsqrt`` differs
    from it in the last bit of some rows' scale, and then in an element of
    the bf16 output now and then (ROADMAP queue 3)."""
    xf = x.float()
    y = xf * torch.rsqrt(mean_square(xf) + eps)
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
