"""Mimi neural audio codec, encode half (counterpart of
``dsm_tpu/models/mimi.py``).

One 80 ms step: ``pcm (B, 1, 1920)`` -> SeaNet encoder (x960) -> 2 latent
frames (d=512) -> 8-layer codec transformer over those 2 frames (bf16 or
f32 ring, ``ring_commit`` kernel) -> learnt x2 downsample -> split-RVQ
codes ``(B, n_q, 1)``.  Decode (transposed convs, decoder transformer) is
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import conv as C
from ..ops import rvq as Q
from ..ops import transformer as T


@dataclasses.dataclass(frozen=True)
class SeaNetConfig:
    dimension: int = 512
    channels: int = 1
    n_filters: int = 64
    n_residual_layers: int = 1
    ratios: Tuple[int, ...] = (8, 6, 5, 4)
    kernel_size: int = 7
    residual_kernel_size: int = 3
    last_kernel_size: int = 3
    dilation_base: int = 2
    compress: int = 2


def codec_transformer_config() -> T.TransformerConfig:
    """The encoder bottleneck transformer."""
    return T.TransformerConfig(
        d_model=512, num_heads=8, num_layers=8, dim_feedforward=2048,
        context=250, gating=False, norm="layer_norm",
        positional_embedding="rope", max_period=10_000.0, layer_scale=0.01,
    )


@dataclasses.dataclass(frozen=True)
class MimiConfig:
    seanet: SeaNetConfig = SeaNetConfig()
    transformer: T.TransformerConfig = dataclasses.field(
        default_factory=codec_transformer_config)
    n_q: int = 16
    bins: int = 2048
    q_dim: int = 256
    sample_rate: float = 24_000.0
    frame_rate: float = 12.5

    @property
    def encoder_stride(self) -> int:
        s = 1
        for r in self.seanet.ratios:
            s *= r
        return s

    @property
    def encoder_frame_rate(self) -> float:
        return self.sample_rate / self.encoder_stride

    @property
    def downsample_stride(self) -> int:
        return int(self.encoder_frame_rate / self.frame_rate)

    @property
    def frame_size(self) -> int:
        return int(self.sample_rate / self.frame_rate)

    @property
    def frames_per_step(self) -> int:
        return self.downsample_stride

    @property
    def rvq(self) -> Q.SplitRvqConfig:
        d = self.seanet.dimension
        return Q.SplitRvqConfig(dim=self.q_dim, input_dim=d, output_dim=d,
                                n_q=self.n_q, bins=self.bins)


def v0_1(n_q: Optional[int] = None) -> MimiConfig:
    return MimiConfig(n_q=n_q or 16)


# ---------------------------------------------------------------------------
# SeaNet encoder
# ---------------------------------------------------------------------------


def _resblock_cfgs(cfg: SeaNetConfig, dim: int, j: int):
    hidden = dim // cfg.compress
    c1 = C.ConvConfig(dim, hidden, cfg.residual_kernel_size,
                      dilation=cfg.dilation_base ** j)
    c2 = C.ConvConfig(hidden, dim, 1)
    return c1, c2


def _enc_cfgs(cfg: SeaNetConfig):
    mult = 1
    dims = []
    for ratio in reversed(cfg.ratios):
        dims.append((mult * cfg.n_filters, ratio))
        mult *= 2
    init_cfg = C.ConvConfig(cfg.channels, cfg.n_filters, cfg.kernel_size)
    downs = [C.ConvConfig(dim, dim * 2, k=ratio * 2, stride=ratio)
             for dim, ratio in dims]
    final_cfg = C.ConvConfig(mult * cfg.n_filters, cfg.dimension,
                             cfg.last_kernel_size)
    return init_cfg, dims, downs, final_cfg


def encoder_init(cfg: SeaNetConfig, gen: torch.Generator, dtype=torch.float32) -> dict:
    init_cfg, dims, downs, final_cfg = _enc_cfgs(cfg)
    layers = []
    for i, (dim, _ratio) in enumerate(dims):
        res = []
        for j in range(cfg.n_residual_layers):
            c1, c2 = _resblock_cfgs(cfg, dim, j)
            res.append({"b1": C.init(c1, gen, dtype), "b2": C.init(c2, gen, dtype)})
        layers.append({"res": res, "down": C.init(downs[i], gen, dtype)})
    return {"init": C.init(init_cfg, gen, dtype), "layers": layers,
            "final": C.init(final_cfg, gen, dtype)}


def encoder_state(cfg: SeaNetConfig, batch: int, dtype=torch.float32,
                  device=None) -> dict:
    init_cfg, dims, downs, final_cfg = _enc_cfgs(cfg)
    layers = []
    for i, (dim, _ratio) in enumerate(dims):
        res = []
        for j in range(cfg.n_residual_layers):
            c1, c2 = _resblock_cfgs(cfg, dim, j)
            res.append({"b1": C.init_state(c1, batch, dtype, device),
                        "b2": C.init_state(c2, batch, dtype, device)})
        layers.append({"res": res,
                       "down": C.init_state(downs[i], batch, dtype, device)})
    return {"init": C.init_state(init_cfg, batch, dtype, device),
            "layers": layers,
            "final": C.init_state(final_cfg, batch, dtype, device)}


def encoder_step(cfg: SeaNetConfig, params, state, x, mask=None):
    init_cfg, dims, downs, final_cfg = _enc_cfgs(cfg)
    x, s_init = C.step(init_cfg, params["init"], state["init"], x, mask)
    new_layers = []
    for i, (dim, _ratio) in enumerate(dims):
        lp, ls = params["layers"][i], state["layers"][i]
        new_res = []
        for j in range(cfg.n_residual_layers):
            c1, c2 = _resblock_cfgs(cfg, dim, j)
            rp, rs = lp["res"][j], ls["res"][j]
            y, s1 = C.step(c1, rp["b1"], rs["b1"], F.elu(x), mask)
            y, s2 = C.step(c2, rp["b2"], rs["b2"], F.elu(y), mask)
            x = x + y  # true_skip
            new_res.append({"b1": s1, "b2": s2})
        x, sd = C.step(downs[i], lp["down"], ls["down"], F.elu(x), mask)
        new_layers.append({"res": new_res, "down": sd})
    x, s_final = C.step(final_cfg, params["final"], state["final"], F.elu(x), mask)
    return x, {"init": s_init, "layers": new_layers, "final": s_final}


# ---------------------------------------------------------------------------
# Encode side of the codec
# ---------------------------------------------------------------------------


def init(cfg: MimiConfig, gen: torch.Generator, dtype=torch.float32) -> dict:
    """Random encode-side params on ``gen``'s device."""
    s, d = cfg.downsample_stride, cfg.seanet.dimension
    return {
        "encoder": encoder_init(cfg.seanet, gen, dtype),
        "encoder_transformer": T.init(cfg.transformer, gen, dtype),
        "downsample": C.init(C.downsample_cfg(s, d), gen, dtype),
        "quantizer": Q.split_init(cfg.rvq, gen, dtype),
    }


def init_encode_state(cfg: MimiConfig, batch: int, dtype=torch.float32,
                      device=None) -> dict:
    """``dtype`` sets the codec ring and the conv carries (the conv compute
    dtype follows its inputs)."""
    return {
        "enc": encoder_state(cfg.seanet, batch, dtype, device),
        "enc_t": T.init_state(cfg.transformer, batch, dtype,
                              step_t=cfg.frames_per_step, device=device),
        "down": C.init_state(
            C.downsample_cfg(cfg.downsample_stride, cfg.seanet.dimension),
            batch, dtype, device),
    }


def _tree_conv_reset(state, reset_mask):
    if isinstance(state, dict) and "buf" in state:
        return C.reset_state(state, reset_mask)
    if isinstance(state, dict):
        return {k: _tree_conv_reset(v, reset_mask) for k, v in state.items()}
    if isinstance(state, list):
        return [_tree_conv_reset(v, reset_mask) for v in state]
    return state


def reset_encode_state(state: dict, reset_mask: torch.Tensor) -> dict:
    """Per-slot reset without touching the codec ring."""
    return {
        "enc": _tree_conv_reset(state["enc"], reset_mask),
        "enc_t": T.reset_state(state["enc_t"], reset_mask),
        "down": C.reset_state(state["down"], reset_mask),
    }


def encode_step(cfg: MimiConfig, params, state, pcm, mask=None):
    """One 80 ms codec step: ``pcm (B, 1, 1920)`` -> ``codes (B, n_q, 1)``."""
    x, s_enc = encoder_step(cfg.seanet, params["encoder"], state["enc"], pcm, mask)
    xt, s_t = T.step(cfg.transformer, params["encoder_transformer"],
                     state["enc_t"], x.transpose(1, 2), mask)
    x, s_down = C.step(
        C.downsample_cfg(cfg.downsample_stride, cfg.seanet.dimension),
        params["downsample"], state["down"], xt.transpose(1, 2), mask)
    codes = Q.split_encode(cfg.rvq, params["quantizer"], x)
    return codes, {"enc": s_enc, "enc_t": s_t, "down": s_down}
