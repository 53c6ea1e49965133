"""Mimi neural audio codec (counterpart of ``dsm_tpu/models/mimi.py``).

Encode, one 80 ms step: ``pcm (B, 1, 1920)`` -> SeaNet encoder (x960) -> 2
latent frames (d=512) -> 8-layer codec transformer over those 2 frames
(bf16 or f32 ring, ``ring_commit`` kernel) -> learnt x2 downsample ->
split-RVQ codes ``(B, n_q, 1)``.

Decode, the mirror image: codes ``(B, n_q, 1)`` -> split-RVQ sum (d=512)
-> learnt x2 upsample (depthwise transposed conv) -> 8-layer decoder
transformer over 2 frames (``ring_commit``) -> SeaNet decoder (transposed
convs, x960) -> ``pcm (B, 1, 1920)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import conv as C
from ..ops import rvq as Q
from ..ops import transformer as T
from ..utils.state import copy_into


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


def _resblock_forward(cfg: SeaNetConfig, dim: int, j: int, params, x):
    c1, c2 = _resblock_cfgs(cfg, dim, j)
    y = C.forward(c1, params["b1"], F.elu(x))
    y = C.forward(c2, params["b2"], F.elu(y))
    return x + y  # true_skip


def encoder_forward(cfg: SeaNetConfig, params, x):
    """The full-sequence encoder: ``pcm (B, 1, T)`` -> ``(B, d, T / 960)``."""
    init_cfg, dims, downs, final_cfg = _enc_cfgs(cfg)
    x = C.forward(init_cfg, params["init"], x)
    for i, (dim, _ratio) in enumerate(dims):
        for j in range(cfg.n_residual_layers):
            x = _resblock_forward(cfg, dim, j, params["layers"][i]["res"][j], x)
        x = C.forward(downs[i], params["layers"][i]["down"], F.elu(x))
    return C.forward(final_cfg, params["final"], F.elu(x))


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
# SeaNet decoder
# ---------------------------------------------------------------------------


def _dec_cfgs(cfg: SeaNetConfig):
    mult = 1 << len(cfg.ratios)
    init_cfg = C.ConvConfig(cfg.dimension, mult * cfg.n_filters, cfg.kernel_size)
    ups, res_dims = [], []
    for ratio in cfg.ratios:
        ups.append(C.ConvTrConfig(mult * cfg.n_filters, mult * cfg.n_filters // 2,
                                  k=ratio * 2, stride=ratio))
        res_dims.append(mult * cfg.n_filters // 2)
        mult //= 2
    final_cfg = C.ConvConfig(cfg.n_filters, cfg.channels, cfg.last_kernel_size)
    return init_cfg, ups, res_dims, final_cfg


def decoder_init(cfg: SeaNetConfig, gen: torch.Generator, dtype=torch.float32) -> dict:
    init_cfg, ups, res_dims, final_cfg = _dec_cfgs(cfg)
    layers = []
    for i, up in enumerate(ups):
        res = []
        for j in range(cfg.n_residual_layers):
            c1, c2 = _resblock_cfgs(cfg, res_dims[i], j)
            res.append({"b1": C.init(c1, gen, dtype), "b2": C.init(c2, gen, dtype)})
        layers.append({"up": C.tr_init(up, gen, dtype), "res": res})
    return {"init": C.init(init_cfg, gen, dtype), "layers": layers,
            "final": C.init(final_cfg, gen, dtype)}


def decoder_state(cfg: SeaNetConfig, batch: int, dtype=torch.float32,
                  device=None) -> dict:
    init_cfg, ups, res_dims, final_cfg = _dec_cfgs(cfg)
    layers = []
    for i, up in enumerate(ups):
        res = []
        for j in range(cfg.n_residual_layers):
            c1, c2 = _resblock_cfgs(cfg, res_dims[i], j)
            res.append({"b1": C.init_state(c1, batch, dtype, device),
                        "b2": C.init_state(c2, batch, dtype, device)})
        layers.append({"up": C.tr_init_state(up, batch, dtype, device), "res": res})
    return {"init": C.init_state(init_cfg, batch, dtype, device), "layers": layers,
            "final": C.init_state(final_cfg, batch, dtype, device)}


def decoder_step(cfg: SeaNetConfig, params, state, x, mask=None):
    init_cfg, ups, res_dims, final_cfg = _dec_cfgs(cfg)
    x, s_init = C.step(init_cfg, params["init"], state["init"], x, mask)
    new_layers = []
    for i, up in enumerate(ups):
        lp, ls = params["layers"][i], state["layers"][i]
        x, su = C.tr_step(up, lp["up"], ls["up"], F.elu(x), mask)
        new_res = []
        for j in range(cfg.n_residual_layers):
            c1, c2 = _resblock_cfgs(cfg, res_dims[i], j)
            rp, rs = lp["res"][j], ls["res"][j]
            y, s1 = C.step(c1, rp["b1"], rs["b1"], F.elu(x), mask)
            y, s2 = C.step(c2, rp["b2"], rs["b2"], F.elu(y), mask)
            x = x + y  # true_skip
            new_res.append({"b1": s1, "b2": s2})
        new_layers.append({"up": su, "res": new_res})
    x, s_final = C.step(final_cfg, params["final"], state["final"], F.elu(x), mask)
    return x, {"init": s_init, "layers": new_layers, "final": s_final}


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------


def init(cfg: MimiConfig, gen: torch.Generator, dtype=torch.float32) -> dict:
    """Random params on ``gen``'s device, both halves."""
    s, d = cfg.downsample_stride, cfg.seanet.dimension
    return {
        "encoder": encoder_init(cfg.seanet, gen, dtype),
        "decoder": decoder_init(cfg.seanet, gen, dtype),
        "encoder_transformer": T.init(cfg.transformer, gen, dtype),
        "decoder_transformer": T.init(cfg.transformer, gen, dtype),
        "downsample": C.init(C.downsample_cfg(s, d), gen, dtype),
        "upsample": C.tr_init(C.upsample_cfg(s, d), gen, dtype),
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


def init_decode_state(cfg: MimiConfig, batch: int, dtype=torch.float32,
                      device=None) -> dict:
    """``dtype`` sets the decoder ring and the conv carries."""
    return {
        "up": C.tr_init_state(
            C.upsample_cfg(cfg.downsample_stride, cfg.seanet.dimension),
            batch, dtype, device),
        "dec_t": T.init_state(cfg.transformer, batch, dtype,
                              step_t=cfg.frames_per_step, device=device),
        "dec": decoder_state(cfg.seanet, batch, dtype, device),
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


def reset_decode_state(state: dict, reset_mask: torch.Tensor) -> dict:
    """Per-slot reset without touching the decoder ring."""
    return {
        "up": C.reset_state(state["up"], reset_mask),
        "dec_t": T.reset_state(state["dec_t"], reset_mask),
        "dec": _tree_conv_reset(state["dec"], reset_mask),
    }


def reset_encode_state_in_place(state: dict, reset_mask: torch.Tensor) -> None:
    """:func:`reset_encode_state` written into ``state``'s own tensors."""
    copy_into(state, reset_encode_state(state, reset_mask))


def reset_decode_state_in_place(state: dict, reset_mask: torch.Tensor) -> None:
    """:func:`reset_decode_state` written into ``state``'s own tensors."""
    copy_into(state, reset_decode_state(state, reset_mask))


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


def encode_step_in_place(cfg: MimiConfig, params, state, pcm, mask=None):
    """:func:`encode_step` on state buffers that stay the same from step to
    step: the encoder ring is written in place by the step already; its
    ``pos`` and ``valid``, the SEANet conv carries and the downsample carry
    are written back into ``state``'s own tensors.  Returns the codes."""
    codes, new_state = encode_step(cfg, params, state, pcm, mask)
    copy_into(state, new_state)
    return codes


def encode_pre_quantize(cfg: MimiConfig, params, pcm: torch.Tensor) -> torch.Tensor:
    """Offline encode without the quantiser (the speaker encoder's input):
    ``pcm (B, 1, T)`` -> the 12.5 Hz latents ``(B, d, T / 1920)``, through
    the full-sequence encoder, codec transformer and downsample."""
    x = encoder_forward(cfg.seanet, params["encoder"], pcm)
    x = T.forward(cfg.transformer, params["encoder_transformer"], x.transpose(1, 2))
    return C.forward(C.downsample_cfg(cfg.downsample_stride, cfg.seanet.dimension),
                     params["downsample"], x.transpose(1, 2))


def decode_step(cfg: MimiConfig, params, state, codes, mask=None):
    """One 80 ms decode step: ``codes (B, n_q, 1)`` -> ``pcm (B, 1, 1920)``."""
    emb = Q.split_decode(cfg.rvq, params["quantizer"], codes)
    x, s_up = C.tr_step(C.upsample_cfg(cfg.downsample_stride, cfg.seanet.dimension),
                        params["upsample"], state["up"], emb, mask)
    xt, s_t = T.step(cfg.transformer, params["decoder_transformer"], state["dec_t"],
                     x.transpose(1, 2), mask)
    pcm, s_dec = decoder_step(cfg.seanet, params["decoder"], state["dec"],
                              xt.transpose(1, 2), mask)
    return pcm, {"up": s_up, "dec_t": s_t, "dec": s_dec}


def decode_step_in_place(cfg: MimiConfig, params, state, codes, mask=None):
    """:func:`decode_step` on state buffers that stay the same from step to
    step: the decoder ring is written in place by the step already; its
    ``pos`` and ``valid``, the upsample carry and the SEANet conv carries are
    written back into ``state``'s own tensors.  Returns the pcm."""
    pcm, new_state = decode_step(cfg, params, state, codes, mask)
    copy_into(state, new_state)
    return pcm
