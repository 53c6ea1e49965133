"""Streaming decoder transformer (counterpart of ``dsm_tpu/ops/transformer.py``).

Pre-norm blocks with RoPE or no positional embedding, sliding-window
self-attention over a fixed ring KV cache per layer, gated (SiLU GLU) or
GELU MLP, optional layer scale.

Parameters are a list of per-layer dicts (the JAX package stacks them on a
leading axis for ``lax.scan``; ``bridge.py`` splits that axis).  The step
updates the layer rings in place; the returned state dict holds the same
ring tensors.  Cross-attention (TTS) is not ported yet and has no config
field; the sinusoidal embedding raises (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import attention as attn
from . import decode_attn as dattn
from . import mlp as mlp_mod
from . import norm as norm_mod
from . import ring_kernels as rkern
from .qmm import mm_w8a8


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    d_model: int
    num_heads: int
    num_layers: int
    dim_feedforward: int
    context: int
    gating: bool = True  # SiLU GLU if True else GELU MLP
    norm: str = "rms_norm"  # "rms_norm" | "layer_norm"
    positional_embedding: str = "rope"  # "rope" | "sin" | "none"
    max_period: float = 10_000.0
    bias_attn: bool = False
    layer_scale: Optional[float] = None
    head_dim: Optional[int] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def norm_kind(self) -> str:
        return self.norm


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.positional_embedding not in ("rope", "none"):
        raise NotImplementedError(
            f"positional embedding {cfg.positional_embedding!r} is not ported "
            "yet; see ROADMAP.md")


def init(cfg: TransformerConfig, gen: torch.Generator, dtype=torch.float32) -> list:
    """Random per-layer params on ``gen``'s device: uniform ``±1/sqrt(in)``
    linears, unit norms, as the JAX init (other random numbers)."""
    _check_supported(cfg)
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.hd
    dev = gen.device
    layers = []
    for _ in range(cfg.num_layers):
        p = {
            "in_proj_w": mlp_mod.linear_init(gen, d, 3 * h * hd, dtype),
            "out_proj_w": mlp_mod.linear_init(gen, h * hd, d, dtype),
            "norm1": norm_mod.norm_init(cfg.norm_kind, d, dtype, dev),
            "norm2": norm_mod.norm_init(cfg.norm_kind, d, dtype, dev),
            "mlp": mlp_mod.init(gen, d, cfg.dim_feedforward, cfg.gating, dtype),
        }
        if cfg.bias_attn:
            p["in_proj_b"] = torch.zeros((3 * h * hd,), dtype=dtype, device=dev)
            p["out_proj_b"] = torch.zeros((d,), dtype=dtype, device=dev)
        if cfg.layer_scale is not None:
            p["layer_scale_1"] = torch.full((d,), cfg.layer_scale, dtype=dtype, device=dev)
            p["layer_scale_2"] = torch.full((d,), cfg.layer_scale, dtype=dtype, device=dev)
        layers.append(p)
    return layers


def capacity(cfg: TransformerConfig, step_t: int = 1, kv_quant: bool = False) -> int:
    """Ring rows: ``context + step_t - 1`` rounded up to 128 (int8 rings) or
    32 (bf16/f32 rings), as the JAX package rounds them."""
    cap = cfg.context + step_t - 1
    align = 128 if kv_quant else 32
    if align % step_t:
        raise ValueError(f"step_t {step_t} must divide {align}")
    if cap % align:
        cap += align - cap % align
    return cap


def init_state(cfg: TransformerConfig, batch: int, cache_dtype=torch.bfloat16,
               step_t: int = 1, kv_quant: bool = False, device=None) -> dict:
    """Per-layer K/V rings, the shared tick ``pos`` (a host int) and the
    ``(B, C)`` validity bitmap.  ``kv_quant``: int8 rings with per-row f32
    scale rings ``ks``/``vs``."""
    h, hd = cfg.num_heads, cfg.hd
    cap = capacity(cfg, step_t, kv_quant)
    shape = (batch, h, cap, hd)
    layers = []
    for _ in range(cfg.num_layers):
        if kv_quant:
            layers.append({
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros((batch, h, cap), dtype=torch.float32, device=device),
                "vs": torch.zeros((batch, h, cap), dtype=torch.float32, device=device),
            })
        else:
            layers.append({
                "k": torch.zeros(shape, dtype=cache_dtype, device=device),
                "v": torch.zeros(shape, dtype=cache_dtype, device=device),
            })
    return {
        "layers": layers,
        "pos": 0,
        "valid": torch.zeros((batch, cap), dtype=torch.bool, device=device),
    }


def reset_state(state: dict, reset_mask: torch.Tensor) -> dict:
    """Per-slot reset: clear the slot's validity row (in place).  Rings and
    the tick are untouched; stale rows stay masked until overwritten."""
    state["valid"].masked_fill_(reset_mask[:, None], False)
    return state


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w.T``; ``w`` dense or int8 ``{"q": (O, I), "s": (O,)}``, which
    runs as W8A8 (the serving profile's matmul)."""
    if isinstance(w, dict):
        return mm_w8a8(x, w["q"], w["s"])
    return x @ w.to(x.dtype).T


def _is_q(x) -> bool:
    return isinstance(x, dict) and "q" in x and "s" in x


def quantize_weights(tree, min_size: int = 1 << 16):
    """Weight-only int8 quantisation of the matmul weights of a param tree,
    bit for bit as the JAX package's numpy version: matrix leaves with at
    least ``min_size`` elements become ``{"q": int8, "s": f32 per output
    channel}``; norms, embeddings, layer scales and small leaves stay.

    The JAX package sees a transformer's layers stacked, so a layer leaf's
    size counts once per layer there; lists under a ``*transformer`` key
    are counted the same way here."""

    def quant(name, leaf, mult):
        if (leaf.ndim < 2 or leaf.numel() * mult < min_size or "emb" in name
                or "layer_scale" in name or "alpha" in name):
            return leaf
        w = leaf.float()
        s = w.abs().amax(dim=-1, keepdim=True) / 127.0
        s = torch.clamp(s, min=1e-12)
        q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
        return {"q": q, "s": s[..., 0]}

    def walk(name, node, mult):
        if _is_q(node):
            return node
        if isinstance(node, dict):
            return {k: walk(k, v, mult) for k, v in node.items()}
        if isinstance(node, list):
            m = mult * len(node) if name.endswith("transformer") else mult
            return [walk(name, v, m) for v in node]
        return quant(name, node, mult)

    return walk("", tree, 1)


def _qkv(cfg, lp, x):
    b, t, _ = x.shape
    h, hd = cfg.num_heads, cfg.hd
    qkv = mm(x, lp["in_proj_w"])
    if "in_proj_b" in lp:
        qkv = qkv + lp["in_proj_b"].to(x.dtype)
    qkv = qkv.reshape(b, t, 3, h, hd)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _proj_out(cfg, lp, y, b, t):
    y = y.transpose(1, 2).reshape(b, t, cfg.num_heads * cfg.hd)
    y = mm(y, lp["out_proj_w"])
    if "out_proj_b" in lp:
        y = y + lp["out_proj_b"].to(y.dtype)
    return y


def _mlp_block(cfg, lp, x):
    y = norm_mod.apply_norm(cfg.norm_kind, lp["norm2"], x)
    y = mlp_mod.apply(lp["mlp"], y)
    if "layer_scale_2" in lp:
        y = y * lp["layer_scale_2"].to(y.dtype)
    return x + y


def step(cfg: TransformerConfig, params: list, state: dict, x: torch.Tensor,
         mask: Optional[torch.Tensor] = None):
    """One streaming step: ``x (B, T, D)`` -> ``(y (B, T, D), state')``.

    The kernel seams sit where the JAX step has them:
      * int8 rings (T=1): quantise the fresh K/V rows, ``scale_commit``, then
        ``decode_attend_commit`` over the pre-commit ring (it commits the
        int8 row itself);
      * bf16/f32 rings: ``ring_commit``, then ``attend_global_split`` over
        the committed ring (this step's rows are masked from the ring read).
    """
    _check_supported(cfg)
    b, t, _ = x.shape
    cap = state["valid"].shape[1]
    plan = attn.global_ring_plan(state["pos"], cap, t, device=x.device)
    valid_old = state["valid"]
    valid = attn.update_valid_bitmap(valid_old, plan["w"], mask)

    rope = None
    if cfg.positional_embedding == "rope":
        positions = torch.arange(t, dtype=torch.int64, device=x.device)
        rope = attn.rope_cos_sin((positions + plan["q_pos"][0])[None, :],
                                 cfg.hd, cfg.max_period)

    kv_quant = "ks" in state["layers"][0]
    if kv_quant and t != 1:
        raise ValueError("int8 KV rings take T=1 steps")
    for lp, st in zip(params, state["layers"]):
        xn = norm_mod.apply_norm(cfg.norm_kind, lp["norm1"], x)
        q, k, v = _qkv(cfg, lp, xn)
        if rope is not None:
            q = attn.apply_rope(q, *rope)
            k = attn.apply_rope(k, *rope)
        if kv_quant:
            kq, vq, ks_new, vs_new = attn.quantize_kv_rows(k, v)
            rkern.scale_commit(st["ks"], st["vs"], ks_new, vs_new, plan["w"][0])
            y, _, _ = dattn.decode_attend_commit(
                q, st["k"], st["v"], st["ks"], st["vs"], kq, vq, k, v, plan,
                valid_old, window=cfg.context,
            )
        else:
            rkern.ring_commit(st["k"], st["v"], k, v, plan["w"][0])
            y = attn.attend_global_split(
                q, st["k"], st["v"], k, v, plan, valid_old, window=cfg.context
            )
        y = _proj_out(cfg, lp, y, b, t)
        if "layer_scale_1" in lp:
            y = y * lp["layer_scale_1"].to(y.dtype)
        x = x + y
        x = _mlp_block(cfg, lp, x)

    return x, {"layers": state["layers"], "pos": plan["new_pos"], "valid": valid}
