"""Streaming decoder transformer (counterpart of ``dsm_tpu/ops/transformer.py``).

Pre-norm blocks with RoPE, a sinusoidal or no positional embedding, sliding-window
self-attention over a fixed ring KV cache per layer, optional gated
cross-attention over a static source (the TTS voice), gated (SiLU GLU) or
GELU MLP, optional layer scale.  :func:`micro_step` is the DepFormer's lean
step over a small dense cache.

Parameters are a list of per-layer dicts (the JAX package stacks them on a
leading axis for ``lax.scan``; ``bridge.py`` splits that axis).  The step
updates the layer rings in place; the returned state dict holds the same
ring tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..parallel import mesh as mesh_mod
from . import attention as attn
from . import decode_attn as dattn
from . import mlp as mlp_mod
from . import norm as norm_mod
from . import ring_kernels as rkern
from . import qmm as qmm_mod


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
    cross_attention: bool = False
    ca_gating: str = "normal"  # "normal" | "constant_*" | "conditional_*"
    ca_dim: Optional[int] = None  # source dim of the cross-attention KV
    ca_norm: Optional[str] = None  # norm_cross kind; None -> same as `norm`
    # int8 rings at T=1: None = the shape rule picks the fused or the split
    # pipeline; True = fused at every ring one block can hold; False = split
    # everywhere (``decode_attn.fused_commit_supported``).
    fused_attn: Optional[bool] = None
    # Tensor parallelism (``parallel/mesh.tp_local_transformer_cfg``): True
    # when this config is one tp shard's (heads split, ``head_dim`` pinned,
    # MLP hidden sliced by its params); the three row-parallel partial sums
    # are then summed over the tp shards (``parallel.mesh.all_reduce``)
    # before the bias, the gate or the layer scale.
    tp_shard: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def norm_kind(self) -> str:
        return self.norm


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.positional_embedding not in ("rope", "sin", "none"):
        raise ValueError(f"unknown positional embedding {cfg.positional_embedding!r}")


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
        if cfg.cross_attention:
            p["norm_cross"] = norm_mod.norm_init(cfg.ca_norm or cfg.norm_kind, d,
                                                 dtype, dev)
            p["ca_q_w"] = mlp_mod.linear_init(gen, d, h * hd, dtype)
            p["ca_kv_w"] = mlp_mod.linear_init(gen, cfg.ca_dim or d, 2 * h * hd, dtype)
            p["ca_out_w"] = mlp_mod.linear_init(gen, h * hd, d, dtype)
            if cfg.ca_gating.startswith("constant"):
                p["ca_gate_alpha"] = torch.zeros((1,), dtype=dtype, device=dev)
            elif cfg.ca_gating.startswith("conditional"):
                hidden = int(0.125 * d)
                p["ca_gate_in_w"] = mlp_mod.linear_init(gen, d, hidden, dtype)
                p["ca_gate_out_w"] = mlp_mod.linear_init(gen, hidden, d, dtype)
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
               step_t: int = 1, kv_quant: bool = False, device=None,
               kv_bits: int = 8) -> dict:
    """Per-layer K/V rings, the shared tick ``pos`` (a 0-d int32 tensor on
    ``device``, as the JAX package's) and the ``(B, C)`` validity bitmap.
    ``kv_quant``: int8 rings with per-row f32 scale rings ``ks``/``vs``; with
    ``kv_bits = 4`` the rings hold int4 values nibble-packed into uint8 rows
    of ``Dh/2`` bytes (``attention.pack4``), same capacity."""
    if kv_bits not in (8, 4):
        raise ValueError(f"kv_bits must be 8 or 4, got {kv_bits}")
    h, hd = cfg.num_heads, cfg.hd
    cap = capacity(cfg, step_t, kv_quant)
    shape = (batch, h, cap, hd)
    q_shape = shape if kv_bits == 8 else (batch, h, cap, hd // 2)
    q_dtype = torch.int8 if kv_bits == 8 else torch.uint8
    layers = []
    for _ in range(cfg.num_layers):
        if kv_quant:
            layers.append({
                "k": torch.zeros(q_shape, dtype=q_dtype, device=device),
                "v": torch.zeros(q_shape, dtype=q_dtype, device=device),
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
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "valid": torch.zeros((batch, cap), dtype=torch.bool, device=device),
    }


def reset_state(state: dict, reset_mask: torch.Tensor) -> dict:
    """Per-slot reset: clear the slot's validity row (in place).  Rings and
    the tick are untouched; stale rows stay masked until overwritten."""
    state["valid"].masked_fill_(reset_mask[:, None], False)
    return state


def w8a8_at(w: dict, site: Optional[str] = None) -> bool:
    """Whether the int8 weight ``w`` multiplies as W8A8 at matmul ``site``.
    The profile travels with the weight (:func:`quantize_weights` writes it):
    no ``"w8a8"`` key or True = W8A8 everywhere, False = weight-only
    everywhere, a frozenset of site names = W8A8 at those sites (and where
    the caller names no site), weight-only at the others."""
    prof = w.get("w8a8", True)
    if isinstance(prof, bool):
        return prof
    return site is None or site in prof


def mm(x: torch.Tensor, w, site: Optional[str] = None) -> torch.Tensor:
    """``x @ w.T``; ``w`` dense or int8 ``{"q": (O, I), "s": (O,)}`` with
    per-output-channel scales.  An int8 weight multiplies as W8A8
    (``qmm.mm_w8a8``) where its profile says so at ``site`` (:func:`w8a8_at`;
    ``site`` is the matmul's name: "in_proj", "out_proj", "ca_q", "ca_out",
    "mlp_in", "mlp_out", "text_linear", "dep_out", "low_rank"), else as the
    weight-only product ``qmm.qmm``: its kernel on CUDA tensors, its plain
    version, in the same order, on CPU tensors."""
    if isinstance(w, dict):
        if w8a8_at(w, site):
            return qmm_mod.mm_w8a8(x, w["q"], w["s"])
        return qmm_mod.qmm(x, w["q"], w["s"])
    return x @ w.to(x.dtype).T


def mm_dequant(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w.T`` through the dequantised weight (the product rounded, then
    scaled in the activation's type), whatever the weight's profile: the
    once-per-voice cross-attention projection, as the JAX package runs it."""
    if isinstance(w, dict):
        return (x @ w["q"].to(x.dtype).T) * w["s"].to(x.dtype)
    return x @ w.to(x.dtype).T


def _is_q(x) -> bool:
    return isinstance(x, dict) and "q" in x and "s" in x


def quantize_weights(tree, min_size: int = 1 << 16, w8a8=True):
    """Weight-only int8 quantisation of the matmul weights of a param tree,
    bit for bit as the JAX package's numpy version: matrix leaves with at
    least ``min_size`` elements become ``{"q": int8, "s": f32 per output
    channel}``; norms, embeddings, layer scales and small leaves stay.
    Leaves that are int8 already keep their tensors.

    ``w8a8``: the profile every int8 leaf of the result carries
    (:func:`w8a8_at`): True (W8A8 everywhere; the leaf gets no key), False
    (weight-only everywhere) or an iterable of site names.  The JAX package
    keeps the profile in process globals; here two trees of different
    profiles can be live at once.

    The JAX package sees a transformer's layers stacked, so a layer leaf's
    size counts once per layer there; lists under a ``*transformer`` key
    are counted the same way here."""
    if not isinstance(w8a8, bool):
        w8a8 = frozenset(w8a8)

    def tagged(q, s):
        return {"q": q, "s": s} if w8a8 is True else {"q": q, "s": s, "w8a8": w8a8}

    def quant(name, leaf, mult):
        if (leaf.ndim < 2 or leaf.numel() * mult < min_size or "emb" in name
                or "layer_scale" in name or "alpha" in name):
            return leaf
        w = leaf.float()
        s = attn.div_ieee(w.abs().amax(dim=-1, keepdim=True), 127.0)
        s = torch.clamp(s, min=1e-12)
        q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
        return tagged(q, s[..., 0])

    def walk(name, node, mult):
        if _is_q(node):
            return tagged(node["q"], node["s"])
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
    qkv = mm(x, lp["in_proj_w"], site="in_proj")
    if "in_proj_b" in lp:
        qkv = qkv + lp["in_proj_b"].to(x.dtype)
    qkv = qkv.reshape(b, t, 3, h, hd)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _proj_out(cfg, lp, y, b, t):
    y = y.transpose(1, 2).reshape(b, t, cfg.num_heads * cfg.hd)
    y = mm(y, lp["out_proj_w"], site="out_proj")
    if cfg.tp_shard:  # the shards' partial sums over their heads, before the bias
        y = mesh_mod.all_reduce(y)
    if "out_proj_b" in lp:
        y = y + lp["out_proj_b"].to(y.dtype)
    return y


def _mlp_block(cfg, lp, x):
    y = norm_mod.apply_norm(cfg.norm_kind, lp["norm2"], x)
    y = mlp_mod.apply(lp["mlp"], y)
    if cfg.tp_shard:  # partial sums over the shards' hidden slices
        y = mesh_mod.all_reduce(y)
    if "layer_scale_2" in lp:
        y = y * lp["layer_scale_2"].to(y.dtype)
    return x + y


def _ca_gate(cfg, lp, x_normed, y):
    if cfg.ca_gating == "normal":
        return y
    if cfg.ca_gating.startswith("constant"):
        a = lp["ca_gate_alpha"].float()
        a = torch.tanh(a) if "tanh" in cfg.ca_gating else torch.sigmoid(a - 4.0)
        return y * a.to(y.dtype)
    h = torch.relu(x_normed @ lp["ca_gate_in_w"].to(y.dtype).T)
    a = h @ lp["ca_gate_out_w"].to(y.dtype).T
    if "tanh" in cfg.ca_gating:
        a = torch.tanh(a)
    elif "learnable_bias" in cfg.ca_gating:
        a = torch.sigmoid(a)
    else:
        a = torch.sigmoid(a - 4.0)
    return y * a


def _cross_block(cfg, lp, x, ca_k=None, ca_v=None, ca_q=None):
    """Gated cross-attention residual.  ``ca_q``: one layer of the int8
    source ``{"k", "v", "ks", "vs", "s_len"}`` (:func:`quantize_ca_kv`),
    taken before ``ca_k/ca_v``.  At T=1 where ``ca_supported`` holds it
    goes through ``ca_decode_attend`` (its kernel on CUDA tensors, its
    plain version on CPU tensors), elsewhere through ``cross_attend_q``."""
    b, t, _ = x.shape
    xn = norm_mod.apply_norm(cfg.ca_norm or cfg.norm_kind, lp["norm_cross"], x)
    q = mm(xn, lp["ca_q_w"], site="ca_q")
    q = q.reshape(b, t, cfg.num_heads, cfg.hd).transpose(1, 2)
    if ca_q is not None:
        args = (q, ca_q["k"], ca_q["v"], ca_q["ks"], ca_q["vs"], ca_q["s_len"])
        if t == 1 and dattn.ca_supported(q, ca_q["k"]):
            y = dattn.ca_decode_attend(*args)
        else:
            y = attn.cross_attend_q(*args)
    else:
        y = attn.cross_attend(q, ca_k, ca_v)
    y = y.transpose(1, 2).reshape(b, t, cfg.num_heads * cfg.hd)
    y = mm(y, lp["ca_out_w"], site="ca_out")
    if cfg.tp_shard:  # the gate reads the replicated xn: sum first, then gate
        y = mesh_mod.all_reduce(y)
    return x + _ca_gate(cfg, lp, xn, y)


def precompute_ca_kv(cfg: TransformerConfig, params: list, ca_tokens: torch.Tensor):
    """Project a cross-attention source once per session: ``ca_tokens (B,
    S, ca_dim)`` -> stacked per-layer K/V ``(L, B, H, S, Dh)``.  One layer
    at a time, to bound peak memory, as the JAX package's ``lax.map``."""
    b, s, _ = ca_tokens.shape
    h, hd = cfg.num_heads, cfg.hd
    ks, vs = [], []
    for lp in params:
        kv = mm_dequant(ca_tokens, lp["ca_kv_w"]).reshape(b, s, 2, h, hd)
        ks.append(kv[:, :, 0].transpose(1, 2))
        vs.append(kv[:, :, 1].transpose(1, 2))
    return torch.stack(ks), torch.stack(vs)


def quantize_ca_kv(ca_kv, s_len: Optional[int] = None) -> dict:
    """int8 copy of a precomputed source with per-row f32 scales over Dh;
    rows zero-padded up to a multiple of 128 (``s_len`` = the real rows),
    bit for bit as the JAX package under ``jax.jit``."""
    k, v = ca_kv
    s = k.shape[3]
    s_len = s if s_len is None else int(s_len)
    pad = (-s) % 128

    def quant(x):
        if pad:
            x = torch.cat([x, x.new_zeros((*x.shape[:3], pad, x.shape[4]))], dim=3)
        xf = x.float()
        scale = attn.mul_recip(torch.clamp(xf.abs().amax(dim=-1), min=1e-8), 127.0)
        q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
        return q.to(torch.int8), scale

    kq, ks = quant(k)
    vq, vs = quant(v)
    return {"k": kq, "v": vq, "ks": ks, "vs": vs, "s_len": s_len}


def _pos_embed_sin(cfg: TransformerConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """``x (B, T, D)`` plus the sinusoidal embedding of ``positions (B, T)``:
    ``concat(cos, sin)`` of ``position / max_period ** (i / (D/2 - 1))``."""
    half = x.shape[-1] // 2
    idx = torch.arange(half, dtype=torch.float32, device=x.device)
    inv_freq = 1.0 / (cfg.max_period ** (idx / (half - 1)))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([torch.cos(freqs), torch.sin(freqs)], dim=-1)
    return x + emb.to(x.dtype)


def _ca_layer(ca_kv, l: int) -> dict:
    if isinstance(ca_kv, dict):
        return {"ca_q": {"k": ca_kv["k"][l], "v": ca_kv["v"][l], "ks": ca_kv["ks"][l],
                         "vs": ca_kv["vs"][l], "s_len": ca_kv["s_len"]}}
    return {"ca_k": ca_kv[0][l], "ca_v": ca_kv[1][l]}


def step(cfg: TransformerConfig, params: list, state: dict, x: torch.Tensor,
         mask: Optional[torch.Tensor] = None, ca_kv=None):
    """One streaming step: ``x (B, T, D)`` -> ``(y (B, T, D), state')``.

    The kernel seams sit where the JAX step has them:
      * the rotary embedding (``cfg.positional_embedding == "rope"``) of q
        and k: folded into the commit of bf16/f32 rings (``rope_commit``),
        one launch of its own (``rope_qk``) before the int8 and packed-int4
        commits below;
      * int8 rings (T=1): by the JAX package's shape rule
        (``decode_attn.fused_commit_supported``: Dh=128, ``h % 8 == 0``,
        ``h <= 16`` and a ring of at most 2.5 MB per slot) the fused
        pipeline, ``quantize_scale_commit`` (the fresh K/V rows quantised,
        their scales committed) then ``decode_attend_commit`` over the
        pre-commit ring (it commits the int8 row itself); for every other
        int8 ring the split pipeline, ``quantize_commit`` (the rows quantised
        and committed with their scales) then ``decode_attend`` over the
        committed ring (on the card a head width its kernel does not take
        raises).  ``cfg.fused_attn`` overrides the rule: True takes the fused
        pipeline at every ring of at most 2.5 MB per slot with ``h % 8 ==
        0``, False the split pipeline everywhere;
      * packed-int4 rings (uint8, ``init_state(kv_bits=4)``; T=1): the fresh
        rows are quantised and nibble-packed by ``quantize_commit`` (as
        ``quantize_kv_rows_packed4``) and always take the split pipeline,
        whatever ``cfg.fused_attn`` says;
      * bf16/f32 rings: ``rope_commit`` (``ring_commit`` without the rope),
        then ``attend_global_split`` over the committed ring (this step's
        rows are masked from the ring read);
      * ``ca_kv``: the stacked per-layer source of :func:`precompute_ca_kv`
        (a ``(k, v)`` pair) or of :func:`quantize_ca_kv` (the int8 dict),
        attended after each self-attention block (:func:`_cross_block`).

    ``state["pos"]`` is a 0-d int32 tensor on the device: the rope's
    positions, the validity bitmap and every kernel's write row come from it
    on the device, and the step returns ``pos + T`` as a tensor.  Nothing is
    read back to the host, so the step can be captured in a CUDA graph.
    """
    _check_supported(cfg)
    b, t, _ = x.shape
    cap = state["valid"].shape[1]
    plan = attn.global_ring_plan(state["pos"], cap, t, device=x.device)
    pos = plan["pos"]
    valid_old = state["valid"]
    valid = attn.update_valid_bitmap(valid_old, plan["w"], mask)

    rope = None
    positions = plan["q_pos"][None, :]
    if cfg.positional_embedding == "rope":
        rope = attn.rope_cos_sin(positions, cfg.hd, cfg.max_period)
    elif cfg.positional_embedding == "sin":
        x = _pos_embed_sin(cfg, x, positions.expand(b, t))

    kv_quant = "ks" in state["layers"][0]
    if kv_quant and t != 1:
        raise ValueError("int8 and packed-int4 KV rings take T=1 steps")
    for li, (lp, st) in enumerate(zip(params, state["layers"])):
        xn = norm_mod.apply_norm(cfg.norm_kind, lp["norm1"], x)
        q, k, v = _qkv(cfg, lp, xn)
        if kv_quant:
            if rope is not None:
                q, k = rkern.rope_qk(q, k, *rope)
            # fused_commit_supported holds for int8 rings only: never for packed4.
            if dattn.fused_commit_supported(q, st["k"], plan, cfg.fused_attn):
                kq, vq = rkern.quantize_scale_commit(k, v, st["ks"], st["vs"], pos)
                y, _, _ = dattn.decode_attend_commit(
                    q, st["k"], st["v"], st["ks"], st["vs"], kq, vq, k, v, plan,
                    valid_old, window=cfg.context,
                )
            else:
                rkern.quantize_commit(k, v, st["k"], st["v"], st["ks"], st["vs"], pos)
                y = dattn.decode_attend(q, st["k"], st["v"], st["ks"], st["vs"], k, v,
                                        plan, valid_old, window=cfg.context)
        else:
            if rope is not None:
                q, k = rkern.rope_commit(q, k, v, st["k"], st["v"], *rope, pos)
            else:
                rkern.ring_commit(st["k"], st["v"], k, v, pos)
            y = attn.attend_global_split(
                q, st["k"], st["v"], k, v, plan, valid_old, window=cfg.context
            )
        y = _proj_out(cfg, lp, y, b, t)
        if "layer_scale_1" in lp:
            y = y * lp["layer_scale_1"].to(y.dtype)
        x = x + y
        if ca_kv is not None:
            x = _cross_block(cfg, lp, x, **_ca_layer(ca_kv, li))
        x = _mlp_block(cfg, lp, x)

    return x, {"layers": state["layers"], "pos": plan["new_pos"], "valid": valid}


def micro_init(cfg: TransformerConfig, batch: int, capacity: int, dtype,
               device=None) -> dict:
    """Dense K/V carry for :func:`micro_step`: per-layer ``(B, H, S, Dh)``
    zeros, no ring or bitmap."""
    shape = (batch, cfg.num_heads, capacity, cfg.hd)
    return {"k": [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(cfg.num_layers)],
            "v": [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(cfg.num_layers)]}


def micro_step(cfg: TransformerConfig, params: list, kv: dict, x: torch.Tensor,
               idx: int):
    """One DepFormer slice step: ``x (B, D)`` at position ``idx`` of the
    dense cache (written in place) -> ``(y (B, D), kv)``.  :func:`step`'s
    semantics at no positional embedding, T=1, every slot active and a
    fresh cache, without the serving-ring machinery; f32 scores, softmax and
    V-dot accumulation, as ``dsm_tpu.ops.transformer.micro_step``."""
    b, _ = x.shape
    cap = kv["k"][0].shape[2]
    scale = 1.0 / math.sqrt(cfg.hd)
    pos_ok = torch.arange(cap, device=x.device) <= idx
    xt = x[:, None, :]
    for lp, kc, vc in zip(params, kv["k"], kv["v"]):
        xn = norm_mod.apply_norm(cfg.norm_kind, lp["norm1"], xt)
        q, k, v = _qkv(cfg, lp, xn)  # (B, H, 1, Dh)
        kc[:, :, idx] = k[:, :, 0].to(kc.dtype)
        vc[:, :, idx] = v[:, :, 0].to(vc.dtype)
        scores = torch.einsum("bhtd,bhsd->bhts", q.float(), kc.float()) * scale
        scores = torch.where(pos_ok, scores, attn.NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        y = torch.einsum("bhts,bhsd->bhtd", probs.to(vc.dtype).float(), vc.float())
        y = _proj_out(cfg, lp, y.to(xt.dtype), b, 1)
        if "layer_scale_1" in lp:
            y = y * lp["layer_scale_1"].to(y.dtype)
        xt = _mlp_block(cfg, lp, xt + y)
    return xt[:, 0, :], kv


def forward(cfg: TransformerConfig, params: list, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence pass over ``x (B, T, D)`` from a fresh state: causal
    attention inside a window of the ``context`` latest positions, the same
    result as :func:`step` frame by frame.  Plain PyTorch (the JAX package
    runs it through XLA, no kernel): f32 scores plus a ``NEG_INF`` bias,
    f32 softmax and V-dot accumulation.  Mimi's offline encode takes it."""
    _check_supported(cfg)
    b, t, _ = x.shape
    dev = x.device
    positions = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(b, t)
    rope = None
    if cfg.positional_embedding == "rope":
        rope = attn.rope_cos_sin(positions, cfg.hd, cfg.max_period)
    elif cfg.positional_embedding == "sin":
        x = _pos_embed_sin(cfg, x, positions)
    q_idx = torch.arange(t, device=dev)[:, None]
    k_idx = torch.arange(t, device=dev)[None, :]
    valid = (k_idx <= q_idx) & (q_idx - k_idx < cfg.context)
    bias = torch.where(valid, 0.0, attn.NEG_INF).to(torch.float32)[None, None]
    scale = 1.0 / math.sqrt(cfg.hd)
    for lp in params:
        xn = norm_mod.apply_norm(cfg.norm_kind, lp["norm1"], x)
        q, k, v = _qkv(cfg, lp, xn)
        if rope is not None:
            q = attn.apply_rope(q, *rope)
            k = attn.apply_rope(k, *rope)
        scores = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale + bias
        probs = torch.softmax(scores, dim=-1)
        y = torch.einsum("bhts,bhsd->bhtd", probs.to(v.dtype).float(), v.float())
        y = _proj_out(cfg, lp, y.to(x.dtype), b, t)
        if "layer_scale_1" in lp:
            y = y * lp["layer_scale_1"].to(y.dtype)
        x = _mlp_block(cfg, lp, x + y)
    return x
