"""Delayed-streams LM (counterpart of ``dsm_tpu/models/lm.py``).

One frame per step: the text token and one token per audio codebook are
embedded and summed (``-1`` = absent, contributes zeros; an optional
condition is added), run through the streaming temporal transformer (with
the voice cross-attention for TTS), normalised, and projected to text
logits; the semantic-VAD extra heads read the same hidden vector.  The
DepFormer then samples the frame's audio codebooks, one slice per codebook
(:func:`depformer_sample`, the JAX package's lean path).  Presets: the STT
models, s2s-2b, the 48-layer TTS model tts_202501, the legacy TTS model
tts_v0_1 and Moshi 7B; the serving configurations, tts-1.6b's among them,
come from the TOML (``server/config.py``).

Layout: a transformer is a list of per-layer dicts; the DepFormer's
per-slice transformers are a list (slices) of such lists, while its other
per-slice weights stay stacked on a leading slice axis, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops import norm as norm_mod
from ..ops import sampling as S
from ..ops import transformer as T


@dataclasses.dataclass(frozen=True)
class DepFormerConfig:
    transformer: T.TransformerConfig
    num_slices: int
    low_rank_embeddings: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class LmConfig:
    transformer: T.TransformerConfig
    text_in_vocab_size: int
    text_out_vocab_size: int
    audio_vocab_size: int
    audio_codebooks: int
    extra_heads: Optional[Tuple[int, int]] = None  # (num_heads, dim)
    depformer: Optional[DepFormerConfig] = None

    @property
    def audio_pad_token(self) -> int:
        return self.audio_vocab_size - 1

    @property
    def text_start_token(self) -> int:
        return self.text_in_vocab_size - 1

    @property
    def generated_codebooks(self) -> int:
        return self.depformer.num_slices if self.depformer else 0

    @property
    def d_model(self) -> int:
        return self.transformer.d_model


def stt_1b_en_fr() -> LmConfig:
    """kyutai/stt-1b-en_fr (configs/config-stt.toml)."""
    return LmConfig(
        transformer=T.TransformerConfig(
            d_model=2048, num_heads=16, num_layers=16, dim_feedforward=8192,
            context=750, max_period=100_000.0,
        ),
        text_in_vocab_size=8001,
        text_out_vocab_size=8000,
        audio_vocab_size=2049,
        audio_codebooks=32,
        extra_heads=(4, 6),  # semantic VAD
    )


def stt_2_6b_en() -> LmConfig:
    """kyutai/stt-2.6b-en (configs/config-stt-en.toml): 32 heads x 64, no
    semantic-VAD heads."""
    return LmConfig(
        transformer=T.TransformerConfig(
            d_model=2048, num_heads=32, num_layers=48, dim_feedforward=8192,
            context=375, max_period=100_000.0,
        ),
        text_in_vocab_size=4001,
        text_out_vocab_size=4000,
        audio_vocab_size=2049,
        audio_codebooks=32,
    )


def asr_300m_202501() -> LmConfig:
    return LmConfig(
        transformer=T.TransformerConfig(
            d_model=1024, num_heads=8, num_layers=16, dim_feedforward=4096,
            context=750, max_period=100_000.0,
        ),
        text_in_vocab_size=48001,
        text_out_vocab_size=48000,
        audio_vocab_size=2049,
        audio_codebooks=32,
    )


def asr_v0_1_1b() -> LmConfig:
    return LmConfig(
        transformer=T.TransformerConfig(
            d_model=2048, num_heads=16, num_layers=16, dim_feedforward=8192,
            context=750, max_period=100_000.0,
        ),
        text_in_vocab_size=48001,
        text_out_vocab_size=48000,
        audio_vocab_size=2049,
        audio_codebooks=8,
    )


def _depformer(num_slices: int, d: int = 1024, heads: int = 16, layers: int = 6
               ) -> DepFormerConfig:
    """The DepFormer defaults of the JAX package: one slice per generated
    codebook, no positional embedding, context = the slice count."""
    return DepFormerConfig(
        transformer=T.TransformerConfig(
            d_model=d, num_heads=heads, num_layers=layers, dim_feedforward=4 * d,
            context=num_slices, positional_embedding="none",
        ),
        num_slices=num_slices,
    )


def s2s_2b_16rvq_202501() -> LmConfig:
    """The full-duplex dialogue model (configs/config-duplex-tpu-serving.toml):
    32 audio codebooks in (16 generated + 16 of the user), 16 slices out."""
    return LmConfig(
        transformer=T.TransformerConfig(
            d_model=2560, num_heads=20, num_layers=24, dim_feedforward=10240,
            context=3000, max_period=100_000.0,
        ),
        depformer=_depformer(16),
        text_in_vocab_size=48001,
        text_out_vocab_size=48000,
        audio_vocab_size=2049,
        audio_codebooks=32,
    )


def tts_202501() -> LmConfig:
    """The 48-layer TTS model: 32 heads x 64, context 500, the voice
    cross-attention with a LayerNorm ``norm_cross`` (head-major in the JAX
    package's kernels), DepFormer 32 slices x 6 layers without low-rank
    embeddings; ``max_period`` is the default 10,000."""
    return LmConfig(
        transformer=T.TransformerConfig(
            d_model=2048, num_heads=32, num_layers=48, dim_feedforward=8192,
            context=500, cross_attention=True, ca_norm="layer_norm",
        ),
        depformer=_depformer(32),
        text_in_vocab_size=8001,
        text_out_vocab_size=8000,
        audio_vocab_size=2049,
        audio_codebooks=32,
    )


def tts_v0_1() -> LmConfig:
    """The legacy T5-conditioned TTS model (``sessions/tts_legacy.py``):
    LayerNorm blocks, a GELU MLP without gating, cross-attention over the
    projected text states (source width = the model's), context 4096, 32
    heads x 64, 48 layers; 16 codebooks, audio vocab 2050 (2048 bins, the
    end-of-generation id and the pad); no text stream out."""
    return LmConfig(
        transformer=T.TransformerConfig(
            d_model=2048, num_heads=32, num_layers=48, dim_feedforward=8192,
            context=4096, gating=False, norm="layer_norm", cross_attention=True,
            ca_norm="layer_norm",
        ),
        depformer=_depformer(16),
        text_in_vocab_size=32001,
        text_out_vocab_size=32001,
        audio_vocab_size=2050,
        audio_codebooks=16,
    )


def moshi_v0_1() -> LmConfig:
    """Moshi 7B: d=4096, 32 heads x 128, 32 layers, ff 16384 (a gated hidden
    of 11264), context 3000, rope at the default period; 8 audio codebooks
    in, a DepFormer of 8 slices."""
    return LmConfig(
        transformer=T.TransformerConfig(
            d_model=4096, num_heads=32, num_layers=32, dim_feedforward=16384,
            context=3000,
        ),
        depformer=_depformer(8),
        text_in_vocab_size=32001,
        text_out_vocab_size=32000,
        audio_vocab_size=2049,
        audio_codebooks=8,
    )


def moshi_v0_1_streaming(num_slices: int = 16) -> LmConfig:
    """Moshi 7B with 16 audio codebooks in and ``num_slices`` DepFormer
    slices.  The dialogue layout (``configs/models/moshi_7b.json``: ``n_q``
    16, ``dep_q`` 8) is ``num_slices = 8``: 8 generated codebooks beside the
    user's 8."""
    return dataclasses.replace(moshi_v0_1(), audio_codebooks=16,
                               depformer=_depformer(num_slices))


def _emb_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * 0.02).to(dtype)


def init(cfg: LmConfig, gen: torch.Generator, dtype=torch.float32) -> dict:
    """Random params on ``gen``'s device, distributed as the JAX init."""
    d = cfg.d_model
    params = {
        "text_emb": _emb_init(gen, (cfg.text_in_vocab_size, d), dtype),
        "audio_embs": _emb_init(
            gen, (cfg.audio_codebooks, cfg.audio_vocab_size, d), dtype),
        "transformer": T.init(cfg.transformer, gen, dtype),
        "out_norm": norm_mod.norm_init(cfg.transformer.norm, d, dtype, gen.device),
        "text_linear": _emb_init(gen, (cfg.text_out_vocab_size, d), dtype),
    }
    if cfg.extra_heads is not None:
        n, hd = cfg.extra_heads
        params["extra_heads"] = _emb_init(gen, (n, hd, d), dtype)
    if cfg.depformer is not None:
        params["depformer"] = depformer_init(cfg, gen, dtype)
    return params


def depformer_init(cfg: LmConfig, gen: torch.Generator, dtype=torch.float32) -> dict:
    """Per-slice DepFormer weights: slice 0 embeds the text token, slices
    1.. the previous codebook's audio token; the output cannot be the
    audio pad token."""
    dep = cfg.depformer
    s, d_dep = dep.num_slices, dep.transformer.d_model
    emb_dim = dep.low_rank_embeddings or d_dep
    params = {
        "transformer": [T.init(dep.transformer, gen, dtype) for _ in range(s)],
        "linear_in": _emb_init(gen, (s, d_dep, cfg.d_model), dtype),
        "linear_out": _emb_init(gen, (s, cfg.audio_vocab_size - 1, d_dep), dtype),
        "text_emb": _emb_init(gen, (cfg.text_in_vocab_size, emb_dim), dtype),
        "audio_embs": _emb_init(gen, (s - 1, cfg.audio_vocab_size, emb_dim), dtype),
    }
    if dep.low_rank_embeddings is not None:
        params["low_rank"] = _emb_init(gen, (s, d_dep, dep.low_rank_embeddings), dtype)
    return params


def init_state(cfg: LmConfig, batch: int, cache_dtype=torch.bfloat16,
               kv_quant: bool = False, device=None, kv_bits: int = 8) -> dict:
    return {"t": T.init_state(cfg.transformer, batch, cache_dtype,
                              kv_quant=kv_quant, device=device, kv_bits=kv_bits)}


def reset_state(state: dict, reset_mask: torch.Tensor) -> dict:
    return {"t": T.reset_state(state["t"], reset_mask)}


def _masked_embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    emb = table[ids.clamp(min=0)]
    return torch.where((ids >= 0)[..., None], emb, 0.0)


def embed_inputs(cfg: LmConfig, params: dict, text_ids: torch.Tensor,
                 audio_ids: torch.Tensor,
                 condition: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of the text and per-codebook audio embeddings (plus
    ``condition``, ``(1, D)`` or ``(B, D)``) -> ``(B, 1, D)``.
    ``text_ids (B,)``, ``audio_ids (B, K)``; -1 = absent."""
    emb = _masked_embed(params["text_emb"], text_ids)  # (B, D)
    k_in = cfg.audio_codebooks
    tables = params["audio_embs"][:k_in]
    books = torch.arange(k_in, device=audio_ids.device)[None, :]
    audio = tables[books, audio_ids.clamp(min=0)]  # (B, K, D)
    audio = torch.where((audio_ids >= 0)[..., None], audio, 0.0)
    emb = emb + torch.sum(audio, dim=1)
    if condition is not None:
        emb = emb + condition
    return emb[:, None, :]


def step(cfg: LmConfig, params: dict, state: dict, text_ids: torch.Tensor,
         audio_ids: torch.Tensor, mask: Optional[torch.Tensor] = None,
         condition: Optional[torch.Tensor] = None, ca_kv=None):
    """One LM frame step -> ``(text_logits (B, V_out), hidden (B, D),
    state')``; ``hidden`` is the normalised transformer output.  ``ca_kv``:
    the voice source (``transformer.step``)."""
    emb = embed_inputs(cfg, params, text_ids, audio_ids, condition)
    ys, t_state = T.step(cfg.transformer, params["transformer"], state["t"],
                         emb, mask, ca_kv=ca_kv)
    ys = norm_mod.apply_norm(cfg.transformer.norm, params["out_norm"], ys)
    hidden = ys[:, 0, :]
    text_logits = T.mm(hidden, params["text_linear"], site="text_linear")
    return text_logits, hidden, {"t": t_state}


def extra_heads_probs(cfg: LmConfig, params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Semantic-VAD head probabilities: softmax over each head's dim, first
    component.  Returns ``(B, num_heads)`` f32."""
    w = params["extra_heads"]  # (n, hd, D)
    logits = torch.einsum("bd,nhd->bnh", hidden.float(), w.float())
    return torch.softmax(logits, dim=-1)[..., 0]


# ---------------------------------------------------------------------------
# DepFormer sampling (the lean path of dsm_tpu.models.lm.depformer_sample)
# ---------------------------------------------------------------------------


def _slice_w(w, i: int):
    """Slice ``i`` of a weight stacked on its leading axis (dense or int8)."""
    if isinstance(w, dict):
        return {**w, "q": w["q"][i], "s": w["s"][i]}  # the profile rides along
    return w[i]


def _mm_all_slices(hidden: torch.Tensor, w) -> torch.Tensor:
    """``hidden (B, D) @ linear_in_s.T`` for every slice at once -> ``(S,
    B, d_dep)``.  An int8 weight is multiplied dequantised, not as W8A8,
    as the JAX package does."""
    if isinstance(w, dict):
        y = torch.einsum("bi,soi->sbo", hidden, w["q"].to(hidden.dtype))
        return y * w["s"].to(hidden.dtype)[:, None, :]
    return torch.einsum("bi,soi->sbo", hidden, w.to(hidden.dtype))


def _dep_embed(table: torch.Tensor, token: torch.Tensor, low_rank_w) -> torch.Tensor:
    emb = table[token.long()]
    if low_rank_w is not None:
        emb = T.mm(emb, low_rank_w, site="low_rank")
    return emb


def depformer_sample(cfg: LmConfig, params: dict, hidden: torch.Tensor,
                     text_token: torch.Tensor, forced_next: torch.Tensor,
                     key: Optional[torch.Tensor], samp: S.SamplingConfig,
                     cfg_alpha=None, temperature: Optional[torch.Tensor] = None,
                     slot_keys: Optional[torch.Tensor] = None, row0: int = 0) -> torch.Tensor:
    """Sample every audio codebook of the frame -> ``tokens (B, S)`` int32.

    ``hidden (B, D)``: the temporal transformer's output; ``text_token
    (B,)``: the frame's text token; ``forced_next`` ``(S,)`` or ``(B, S)``
    overrides the token fed to the next slice (-1 = the sample).  With
    ``cfg_alpha`` (a float or a per-slot ``(B/2,)`` tensor) the rows are
    [cond..., uncond...] halves mixed as ``a*cond - (a-1)*uncond`` and both
    halves get the same token.  ``slot_keys (B', 2)`` (B' = cond rows)
    draws from per-slot streams ``fold_in(slot_key, 100 + slice)``; their
    Gumbel noise for all slices is made in one pass before the chain, since
    it depends on the keys alone.  Without slot keys, slice ``i`` draws
    with ``split(key, S)[i]``, its noise too made for every slice at once
    where the temperature is one for all rows; ``row0``: the drawing rows
    are rows ``row0 ..`` of a larger batch's draw (a dp shard's,
    ``ops/sampling.random_bits``)."""
    dp = params["depformer"]
    dep = cfg.depformer
    dcfg = dep.transformer
    b = hidden.shape[0]
    n_slices = dep.num_slices
    dev = hidden.device
    forced_next = torch.as_tensor(forced_next, dtype=torch.int32, device=dev)
    if forced_next.dim() == 1:
        forced_next = forced_next[None, :].expand(b, n_slices)

    kv = T.micro_init(dcfg, b, n_slices, hidden.dtype, dev)
    x_base = _mm_all_slices(hidden, dp["linear_in"]).to(hidden.dtype)
    n_draw = b // 2 if cfg_alpha is not None else b
    v_out = cfg.audio_vocab_size - 1
    noise = keys = None
    if slot_keys is not None:
        idx = torch.arange(100, 100 + n_slices, device=dev)[:, None]
        noise = S.gumbel(S.fold_in(slot_keys[None], idx), (v_out,))  # (S, B', V)
        t_rows = (temperature[:n_draw] if temperature is not None else
                  torch.full((n_draw,), samp.temperature, device=dev))
    else:
        keys = S.split(key, n_slices)
        if temperature is None and samp.temperature > 0.0:
            # Every slice's draws in one pass, as slice by slice (the same bits).
            noise = S.gumbel(keys, (n_draw, v_out), row0)  # (S, B', V)

    def draw(logits, i):
        if slot_keys is not None:
            return S.sample_per_slot(logits, None, t_rows, samp.top_k, noise=noise[i])
        if temperature is not None:
            return S.sample_dynamic(logits, keys[i], temperature[:n_draw], samp.top_k, row0)
        return S.sample_with_noise(samp, logits, None if noise is None else noise[i])

    def combine_and_sample(logits, i):
        if cfg_alpha is None:
            return draw(logits, i)
        half = b // 2
        a = torch.as_tensor(cfg_alpha, dtype=torch.float32, device=dev)
        if a.dim() == 1:
            a = a[:, None]
        lc, lu = logits[:half].float(), logits[half:].float()
        tok = draw(a * lc - (a - 1.0) * lu, i)
        return torch.cat([tok, tok], dim=0)

    low_rank = dp.get("low_rank")
    toks = []
    last = text_token
    for i in range(n_slices):
        table = dp["text_emb"] if i == 0 else dp["audio_embs"][i - 1]
        lr = _slice_w(low_rank, i) if low_rank is not None else None
        x = x_base[i] + _dep_embed(table, last, lr).to(hidden.dtype)
        h, kv = T.micro_step(dcfg, dp["transformer"][i], kv, x, i)
        logits = T.mm(h, _slice_w(dp["linear_out"], i), site="dep_out")
        tok = combine_and_sample(logits, i)
        toks.append(tok)
        last = torch.where(forced_next[:, i] >= 0, forced_next[:, i], tok)
    return torch.stack(toks, dim=1).to(torch.int32)


def forced_audio_tokens(cfg: LmConfig, step_idx_lt_delay: bool, device=None) -> torch.Tensor:
    """The forced next-slice tokens ``(S,)``: pads for slices 1.. while
    the step is inside the acoustic delay, else none (-1)."""
    s = cfg.generated_codebooks
    if not step_idx_lt_delay:
        return torch.full((s,), -1, dtype=torch.int32, device=device)
    toks = [-1] + [cfg.audio_pad_token] * (s - 1)
    return torch.tensor(toks, dtype=torch.int32, device=device)
