"""Delayed-streams LM, the STT side (counterpart of ``dsm_tpu/models/lm.py``).

One frame per step: the text token and one token per audio codebook are
embedded and summed (``-1`` = absent, contributes zeros), run through the
streaming temporal transformer, normalised, and projected to text logits;
the semantic-VAD extra heads read the same hidden vector.  The DepFormer
(TTS, duplex) and the presets other than stt-1b are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops import norm as norm_mod
from ..ops import transformer as T


@dataclasses.dataclass(frozen=True)
class LmConfig:
    transformer: T.TransformerConfig
    text_in_vocab_size: int
    text_out_vocab_size: int
    audio_vocab_size: int
    audio_codebooks: int
    extra_heads: Optional[Tuple[int, int]] = None  # (num_heads, dim)

    @property
    def audio_pad_token(self) -> int:
        return self.audio_vocab_size - 1

    @property
    def text_start_token(self) -> int:
        return self.text_in_vocab_size - 1

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
    return params


def init_state(cfg: LmConfig, batch: int, cache_dtype=torch.bfloat16,
               kv_quant: bool = False, device=None) -> dict:
    return {"t": T.init_state(cfg.transformer, batch, cache_dtype,
                              kv_quant=kv_quant, device=device)}


def reset_state(state: dict, reset_mask: torch.Tensor) -> dict:
    return {"t": T.reset_state(state["t"], reset_mask)}


def _masked_embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    emb = table[ids.clamp(min=0)]
    return torch.where((ids >= 0)[..., None], emb, 0.0)


def embed_inputs(cfg: LmConfig, params: dict, text_ids: torch.Tensor,
                 audio_ids: torch.Tensor) -> torch.Tensor:
    """Sum of the text and per-codebook audio embeddings -> ``(B, 1, D)``.
    ``text_ids (B,)``, ``audio_ids (B, K)``; -1 = absent."""
    emb = _masked_embed(params["text_emb"], text_ids)  # (B, D)
    k_in = cfg.audio_codebooks
    tables = params["audio_embs"][:k_in]
    books = torch.arange(k_in, device=audio_ids.device)[None, :]
    audio = tables[books, audio_ids.clamp(min=0)]  # (B, K, D)
    audio = torch.where((audio_ids >= 0)[..., None], audio, 0.0)
    return (emb + torch.sum(audio, dim=1))[:, None, :]


def step(cfg: LmConfig, params: dict, state: dict, text_ids: torch.Tensor,
         audio_ids: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """One LM frame step -> ``(text_logits (B, V_out), hidden (B, D),
    state')``; ``hidden`` is the normalised transformer output."""
    emb = embed_inputs(cfg, params, text_ids, audio_ids)
    ys, t_state = T.step(cfg.transformer, params["transformer"], state["t"],
                         emb, mask)
    ys = norm_mod.apply_norm(cfg.transformer.norm, params["out_norm"], ys)
    hidden = ys[:, 0, :]
    text_logits = T.mm(hidden, params["text_linear"])
    return text_logits, hidden, {"t": t_state}


def extra_heads_probs(cfg: LmConfig, params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Semantic-VAD head probabilities: softmax over each head's dim, first
    component.  Returns ``(B, num_heads)`` f32."""
    w = params["extra_heads"]  # (n, hd, D)
    logits = torch.einsum("bd,nhd->bnh", hidden.float(), w.float())
    return torch.softmax(logits, dim=-1)[..., 0]
