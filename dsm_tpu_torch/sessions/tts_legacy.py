"""The legacy T5-conditioned TTS (counterpart of
``dsm_tpu/sessions/tts_legacy.py``; moshi-core's tts.rs).

A text encoder's hidden states (T5) are projected to the LM's width and
become the cross-attention source; the LM generates audio tokens only (no
text stream): codebook 0 at delay 0, the acoustic codebooks at delay 2.
Generation stops once a sampled id reaches ``quantizer_bins`` (the
end-of-generation id), after two more steps that flush the delayed acoustic
tokens (tts.rs ``sample_lp``).

:func:`conditions` builds the source: the projected text states alone, or,
with a speaker sample, the two classifier-free-guidance rows
``[text | speaker | zeros...]`` and ``[text | zeros | zeros...]`` with the
sinusoidal position embedding added.  :func:`step` runs on the device
without reading back; :func:`sample` reads the end-of-generation flag once
a step.  The T5 encoder itself is not part of the port:
:func:`encode_text_t5` runs the ``transformers`` one where it is installed
and raises where it is not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models import lm as LM
from ..models import mimi as MIMI
from ..models.speaker import add_sin_embeddings
from ..ops import sampling as S
from ..ops import transformer as T

ACOUSTIC_DELAY = 2
UNSET = -1


@dataclasses.dataclass(frozen=True)
class LegacyTtsConfig:
    lm: LM.LmConfig
    mimi: Optional[MIMI.MimiConfig] = None
    max_duration_s: float = 60.0
    speaker_cond_duration_s: float = 10.0
    max_speakers: int = 2
    frame_rate: float = 12.5
    temperature: float = 0.8
    top_k: int = 100

    @property
    def max_steps(self) -> int:
        return int(self.max_duration_s * self.frame_rate) + 3

    @property
    def quantizer_bins(self) -> int:
        # audio_vocab_size = bins + end-of-generation + pad
        return self.lm.audio_vocab_size - 2


def conditions(cfg: LegacyTtsConfig, params: dict, text_states: torch.Tensor,
               t5_proj: torch.Tensor, speaker_pcm: Optional[torch.Tensor] = None,
               speaker_proj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The cross-attention source, f32.  ``text_states (1, T, d_t5)`` (the
    T5 encoder's output), ``t5_proj (d_t5, d_model)``.  Without a speaker
    sample: ``(1, T, d_model)``.  With ``speaker_pcm (1, 1, n)`` (through
    ``params["mimi"]``'s encoder, no quantiser) and ``speaker_proj (d_mimi,
    d_model)``: the two guidance rows, position embeddings added."""
    txt = text_states.float() @ t5_proj.float()
    if speaker_pcm is None:
        return txt
    if cfg.mimi is None or speaker_proj is None:
        raise ValueError("a speaker sample needs cfg.mimi and speaker_proj")
    emb = MIMI.encode_pre_quantize(cfg.mimi, params["mimi"], speaker_pcm)
    sc = emb.transpose(1, 2).float() @ speaker_proj.float()
    z = torch.zeros_like(sc)
    pads = [z] * (cfg.max_speakers - 1)
    c1 = torch.cat([txt, sc] + pads, dim=1)
    c2 = torch.cat([txt, z] + pads, dim=1)
    return add_sin_embeddings(torch.cat([c1, c2], dim=0))


def init_state(cfg: LegacyTtsConfig, cfg_rows: int, cache_dtype=torch.bfloat16,
               device=None) -> dict:
    """``cfg_rows`` = 2 with classifier-free guidance, else 1."""
    k = cfg.lm.audio_codebooks
    return {
        "lm": LM.init_state(cfg.lm, cfg_rows, cache_dtype, device=device),
        "audio_tokens": torch.full((cfg.max_steps, k), UNSET, dtype=torch.int32, device=device),
        "step_idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def step(cfg: LegacyTtsConfig, params: dict, state: dict, rng: torch.Tensor, ca_kv,
         cfg_alpha: Optional[float] = None):
    """One audio-only step -> ``({"tokens" (K,), "end_of_gen" 0-d bool},
    state')``; the token buffer is written in place.

    Inputs come from the delayed buffer: codebook 0 reads its previous
    token, the acoustic codebooks the row ``step - 3`` (delay 2 plus the
    frame's shift), pads inside the warm-up window; the acoustic slices are
    forced to pads while ``step < 2``."""
    lm_cfg = cfg.lm
    s = state["step_idx"]
    buf = state["audio_tokens"]
    dev = buf.device
    k = lm_cfg.audio_codebooks
    books = torch.arange(k, device=dev)
    pad = lm_cfg.audio_pad_token

    # Rows are indexed by (1,)-tensors: a 0-d index would be read on the host.
    at = s.reshape(1).long()
    cb0 = torch.where(s == 0, pad, buf[torch.clamp(at - 1, min=0), 0])
    acoustic = torch.where(s <= ACOUSTIC_DELAY, pad, buf[torch.clamp(at - 3, min=0)][0])
    audio_in_1 = torch.cat([cb0, acoustic[1:]])[None, :]
    n_rows = 2 if cfg_alpha is not None else 1
    audio_in = audio_in_1.expand(n_rows, k)
    text_in = torch.full((n_rows,), UNSET, dtype=torch.int32, device=dev)  # no text stream

    _, hidden, lm_state = LM.step(lm_cfg, params["lm"], state["lm"], text_in, audio_in,
                                  ca_kv=ca_kv)
    forced_next = torch.where((s < ACOUSTIC_DELAY) & (books > 0), pad, UNSET).to(torch.int32)
    tokens = LM.depformer_sample(
        lm_cfg, params["lm"], hidden, text_in, forced_next, rng,
        S.SamplingConfig(cfg.temperature, cfg.top_k), cfg_alpha=cfg_alpha)[0]

    # Delayed writes: codebook 0 at the step, the acoustic ones at step - 2.
    buf[at, 0] = tokens[:1]
    wa = torch.clamp(at - ACOUSTIC_DELAY, min=0)
    buf[wa] = torch.where(books > 0, tokens, buf[wa][0])[None]

    eog = (s > 0) & torch.any(tokens >= cfg.quantizer_bins)
    new_state = {"lm": lm_state, "audio_tokens": buf, "step_idx": s + 1}
    return {"tokens": tokens, "end_of_gen": eog}, new_state


def sample(cfg: LegacyTtsConfig, params: dict, ca_src: torch.Tensor, seed: int = 299792458,
           cfg_alpha: Optional[float] = None, max_steps: Optional[int] = None) -> np.ndarray:
    """The whole generation on the device of ``ca_src``, bf16 rings -> ``(T, K)`` int32
    audio tokens, cut to the leading run of frames that are fully written
    and in range.  ``ca_src`` has 2 rows with ``cfg_alpha``, else 1."""
    n_rows = 2 if cfg_alpha is not None else 1
    if ca_src.shape[0] != n_rows:
        raise ValueError(f"ca_src has {ca_src.shape[0]} rows, guidance needs {n_rows}")
    dev = ca_src.device
    with torch.inference_mode():
        ca_kv = T.precompute_ca_kv(cfg.lm.transformer, params["lm"]["transformer"], ca_src)
        state = init_state(cfg, n_rows, device=dev)
        n = min(max_steps or cfg.max_steps, cfg.max_steps - 1)
        rng = S.prng_key(seed)
        keys = []
        for _ in range(n):
            rng, sub = S.split(rng)
            keys.append(sub)
        keys = torch.stack(keys).to(dev) if keys else None
        end_at = None
        for i in range(n):
            out, state = step(cfg, params, state, keys[i], ca_kv, cfg_alpha=cfg_alpha)
            if end_at is None and bool(out["end_of_gen"]):
                end_at = i + ACOUSTIC_DELAY  # flush the delayed acoustic tokens
            if end_at is not None and i >= end_at:
                break
        buf = state["audio_tokens"].cpu().numpy()
    valid = (buf >= 0).all(axis=1) & (buf < cfg.quantizer_bins).all(axis=1)
    t = int(np.argmin(valid)) if not valid.all() else buf.shape[0]
    return buf[:t]


def encode_text_t5(text: str, model_name: str = "t5-base") -> torch.Tensor:
    """``(1, T, d_t5)`` f32 states of a HuggingFace T5 encoder, on the CPU.
    Needs the ``transformers`` package and the model's files; raises
    RuntimeError without the package."""
    try:
        from transformers import AutoTokenizer, T5EncoderModel
    except Exception as e:
        raise RuntimeError(f"transformers unavailable: {e}") from e
    tok = AutoTokenizer.from_pretrained(model_name)
    model = T5EncoderModel.from_pretrained(model_name)
    with torch.no_grad():
        ids = tok(text, return_tensors="pt").input_ids
        return model(input_ids=ids).last_hidden_state.float()
