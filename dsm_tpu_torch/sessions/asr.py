"""Streaming ASR step (counterpart of ``dsm_tpu/sessions/asr.py``).

One 80 ms frame, batched over every slot:

  pcm (B, 1, 1920) -> Mimi encode -> 1-frame audio delay -> LM step
                   -> semantic-VAD probs + greedy text token
                   -> per-slot counters advance

Everything numeric stays on the device; the word assembly
(:class:`WordState`) runs on the host, as in the JAX package.  ``mask (B,)``
marks the slots with a frame this step, ``reset (B,)`` the slots handed to
a new stream before it.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..models import lm as LM
from ..models import mimi as MIMI
from ..ops import sampling as S


@dataclasses.dataclass(frozen=True)
class AsrConfig:
    lm: LM.LmConfig
    mimi: MIMI.MimiConfig
    asr_delay_in_tokens: int = 6
    temperature: float = 0.0
    text_sep_token: int = 0  # word separator
    text_pad_token: int = 3
    frame_rate: float = 12.5
    mimi_dtype: str = "float32"  # codec compute dtype; RVQ distances stay f32
    kv_quant: bool = False  # int8 LM KV rings with per-row f32 scales


def init_state(cfg: AsrConfig, batch: int, cache_dtype=torch.bfloat16,
               device=None) -> dict:
    mimi_dt = getattr(torch, cfg.mimi_dtype)
    return {
        "mimi_enc": MIMI.init_encode_state(cfg.mimi, batch, mimi_dt, device),
        "lm": LM.init_state(cfg.lm, batch, cache_dtype, kv_quant=cfg.kv_quant,
                            device=device),
        # Audio tokens of the previous frame: the 1-frame audio delay.
        "next_codebooks": torch.full((batch, cfg.lm.audio_codebooks),
                                     cfg.lm.audio_pad_token, dtype=torch.int32,
                                     device=device),
        "text_token": torch.full((batch,), cfg.lm.text_start_token,
                                 dtype=torch.int32, device=device),
        "step_idx": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def reset_slots(cfg: AsrConfig, state: dict, reset: torch.Tensor) -> dict:
    """Per-slot reset for slot reuse; KV rings untouched."""
    return {
        "mimi_enc": MIMI.reset_encode_state(state["mimi_enc"], reset),
        "lm": LM.reset_state(state["lm"], reset),
        "next_codebooks": state["next_codebooks"].masked_fill(
            reset[:, None], cfg.lm.audio_pad_token),
        "text_token": state["text_token"].masked_fill(
            reset, cfg.lm.text_start_token),
        "step_idx": state["step_idx"].masked_fill(reset, 0),
    }


def step(cfg: AsrConfig, params: dict, state: dict, pcm: torch.Tensor,
         mask: torch.Tensor, reset: torch.Tensor):
    """One batched ASR frame step -> ``(out, state')`` with ``out =
    {text_token (B,), prs (B, n_vad), step_idx (B,), codes (B, K)}``;
    ``step_idx`` counts the frames a slot has stepped, this one included."""
    state = reset_slots(cfg, state, reset)
    audio_tokens, mimi_state = MIMI.encode_step(
        cfg.mimi, params["mimi"], state["mimi_enc"],
        pcm.to(getattr(torch, cfg.mimi_dtype)), mask)
    audio_tokens = audio_tokens[..., 0]  # (B, K) int32

    is_first = state["step_idx"] == 0
    lm_audio_in = state["next_codebooks"].masked_fill(
        is_first[:, None], cfg.lm.audio_pad_token)
    next_codebooks = torch.where(mask[:, None], audio_tokens,
                                 state["next_codebooks"])
    text_in = state["text_token"].masked_fill(is_first, cfg.lm.text_start_token)

    text_logits, hidden, lm_state = LM.step(
        cfg.lm, params["lm"], state["lm"], text_in, lm_audio_in, mask)

    if cfg.lm.extra_heads is not None:
        prs = LM.extra_heads_probs(cfg.lm, params["lm"], hidden)
    else:
        prs = torch.zeros((pcm.shape[0], 0), dtype=torch.float32,
                          device=pcm.device)
    text_token = S.sample(S.SamplingConfig(temperature=cfg.temperature),
                          text_logits.float())

    new_text = torch.where(mask, text_token, state["text_token"])
    new_step = state["step_idx"] + mask.to(torch.int32)
    out = {"text_token": new_text, "prs": prs, "step_idx": new_step,
           "codes": audio_tokens}
    new_state = {"mimi_enc": mimi_state, "lm": lm_state,
                 "next_codebooks": next_codebooks, "text_token": new_text,
                 "step_idx": new_step}
    return out, new_state


# ---------------------------------------------------------------------------
# Host-side word assembly (a copy of the JAX module's, which imports jax)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WordEvent:
    tokens: List[int]
    start_time: float
    batch_idx: int


@dataclasses.dataclass
class EndWordEvent:
    stop_time: float
    batch_idx: int


@dataclasses.dataclass
class StepEvent:
    step_idx: int
    prs: List[List[float]]


class WordState:
    """Per-slot word accumulation with 12.5 Hz timestamps."""

    def __init__(self, cfg: AsrConfig, batch: int):
        self.cfg = cfg
        self.batch = batch
        self.word_tokens: List[List[int]] = [[] for _ in range(batch)]
        self.unended_word = [False] * batch
        self.last_stop_time = [0.0] * batch

    def reset_slot(self, idx: int) -> None:
        self.word_tokens[idx] = []
        self.unended_word[idx] = False
        self.last_stop_time[idx] = 0.0

    def process(self, text_tokens, step_idx, mask) -> List[object]:
        """Events from one step's host arrays ``(B,)``."""
        cfg = self.cfg
        events: List[object] = []
        for b in range(self.batch):
            if not mask[b]:
                continue
            tok = int(text_tokens[b])
            steps = int(step_idx[b])
            if steps < cfg.asr_delay_in_tokens:
                continue
            if tok in (cfg.text_pad_token, cfg.text_sep_token):
                if self.word_tokens[b]:
                    events.append(
                        WordEvent(self.word_tokens[b], self.last_stop_time[b], b))
                    self.word_tokens[b] = []
                    self.unended_word[b] = True
            else:
                self.word_tokens[b].append(tok)
            if tok == cfg.text_sep_token:
                stop_time = (steps - cfg.asr_delay_in_tokens) / cfg.frame_rate
                if self.unended_word[b]:
                    self.unended_word[b] = False
                    events.append(EndWordEvent(stop_time, b))
                self.last_stop_time[b] = stop_time
        return events
