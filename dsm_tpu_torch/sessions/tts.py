"""Streaming TTS step, continuously batched (counterpart of
``dsm_tpu/sessions/tts.py``).

Per 80 ms frame and slot:

  * build the delayed audio-token inputs (codebook 0 delay 0, the others
    ``acoustic_delay``; inside the text-audio window the non-pad tokens are
    absent, -1);
  * run the LM (voice cross-attention, optional classifier-free guidance
    as a doubled batch [cond rows..., uncond rows...]);
  * pick the text token under the host's constraint (a forced word piece,
    a pad, or the model's choice between pad and end-of-word);
  * sample the audio codebooks with the DepFormer and write them at their
    delayed positions of the slot's token buffer.

Every slot has its own step counter, so sessions of any age step together.
Sampling with ``seeds`` draws from per-slot streams keyed by (seed, step,
draw index), as the JAX package does; the tokens then do not depend on the
batch.  The step returns new tensors for the buffers it changes; the LM's
rings are updated in place.  :func:`step_in_place` writes those tensors back
into the state's own buffers, the form a captured CUDA graph replays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models import lm as LM
from ..ops import sampling as S
from ..utils.state import copy_into

UNGENERATED = -1  # token-buffer entries not written yet

# Constraint modes for the text token.
ALLOW_TEXT = 0  # force the given token (the next word piece)
ALLOW_PAD = 1  # force pad
ALLOW_PAD_OR_EPAD = 2  # the model chooses pad; anything else becomes eop


@dataclasses.dataclass(frozen=True)
class TtsConfig:
    lm: LM.LmConfig
    acoustic_delay: int = 2
    text_pad_token: int = 3
    text_bos_token: int = 1
    text_eos_token: int = 2
    text_eop_token: int = 0
    text_start_token: int = 8000
    text_audio_delay_in_tokens: int = 25  # 2 s at 12.5 Hz
    max_consecutive_pads: int = 10
    extra_steps: int = 5
    max_steps: int = 4096
    speaker_cond_duration_s: float = 10.0
    speaker_cond_dim: int = 2048
    speaker_cond_n_speakers: int = 5
    temperature: float = 0.8
    top_k: int = 250
    text_temperature: float = 0.6
    text_top_k: int = 25
    cfg_alpha: Optional[float] = None
    kv_quant: bool = False

    @property
    def n_codebooks(self) -> int:
        return self.lm.generated_codebooks


def init_state(cfg: TtsConfig, batch: int, cache_dtype=torch.bfloat16,
               device=None) -> dict:
    k = cfg.n_codebooks
    cap = cfg.max_steps + cfg.acoustic_delay

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.int32, device=device)

    return {
        "lm": LM.init_state(cfg.lm, batch, cache_dtype, kv_quant=cfg.kv_quant,
                            device=device),
        "audio_tokens": full((batch, cap, k), UNGENERATED),
        "text_tokens": full((batch, cap), UNGENERATED),
        "consecutive_pads": full((batch,), 0),
        "prev_text": full((batch,), cfg.text_start_token),
        "step_idx": full((batch,), 0),
    }


def reset_slots(cfg: TtsConfig, state: dict, reset: torch.Tensor) -> dict:
    """Per-slot reset for slot reuse; the LM rings are untouched."""
    return {
        "lm": LM.reset_state(state["lm"], reset),
        "audio_tokens": state["audio_tokens"].masked_fill(reset[:, None, None],
                                                          UNGENERATED),
        "text_tokens": state["text_tokens"].masked_fill(reset[:, None], UNGENERATED),
        "consecutive_pads": state["consecutive_pads"].masked_fill(reset, 0),
        "prev_text": state["prev_text"].masked_fill(reset, cfg.text_start_token),
        "step_idx": state["step_idx"].masked_fill(reset, 0),
    }


def _delays(cfg: TtsConfig, device) -> torch.Tensor:
    d = torch.full((cfg.n_codebooks,), cfg.acoustic_delay, dtype=torch.int32,
                   device=device)
    d[:1].fill_(0)  # a fill, not a copy from the host: the tick is captured on the card
    return d[None, :]


def _take(buf: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``buf[b, pos[b, k], k]`` for ``buf (B, cap, K)``, ``pos (B, K)``."""
    return buf.gather(1, pos[:, None, :].long())[:, 0, :]


def _delayed_input_tokens(cfg: TtsConfig, state: dict) -> torch.Tensor:
    """Audio-token inputs of this step ``(B, K)``, -1 = absent: pad inside
    the codebook's delay, absent inside the text-audio window, else the
    delayed buffer read ``buf[b, s_b - 1 - delay_k, k]``."""
    s = state["step_idx"][:, None]
    delays = _delays(cfg, s.device)
    read = _take(state["audio_tokens"], torch.clamp(s - 1 - delays, min=0))
    in_delay = s <= delays
    in_zero = ~in_delay & (s <= cfg.text_audio_delay_in_tokens + delays)
    tok = torch.where(in_delay, cfg.lm.audio_pad_token, read)
    return torch.where(in_zero, UNGENERATED, tok).to(torch.int32)


def step(cfg: TtsConfig, params: dict, state: dict, allowed_mode: torch.Tensor,
         allowed_token: torch.Tensor, rng: Optional[torch.Tensor] = None,
         ca_kv=None, condition: Optional[torch.Tensor] = None,
         mask: Optional[torch.Tensor] = None, reset: Optional[torch.Tensor] = None,
         temps: Optional[dict] = None, seeds: Optional[torch.Tensor] = None,
         cfg_alpha=None):
    """One TTS frame for every slot -> ``(out, state')``.

    ``out``: the text token written this step, the delay-resolved audio
    frame ``(B, K)`` with ``frame_valid`` (False while the acoustic delay has
    not elapsed, and for frozen slots), and ``step_idx``.  ``mask`` freezes
    inactive slots; ``reset`` re-initialises reused slots first.  ``seeds``
    (per slot) select per-slot key streams; without them ``rng (2,)`` is
    split as in the JAX package.  ``temps``: per-slot ``{"text", "audio"}``
    temperatures; ``cfg_alpha``: a float or per-slot ``(B/2,)`` guidance."""
    lm_cfg = cfg.lm
    b = allowed_mode.shape[0]
    dev = allowed_mode.device
    if mask is None:
        mask = torch.ones((b,), dtype=torch.bool, device=dev)
    if reset is not None:
        state = reset_slots(cfg, state, reset)
    s = state["step_idx"]

    audio_in = _delayed_input_tokens(cfg, state)
    text_logits, hidden, lm_state = LM.step(
        lm_cfg, params["lm"], state["lm"], state["prev_text"], audio_in,
        mask=mask, condition=condition, ca_kv=ca_kv)

    alpha = cfg_alpha if cfg_alpha is not None else cfg.cfg_alpha
    n_draw = b // 2 if alpha is not None else b
    k_text = k_dep = key_rows = dep_keys = None
    if seeds is not None:
        key_rows = S.slot_keys(seeds[:n_draw], s[:n_draw])
        dep_keys = S.fold_keys(key_rows, 2)
    else:
        _, k_text, k_dep = S.split(rng, 3)

    logits = text_logits.float()
    if alpha is not None:
        a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
        if a.dim() == 1:
            a = a[:, None]
        mixed = a * logits[:n_draw] - (a - 1.0) * logits[n_draw:]
        logits = torch.cat([mixed, mixed], dim=0)
    if seeds is not None:
        t = (temps["text"][:n_draw] if temps is not None else
             torch.full((n_draw,), cfg.text_temperature, device=dev))
        sampled = S.sample_per_slot(logits[:n_draw], S.fold_keys(key_rows, 1), t,
                                    cfg.text_top_k)
    elif temps is not None:
        t = torch.broadcast_to(torch.as_tensor(temps["text"], device=dev), (b,))
        sampled = S.sample_dynamic(logits[:n_draw], k_text, t[:n_draw], cfg.text_top_k)
    else:
        sampled = S.sample(S.SamplingConfig(cfg.text_temperature, cfg.text_top_k),
                           logits[:n_draw], k_text)
    sampled = torch.cat([sampled] * (b // n_draw), dim=0)

    # Pad-or-end-of-word: the model's choice collapses to {pad, eop}; too
    # many pads in a row force eop.
    pad, eop = cfg.text_pad_token, cfg.text_eop_token
    pad_or_epad = torch.where(sampled == pad, pad, eop)
    pad_or_epad = torch.where(state["consecutive_pads"] > cfg.max_consecutive_pads,
                              eop, pad_or_epad)
    text_token = torch.where(
        allowed_mode == ALLOW_TEXT, allowed_token,
        torch.where(allowed_mode == ALLOW_PAD, pad, pad_or_epad)).to(torch.int32)
    consecutive_pads = torch.where(text_token == pad, state["consecutive_pads"] + 1, 0)

    # The DepFormer runs for every row; rows inside the text-audio window
    # take pads.  Pads are forced into slices 1.. inside the acoustic delay.
    k_arr = torch.arange(cfg.n_codebooks, device=dev)
    forced = torch.where((s[:, None] < cfg.acoustic_delay) & (k_arr[None, :] > 0),
                         lm_cfg.audio_pad_token, -1).to(torch.int32)
    dep_tokens = LM.depformer_sample(
        lm_cfg, params["lm"], hidden, text_token, forced, k_dep,
        S.SamplingConfig(cfg.temperature, cfg.top_k), cfg_alpha=alpha,
        temperature=None if temps is None else temps["audio"], slot_keys=dep_keys)
    audio_tokens = torch.where((s < cfg.text_audio_delay_in_tokens)[:, None],
                               lm_cfg.audio_pad_token, dep_tokens)

    # Delayed writes: codebook 0 at step s, the others at s - acoustic_delay,
    # only where the entry is still unwritten; frozen slots write nothing.
    buf = state["audio_tokens"]
    write_pos = torch.clamp(s[:, None] - _delays(cfg, dev), min=0).long()
    cur = _take(buf, write_pos)
    newval = torch.where(cur == UNGENERATED, audio_tokens, cur)
    newval = torch.where(mask[:, None], newval, cur).to(torch.int32)
    buf = buf.scatter(1, write_pos[:, None, :], newval[:, None, :])

    rows = torch.arange(b, device=dev)
    text_written = torch.where(mask, text_token, state["prev_text"])
    text_buf = state["text_tokens"].clone()
    text_buf[rows, s.long()] = torch.where(mask, text_token,
                                           state["text_tokens"][rows, s.long()])

    # The completed frame at s - acoustic_delay.
    frame_pos = torch.clamp(s - cfg.acoustic_delay, min=0)
    frame = _take(buf, frame_pos[:, None].expand(b, cfg.n_codebooks))
    complete = (s >= cfg.acoustic_delay) & (frame != UNGENERATED).all(dim=1)
    frame_valid = complete & (frame < lm_cfg.audio_pad_token).all(dim=1) & mask

    new_step = s + mask.to(torch.int32)
    out = {"text_token": text_written, "frame": frame, "frame_valid": frame_valid,
           "step_idx": new_step}
    new_state = {
        "lm": lm_state,
        "audio_tokens": buf,
        "text_tokens": text_buf,
        "consecutive_pads": torch.where(mask, consecutive_pads,
                                        state["consecutive_pads"]).to(torch.int32),
        "prev_text": text_written,
        "step_idx": new_step,
    }
    return out, new_state


def step_in_place(cfg: TtsConfig, params: dict, state: dict, allowed_mode: torch.Tensor,
                  allowed_token: torch.Tensor, **kw) -> dict:
    """:func:`step` on state buffers that stay the same from tick to tick
    (the counterpart of the JAX engine's ``donate_argnums``): the step, then
    every state tensor it replaced (``audio_tokens``, ``text_tokens``,
    ``consecutive_pads``, ``prev_text``, ``step_idx``, the LM's ``pos`` and
    ``valid``) written back into ``state``'s own tensor with ``copy_``; the
    LM's rings are written in place by the step already.  Keywords as
    :func:`step`'s; returns ``out``.  Its launches can be captured in a CUDA
    graph (``server/tts_batched.py``) and replayed on the same buffers."""
    out, new_state = step(cfg, params, state, allowed_mode, allowed_token, **kw)
    copy_into(state, new_state)
    return out


def overwrite_last_text_token(state: dict, token: int,
                              slots: Optional[torch.Tensor] = None) -> dict:
    """Replace the last written text token of the ``slots (B,)`` (all by
    default) by ``token``: the pad over a session's final end-of-word."""
    b = state["prev_text"].shape[0]
    dev = state["prev_text"].device
    sel = (torch.ones((b,), dtype=torch.bool, device=dev) if slots is None
           else torch.as_tensor(slots, device=dev))
    rows = torch.arange(b, device=dev)
    s_prev = torch.clamp(state["step_idx"] - 1, min=0).long()
    text_buf = state["text_tokens"].clone()
    text_buf[rows, s_prev] = torch.where(sel, token, text_buf[rows, s_prev]).to(torch.int32)
    out = dict(state)
    out["text_tokens"] = text_buf
    out["prev_text"] = torch.where(sel, token, state["prev_text"]).to(torch.int32)
    return out


def overwrite_last_text_token_in_place(state: dict, token: int,
                                       slots: Optional[torch.Tensor] = None) -> None:
    """:func:`overwrite_last_text_token` written into ``state``'s own
    ``text_tokens`` and ``prev_text``, so that a captured tick that reads
    them sees the pad."""
    copy_into(state, overwrite_last_text_token(state, token, slots))


def tokenize_prompt(turns, bos: int, eos: int, encode) -> list:
    """Multi-speaker turns -> ``[(word_tokens, is_main)]``: even turns are
    the main speaker (bos before their first word), odd turns the other
    speaker (eos)."""
    prompt = []
    for turn_idx, turn in enumerate(turns):
        main = turn_idx % 2 == 0
        token = bos if main else eos
        for word_idx, word in enumerate(turn.split(" ")):
            ids = list(encode(word))
            if word_idx == 0 and main:
                ids.insert(0, token)
            if ids:
                prompt.append((ids, main))
    return prompt
