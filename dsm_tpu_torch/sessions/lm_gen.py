"""Full-duplex dialogue step, continuously batched (counterpart of
``dsm_tpu/sessions/lm_gen.py``).

Per 80 ms frame and slot the LM consumes the codebooks it generated itself
(its own voice, delayed: the semantic codebook by one frame, the acoustic
ones by ``acoustic_delay`` more) and the user's codebooks from Mimi, samples
a text token (optional pad bias and repetition penalty on the text logits)
and, through the DepFormer, the generated audio codebooks, which it writes
at their delayed positions of the slot's token buffer.

Every slot has its own step counter; ``mask`` freezes inactive slots and
``reset`` restarts reused ones, as data.  One key draws for the whole batch
(``split(rng, 3)``), as in the JAX package.  Unlike the JAX step, which
returns new arrays, this one updates the token buffers and the LM's rings
in place: a masked slot's entries are gathered before the write and written
back, so no buffer is copied.  Past the end of a slot's buffers
(``max_steps + acoustic_delay`` entries) a write is dropped and a read gives
the smallest int32, an absent token, as JAX's scatter and
``take_along_axis`` do.  :func:`step_in_place` also writes the counters and
the LM's position and bitmap back into the state's own buffers, the form a
captured CUDA graph replays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..models import lm as LM
from ..ops import sampling as S
from ..utils.state import copy_into

UNGENERATED = -1
_OUT_OF_RANGE = torch.iinfo(torch.int32).min  # what a read past the buffer's end gives


@dataclasses.dataclass(frozen=True)
class DuplexConfig:
    lm: LM.LmConfig
    generated_audio_codebooks: int = 8
    input_audio_codebooks: int = 8
    acoustic_delay: int = 2
    text_pad_token: int = 3
    text_eop_token: int = 0
    text_start_token: int = 32000
    max_steps: int = 4096
    audio_temperature: float = 0.8
    audio_top_k: int = 250
    text_temperature: float = 0.7
    text_top_k: int = 25
    pad_mult: Optional[float] = None
    repetition_penalty: Optional[Tuple[int, float]] = None  # (context, penalty)

    @property
    def total_codebooks(self) -> int:
        return self.generated_audio_codebooks + self.input_audio_codebooks


def init_state(cfg: DuplexConfig, batch: int = 1, cache_dtype=torch.bfloat16,
               kv_quant: bool = False, device=None, kv_bits: int = 8) -> dict:
    cap = cfg.max_steps + cfg.acoustic_delay

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.int32, device=device)

    return {
        "lm": LM.init_state(cfg.lm, batch, cache_dtype, kv_quant=kv_quant, device=device,
                            kv_bits=kv_bits),
        "audio_tokens": full((batch, cap, cfg.total_codebooks), UNGENERATED),
        "text_tokens": full((batch, cap), UNGENERATED),
        "prev_text": full((batch,), cfg.text_start_token),
        "step_idx": full((batch,), 0),
    }


def reset_slots(cfg: DuplexConfig, state: dict, reset: torch.Tensor) -> dict:
    """Restart the given slots' dialogues, in place: the LM's validity rows
    cleared, the token buffers wiped, the counters at 0."""
    LM.reset_state(state["lm"], reset)
    state["audio_tokens"].masked_fill_(reset[:, None, None], UNGENERATED)
    state["text_tokens"].masked_fill_(reset[:, None], UNGENERATED)
    state["prev_text"].masked_fill_(reset, cfg.text_start_token)
    state["step_idx"].masked_fill_(reset, 0)
    return state


def _rep_penalty(cfg: DuplexConfig, logits: torch.Tensor, text_buf: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """Repetition penalty over the last ``context`` text tokens that are
    neither pad, end-of-word, start nor unwritten: their positive logits
    are divided by ``penalty``, their negative ones multiplied."""
    if cfg.repetition_penalty is None:
        return logits
    context, penalty = cfg.repetition_penalty
    if penalty == 1.0:
        return logits
    b, v = logits.shape
    dev = logits.device
    window = 4 * context  # enough to find `context` such tokens
    idx = torch.arange(window, device=dev)
    s = torch.as_tensor(s, device=dev).reshape(-1)  # scalar or per-slot (B,)
    pos = s[:, None] - 1 - idx[None, :]  # (B, window), most recent first
    pos = pos.expand(b, window)
    toks = text_buf.gather(1, pos.clamp(0, text_buf.shape[1] - 1).long())
    special = ((toks == cfg.text_pad_token) | (toks == cfg.text_eop_token)
               | (toks == cfg.text_start_token) | (toks == UNGENERATED))
    eligible = (pos >= 0) & ~special
    keep = eligible & (torch.cumsum(eligible.to(torch.int32), dim=1) <= context)
    safe = torch.where(keep, toks, 0).long()
    # A sum, so that a duplicate or a dropped token cannot undo a kept one.
    seen = torch.zeros((b, v), dtype=torch.int32, device=dev)
    seen.scatter_add_(1, safe, keep.to(torch.int32))
    scale = torch.where(logits >= 0, 1.0 / penalty, penalty)
    return torch.where(seen > 0, logits * scale, logits)


def _put(buf: torch.Tensor, pos: torch.Tensor, cols: torch.Tensor,
         vals: torch.Tensor, live: torch.Tensor) -> None:
    """``buf[b, pos[b, k], cols[k]] = vals[b, k]`` for the slots ``live``,
    in place; the other slots keep their entries, and a position past the
    buffer's end is not written."""
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    ok = live[:, None] & (pos < buf.shape[1])
    idx = (rows, pos.clamp(max=buf.shape[1] - 1).long(), cols[None, :])
    buf[idx] = torch.where(ok, vals.to(buf.dtype), buf[idx])


def step(cfg: DuplexConfig, params: dict, state: dict,
         input_audio_tokens: torch.Tensor, rng: torch.Tensor,
         force_text_token: Optional[torch.Tensor] = None, ca_kv=None,
         condition: Optional[torch.Tensor] = None,
         cfg_alpha: Optional[float] = None, asr_delay=None,
         mask: Optional[torch.Tensor] = None, reset: Optional[torch.Tensor] = None,
         row0: int = 0):
    """One duplex frame for every slot -> ``(out, state)``, the state being
    the input, updated in place.

    ``input_audio_tokens (B, input_codebooks)``: the user's codes from Mimi;
    ``rng (2,)``: this step's key.  ``out``: ``text_token (B,)``, the
    delay-resolved ``frame (B, gen)`` of the model's own speech with
    ``frame_valid``, the raw DepFormer samples ``audio_tokens`` and the new
    ``step_idx``.  ``force_text_token (B,)`` (>= 0) overrides the sample.
    ``asr_delay`` (an int or per-slot ``(B,)``; 0 = off) hides the text
    input for steps ``0 < s < delay`` (the -1 sentinel embeds to zeros)
    while sampling goes on.  ``mask`` freezes inactive slots (no buffer
    write, counter and ``prev_text`` kept); ``reset`` restarts slots before
    the step.  ``cfg_alpha``: rows are [cond..., uncond...] halves.
    ``row0``: these slots are rows ``row0 ..`` of a larger batch, whose draws
    they take (a dp shard of a meshed engine draws the unmeshed batch's)."""
    if reset is not None:
        state = reset_slots(cfg, state, reset)
    s = state["step_idx"]
    lm_cfg = cfg.lm
    gen = cfg.generated_audio_codebooks
    buf = state["audio_tokens"]
    b, cap = buf.shape[0], buf.shape[1]
    dev = buf.device
    active = mask if mask is not None else torch.ones((b,), dtype=torch.bool, device=dev)

    # The user's audio tokens of this step (input group).
    if cfg.input_audio_codebooks:
        in_cols = gen + torch.arange(cfg.input_audio_codebooks, device=dev)
        _put(buf, s[:, None].expand(b, cfg.input_audio_codebooks), in_cols,
             input_audio_tokens, active)

    # Model inputs under the delay pattern: the first codebook of each
    # group is one frame late, the acoustic ones acoustic_delay more.
    k_arr = torch.arange(cfg.total_codebooks, device=dev)
    is_semantic = (k_arr == 0) | (k_arr == gen)
    delays = torch.where(is_semantic, 1, cfg.acoustic_delay + 1)
    read_pos = (s[:, None] - delays[None, :]).clamp(min=0)  # (B, K)
    read = buf.gather(1, read_pos.clamp(max=cap - 1)[:, None, :].long())[:, 0, :]
    read = torch.where(read_pos < cap, read, _OUT_OF_RANGE)
    pad = lm_cfg.audio_pad_token
    first = torch.where(is_semantic[None, :], s[:, None] == 0,
                        s[:, None] <= cfg.acoustic_delay)
    audio_in = torch.where(first, pad, read).to(torch.int32)

    text_in = state["prev_text"]
    if asr_delay is not None:
        d = torch.as_tensor(asr_delay, dtype=torch.int32, device=dev)
        text_in = torch.where((s > 0) & (s < d), -1, text_in).to(torch.int32)
    text_logits, hidden, state["lm"] = LM.step(
        lm_cfg, params["lm"], state["lm"], text_in, audio_in, mask=mask, ca_kv=ca_kv,
        condition=condition)
    logits = text_logits.float()
    if cfg_alpha is not None:
        half = b // 2
        logits = cfg_alpha * logits[:half] - (cfg_alpha - 1.0) * logits[half:]
        logits = torch.cat([logits, logits], dim=0)
    logits = _rep_penalty(cfg, logits, state["text_tokens"], s)
    if cfg.pad_mult is not None:
        # exp(pad_mult) on the pad's probability = pad_mult on its logit.
        logits = logits.clone()
        logits[:, cfg.text_pad_token] += cfg.pad_mult

    _, k_text, k_dep = S.split(rng, 3)
    text_token = S.sample(S.SamplingConfig(cfg.text_temperature, cfg.text_top_k),
                          logits, k_text, row0)
    if force_text_token is not None:
        text_token = torch.where(force_text_token >= 0, force_text_token,
                                 text_token).to(torch.int32)

    g_arr = torch.arange(gen, device=dev)
    forced = torch.where((s[:, None] < cfg.acoustic_delay) & (g_arr[None, :] > 0),
                         pad, -1).to(torch.int32)
    audio_tokens = LM.depformer_sample(
        lm_cfg, params["lm"], hidden, text_token, forced, k_dep,
        S.SamplingConfig(cfg.audio_temperature, cfg.audio_top_k), cfg_alpha=cfg_alpha,
        row0=row0)

    # Generated tokens at their delayed positions (the saturating first
    # frames overwrite position 0).
    wdel = torch.where(g_arr == 0, 0, cfg.acoustic_delay)
    _put(buf, (s[:, None] - wdel[None, :]).clamp(min=0), g_arr, audio_tokens, active)

    text_buf = state["text_tokens"]
    rows = torch.arange(b, device=dev)
    s_safe = s.clamp(max=cap - 1).long()
    text_buf[rows, s_safe] = torch.where(active & (s < cap), text_token,
                                          text_buf[rows, s_safe])
    state["prev_text"] = torch.where(active, text_token, state["prev_text"]).to(torch.int32)
    state["step_idx"] = s + active.to(torch.int32)

    frame_pos = (s - cfg.acoustic_delay).clamp(min=0)
    frame = buf[rows, frame_pos.clamp(max=cap - 1).long(), :gen]
    frame = torch.where((frame_pos < cap)[:, None], frame, _OUT_OF_RANGE)
    frame_valid = ((s >= cfg.acoustic_delay) & active
                   & ((frame >= 0) & (frame < lm_cfg.audio_vocab_size - 1)).all(dim=1))
    out = {"text_token": text_token, "frame": frame, "frame_valid": frame_valid,
           "audio_tokens": audio_tokens, "step_idx": state["step_idx"]}
    return out, state


def step_in_place(cfg: DuplexConfig, params: dict, state: dict,
                  input_audio_tokens: torch.Tensor, rng: torch.Tensor, **kw) -> dict:
    """:func:`step` on state buffers that stay the same from tick to tick
    (the counterpart of the JAX engine's ``donate_argnums``): the step on a
    shallow copy of ``state``, then every tensor it replaced (``prev_text``,
    ``step_idx``, the LM's ``pos`` and ``valid``) written back into
    ``state``'s own tensor; the token buffers and the LM's rings are written
    in place by the step already.  Keywords as :func:`step`'s; returns
    ``out``.  Its launches can be captured in a CUDA graph
    (``server/duplex_batched.py``) and replayed on the same buffers."""
    out, new_state = step(cfg, params, dict(state), input_audio_tokens, rng, **kw)
    copy_into(state, new_state)
    return out
