"""Single-stream delayed generation (counterpart of
``dsm_tpu/sessions/lm_gen_simple.py``; moshi-core's lm_generate.rs).

The general generator behind ``cli gen``: any per-codebook
``audio_delays``, teacher forcing of text and audio tokens, and absent
inputs.  Forced tokens use sentinels: ``>= 0`` forces that id, ``FREE``
(-1) samples, ``ZERO`` (-2) makes the input at that position absent (no
embedding).

One stream (B = 1); the token buffers and the LM's rings stay on the
device, and :func:`generate` fetches a chunk's tokens to the host once.
Past the end of the buffers (``max_steps + max(audio_delays)`` entries) a
read gives the smallest int32, an audio write is dropped, and the text
write and the frame read take the last entry, as JAX's gather, scatter and
dynamic slices do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import lm as LM
from ..ops import sampling as S

FREE = -1
ZERO = -2
UNGENERATED = -1
_OUT_OF_RANGE = torch.iinfo(torch.int32).min


@dataclasses.dataclass(frozen=True)
class GenConfig:
    lm: LM.LmConfig
    audio_delays: Tuple[int, ...]  # per generated codebook
    text_pad_token: int = 3
    text_eop_token: int = 0
    text_start_token: int = 32000
    max_steps: int = 4096
    audio_temperature: float = 0.8
    audio_top_k: int = 250
    text_temperature: float = 0.7
    text_top_k: int = 25

    @property
    def max_delay(self) -> int:
        return max(self.audio_delays) if self.audio_delays else 0


def init_state(cfg: GenConfig, cache_dtype=torch.bfloat16, device=None) -> dict:
    """The stream's state on ``device``: the LM's rings (``cache_dtype``),
    the delayed token buffers, the previous text token and the step (a 0-d
    int32 tensor)."""
    k = len(cfg.audio_delays)
    cap = cfg.max_steps + cfg.max_delay
    return {
        "lm": LM.init_state(cfg.lm, 1, cache_dtype, device=device),
        "audio_tokens": torch.full((1, cap, k), UNGENERATED, dtype=torch.int32, device=device),
        "text_tokens": torch.full((1, cap), UNGENERATED, dtype=torch.int32, device=device),
        "prev_text": torch.full((1,), cfg.text_start_token, dtype=torch.int32, device=device),
        "step_idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def step(cfg: GenConfig, params: dict, state: dict, rng: torch.Tensor,
         forced_text: torch.Tensor, forced_audio: torch.Tensor):
    """One generation step -> ``(out, state')``, ``out = {text_token (1,),
    frame (1, K), frame_valid (1,)}``.  ``rng (2,)`` is this step's key
    (split into the text's and the DepFormer's); ``forced_text`` a 0-d and
    ``forced_audio`` a ``(K,)`` int32 tensor of sentinels.  The token buffers
    and the rings are written in place; nothing is read back to the host."""
    lm_cfg = cfg.lm
    dev = state["step_idx"].device
    s = state["step_idx"]
    buf = state["audio_tokens"]
    cap = buf.shape[1]
    k = len(cfg.audio_delays)
    books = torch.arange(k, device=dev)
    delays = torch.tensor(cfg.audio_delays, dtype=torch.int32, device=dev)
    pad = lm_cfg.audio_pad_token

    # Inputs: the delayed reads, pads inside each codebook's delay window.
    read_pos = torch.clamp(s - 1 - delays, min=0)
    read = torch.where(read_pos < cap, buf[0, read_pos.clamp(max=cap - 1), books],
                       _OUT_OF_RANGE)
    audio_in = torch.where(s <= delays, pad, read)
    audio_in = torch.where(forced_audio == ZERO, UNGENERATED, audio_in)
    if k < lm_cfg.audio_codebooks:  # codebooks past the configured streams are absent
        audio_in = torch.cat([audio_in, torch.full((lm_cfg.audio_codebooks - k,), UNGENERATED,
                                                   dtype=torch.int32, device=dev)])
    text_in = torch.where(forced_text == ZERO, -1, state["prev_text"][0])[None]

    text_logits, hidden, lm_state = LM.step(lm_cfg, params["lm"], state["lm"], text_in,
                                            audio_in[None])
    _, k_text, k_dep = S.split(rng, 3)
    sampled = S.sample(S.SamplingConfig(cfg.text_temperature, cfg.text_top_k),
                       text_logits.float(), k_text)
    text_token = torch.where(forced_text >= 0, forced_text, sampled[0])[None].to(torch.int32)

    forced_next = torch.where((s < cfg.max_delay) & (books > 0), pad, -1).to(torch.int32)
    audio_tokens = LM.depformer_sample(
        lm_cfg, params["lm"], hidden, text_token, forced_next, k_dep,
        S.SamplingConfig(cfg.audio_temperature, cfg.audio_top_k))
    audio_tokens = torch.where(forced_audio[None] >= 0, forced_audio[None], audio_tokens)

    write_pos = torch.clamp(s - delays, min=0)
    at = write_pos.clamp(max=cap - 1)
    buf[0, at, books] = torch.where(write_pos < cap, audio_tokens[0], buf[0, at, books])
    at = s.reshape(1).long()  # a 0-d index would be read on the host
    state["text_tokens"][0, at.clamp(max=cap - 1)] = text_token

    frame_pos = torch.clamp(at - cfg.max_delay, min=0).clamp(max=cap - 1)
    frame = buf[:, frame_pos][:, 0]
    frame_valid = (s >= cfg.max_delay) & torch.all(
        (frame >= 0) & (frame < lm_cfg.audio_vocab_size - 1), dim=1)

    out = {"text_token": text_token, "frame": frame, "frame_valid": frame_valid}
    new_state = {"lm": lm_state, "audio_tokens": buf, "text_tokens": state["text_tokens"],
                 "prev_text": text_token, "step_idx": s + 1}
    return out, new_state


def step_keys(seed: int, n_steps: int) -> torch.Tensor:
    """The per-step keys of :func:`generate` -> ``(n_steps, 2)`` on the CPU:
    ``rng, sub = split(rng)`` from ``prng_key(seed)``, as the JAX loop
    splits them."""
    rng = S.prng_key(seed)
    subs = []
    for _ in range(n_steps):
        rng, sub = S.split(rng)
        subs.append(sub)
    return torch.stack(subs) if subs else torch.zeros((0, 2), dtype=torch.int64)


def generate(cfg: GenConfig, params: dict, n_steps: int, seed: int = 0,
             forced_text: Optional[Sequence[int]] = None, chunk: int = 64):
    """Offline generation on the device of ``params``, bf16 rings -> ``(text
    tokens [T], audio frames (T', K) int32)``.

    ``chunk`` steps run between two fetches: their tokens stay on the device
    and come to the host in one copy.  The per-step keys are those of the
    JAX loop, so the tokens are the same for any ``chunk``."""
    dev = params["lm"]["text_emb"].device
    state = init_state(cfg, device=dev)
    k = len(cfg.audio_delays)
    free_audio = torch.full((k,), FREE, dtype=torch.int32, device=dev)
    keys = step_keys(seed, n_steps).to(dev)
    fts = np.full(n_steps, FREE, np.int32)
    if forced_text is not None:
        n_f = min(len(forced_text), n_steps)
        fts[:n_f] = np.asarray(forced_text[:n_f], np.int32)
    fts = torch.from_numpy(fts).to(dev)

    texts: list = []
    frames: list = []
    with torch.inference_mode():
        for i in range(0, n_steps, chunk):
            n = min(chunk, n_steps - i)
            out_t = torch.empty(n, dtype=torch.int32, device=dev)
            out_v = torch.empty(n, dtype=torch.bool, device=dev)
            out_f = torch.empty((n, k), dtype=torch.int32, device=dev)
            for j in range(n):
                out, state = step(cfg, params, state, keys[i + j], fts[i + j], free_audio)
                out_t[j] = out["text_token"][0]
                out_v[j] = out["frame_valid"][0]
                out_f[j] = out["frame"][0]
            t_k, v_k, f_k = out_t.cpu().numpy(), out_v.cpu().numpy(), out_f.cpu().numpy()
            texts.extend(int(t) for t in t_k)
            frames.extend(f_k[j] for j in range(n) if v_k[j])
    return texts, (np.stack(frames) if frames else np.zeros((0, k), np.int32))
