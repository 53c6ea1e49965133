"""Speaker (voice) encoder for the TTS cross-attention (counterpart of
``dsm_tpu/models/speaker.py``).

A ~10 s voice sample a speaker is normalised to a fixed level, run through
Mimi's encoder up to its quantiser (12.5 Hz latents, d=512), projected to
the conditioning width, padded to ``n_speakers`` slots with a learnt padding
vector, flattened over the speakers and given absolute sinusoidal position
embeddings.  The result is the cross-attention source whose per-layer K/V
the transformer projects once a session (``ops.transformer.precompute_ca_kv``).
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import List

import torch

from ..ops import transformer as T
from . import mimi as MIMI


@dataclasses.dataclass(frozen=True)
class SpeakerEncoderConfig:
    cond_dim: int = 2048
    n_speakers: int = 5
    duration_s: float = 10.0
    mimi: MIMI.MimiConfig = dataclasses.field(default_factory=MIMI.v0_1)

    @property
    def frames_per_speaker(self) -> int:
        """10 s at 12.5 Hz: 125 frames."""
        return int(self.duration_s * self.mimi.frame_rate)


def init(cfg: SpeakerEncoderConfig, gen: torch.Generator, dtype=torch.float32) -> dict:
    """Random params on ``gen``'s device, distributed as the JAX init."""
    d = cfg.mimi.seanet.dimension
    dev = gen.device
    proj = torch.randn((cfg.cond_dim, d), generator=gen, device=dev) / math.sqrt(d)
    pad = torch.randn((1, 1, cfg.cond_dim), generator=gen, device=dev) * 0.02
    return {"proj": proj.to(dtype), "learnt_padding": pad.to(dtype)}


def add_sin_embeddings(xs: torch.Tensor, max_period: float = 10_000.0) -> torch.Tensor:
    """``xs (B, T, D)`` plus the absolute ``concat(cos, sin)`` embedding of
    the positions ``0..T-1``, summed in f32."""
    _b, t, d = xs.shape
    half = d // 2
    dev = xs.device
    pos = torch.arange(t, dtype=torch.float32, device=dev)[:, None]
    idx = torch.arange(half, dtype=torch.float32, device=dev)
    inv_freq = 1.0 / torch.pow(torch.tensor(max_period, dtype=torch.float32, device=dev),
                               idx / (half - 1))
    freqs = pos * inv_freq
    emb = torch.cat([torch.cos(freqs), torch.sin(freqs)], dim=-1)
    return (xs.float() + emb[None]).to(xs.dtype)


def normalize_speaker_pcm(pcm: torch.Tensor) -> torch.Tensor:
    """Fixed-level normalisation: ``0.08 * pcm / std`` after the mean."""
    pcm = pcm - torch.mean(pcm)
    std = torch.sqrt(torch.mean(torch.square(pcm)) + 1e-9)
    return pcm * (0.08 / std)


def encode(cfg: SpeakerEncoderConfig, params: dict, mimi_params: dict,
           speaker_pcms: List[torch.Tensor]) -> torch.Tensor:
    """Speaker pcms (each ``(T,)`` mono 24 kHz f32) -> the cross-attention
    source ``(1, n_speakers * frames, cond_dim)``."""
    if not speaker_pcms:
        return empty(cfg, params)
    pcm = torch.cat([normalize_speaker_pcm(p)[None, None, :]
                     for p in speaker_pcms[:cfg.n_speakers]], dim=0)
    lat = MIMI.encode_pre_quantize(cfg.mimi, mimi_params, pcm)  # (S, d, T)
    emb = torch.einsum("sdt,cd->stc", lat, params["proj"].to(lat.dtype))
    n = emb.shape[0]
    if n < cfg.n_speakers:
        pad = params["learnt_padding"].to(emb.dtype).expand(
            cfg.n_speakers - n, emb.shape[1], cfg.cond_dim)
        emb = torch.cat([emb, pad], dim=0)
    return add_sin_embeddings(emb.reshape(1, -1, cfg.cond_dim))


def empty(cfg: SpeakerEncoderConfig, params: dict) -> torch.Tensor:
    """The no-voice condition: the learnt padding in every slot."""
    emb = params["learnt_padding"].expand(
        1, cfg.n_speakers * cfg.frames_per_speaker, cfg.cond_dim)
    return add_sin_embeddings(emb)


class VoiceCache:
    """LRU of the per-layer cross-attention K/V of resolved voices."""

    def __init__(self, lm_tcfg: T.TransformerConfig, lm_tparams, capacity: int = 16):
        self.tcfg = lm_tcfg
        self.tparams = lm_tparams
        self.capacity = capacity
        self._cache: OrderedDict = OrderedDict()

    def get(self, key: str, ca_tokens_fn):
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        kv = T.precompute_ca_kv(self.tcfg, self.tparams, ca_tokens_fn())
        self._cache[key] = kv
        if len(self._cache) > self.capacity:
            self._cache.popitem(last=False)
        return kv
