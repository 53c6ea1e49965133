"""TTS voice resolution (counterpart of ``dsm_tpu/server/voices.py``).

A voice is the cross-attention source of the TTS LM, ``(1, S, cond_dim)``
f32.  It comes from a preloaded entry (a ``.safetensors`` path, or an
array handed over directly) or from a voice directory, looked up by a
path-traversal-checked relative name with the ``name+start_s`` suffix
syntax.  A ``.safetensors`` voice holds the source itself; a ``.wav``
sample is cut to the speaker encoder's duration from ``start_s`` and
encoded through Mimi's pre-quantisation encoder
(``models/speaker.py``).  Resolved voices stay in an LRU.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import speaker as SPK
from ..utils.checkpoint import load_safetensors as read_safetensors


def parse_voice_spec(spec: str) -> Tuple[str, float]:
    """``name+12.5`` -> (name, 12.5 s start offset)."""
    if "+" in spec:
        name, _, off = spec.rpartition("+")
        try:
            return name, float(off)
        except ValueError:
            return spec, 0.0
    return spec, 0.0


def safe_voice_path(voice_dir: str, name: str) -> Optional[str]:
    """A voice name inside ``voice_dir``, refusing path traversal."""
    base = os.path.realpath(voice_dir)
    cand = os.path.realpath(os.path.join(base, name))
    if not cand.startswith(base + os.sep) and cand != base:
        return None
    if os.path.exists(cand):
        return cand
    for ext in (".safetensors", ".wav"):
        if os.path.exists(cand + ext):
            return cand + ext
    return None


def load_voice_embedding(path: str) -> np.ndarray:
    """A precomputed voice file -> ``(1, S, cond_dim)`` f32; takes the
    common key spellings or a file's only tensor."""
    t = read_safetensors(path)
    for key in ("speaker_wavs", "ca_src", "condition", "embedding"):
        if key in t:
            arr = np.array(t[key], np.float32)
            break
    else:
        if len(t) != 1:
            raise ValueError(f"ambiguous voice file {path}: keys {list(t)}")
        arr = np.array(next(iter(t.values())), np.float32)
    return arr[None] if arr.ndim == 2 else arr


class VoiceResolver:
    """Voice spec -> cross-attention source, with an LRU of resolved voices.
    ``.wav`` voices need ``speaker_cfg``, ``speaker_params`` and
    ``mimi_params`` (the codec's encoder; its device is the encoder's)."""

    def __init__(self, voice_dir: Optional[str] = None,
                 preloaded: Optional[dict] = None,
                 speaker_cfg: Optional[SPK.SpeakerEncoderConfig] = None,
                 speaker_params=None, mimi_params=None, cache_size: int = 32):
        self.voice_dir = voice_dir
        # name -> a .safetensors or .wav path, or an array (S, D) / (1, S, D)
        self.preloaded = dict(preloaded or {})
        self.speaker_cfg = speaker_cfg
        self.speaker_params = speaker_params
        self.mimi_params = mimi_params
        self._cache: OrderedDict = OrderedDict()
        self.cache_size = cache_size

    def resolve(self, spec: Optional[str]) -> Optional[np.ndarray]:
        """Voice spec -> ``(1, S, cond_dim)`` f32, or None (no voice)."""
        if not spec:
            return None
        if spec in self._cache:
            self._cache.move_to_end(spec)
            return self._cache[spec]
        name, start_s = parse_voice_spec(spec)
        entry = self.preloaded.get(name)
        if entry is not None and not isinstance(entry, str):
            arr = np.asarray(entry, np.float32)
            return arr[None] if arr.ndim == 2 else arr
        path = entry
        if path is None and self.voice_dir:
            path = safe_voice_path(self.voice_dir, name)
        if path is None:
            raise FileNotFoundError(f"unknown voice {spec!r}")
        if path.endswith(".safetensors"):
            ca = load_voice_embedding(path)
        elif path.endswith(".wav"):
            ca = self._encode_wav(path, start_s)
        else:
            raise ValueError(f"unsupported voice file {path}")
        self._cache[spec] = ca
        if len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        return ca

    def _encode_wav(self, path: str, start_s: float) -> np.ndarray:
        """A wav sample from ``start_s``, cut or zero-padded to the encoder's
        duration, through the speaker encoder -> ``(1, S, cond_dim)`` f32."""
        if self.speaker_cfg is None or self.speaker_params is None:
            raise RuntimeError("no speaker encoder configured for wav voices")
        from ..utils.audio import decode_audio

        sr = int(self.speaker_cfg.mimi.sample_rate)
        pcm = decode_audio(path, sr)
        start = int(start_s * sr)
        dur = int(self.speaker_cfg.duration_s * sr)
        pcm = pcm[start:start + dur]
        if len(pcm) < dur:
            pcm = np.pad(pcm, (0, dur - len(pcm)))
        dev = self.speaker_params["proj"].device
        with torch.inference_mode():
            ca = SPK.encode(self.speaker_cfg, self.speaker_params, self.mimi_params,
                            [torch.as_tensor(pcm, dtype=torch.float32, device=dev)])
        return ca.float().cpu().numpy()
