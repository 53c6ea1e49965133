"""WAV in and out for the port's HTTP routes (the WAV part of
``dsm_tpu/utils/audio.py``).

Uploads in flac, ogg or mp3, which the JAX package decodes through its
codec modules, are not ported (ROADMAP.md) and are refused.
"""

from __future__ import annotations

import io
import struct
import wave
from math import gcd

import numpy as np


def wav_bytes(pcm: np.ndarray, sample_rate: int = 24_000) -> bytes:
    """Mono float ``[-1, 1]`` pcm -> in-memory 16-bit WAV bytes."""
    pcm = np.asarray(pcm, np.float32).reshape(-1)
    data = np.clip(pcm * 32768.0, -32768, 32767).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                 sample_rate * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    return hdr + data


def decode_wav_bytes(data: bytes, target_rate: int = 24_000) -> np.ndarray:
    """A WAV payload (8/16/32-bit, any channel count) -> mono f32 pcm at
    ``target_rate`` (polyphase resampling where the rate differs)."""
    if data[:4] != b"RIFF":
        raise NotImplementedError("only WAV uploads are served by the port")
    with wave.open(io.BytesIO(data)) as w:
        sr, ch, sw = w.getframerate(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if sw == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif sw == 1:
        x = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sw}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    if sr == target_rate:
        return x
    from scipy.signal import resample_poly

    g = gcd(sr, target_rate)
    return resample_poly(x.astype(np.float64), target_rate // g, sr // g).astype(np.float32)


def decode_audio(path: str, target_rate: int = 24_000) -> np.ndarray:
    """A ``.wav`` file -> mono f32 pcm at ``target_rate`` (other containers
    are not ported)."""
    if not path.lower().endswith(".wav"):
        raise NotImplementedError(f"cannot decode {path!r}: only WAV files are read by the port")
    with open(path, "rb") as f:
        return decode_wav_bytes(f.read(), target_rate)
