"""Audio in and out (counterpart of ``dsm_tpu/utils/audio.py``): WAV read and
write, polyphase resampling, mono downmix, the level meter, and file and
upload decoding.

Compressed formats: flac through the numpy decoder (``utils/flac.py``), mp3
through libmpg123 and ogg/vorbis through libvorbisfile (``utils/codecs.py``),
ogg/opus through libopus and libogg (``utils/opus.py``).  An ogg stream is
tried as vorbis first, then as opus.  A format whose library does not load
is refused with its name.
"""

from __future__ import annotations

import io
import os
import struct
import tempfile
import wave
from math import gcd
from typing import Tuple

import numpy as np


def _pcm16(pcm: np.ndarray) -> bytes:
    pcm = np.asarray(pcm, np.float32).reshape(-1)
    return np.clip(pcm * 32768.0, -32768, 32767).astype("<i2").tobytes()


def write_wav(path: str, pcm: np.ndarray, sample_rate: int = 24_000) -> None:
    """Mono float ``[-1, 1]`` pcm -> a 16-bit WAV file."""
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(_pcm16(pcm))


def wav_bytes(pcm: np.ndarray, sample_rate: int = 24_000) -> bytes:
    """Mono float ``[-1, 1]`` pcm -> in-memory 16-bit WAV bytes."""
    data = _pcm16(pcm)
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                 sample_rate * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    return hdr + data


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """A WAV file -> ``(mono f32 pcm in [-1, 1], sample rate)``."""
    with wave.open(path, "rb") as w:
        return _decode_wave_obj(w)


def _decode_wave_obj(w) -> Tuple[np.ndarray, int]:
    """8/16/32-bit samples, any channel count, downmixed to mono."""
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
    return x, sr


def resample(pcm: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Polyphase resampling (scipy's ``resample_poly``) -> f32."""
    if src_rate == dst_rate:
        return np.asarray(pcm, np.float32)
    from scipy.signal import resample_poly

    g = gcd(src_rate, dst_rate)
    return resample_poly(np.asarray(pcm, np.float64), dst_rate // g,
                         src_rate // g).astype(np.float32)


def audio_level_db(pcm: np.ndarray) -> float:
    """RMS level in dBFS."""
    rms = float(np.sqrt(np.mean(np.square(np.asarray(pcm, np.float64))) + 1e-12))
    return 20.0 * np.log10(max(rms, 1e-9))


def _mp3(data_or_path, target_rate: int, what: str) -> np.ndarray:
    from . import codecs

    if not codecs.mp3_available():
        raise NotImplementedError(f"cannot decode {what}: libmpg123 not available")
    if isinstance(data_or_path, str):
        pcm, sr = codecs.decode_mp3_file(data_or_path)
    else:
        pcm, sr = codecs.decode_mp3(data_or_path)
    return resample(pcm.mean(axis=1) if pcm.ndim > 1 else pcm, sr, target_rate)


def _vorbis(data_or_path):
    """``decode_vorbis_file`` of a path, or of bytes through a temporary file."""
    from . import codecs

    if isinstance(data_or_path, str):
        return codecs.decode_vorbis_file(data_or_path)
    fd, tmp = tempfile.mkstemp(suffix=".ogg")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data_or_path)
        return codecs.decode_vorbis_file(tmp)
    finally:
        os.unlink(tmp)


def _ogg(data_or_path, target_rate: int, what: str) -> np.ndarray:
    """An ogg stream: vorbis where libvorbisfile loads and the stream is
    vorbis (a ``ValueError`` says it is not), else opus where libopus loads;
    a stream that gives no samples is refused."""
    from . import codecs, opus

    if codecs.vorbis_available():
        try:
            pcm, sr = _vorbis(data_or_path)
            return resample(pcm.mean(axis=1), sr, target_rate)
        except ValueError:
            pass
    if opus.available():
        data = data_or_path
        if isinstance(data, str):
            with open(data, "rb") as f:
                data = f.read()
        pcm = opus.OggOpusDecoder().decode(data)
        if len(pcm):
            return resample(pcm, opus.SAMPLE_RATE, target_rate)
    raise NotImplementedError(f"cannot decode {what}: no ogg codec available")


def decode_audio(path: str, target_rate: int = 24_000) -> np.ndarray:
    """An audio file (wav, flac, mp3, ogg/vorbis, ogg/opus) -> mono f32 pcm at
    ``target_rate``; channels are averaged."""
    low = path.lower()
    what = repr(path)
    if low.endswith(".wav"):
        pcm, sr = read_wav(path)
        return resample(pcm, sr, target_rate)
    if low.endswith((".mp3", ".mp2", ".mpga")):
        return _mp3(path, target_rate, what)
    if low.endswith((".ogg", ".oga")):
        return _ogg(path, target_rate, what)
    if low.endswith(".flac"):
        from .flac import decode_flac_file

        pcm, sr = decode_flac_file(path)
        return resample(pcm.mean(axis=1), sr, target_rate)
    raise NotImplementedError(
        f"no codec for {what}; supported: wav, mp3, ogg (vorbis, opus), flac")


def decode_audio_bytes(data: bytes, target_rate: int = 24_000) -> np.ndarray:
    """An in-memory audio payload -> mono f32 pcm at ``target_rate``, the
    container told by its magic bytes (an upload's body)."""
    if data[:4] == b"RIFF":
        with wave.open(io.BytesIO(data)) as w:
            pcm, sr = _decode_wave_obj(w)
        return resample(pcm, sr, target_rate)
    if data[:4] == b"fLaC":
        from .flac import decode_flac

        pcm, sr = decode_flac(data)
        return resample(pcm.mean(axis=1), sr, target_rate)
    if data[:4] == b"OggS":
        return _ogg(data, target_rate, "the ogg payload")
    if data[:3] == b"ID3" or (len(data) > 1 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0):
        return _mp3(data, target_rate, "the mp3 payload")
    raise NotImplementedError("unrecognised audio payload (supported: wav, flac, ogg, mp3)")
