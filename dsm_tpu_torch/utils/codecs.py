"""Compressed audio through the system's codec libraries, over ctypes (a copy
of ``dsm_tpu/utils/codecs.py``).

The reference server decodes any container its decoder knows
(moshi-server/src/utils.rs:263-305); the repo's own samples are mp3.

  * mp3: libmpg123 (decode) and libmp3lame (encode; the tests encode a
    known sine and decode it back)
  * ogg/vorbis: libvorbisfile

Each library is loaded on first use; ``mp3_available()``,
``lame_available()`` and ``vorbis_available()`` say whether it loaded, and
the callers refuse a format whose library is missing, naming it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import tempfile
from typing import Optional, Tuple

import numpy as np

_mpg123 = None
_lame = None
_vorbisfile = None


def _lib(*names):
    for n in names:
        try:
            return ctypes.CDLL(n)
        except OSError:
            continue
    found = ctypes.util.find_library(names[0].split(".so")[0].replace("lib", ""))
    if found:
        try:
            return ctypes.CDLL(found)
        except OSError:
            pass
    return None


def _load_mpg123():
    global _mpg123
    if _mpg123 is not None:
        return _mpg123
    lib = _lib("libmpg123.so.0", "libmpg123.so")
    if lib is None:
        return None
    lib.mpg123_init()
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_param.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_double,
    ]
    lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
    lib.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.mpg123_read.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    _mpg123 = lib
    return lib


def mp3_available() -> bool:
    return _load_mpg123() is not None


# mpg123.h constants
_MPG123_ADD_FLAGS = 2
_MPG123_FORCE_FLOAT = 0x400
_MPG123_OK = 0
_MPG123_NEED_MORE = -10
_MPG123_NEW_FORMAT = -11
_MPG123_DONE = -12


def decode_mp3(data: bytes) -> Tuple[np.ndarray, int]:
    """MPEG audio bytes -> (float32 pcm (n, channels), sample_rate)."""
    lib = _load_mpg123()
    if lib is None:
        raise RuntimeError("libmpg123 not available")
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new: {err.value}")
    try:
        lib.mpg123_param(h, _MPG123_ADD_FLAGS, _MPG123_FORCE_FLOAT, 0.0)
        if lib.mpg123_open_feed(h) != _MPG123_OK:
            raise RuntimeError("mpg123_open_feed failed")
        if lib.mpg123_feed(h, data, len(data)) != _MPG123_OK:
            raise RuntimeError("mpg123_feed failed")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        buf = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        chunks = []
        while True:
            ret = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if ret == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(
                    h, ctypes.byref(rate), ctypes.byref(channels),
                    ctypes.byref(enc),
                )
                continue
            if done.value:
                chunks.append(
                    np.frombuffer(buf.raw[: done.value], np.float32).copy()
                )
            if ret in (_MPG123_DONE, _MPG123_NEED_MORE):
                break
            if ret not in (_MPG123_OK,):
                raise RuntimeError(f"mpg123_read: {ret}")
        if not chunks:
            raise ValueError("no MPEG audio frames decoded")
        pcm = np.concatenate(chunks)
        ch = max(channels.value, 1)
        pcm = pcm.reshape(-1, ch)
        return pcm, int(rate.value)
    finally:
        lib.mpg123_delete(h)


def _load_lame():
    global _lame
    if _lame is not None:
        return _lame
    lib = _lib("libmp3lame.so.0", "libmp3lame.so")
    if lib is None:
        return None
    lib.lame_init.restype = ctypes.c_void_p
    for fn in ("lame_set_in_samplerate", "lame_set_out_samplerate",
               "lame_set_num_channels", "lame_set_brate", "lame_set_mode"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.lame_init_params.argtypes = [ctypes.c_void_p]
    lib.lame_encode_buffer_ieee_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.lame_encode_flush.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
    ]
    lib.lame_close.argtypes = [ctypes.c_void_p]
    _lame = lib
    return lib


def lame_available() -> bool:
    return _load_lame() is not None


def encode_mp3(pcm: np.ndarray, sample_rate: int, bitrate_kbps: int = 128) -> bytes:
    """Mono float32 pcm -> mp3 bytes (libmp3lame; test fixtures only)."""
    lib = _load_lame()
    if lib is None:
        raise RuntimeError("libmp3lame not available")
    pcm = np.ascontiguousarray(pcm, np.float32).reshape(-1)
    h = lib.lame_init()
    if not h:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(h, sample_rate)
        lib.lame_set_out_samplerate(h, sample_rate)
        lib.lame_set_num_channels(h, 1)
        lib.lame_set_brate(h, bitrate_kbps)
        lib.lame_set_mode(h, 3)  # MONO
        if lib.lame_init_params(h) < 0:
            raise RuntimeError("lame_init_params failed")
        out = ctypes.create_string_buffer(len(pcm) + (1 << 16))
        fp = pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        n = lib.lame_encode_buffer_ieee_float(h, fp, fp, len(pcm), out, len(out))
        if n < 0:
            raise RuntimeError(f"lame_encode_buffer: {n}")
        data = out.raw[:n]
        n = lib.lame_encode_flush(h, out, len(out))
        if n > 0:
            data += out.raw[:n]
        return data
    finally:
        lib.lame_close(h)


def _load_vorbisfile():
    global _vorbisfile
    if _vorbisfile is not None:
        return _vorbisfile
    lib = _lib("libvorbisfile.so.3", "libvorbisfile.so")
    if lib is None:
        return None
    lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.ov_info.restype = ctypes.c_void_p
    lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ov_read_float.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.POINTER(ctypes.c_float))),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    lib.ov_clear.argtypes = [ctypes.c_void_p]
    _vorbisfile = lib
    return lib


def vorbis_available() -> bool:
    return _load_vorbisfile() is not None


class _VorbisInfo(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
    ]


def decode_vorbis_file(path: str) -> Tuple[np.ndarray, int]:
    """Ogg/Vorbis file -> (float32 pcm (n, channels), sample_rate)."""
    lib = _load_vorbisfile()
    if lib is None:
        raise RuntimeError("libvorbisfile not available")
    vf = ctypes.create_string_buffer(2048)  # OggVorbis_File (opaque, ample)
    ret = lib.ov_fopen(path.encode(), vf)
    if ret != 0:
        raise ValueError(f"ov_fopen({path!r}): {ret}")
    try:
        info_p = lib.ov_info(vf, -1)
        if not info_p:
            raise ValueError("ov_info failed")
        info = ctypes.cast(info_p, ctypes.POINTER(_VorbisInfo)).contents
        ch, rate = info.channels, int(info.rate)
        pcm_pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
        sec = ctypes.c_int(0)
        chunks = []
        while True:
            n = lib.ov_read_float(vf, ctypes.byref(pcm_pp), 4096,
                                  ctypes.byref(sec))
            if n <= 0:
                break
            frame = np.empty((n, ch), np.float32)
            for c in range(ch):
                frame[:, c] = np.ctypeslib.as_array(pcm_pp[c], shape=(n,))
            chunks.append(frame)
        if not chunks:
            raise ValueError("no vorbis audio decoded")
        return np.concatenate(chunks), rate
    finally:
        lib.ov_clear(vf)


def decode_mp3_file(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return decode_mp3(f.read())
