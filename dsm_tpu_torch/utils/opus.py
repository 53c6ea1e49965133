"""OggOpus streaming encode and decode over libopus and libogg, through ctypes
(counterpart of ``dsm_tpu/utils/opus.py``: the same bytes out of the encoder,
the same samples out of the decoder).

The reference server streams OggOpus audio (moshi-server/src/tts.rs
Encoder::OggOpus, asr.rs InMsg::OggOpus) and its clients decode it:

- ``OggOpusEncoder``: float pcm (24 kHz mono) -> Ogg pages.  The first call
  returns the header pages (OpusHead, OpusTags), then one page a call: an
  80 ms frame is four 20 ms Opus packets, flushed onto one page so that the
  stream is live.  A tail short of a whole packet waits for the next call.
- ``OggOpusDecoder``: Ogg bytes, fed in any pieces -> float pcm.

Granule positions are in 48 kHz units, as RFC 7845 has them whatever the
input rate.  ``available()`` says whether both libraries load; the callers
check it and fall back to raw pcm, or refuse, where they do not.  Host code:
no tensor is touched.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
from typing import Optional

import numpy as np

SAMPLE_RATE = 24_000
CHANNELS = 1
PACKET_SAMPLES = 480  # 20 ms at 24 kHz
_GRANULE_SCALE = 48_000 // SAMPLE_RATE
_MAX_PACKET_SAMPLES = 5760  # 120 ms at 48 kHz, the longest Opus packet

_OPUS_APPLICATION_AUDIO = 2049
_opus = None
_ogg = None


class _OggPacket(ctypes.Structure):
    _fields_ = [
        ("packet", ctypes.POINTER(ctypes.c_ubyte)),
        ("bytes", ctypes.c_long),
        ("b_o_s", ctypes.c_long),
        ("e_o_s", ctypes.c_long),
        ("granulepos", ctypes.c_int64),
        ("packetno", ctypes.c_int64),
    ]


class _OggPage(ctypes.Structure):
    _fields_ = [
        ("header", ctypes.POINTER(ctypes.c_ubyte)),
        ("header_len", ctypes.c_long),
        ("body", ctypes.POINTER(ctypes.c_ubyte)),
        ("body_len", ctypes.c_long),
    ]


def _load() -> bool:
    """Load both libraries once; False where either is not found (an
    ``OSError`` from a library that is found but does not load passes)."""
    global _opus, _ogg
    if _opus is not None:
        return True
    op = ctypes.util.find_library("opus")
    og = ctypes.util.find_library("ogg")
    if not op or not og:
        return False
    opus, ogg = ctypes.CDLL(op), ctypes.CDLL(og)
    opus.opus_encoder_create.restype = ctypes.c_void_p
    opus.opus_decoder_create.restype = ctypes.c_void_p
    # A pointer result or a long argument needs its signature, or ctypes
    # cuts it to a 32-bit int.
    ogg.ogg_sync_buffer.restype = ctypes.c_void_p
    ogg.ogg_sync_buffer.argtypes = [ctypes.c_char_p, ctypes.c_long]
    ogg.ogg_sync_wrote.argtypes = [ctypes.c_char_p, ctypes.c_long]
    _opus, _ogg = opus, ogg
    return True


def available() -> bool:
    try:
        return _load()
    except OSError:
        return False


def _opus_head() -> bytes:
    # RFC 7845 section 5.1: magic, version, channels, pre-skip, input rate,
    # output gain, mapping family 0.
    return struct.pack("<8sBBHIhB", b"OpusHead", 1, CHANNELS, 312, SAMPLE_RATE, 0, 0)


def _opus_tags() -> bytes:
    vendor = b"dsm-tpu"
    return struct.pack("<8sI", b"OpusTags", len(vendor)) + vendor + struct.pack("<I", 0)


class _OggStream:
    """An ``ogg_stream_state`` in a buffer larger than the struct, which
    libogg manages."""

    def __init__(self, serial: int):
        self._state = ctypes.create_string_buffer(2048)
        if _ogg.ogg_stream_init(self._state, serial) != 0:
            raise RuntimeError("ogg_stream_init failed")

    def packet_in(self, data: bytes, *, packetno: int, granulepos: int,
                  bos: bool = False, eos: bool = False) -> None:
        buf = (ctypes.c_ubyte * len(data)).from_buffer_copy(data)
        pkt = _OggPacket(packet=ctypes.cast(buf, ctypes.POINTER(ctypes.c_ubyte)),
                         bytes=len(data), b_o_s=int(bos), e_o_s=int(eos),
                         granulepos=granulepos, packetno=packetno)
        if _ogg.ogg_stream_packetin(self._state, ctypes.byref(pkt)) != 0:
            raise RuntimeError("ogg_stream_packetin failed")

    def flush(self) -> bytes:
        out = b""
        page = _OggPage()
        while _ogg.ogg_stream_flush(self._state, ctypes.byref(page)) != 0:
            out += ctypes.string_at(page.header, page.header_len)
            out += ctypes.string_at(page.body, page.body_len)
        return out

    def __del__(self):
        try:
            _ogg.ogg_stream_clear(self._state)
        except Exception:
            pass


class OggOpusEncoder:
    def __init__(self, serial: int = 0x64736D):
        if not _load():
            raise RuntimeError("libopus/libogg not available")
        err = ctypes.c_int(0)
        self._enc = _opus.opus_encoder_create(SAMPLE_RATE, CHANNELS, _OPUS_APPLICATION_AUDIO,
                                              ctypes.byref(err))
        if err.value != 0:
            raise RuntimeError(f"opus_encoder_create: {err.value}")
        self._stream = _OggStream(serial)
        self._packetno = 0
        self._granule = 0
        self._header_sent = False
        self._tail = np.zeros(0, np.float32)

    def header_pages(self) -> bytes:
        """OpusHead and OpusTags, each flushed onto a page of its own."""
        self._stream.packet_in(_opus_head(), packetno=0, granulepos=0, bos=True)
        out = self._stream.flush()
        self._stream.packet_in(_opus_tags(), packetno=1, granulepos=0)
        out += self._stream.flush()
        self._packetno = 2
        self._header_sent = True
        return out

    def encode(self, pcm, eos: bool = False) -> bytes:
        """Float pcm -> Ogg bytes: the header pages first if not yet sent,
        then one page of the whole packets; the rest waits for the next call
        (stream_both.rs MsgSender:284-290 encodes only whole frames)."""
        out = b"" if self._header_sent else self.header_pages()
        pcm = np.ascontiguousarray(pcm, np.float32).reshape(-1)
        if len(self._tail):
            pcm = np.concatenate([self._tail, pcm])
        n_pkts = len(pcm) // PACKET_SAMPLES
        self._tail = pcm[n_pkts * PACKET_SAMPLES:]
        buf = ctypes.create_string_buffer(4000)
        for i in range(n_pkts):
            chunk = pcm[i * PACKET_SAMPLES:(i + 1) * PACKET_SAMPLES]
            n = _opus.opus_encode_float(ctypes.c_void_p(self._enc),
                                        chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                        PACKET_SAMPLES, buf, len(buf))
            if n < 0:
                raise RuntimeError(f"opus_encode_float: {n}")
            self._granule += PACKET_SAMPLES * _GRANULE_SCALE
            self._stream.packet_in(buf.raw[:n], packetno=self._packetno,
                                   granulepos=self._granule, eos=eos and i == n_pkts - 1)
            self._packetno += 1
        return out + self._stream.flush()


class OggOpusDecoder:
    """Ogg bytes in any pieces -> float32 pcm (24 kHz mono); the stream's
    serial is taken from its first page."""

    def __init__(self):
        if not _load():
            raise RuntimeError("libopus/libogg not available")
        err = ctypes.c_int(0)
        self._dec = _opus.opus_decoder_create(SAMPLE_RATE, CHANNELS, ctypes.byref(err))
        if err.value != 0:
            raise RuntimeError(f"opus_decoder_create: {err.value}")
        self._sync = ctypes.create_string_buffer(1024)
        if _ogg.ogg_sync_init(self._sync) != 0:
            raise RuntimeError("ogg_sync_init failed")
        self._stream: Optional[ctypes.Array] = None
        self._skip_packets = 2  # OpusHead and OpusTags

    def decode(self, data: bytes) -> np.ndarray:
        """Feed Ogg bytes; the pcm of every packet they complete."""
        ptr = _ogg.ogg_sync_buffer(self._sync, len(data))
        ctypes.memmove(ptr, data, len(data))
        _ogg.ogg_sync_wrote(self._sync, len(data))
        out = []
        page = _OggPage()
        pcm_buf = (ctypes.c_float * _MAX_PACKET_SAMPLES)()
        while _ogg.ogg_sync_pageout(self._sync, ctypes.byref(page)) == 1:
            if self._stream is None:
                serial = _ogg.ogg_page_serialno(ctypes.byref(page))
                self._stream = ctypes.create_string_buffer(2048)
                if _ogg.ogg_stream_init(self._stream, serial) != 0:
                    raise RuntimeError("ogg_stream_init failed")
            _ogg.ogg_stream_pagein(self._stream, ctypes.byref(page))
            pkt = _OggPacket()
            while _ogg.ogg_stream_packetout(self._stream, ctypes.byref(pkt)) == 1:
                if self._skip_packets > 0:
                    self._skip_packets -= 1
                    continue
                n = _opus.opus_decode_float(ctypes.c_void_p(self._dec), pkt.packet, pkt.bytes,
                                            pcm_buf, _MAX_PACKET_SAMPLES, 0)
                if n < 0:
                    raise RuntimeError(f"opus_decode_float: {n}")
                out.append(np.ctypeslib.as_array(pcm_buf)[:n].copy())
        return np.concatenate(out) if out else np.zeros((0,), np.float32)

    def __del__(self):
        try:
            _ogg.ogg_sync_clear(self._sync)
            if self._stream is not None:
                _ogg.ogg_stream_clear(self._stream)
        except Exception:
            pass


def pad_to_packets(pcm) -> np.ndarray:
    """Float32 pcm zero-padded to whole 480-sample packets, as the routes and
    the STT client pad a chunk before encoding it."""
    pcm = np.asarray(pcm, np.float32)
    rem = len(pcm) % PACKET_SAMPLES
    return np.pad(pcm, (0, PACKET_SAMPLES - rem)) if rem else pcm
