"""Wire protocols: WS close codes, byte-tag message types, msgpack messages.

A copy of ``dsm_tpu/server/protocol.py`` (msgpack only).  msgpack is
imported where a message is packed, so that the byte-tag types load on a
machine without it.

Wire-compatible with the reference so its Rust clients work unmodified:
  * close codes + retryable classification: moshi-server/src/protocol.rs
  * byte-tag framing (duplex moshi protocol): protocol.rs MsgType 0-9
  * ASR streaming msgpack messages: moshi-server/src/asr.rs InMsg/OutMsg
    (serde tag="type" maps)
  * TTS streaming output messages: moshi-server/src/tts.rs OutMsg
"""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional


class CloseCode(enum.IntEnum):
    NORMAL = 1000
    GOING_AWAY = 1001
    PROTOCOL_ERROR = 1002
    INTERNAL_ERROR = 1011
    SERVER_AT_CAPACITY = 4000
    AUTHENTICATION_FAILED = 4001
    SESSION_TIMEOUT = 4002
    INVALID_MESSAGE = 4003
    RATE_LIMITED = 4004
    RESOURCE_UNAVAILABLE = 4005
    CLIENT_TIMEOUT = 4006

    @property
    def reason(self) -> str:
        return _REASONS[self]

    @property
    def is_retryable(self) -> bool:
        return self in (
            CloseCode.SERVER_AT_CAPACITY,
            CloseCode.GOING_AWAY,
            CloseCode.INTERNAL_ERROR,
            CloseCode.RATE_LIMITED,
        )


_REASONS = {
    CloseCode.NORMAL: "Normal closure",
    CloseCode.GOING_AWAY: "Server going away",
    CloseCode.PROTOCOL_ERROR: "Protocol error",
    CloseCode.INTERNAL_ERROR: "Internal server error",
    CloseCode.SERVER_AT_CAPACITY: "Server at capacity",
    CloseCode.AUTHENTICATION_FAILED: "Authentication failed",
    CloseCode.SESSION_TIMEOUT: "Session timeout",
    CloseCode.INVALID_MESSAGE: "Invalid message format",
    CloseCode.RATE_LIMITED: "Rate limited",
    CloseCode.RESOURCE_UNAVAILABLE: "Resource unavailable",
    CloseCode.CLIENT_TIMEOUT: "Client timeout",
}


class MsgType(enum.IntEnum):
    """1-byte type tags of the duplex (moshi) binary protocol."""

    HANDSHAKE = 0
    AUDIO = 1
    TEXT = 2
    CONTROL = 3
    METADATA = 4
    ERROR = 5
    PING = 6
    COLORED_TEXT = 7
    IMAGE = 8
    CODES = 9


# ---------------------------------------------------------------------------
# msgpack tagged messages (rmp_serde `#[serde(tag = "type")]` == string-keyed
# map with a "type" entry)
# ---------------------------------------------------------------------------


def pack(msg: Dict[str, Any], single_float: bool = False) -> bytes:
    # Timestamps are f64 like the reference structs; pcm payloads are f32
    # (Vec<f32>) so Audio messages pack with single-precision floats.
    import msgpack

    return msgpack.packb(msg, use_single_float=single_float)


def unpack(data: bytes) -> Dict[str, Any]:
    import msgpack

    return msgpack.unpackb(data, raw=False)


# -- ASR /api/asr-streaming --


def asr_in_msg(data: bytes) -> Dict[str, Any]:
    """Decode a client->server ASR message: Init | Marker{id} | Audio{pcm} |
    OggOpus{data} | Ping."""
    msg = unpack(data)
    if not isinstance(msg, dict) or "type" not in msg:
        raise ValueError("missing type tag")
    return msg


def asr_word(text: str, start_time: float) -> bytes:
    return pack({"type": "Word", "text": text, "start_time": start_time})


def asr_end_word(stop_time: float) -> bytes:
    return pack({"type": "EndWord", "stop_time": stop_time})


def asr_marker(marker_id: int) -> bytes:
    return pack({"type": "Marker", "id": marker_id})


def asr_step(step_idx: int, prs: List[float], buffered_pcm: int) -> bytes:
    # prs is Vec<f32> in the reference OutMsg (asr.rs:31) — pack
    # single-precision so the bytes match rmp_serde's encoding (the other
    # fields are ints, unaffected by the float width flag).
    return pack(
        {"type": "Step", "step_idx": step_idx, "prs": prs,
         "buffered_pcm": buffered_pcm},
        single_float=True,
    )


def asr_error(message: str) -> bytes:
    return pack({"type": "Error", "message": message})


def asr_ready() -> bytes:
    return pack({"type": "Ready"})


# -- TTS /api/tts_streaming --


def tts_text(text: str, start_s: float, stop_s: float) -> bytes:
    return pack({"type": "Text", "text": text, "start_s": start_s, "stop_s": stop_s})


def tts_audio(pcm: List[float]) -> bytes:
    return pack({"type": "Audio", "pcm": pcm}, single_float=True)


def tts_audio_opus(data: bytes) -> bytes:
    """OggOpusMessagePack format: compressed pages in a msgpack envelope —
    a DISTINCT ``OggOpus`` variant, not ``Audio`` (tts.rs OutMsg :174 and
    Encoder::OggOpusMessagePack :216,259; the Rust client's InMsg decodes
    it by that tag)."""
    return pack({"type": "OggOpus", "data": data})


def tts_error(message: str) -> bytes:
    return pack({"type": "Error", "message": message})


def tts_ready() -> bytes:
    return pack({"type": "Ready"})


TTS_EOS = b"\0"  # binary end-of-stream sentinel (tts.rs:468-472)
