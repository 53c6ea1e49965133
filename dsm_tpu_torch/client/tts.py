"""Streaming TTS client (counterpart of ``dsm_tpu/client/tts.py``).

Sends the text as a WebSocket text frame and ``b"\\0"`` as its end, collects
the audio and the msgpack ``Text`` events, and reports the time to the first
audio byte and the realtime factor.  The audio comes as ``Audio`` messages of
raw pcm, or as Ogg pages decoded with one decoder a session: raw ``OggS``
frames (``?format=OggOpus``), ``OggOpus`` messages (``OggOpusMessagePack``,
tts.rs OutMsg::OggOpus) or ``Audio`` messages carrying ``data`` (older
emitters).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class TtsResult:
    pcm: np.ndarray
    words: List[dict]
    ttfb_s: Optional[float]
    rtf: Optional[float]
    wall_s: float


class TtsClient:
    def __init__(self, url: str, token: Optional[str] = None):
        self.url = url
        self.token = token

    async def synthesize(self, text: str, on_audio=None) -> TtsResult:
        """``on_audio``: optional callback invoked with each pcm chunk as it
        streams (live playback)."""
        import aiohttp
        import msgpack

        headers = {"Authorization": f"Bearer {self.token}"} if self.token else {}
        chunks: List[np.ndarray] = []
        words: List[dict] = []
        t0 = time.monotonic()
        ttfb = None
        opus_dec = None

        def emit(pcm):
            chunks.append(pcm)
            if on_audio is not None:
                on_audio(pcm)

        def decode(data):
            nonlocal opus_dec
            if opus_dec is None:
                from ..utils import opus

                opus_dec = opus.OggOpusDecoder()
            return opus_dec.decode(data)

        async with aiohttp.ClientSession() as session:
            async with session.ws_connect(
                self.url, headers=headers, max_msg_size=64 * 2**20
            ) as ws:
                await ws.send_str(text)
                await ws.send_bytes(b"\0")
                async for msg in ws:
                    if msg.type != aiohttp.WSMsgType.BINARY:
                        continue
                    if msg.data[:4] == b"OggS":
                        pcm = decode(msg.data)
                        if pcm.size:
                            if ttfb is None:
                                ttfb = time.monotonic() - t0
                            emit(pcm)
                        continue
                    m = msgpack.unpackb(msg.data, raw=False)
                    t = m.get("type")
                    if t in ("Audio", "OggOpus"):
                        if ttfb is None:
                            ttfb = time.monotonic() - t0
                        if t == "OggOpus" or "data" in m:
                            pcm = decode(bytes(m["data"]))
                            if pcm.size:
                                emit(pcm)
                        else:
                            emit(np.asarray(m["pcm"], np.float32))
                    elif t == "Text":
                        words.append(m)
                    elif t == "Error":
                        raise RuntimeError(m.get("message"))
        wall = time.monotonic() - t0
        pcm = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        rtf = (len(pcm) / 24_000.0) / wall if wall > 0 else None
        return TtsResult(pcm=pcm, words=words, ttfb_s=ttfb, rtf=rtf, wall_s=wall)
