"""Streaming STT client (counterpart of ``dsm_tpu/client/stt.py``).

Speaks the msgpack WebSocket protocol of ``/api/asr-streaming``: ``Audio``
messages of raw pcm in, or with ``compress=True`` ``OggOpus`` messages of
Ogg pages (asr.rs InMsg::OggOpus; each chunk padded to whole 20 ms packets);
``Ready``, ``Word``, ``EndWord``, ``Step`` and ``Marker`` events out.
Bearer-token auth; the whole session retried on a retryable close code
(4000/4004/4005/4006, 1012/1013); a graceful end: a marker, then silence
until the marker comes back; words assembled with their timestamps.
``msgpack`` and ``aiohttp`` are imported where a session starts.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import List, Optional

import numpy as np

RETRYABLE_CLOSE_CODES = {1012, 1013, 4000, 4004, 4005, 4006}
FRAME = 1920
SHUTDOWN_MARKER = -989_898  # sentinel marker id for the final flush


@dataclasses.dataclass
class SttEvent:
    type: str  # word | end_word | step | marker | ready
    text: Optional[str] = None
    start_time: Optional[float] = None
    stop_time: Optional[float] = None
    step_idx: Optional[int] = None
    prs: Optional[List[float]] = None
    marker_id: Optional[int] = None


@dataclasses.dataclass
class Word:
    text: str
    start_s: float
    stop_s: Optional[float]


class Transcript:
    """Words with their start and stop times, from the events."""

    def __init__(self):
        self.words: List[Word] = []

    def on_event(self, ev: SttEvent) -> None:
        if ev.type == "word":
            self.words.append(Word(ev.text, ev.start_time, None))
        elif ev.type == "end_word" and self.words and self.words[-1].stop_s is None:
            self.words[-1].stop_s = ev.stop_time

    @property
    def text(self) -> str:
        return " ".join(w.text for w in self.words)


class SttClient:
    def __init__(
        self,
        url: str,
        token: Optional[str] = None,
        max_retries: int = 3,
        retry_delay_s: float = 1.0,
        compress: bool = False,
    ):
        self.url = url
        self.token = token
        self.max_retries = max_retries
        self.retry_delay_s = retry_delay_s
        self.compress = compress  # needs libopus and libogg here

    def _headers(self):
        return {"Authorization": f"Bearer {self.token}"} if self.token else {}

    async def transcribe_pcm(
        self,
        pcm: np.ndarray,
        rtf: Optional[float] = None,
        on_event=None,
    ) -> Transcript:
        """Stream pcm (24 kHz mono float32) and return the final transcript.

        ``rtf`` paces the upload (1.0 = real time); None = as fast as
        possible.  Retries the whole session on retryable close codes.
        """
        attempt = 0
        while True:
            try:
                return await self._run_once(pcm, rtf, on_event)
            except ConnectionResetError:
                attempt += 1
                if attempt > self.max_retries:
                    raise
                await asyncio.sleep(self.retry_delay_s)

    async def transcribe_frames(self, frames, on_event=None) -> Transcript:
        """Stream frames from a (sync or async) iterator of float32 chunks,
        e.g. live mic capture, then flush.  The iterator paces the session
        (a mic yields one frame per 80 ms)."""

        async def gen():
            if hasattr(frames, "__aiter__"):
                async for f in frames:
                    yield np.asarray(f, np.float32)
            else:
                loop = asyncio.get_running_loop()
                it = iter(frames)

                def _next():
                    try:
                        return next(it)
                    except StopIteration:
                        return None

                while True:
                    f = await loop.run_in_executor(None, _next)
                    if f is None:
                        break
                    yield np.asarray(f, np.float32)

        return await self._run_once(None, None, on_event, frame_iter=gen())

    async def _run_once(self, pcm, rtf, on_event, frame_iter=None) -> Transcript:
        import aiohttp
        import msgpack

        transcript = Transcript()
        async with aiohttp.ClientSession() as session:
            async with session.ws_connect(
                self.url, headers=self._headers(), max_msg_size=64 * 2**20
            ) as ws:
                opus_enc = None
                if self.compress:
                    from ..utils import opus

                    opus_enc = opus.OggOpusEncoder()

                def _audio_msg(chunk: np.ndarray) -> bytes:
                    if opus_enc is not None:
                        data = opus_enc.encode(opus.pad_to_packets(chunk))
                        return msgpack.packb({"type": "OggOpus", "data": data})
                    return msgpack.packb(
                        {"type": "Audio", "pcm": chunk.tolist()},
                        use_single_float=True,
                    )

                async def sender():
                    if frame_iter is not None:
                        async for chunk in frame_iter:
                            await ws.send_bytes(_audio_msg(chunk))
                    else:
                        n = len(pcm)
                        t_start = time.monotonic()
                        sent = 0
                        for i in range(0, n, FRAME):
                            chunk = np.asarray(pcm[i : i + FRAME], np.float32)
                            await ws.send_bytes(_audio_msg(chunk))
                            sent += len(chunk)
                            if rtf:
                                target = t_start + sent / 24_000.0 / rtf
                                delay = target - time.monotonic()
                                if delay > 0:
                                    await asyncio.sleep(delay)
                    # Graceful flush: a marker, then trailing silence until the
                    # marker comes back (a fixed count of frames could not
                    # drain stt-2.6b's 32-token delay).  The receive loop
                    # cancels this task when the marker arrives; the cap bounds
                    # a lost marker.
                    await ws.send_bytes(
                        msgpack.packb({"type": "Marker", "id": SHUTDOWN_MARKER})
                    )
                    silence = np.zeros(FRAME, np.float32)
                    for _ in range(150):
                        await ws.send_bytes(_audio_msg(silence))
                        await asyncio.sleep(0.04)

                send_task = asyncio.create_task(sender())
                try:
                    async for msg in ws:
                        if msg.type != aiohttp.WSMsgType.BINARY:
                            continue
                        ev = _to_event(msgpack.unpackb(msg.data, raw=False))
                        if ev is None:
                            continue
                        if on_event:
                            on_event(ev)
                        transcript.on_event(ev)
                        if ev.type == "marker" and ev.marker_id == SHUTDOWN_MARKER:
                            break
                finally:
                    send_task.cancel()
                close_code = ws.close_code
                if close_code in RETRYABLE_CLOSE_CODES:
                    raise ConnectionResetError(f"retryable close {close_code}")
        return transcript


def _to_event(m: dict) -> Optional[SttEvent]:
    t = m.get("type")
    if t == "Word":
        return SttEvent("word", text=m["text"], start_time=m["start_time"])
    if t == "EndWord":
        return SttEvent("end_word", stop_time=m["stop_time"])
    if t == "Step":
        return SttEvent("step", step_idx=m["step_idx"], prs=m.get("prs"))
    if t == "Marker":
        return SttEvent("marker", marker_id=m["id"])
    if t == "Ready":
        return SttEvent("ready")
    return None
