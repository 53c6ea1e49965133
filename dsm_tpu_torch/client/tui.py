"""Terminal UI duplex client (counterpart of ``dsm_tpu/client/tui.py``).

A terminal client of the byte-tag duplex protocol (``/api/chat``): it streams
a WAV file (or silence) up at the real-time 80 ms cadence and renders the
model's streaming text and the audio, level and frame counters.

The UI state (``TuiState``) is pure and testable; ``run_tui`` wraps it in
curses, and ``DuplexTuiClient`` drives the WebSocket.  The wire is Opus both
ways where libopus and libogg load (moshi-cli multistream.rs:5-113: a page
an 80 ms frame up, the server's pages decoded), raw pcm (``?format=pcm``)
otherwise or when asked.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np

from ..server.duplex import audio_frame, parse_frame
from ..server.protocol import MsgType

SAMPLE_RATE = 24_000
FRAME_SIZE = 1920  # 80 ms


def pcm_frames(pcm: Optional[np.ndarray], n_frames: int):
    """Yield ``n_frames`` frames of 1920 samples: the file content padded
    with trailing silence (kyutai-cli stt.rs pacing model)."""
    for i in range(n_frames):
        lo = i * FRAME_SIZE
        if pcm is None or lo >= len(pcm):
            yield np.zeros(FRAME_SIZE, np.float32)
        else:
            chunk = pcm[lo : lo + FRAME_SIZE]
            if len(chunk) < FRAME_SIZE:
                chunk = np.pad(chunk, (0, FRAME_SIZE - len(chunk)))
            yield chunk.astype(np.float32)


def level_db(pcm: np.ndarray) -> float:
    """RMS level in dBFS (client-core audio.rs AudioLevel)."""
    rms = float(np.sqrt(np.mean(np.square(pcm)))) if pcm.size else 0.0
    return 20.0 * np.log10(max(rms, 1e-6))


@dataclasses.dataclass
class TuiState:
    """Everything the TUI renders; updated by the client tasks."""

    transcript: str = ""
    frames_sent: int = 0
    frames_recv: int = 0
    tx_level_db: float = -120.0
    rx_level_db: float = -120.0
    connected: bool = False
    status: str = "connecting"
    _recent_text: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=64)
    )

    def on_text(self, text: str) -> None:
        self.transcript += text
        self._recent_text.append(text)

    def on_audio(self, pcm: np.ndarray) -> None:
        self.frames_recv += 1
        self.rx_level_db = level_db(pcm)

    def on_sent(self, pcm: np.ndarray) -> None:
        self.frames_sent += 1
        self.tx_level_db = level_db(pcm)

    @property
    def rx_seconds(self) -> float:
        return self.frames_recv * FRAME_SIZE / SAMPLE_RATE

    def meter(self, db: float, width: int = 20) -> str:
        # -60 dB .. 0 dB mapped onto `width` cells.
        filled = int(max(0.0, min(1.0, (db + 60.0) / 60.0)) * width)
        return "#" * filled + "-" * (width - filled)

    def render_lines(self, width: int = 80, height: int = 24) -> List[str]:
        """Render the whole screen as plain strings (testable; curses just
        blits these)."""
        bar = "=" * min(width, 80)
        head = f" dsm-tpu duplex  [{self.status}]"
        stats = (
            f" tx {self.frames_sent:5d} frames   rx {self.frames_recv:5d}"
            f" frames ({self.rx_seconds:6.1f}s audio)"
        )
        meters = (
            f" mic  [{self.meter(self.tx_level_db)}] {self.tx_level_db:6.1f} dB"
            f"   spk [{self.meter(self.rx_level_db)}] {self.rx_level_db:6.1f} dB"
        )
        lines = [head, bar, stats, meters, bar]
        body_rows = max(1, height - len(lines) - 1)
        words = self.transcript.split(" ")
        wrapped: List[str] = [""]
        for w in words:
            if not w:
                continue
            if len(wrapped[-1]) + len(w) + 1 > width - 2:
                wrapped.append(w)
            else:
                wrapped[-1] = (wrapped[-1] + " " + w).strip()
        lines.extend(wrapped[-body_rows:])
        return [ln[:width] for ln in lines]


class DuplexTuiClient:
    """Streams audio to /api/chat and feeds a TuiState."""

    def __init__(self, url: str, token: Optional[str] = None,
                 wav_path: Optional[str] = None, seconds: float = 30.0,
                 drain_s: float = 2.0, fmt: Optional[str] = None):
        self.url = url
        self.token = token
        self.wav_path = wav_path
        self.seconds = seconds
        self.drain_s = drain_s  # keep receiving after the last sent frame
        self.state = TuiState()
        if fmt is None:
            from ..utils import opus

            fmt = "opus" if opus.available() else "pcm"
        self.fmt = fmt

    async def run(self, on_update=None) -> TuiState:
        import aiohttp

        from ..utils.audio import decode_audio

        pcm = decode_audio(self.wav_path, SAMPLE_RATE) if self.wav_path else None
        n_frames = int(self.seconds / 0.080)
        headers = {}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        st = self.state
        url = self.url
        enc = dec = None
        if self.fmt == "opus":
            from ..utils import opus

            enc, dec = opus.OggOpusEncoder(), opus.OggOpusDecoder()
        else:
            sep = "&" if "?" in url else "?"
            url = f"{url}{sep}format=pcm"
        async with aiohttp.ClientSession() as session:
            async with session.ws_connect(url, headers=headers) as ws:
                st.connected = True
                st.status = "streaming"

                async def sender():
                    t0 = time.monotonic()
                    for i, frame in enumerate(pcm_frames(pcm, n_frames)):
                        if enc is None:
                            await ws.send_bytes(audio_frame(frame))
                        else:
                            data = enc.encode(frame)
                            if data:
                                await ws.send_bytes(bytes([MsgType.AUDIO]) + data)
                        st.on_sent(frame)
                        if on_update:
                            on_update(st)
                        # Real-time pacing against the wall clock.
                        target = t0 + (i + 1) * 0.080
                        dt = target - time.monotonic()
                        if dt > 0:
                            await asyncio.sleep(dt)

                send_task = asyncio.create_task(sender())
                # Receive until the upload is done AND either we heard the
                # model or the drain window expired (the model lags its
                # input by the acoustic delay + first-step compile).
                drain_from = None
                while True:
                    try:
                        msg = await ws.receive(timeout=0.25)
                    except asyncio.TimeoutError:
                        msg = None
                    if msg is not None:
                        if msg.type in (
                            aiohttp.WSMsgType.CLOSE,
                            aiohttp.WSMsgType.CLOSING,
                            aiohttp.WSMsgType.CLOSED,
                            aiohttp.WSMsgType.ERROR,
                        ):
                            break
                        if msg.type == aiohttp.WSMsgType.BINARY and msg.data:
                            tag, payload = parse_frame(msg.data)
                            if tag == MsgType.TEXT:
                                st.on_text(payload.decode())
                            elif tag == MsgType.AUDIO:
                                if dec is None:
                                    st.on_audio(np.frombuffer(payload, "<f4"))
                                else:
                                    out = dec.decode(payload)
                                    if len(out):
                                        st.on_audio(out)
                            if on_update:
                                on_update(st)
                    if send_task.done():
                        if drain_from is None:
                            drain_from = time.monotonic()
                            st.status = "draining"
                        idle = time.monotonic() - drain_from
                        if st.frames_recv > 0 or idle > self.drain_s:
                            break
                await send_task
                if not ws.closed:
                    await ws.close()
                st.status = "done"
        return st


def run_tui(url: str, token: Optional[str] = None,
            wav_path: Optional[str] = None, seconds: float = 30.0) -> TuiState:
    """Curses entry point (the ``tui`` subcommand)."""
    import curses

    client = DuplexTuiClient(url, token=token, wav_path=wav_path,
                             seconds=seconds)

    def main(scr):
        curses.curs_set(0)
        scr.nodelay(True)

        def draw(st: TuiState):
            h, w = scr.getmaxyx()
            scr.erase()
            for y, line in enumerate(st.render_lines(w - 1, h)):
                if y < h - 1:
                    scr.addstr(y, 0, line)
            scr.refresh()

        return asyncio.run(client.run(on_update=draw))

    return curses.wrapper(main)
