"""Live microphone capture and speaker playback for the clients
(counterpart of ``dsm_tpu/client/audio_io.py``).

Capture mono pcm at 24 kHz in 1,920-sample chunks (one Mimi frame); play it
back through a ring buffer with a prebuffer; resample linearly across chunk
boundaries; meter the level in dBFS.

The device layer is optional: it uses the ``sounddevice`` (PortAudio)
package when it imports and raises ``AudioUnavailable`` otherwise, so file
and silence streaming keep working on a host without audio devices.  The
streaming resampler, the prebuffered playback ring and the level meter are
pure Python and numpy, and run without hardware.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

TARGET_RATE = 24_000
FRAME = 1920  # 80 ms at 24 kHz — one Mimi frame (mic.rs chunking)


class AudioUnavailable(RuntimeError):
    """No live-audio backend on this host (install ``sounddevice`` +
    PortAudio for mic/speaker support; file and silence streaming still
    work)."""


def _sounddevice():
    try:
        import sounddevice  # noqa: F401  (optional dependency)
        return sounddevice
    except Exception:
        return None


def backend_name() -> Optional[str]:
    """The live-audio backend in use, or None (gated, never raises)."""
    return "sounddevice" if _sounddevice() is not None else None


def require_backend():
    sd = _sounddevice()
    if sd is None:
        raise AudioUnavailable(
            "live audio requires the 'sounddevice' package (PortAudio); "
            "not available on this host — use file input/output instead"
        )
    return sd


class StreamingResampler:
    """Stateful linear resampler, mono float32 (audio.rs linear resampler).

    Keeps one sample of history so chunk boundaries are seamless; the
    fractional read position carries across calls.
    """

    def __init__(self, src_rate: int, dst_rate: int):
        if src_rate <= 0 or dst_rate <= 0:
            raise ValueError("rates must be positive")
        self.src_rate = src_rate
        self.dst_rate = dst_rate
        self._prev = np.zeros(0, np.float32)  # at most 1 carried sample
        self._pos = 0.0  # fractional index into [prev + chunk]

    def process(self, chunk: np.ndarray) -> np.ndarray:
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        if self.src_rate == self.dst_rate:
            return chunk
        buf = np.concatenate([self._prev, chunk])
        if len(buf) < 2:
            self._prev = buf
            return np.zeros(0, np.float32)
        step = self.src_rate / self.dst_rate
        # Output positions pos, pos+step, ... that have both neighbours.
        n_out = int(np.floor((len(buf) - 1 - self._pos) / step)) + 1
        if n_out <= 0:
            self._prev = buf
            return np.zeros(0, np.float32)
        pos = self._pos + step * np.arange(n_out)
        i0 = pos.astype(np.int64)
        frac = (pos - i0).astype(np.float32)
        out = buf[i0] * (1.0 - frac) + buf[np.minimum(i0 + 1, len(buf) - 1)] * frac
        next_pos = self._pos + step * n_out
        # The next output position can land past the current buffer end
        # (integer decimation ratios); keep the position offset consistent
        # with the samples actually retained.
        keep_from = min(int(np.floor(next_pos)), len(buf))
        self._pos = next_pos - keep_from
        self._prev = buf[keep_from:]
        return out.astype(np.float32)


class AudioLevel:
    """Smoothed RMS level in dBFS (client-core audio.rs AudioLevel)."""

    def __init__(self, smoothing: float = 0.7):
        self.smoothing = smoothing
        self.db = -120.0

    def update(self, pcm: np.ndarray) -> float:
        pcm = np.asarray(pcm, np.float32)
        rms = float(np.sqrt(np.mean(pcm * pcm))) if pcm.size else 0.0
        inst = 20.0 * np.log10(max(rms, 1e-6))
        self.db = self.smoothing * self.db + (1.0 - self.smoothing) * inst
        return self.db


class PlaybackBuffer:
    """Prebuffered playback ring (audio.rs AudioPlayer ring buffer).

    ``push`` appends decoded pcm; ``pull(n)`` feeds the device callback —
    it emits silence until ``prebuffer`` samples have accumulated (jitter
    absorption) and zero-fills underruns, counting them.
    """

    def __init__(self, prebuffer: int = 3 * FRAME, max_buffer: int = 24_000 * 30):
        self.prebuffer = prebuffer
        self.max_buffer = max_buffer
        self._chunks: list[np.ndarray] = []
        self._buffered = 0
        self._started = False
        self.underruns = 0
        self.dropped = 0
        self._lock = threading.Lock()

    @property
    def buffered(self) -> int:
        return self._buffered

    def push(self, pcm: np.ndarray) -> None:
        pcm = np.asarray(pcm, np.float32).reshape(-1)
        if not pcm.size:
            return
        with self._lock:
            if self._buffered + pcm.size > self.max_buffer:
                self.dropped += pcm.size
                return
            self._chunks.append(pcm)
            self._buffered += pcm.size
            if self._buffered >= self.prebuffer:
                self._started = True

    def flush_start(self) -> None:
        """End-of-stream: start playback even below the prebuffer threshold
        so the tail (or a very short utterance) is not discarded."""
        with self._lock:
            if self._buffered > 0:
                self._started = True

    def pull(self, n: int) -> np.ndarray:
        out = np.zeros(n, np.float32)
        with self._lock:
            if not self._started:
                return out
            filled = 0
            while filled < n and self._chunks:
                head = self._chunks[0]
                take = min(n - filled, len(head))
                out[filled : filled + take] = head[:take]
                if take == len(head):
                    self._chunks.pop(0)
                else:
                    self._chunks[0] = head[take:]
                filled += take
            self._buffered -= filled
            if filled < n:
                self.underruns += 1
                self._started = False  # re-prebuffer after an underrun
        return out

    def drain_remaining(self) -> np.ndarray:
        with self._lock:
            if not self._chunks:
                return np.zeros(0, np.float32)
            out = np.concatenate(self._chunks)
            self._chunks.clear()
            self._buffered = 0
            return out


class MicSource:
    """Capture mono pcm from the default input device, resampled to 24 kHz
    and re-chunked to 1920-sample frames (mic.rs capture loop)."""

    def __init__(self, device=None, frame: int = FRAME):
        self.sd = require_backend()
        self.device = device
        self.frame = frame
        self._q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=256)
        self._rem = np.zeros(0, np.float32)
        self._stream = None
        self._resampler = None
        self.level = AudioLevel()

    def __enter__(self):
        info = self.sd.query_devices(self.device, "input")
        rate = int(info["default_samplerate"])
        self._resampler = StreamingResampler(rate, TARGET_RATE)

        def callback(indata, frames, time_info, status):
            mono = np.mean(np.asarray(indata, np.float32), axis=1)
            try:
                self._q.put_nowait(mono)
            except queue.Full:
                pass  # drop on backpressure, like the bounded cpal channel

        self._stream = self.sd.InputStream(
            samplerate=rate, channels=max(1, int(info["max_input_channels"])),
            device=self.device, callback=callback,
        )
        self._stream.start()
        return self

    def __exit__(self, *exc):
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
        return False

    def read_frame(self, timeout: float = 2.0) -> Optional[np.ndarray]:
        """Next 1920-sample 24 kHz frame, or None on capture timeout."""
        while len(self._rem) < self.frame:
            try:
                raw = self._q.get(timeout=timeout)
            except queue.Empty:
                return None
            self._rem = np.concatenate([self._rem, self._resampler.process(raw)])
        out, self._rem = self._rem[: self.frame], self._rem[self.frame :]
        self.level.update(out)
        return out


class SpeakerSink:
    """Play 24 kHz mono pcm through the default output device via a
    prebuffered ring (audio.rs AudioPlayer)."""

    def __init__(self, device=None, prebuffer_frames: int = 3):
        self.sd = require_backend()
        self.device = device
        self.ring = PlaybackBuffer(prebuffer=prebuffer_frames * FRAME)
        self._stream = None
        self._resampler = None

    def __enter__(self):
        info = self.sd.query_devices(self.device, "output")
        rate = int(info["default_samplerate"])
        self._resampler = StreamingResampler(TARGET_RATE, rate)

        def callback(outdata, frames, time_info, status):
            outdata[:, 0] = self.ring.pull(frames)
            for c in range(1, outdata.shape[1]):
                outdata[:, c] = outdata[:, 0]

        self._stream = self.sd.OutputStream(
            samplerate=rate, channels=1, device=self.device, callback=callback,
        )
        self._stream.start()
        return self

    def __exit__(self, *exc):
        self.drain()
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
        return False

    def push(self, pcm: np.ndarray) -> None:
        self.ring.push(self._resampler.process(pcm))

    def drain(self, timeout: float = 10.0) -> None:
        """Block until the ring empties (end-of-utterance playback).

        Forces playback past the prebuffer gate first — otherwise a short
        utterance (or an after-underrun tail) below the threshold would
        never start and drain would hang out its timeout, discarding audio.
        """
        import time as _t

        self.ring.flush_start()
        deadline = _t.monotonic() + timeout
        while self.ring.buffered > 0 and _t.monotonic() < deadline:
            self.ring.flush_start()  # restart after any underrun re-gate
            _t.sleep(0.02)
