"""Continuous-batching streaming ASR engine (counterpart of
``dsm_tpu/server/batched_asr.py``).

A fixed pool of slots, a pcm mailbox per connection, one model loop that
packs one ``(B, 1, 1920)`` frame per tick and runs ``sessions.asr.step`` on
the device, markers delivered once their audio has been decoded, per-slot
reset on reuse.  The public surface is the JAX engine's, so the engine runs
inside ``dsm_tpu.server.app.App`` unchanged.

Left out for now (ROADMAP.md): the device mesh, the native frame packer,
the int16 pcm wire, prometheus metrics, session logs and dispatch-ahead
beyond one step in flight.  Mailboxes use the Python deque path.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
import traceback
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..sessions import asr as ASR

FRAME_SIZE = 1920  # 80 ms at 24 kHz


@dataclasses.dataclass
class Events:
    """Per-tick events for one slot, delivered to its connection."""

    slot: int
    channel_id: int
    words: List[object]
    markers: List[int]
    step_idx: int
    prs: Optional[np.ndarray]


class Channel:
    """Per-connection pcm mailbox."""

    _ids = itertools.count(1)

    def __init__(self, slot: int, deliver: Callable[[Events], None],
                 frame_size: Optional[int] = None):
        self.slot = slot
        self.channel_id = next(Channel._ids)
        self.frame_size = frame_size or FRAME_SIZE
        self.pcm = deque()
        self.pcm_samples = 0
        # Cumulative samples pushed: the marker due step is computed from it.
        self.samples_pushed = 0
        self.markers: List[tuple] = []  # (due_step, marker_id) heap
        self.deliver = deliver
        self.lock = threading.Lock()
        self.closed = False
        self.steps = 0
        self.last_data = time.time()

    def push_pcm(self, pcm: np.ndarray) -> None:
        self.last_data = time.time()
        self.samples_pushed += len(pcm)
        with self.lock:
            self.pcm.append(np.asarray(pcm, np.float32))
            self.pcm_samples += len(pcm)

    def buffered_samples(self) -> int:
        return self.pcm_samples

    def take_frame(self) -> Optional[np.ndarray]:
        frame = self.frame_size
        with self.lock:
            if self.pcm_samples < frame:
                return None
            out = np.empty(frame, np.float32)
            pos = 0
            while pos < frame:
                chunk = self.pcm[0]
                n = min(len(chunk), frame - pos)
                out[pos:pos + n] = chunk[:n]
                pos += n
                if n == len(chunk):
                    self.pcm.popleft()
                else:
                    self.pcm[0] = chunk[n:]
            self.pcm_samples -= frame
            return out


class BatchedAsrEngine:
    """Slot pool and model loop for one ASR module on one device."""

    tick_sleep = 0.002  # idle wait of the model loop, seconds

    def __init__(self, cfg: ASR.AsrConfig, params: dict, batch_size: int,
                 device="cpu", fill_gate_frac: float = 0.2):
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.device = torch.device(device)
        # bf16 rings on the card, f32 on the CPU (int8 when cfg.kv_quant).
        cache_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.state = ASR.init_state(cfg, batch_size, cache_dtype, self.device)
        self.frame_size = cfg.mimi.frame_size
        self.tokenizer = None  # sentencepiece is not ported yet: App prints ids
        self.word_state = ASR.WordState(cfg, batch_size)
        self.step_count = 0

        # Fill gating, as in the JAX engine: hold a partial-batch dispatch
        # for up to this fraction of a frame period while live stragglers
        # are expected, so one device step serves the whole 80 ms burst.
        self._fill_gate_frac = fill_gate_frac
        self._frame_period_s = self.frame_size / cfg.mimi.sample_rate
        self._gate_t0 = None

        self.slots: List[Optional[Channel]] = [None] * batch_size
        self.free: deque = deque(range(batch_size))
        self.pending_resets = np.zeros(batch_size, bool)
        self.slot_lock = threading.Lock()
        self.running = False
        self.thread: Optional[threading.Thread] = None
        # One step in flight: a tick dispatches its step, then the previous
        # step's results are fetched and delivered (inline, or by the drain
        # thread once start() has run).
        self.pipeline_depth = 1
        self._pending: deque = deque()
        self._pending_cv = threading.Condition()
        self._inflight = 0
        self._drain_thread: Optional[threading.Thread] = None
        self._pcm_buf = np.zeros((batch_size, 1, self.frame_size), np.float32)

    # -- slot lifecycle --

    def used_slots(self) -> int:
        with self.slot_lock:
            return self.batch_size - len(self.free)

    def open_channel(self, deliver: Callable[[Events], None],
                     seed: Optional[int] = None) -> Optional[Channel]:
        """A channel on a free slot, or None at capacity.  ``seed`` is
        accepted for the JAX engine's signature; greedy decoding reads no
        seed."""
        del seed
        with self.slot_lock:
            if not self.free:
                return None
            slot = self.free.popleft()
            ch = Channel(slot, deliver, frame_size=self.frame_size)
            self.slots[slot] = ch
            self.pending_resets[slot] = True
            self.word_state.reset_slot(slot)
        return ch

    def close_channel(self, ch: Channel) -> None:
        with self.slot_lock:
            ch.closed = True
            if self.slots[ch.slot] is ch:
                self.slots[ch.slot] = None
                self.free.append(ch.slot)

    def add_marker(self, ch: Channel, marker_id: int) -> None:
        """The marker is due once all audio sent before it has been decoded,
        plus the ASR delay."""
        due = ch.samples_pushed // self.frame_size + self.cfg.asr_delay_in_tokens
        heapq.heappush(ch.markers, (due, marker_id))

    # -- device loop --

    def start(self) -> None:
        self.running = True
        self._drain_thread = threading.Thread(
            target=self._drain_loop, name="asr-post-loop", daemon=True)
        self._drain_thread.start()
        self.thread = threading.Thread(
            target=self._loop, name="asr-model-loop", daemon=True)
        self.thread.start()

    def stop(self) -> None:
        self.running = False
        with self._pending_cv:
            self._pending_cv.notify_all()
        if self.thread:
            self.thread.join(timeout=5)
        if self._drain_thread:
            self._drain_thread.join(timeout=5)
            self._drain_thread = None

    def _invoke_step(self, pcm: np.ndarray, mask: np.ndarray, reset: np.ndarray):
        dev = self.device
        out, self.state = ASR.step(
            self.cfg, self.params, self.state,
            torch.as_tensor(pcm, device=dev), torch.as_tensor(mask, device=dev),
            torch.as_tensor(reset, device=dev))
        return out

    def warmup(self, steps: int = 2) -> None:
        """Run zero frames through the whole step (no slot active)."""
        zeros = np.zeros((self.batch_size, 1, self.frame_size), np.float32)
        off = np.zeros(self.batch_size, bool)
        with torch.inference_mode():
            for _ in range(steps):
                out = self._invoke_step(zeros, off, off)
        out["text_token"].cpu()  # waits for the device

    def tick(self) -> bool:
        """One engine tick; True if any slot stepped or results were drained."""
        t_pre0 = time.perf_counter()
        mask = np.zeros(self.batch_size, bool)
        reset = np.zeros(self.batch_size, bool)
        chans: List[Optional[Channel]] = [None] * self.batch_size

        if self._fill_gate_frac > 0 and self._fill_gated(t_pre0):
            if self._pending and self._drain_thread is None:
                self._drain_one()
            return False

        with self.slot_lock:
            reset[:] = self.pending_resets
            self.pending_resets[:] = False
            for slot, ch in enumerate(self.slots):
                if ch is None or ch.closed:
                    continue
                frame = ch.take_frame()
                if frame is not None:
                    self._pcm_buf[slot, 0, :] = frame
                    mask[slot] = True
                    chans[slot] = ch

        if not mask.any() and not reset.any():
            if self._pending and self._drain_thread is None:
                self._drain_one()
                return True
            return False

        t0 = time.perf_counter()
        with torch.inference_mode():
            out = self._invoke_step(self._pcm_buf, mask, reset)
        self.step_count += 1
        with self._pending_cv:
            self._pending.append((out, mask.copy(), chans, t0))
            self._inflight += 1
            self._pending_cv.notify_all()
            if self._drain_thread is not None:
                while self._inflight > self.pipeline_depth and self.running:
                    self._pending_cv.wait(timeout=0.5)
        if self._drain_thread is None:
            while self._inflight > self.pipeline_depth:
                self._drain_one()
        return True

    def _fill_gated(self, now: float) -> bool:
        """True while a partial batch waits for live stragglers."""
        n_open = n_ready = 0
        catchup = False
        stale_cutoff = time.time() - 2 * self._frame_period_s
        with self.slot_lock:
            any_reset = bool(self.pending_resets.any())
            for ch in self.slots:
                if ch is None or ch.closed:
                    continue
                buf = ch.buffered_samples()
                if buf >= self.frame_size:
                    n_open += 1
                    n_ready += 1
                    # 2+ frames queued: catching up, not pacing live audio.
                    catchup = catchup or buf >= 2 * self.frame_size
                elif ch.last_data >= stale_cutoff:
                    n_open += 1  # a live straggler worth waiting for
        if 0 < n_ready < n_open and not catchup and not any_reset:
            if self._gate_t0 is None:
                self._gate_t0 = now
            if now - self._gate_t0 < self._frame_period_s * self._fill_gate_frac:
                return True
        self._gate_t0 = None
        return False

    def _drain_loop(self) -> None:
        while True:
            with self._pending_cv:
                while not self._pending and self.running:
                    self._pending_cv.wait(timeout=0.5)
                if not self._pending:
                    if not self.running:
                        return
                    continue
                item = self._pending.popleft()
            try:
                self._process_item(item)
            except Exception:  # the post loop must outlive one bad step
                traceback.print_exc()
            finally:
                with self._pending_cv:
                    self._inflight -= 1
                    self._pending_cv.notify_all()

    def _drain_one(self) -> None:
        with self._pending_cv:
            if not self._pending:
                return
            item = self._pending.popleft()
        try:
            self._process_item(item)
        finally:
            with self._pending_cv:
                self._inflight -= 1
                self._pending_cv.notify_all()

    def _process_item(self, item) -> None:
        out, mask, chans, _t0 = item
        text_tokens = out["text_token"].cpu().numpy()
        step_idx = out["step_idx"].cpu().numpy()
        prs = out["prs"].cpu().numpy() if out["prs"].shape[-1] else None

        events = self.word_state.process(text_tokens, step_idx, mask)
        by_slot: Dict[int, List[object]] = {}
        for ev in events:
            by_slot.setdefault(ev.batch_idx, []).append(ev)

        for slot, ch in enumerate(chans):
            if ch is None:
                continue
            ch.steps = int(step_idx[slot])
            due_markers = []
            while ch.markers and ch.markers[0][0] <= ch.steps:
                due_markers.append(heapq.heappop(ch.markers)[1])
            ev = Events(slot=slot, channel_id=ch.channel_id,
                        words=by_slot.get(slot, []), markers=due_markers,
                        step_idx=ch.steps,
                        prs=prs[slot] if prs is not None else None)
            # Deliver only while the slot still belongs to this channel.
            if not ch.closed and self.slots[slot] is ch:
                ch.deliver(ev)

    def flush(self) -> None:
        """Deliver every step in flight."""
        if self._drain_thread is not None:
            with self._pending_cv:
                while self._inflight > 0 and self._drain_thread.is_alive():
                    self._pending_cv.wait(timeout=0.5)
            if self._drain_thread.is_alive():
                return
        while self._pending:
            self._drain_one()

    def _loop(self) -> None:
        while self.running:
            try:
                if not self.tick():
                    time.sleep(self.tick_sleep)
            except Exception:  # the model loop must outlive one bad tick
                traceback.print_exc()
                time.sleep(0.1)
