"""Continuous-batching streaming ASR engine (counterpart of
``dsm_tpu/server/batched_asr.py``).

A fixed pool of slots, a pcm mailbox per connection, one model loop that
packs one ``(B, 1, 1920)`` frame per tick and runs ``sessions.asr.step`` on
the device, markers delivered once their audio has been decoded, per-slot
reset on reuse.  The public surface is the JAX engine's; the port's own
``server/app.py`` serves it.

A step's host-bound outputs leave the device as one int32 array packed as
the JAX engine packs them (:func:`pack_outputs`): text tokens, step
counters, then the VAD probabilities in 1e-6 fixed point (truncated),
unpacked on the host by the JAX engine's numpy expressions.

On a CUDA device the step is one captured CUDA graph, the counterpart of the
JAX engine's ``jax.jit(step, donate_argnums=(1,))``: :meth:`warmup` runs the
step eagerly on the side stream it captures on (every kernel built, every
lazy device constant made, cuBLAS's workspace there), then captures
``sessions.asr.step_in_place`` and the packing once over the engine's state
buffers and static input buffers, and every tick copies pcm, mask, reset and
seeds through pinned host staging into those buffers and replays the graph.
Right after each replay the packed array is copied into the next of
``pipeline_depth + 1`` pinned host buffers behind an event; the
post-process waits on that event alone, so fetching a step never waits for
a later replay, and a buffer comes round again only after its step was
post-processed.  A capture that fails raises; the engine never falls back
to the eager step.  ``cuda_graph=False`` runs the eager step (the reference
the card's checks hold the graph to); the CPU has no graph.

Dispatch-ahead is the JAX engine's rule: after a dispatch the tick drains
while more than ``pipeline_depth`` steps are in flight (0: synchronous, 1:
one step in flight, 2: two).  With ``pcm_wire_int16`` the pcm goes up as
int16, ``(clip(pcm, -1, 1) * 32767).astype(int16)`` on the host, and the
step dequantises it on the device as its first node (:func:`wire_in`).

Mailboxes: with ``use_native_packer`` (the default where it builds), the
native frame packer (``server/native.py``): each channel pushes into its
slot's SPSC ring and the tick packs every active slot in one pass into the
engine's pcm buffer.  A push that the ring cannot take whole keeps its rest
in the channel's overflow, moved into the ring before each pack, so no
sample is dropped and the frames are those of the deque path (the JAX
channel drops them).  Without it, a Python deque a channel.

The JAX engine's prometheus calls (``server/metrics.py``) are made at its
call sites, from host values only: steps and frames at the dispatch,
durations at the drain after the fetch.  A ``session_logger``
(``utils/session_log.SessionLogger``) logs each delivered step's text token
and the step's audio codes, which then ride at the end of the packed array.

On a device mesh (``mesh=``, ``parallel/mesh.py``; TOML ``[modules.X.mesh]``)
the engine keeps one engine of its own class a shard, and its tick stages,
runs and fetches every shard, as the JAX engine's one ``shard_map``ped step
does.  Under dp, slot ``s`` lives on shard ``s // (B/dp)``, which holds the
whole params on its device and its slots' state; each shard's step is its own
captured graph on its own card, with dispatch-ahead kept (the shards' packed
arrays are fetched and merged into the unmeshed engine's layout).  Under dp x
tp the main LM is split over heads and MLP hidden with the three joins
summed across the tp shards of a replica: on the card, where those shards
share it, they are one captured graph launched from tp shard 0
(``parallel.mesh.DeviceJoin``); elsewhere they run the eager step in
lock-step, one host thread each (a replica across cards: said in the log,
``cuda_graph=True`` raises).  The text tokens are drawn from per-slot keys,
so the meshed engine's events are the unmeshed engine's under dp.  Under a
mesh the pcm goes up on the f32 wire, as in the JAX engine, which drops the
int16 wire there; the engine logs that the wire was not taken.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import logging
import threading
import time
import traceback
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..parallel import mesh as M
from ..sessions import asr as ASR
from ..utils.gc_tune import freeze_after_warmup
from . import metrics
from .cuda_graph import PinnedOutputs, StagedInputs, capture, fetch
from .native import FramePacker

log = logging.getLogger("dsm.torch.asr")

FRAME_SIZE = 1920  # 80 ms at 24 kHz


def wire_out(pcm: np.ndarray) -> np.ndarray:
    """f32 pcm -> the int16 upload wire (truncating, as the JAX engine)."""
    return (np.clip(pcm, -1.0, 1.0) * 32767.0).astype(np.int16)


def wire_in(pcm: torch.Tensor) -> torch.Tensor:
    """The int16 wire -> f32 on the device: a product with the f32
    constant 1/32767, as the JAX engine's ``_wire_in``."""
    return pcm.to(torch.float32) * (1.0 / 32767.0)


def pack_outputs(out: dict, codes: bool = False) -> torch.Tensor:
    """A step's host-bound outputs as one int32 array: text tokens, step
    counters, then ``prs`` as 1e-6 fixed point (truncated), as the JAX
    engine packs them; with ``codes``, the audio codes ``(B, K)`` last."""
    parts = [out["text_token"].to(torch.int32), out["step_idx"].to(torch.int32)]
    if out["prs"].shape[-1]:
        parts.append((out["prs"].to(torch.float32) * 1e6).to(torch.int32).reshape(-1))
    if codes:
        parts.append(out["codes"].to(torch.int32).reshape(-1))
    return torch.cat(parts)


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
    """Per-connection pcm mailbox: the slot's ring of ``packer`` (with an
    overflow of what the ring did not take), or a deque of chunks."""

    _ids = itertools.count(1)

    def __init__(self, slot: int, deliver: Callable[[Events], None],
                 frame_size: Optional[int] = None,
                 packer: Optional[FramePacker] = None):
        self.slot = slot
        self.channel_id = next(Channel._ids)
        self.frame_size = frame_size or FRAME_SIZE
        self.packer = packer
        self.pcm = deque()  # the deque path's chunks, or the packer's overflow
        self.pcm_samples = 0  # samples in ``pcm``
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
        pcm = np.asarray(pcm, np.float32)
        with self.lock:
            if self.packer is not None and not self.pcm:
                taken = self.packer.push(self.slot, pcm)
                if taken == len(pcm):
                    return
                pcm = pcm[taken:]
            self.pcm.append(pcm)
            self.pcm_samples += len(pcm)

    def refill(self) -> None:
        """Move the overflow into the slot's ring as far as it has room (the
        tick calls it before each pack: the ring's one producer at a time,
        under the channel's lock)."""
        with self.lock:
            while self.pcm:
                chunk = self.pcm[0]
                taken = self.packer.push(self.slot, chunk)
                self.pcm_samples -= taken
                if taken < len(chunk):
                    self.pcm[0] = chunk[taken:]
                    return
                self.pcm.popleft()

    def buffered_samples(self) -> int:
        if self.packer is not None:
            return int(self.packer.available(self.slot)) + self.pcm_samples
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


class BatchedAsrEngine(M.ShardedEngine):
    """Slot pool and model loop for one ASR module on one device (the card
    unless ``device`` names another, as the JAX engine lands on the
    accelerator) or on the shards of ``mesh``."""

    tick_sleep = 0.002  # idle wait of the model loop, seconds

    def __init__(self, cfg: ASR.AsrConfig, params: dict, batch_size: int,
                 device="cuda", fill_gate_frac: float = 0.2,
                 cuda_graph: Optional[bool] = None, pipeline_depth: int = 1,
                 pcm_wire_int16: bool = False, gc_tune: bool = True,
                 use_native_packer: Optional[bool] = None, session_logger=None,
                 mesh: Optional[M.Mesh] = None):
        """``use_native_packer``: None takes the native frame packer where it
        builds, True raises where it does not, False keeps the deque
        mailboxes.  ``session_logger``: a ``utils.session_log.SessionLogger``
        for every channel's text tokens and audio codes.  ``mesh``: serve on
        its shards (``device`` is then the first shard's)."""
        self.cfg = cfg
        self.gc_tune = gc_tune  # freeze the host GC after warm-up (utils/gc_tune.py)
        self.params = params
        self.batch_size = batch_size
        # The captured step (default on CUDA); none on the CPU.
        self._place(mesh, device, cuda_graph, "asr")
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        # bf16 rings on the card, f32 on the CPU (int8 when cfg.kv_quant).
        cache_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        # Under a mesh the shards hold the state (_build_shards).
        self.state = (ASR.init_state(cfg, batch_size, cache_dtype, self.device)
                      if mesh is None else None)
        self.frame_size = cfg.mimi.frame_size
        self.tokenizer = None  # set by the builder (utils/tokenizer.py)
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
        # Dispatch-ahead: up to pipeline_depth steps stay in flight after a
        # tick's dispatch; older ones are fetched and delivered (inline, or
        # by the drain thread once start() has run).
        self.pipeline_depth = max(int(pipeline_depth), 0)
        self._pcm_wire_int16 = bool(pcm_wire_int16)
        self._pending: deque = deque()
        self._pending_cv = threading.Condition()
        self._inflight = 0
        self._drain_thread: Optional[threading.Thread] = None
        self.session_logger = session_logger
        # The JAX engine's observers of each drained step, None unless the
        # caller sets them (``bench_perf.py``): ``step_observer(dt, util)``
        # with the step's dispatch-to-host-visible seconds and the share of
        # slots stepped; ``phase_observer(dict)`` with its dispatch time
        # ``t0`` and host phases in ms, ``queue_ms`` (dispatch to dequeue),
        # ``fetch_ms`` (dequeue to the post-process: the transfer and what
        # remains of the device step, at depth 2 the wait behind the newer
        # dispatch too) and ``post_ms`` (word decode and delivery), and
        # ``util``.  Under a mesh they fire once a step of the whole engine.
        self.step_observer: Optional[Callable[[float, float], None]] = None
        self.phase_observer: Optional[Callable[[dict], None]] = None
        self.packer: Optional[FramePacker] = None
        if use_native_packer or use_native_packer is None:
            try:
                self.packer = FramePacker(batch_size, self.frame_size)
            except Exception:
                if use_native_packer:
                    raise
        if self.packer is not None:  # pack() fills the step's pcm buffer itself
            self._pcm_buf = self.packer.frames[:, None, :]
            self._active = np.zeros(batch_size, bool)
        else:
            self._pcm_buf = np.zeros((batch_size, 1, self.frame_size), np.float32)
        # Per-slot sampling seeds (read at temperature > 0).
        self._seeds = np.zeros(batch_size, np.int64)
        self._seed_counter = int(time.time()) & 0x7FFFFFFF
        if mesh is not None:
            self._build_shards()

    def _build_shards(self) -> None:
        """:meth:`ShardedEngine._build_shards`, a shard's seeds a view of
        the engine's rows."""
        if self._pcm_wire_int16:
            log.warning("asr engine: pcm_wire int16 is not taken under a mesh (the JAX "
                        "engine drops it there too); the pcm goes up as f32")
            self._pcm_wire_int16 = False

        def shard(cfg, params, dev, b, d):
            sh = BatchedAsrEngine(cfg, params, b, device=dev, cuda_graph=self.cuda_graph,
                                  pipeline_depth=self.pipeline_depth, gc_tune=False,
                                  use_native_packer=False,
                                  session_logger=self.session_logger)
            sh._seeds = self._seeds[self._shard_slots(d)]
            return sh

        super()._build_shards("asr", shard)

    # -- slot lifecycle --

    def used_slots(self) -> int:
        with self.slot_lock:
            return self.batch_size - len(self.free)

    def open_channel(self, deliver: Callable[[Events], None],
                     seed: Optional[int] = None) -> Optional[Channel]:
        """A channel on a free slot, or None at capacity.  ``seed``: the
        request's sampling seed (a counter's next value when None), read
        at temperature > 0."""
        with self.slot_lock:
            if not self.free:
                return None
            slot = self.free.popleft()
            if seed is None:
                self._seed_counter = (self._seed_counter + 1) & 0xFFFFFFFF
                seed = self._seed_counter
            self._seeds[slot] = int(seed) & 0xFFFFFFFF
            if self.packer is not None:
                self.packer.reset_slot(slot)
            ch = Channel(slot, deliver, frame_size=self.frame_size, packer=self.packer)
            self.slots[slot] = ch
            self.pending_resets[slot] = True
            self.word_state.reset_slot(slot)
        if self.session_logger is not None:
            self.session_logger.open_session(f"asr-{ch.channel_id}")
        metrics.ASR_OPEN_CHANNELS.set(self.used_slots())
        return ch

    def close_channel(self, ch: Channel) -> None:
        with self.slot_lock:
            ch.closed = True
            if self.slots[ch.slot] is ch:
                self.slots[ch.slot] = None
                self.free.append(ch.slot)
        if self.session_logger is not None:
            self.session_logger.close_session(f"asr-{ch.channel_id}")
        metrics.ASR_OPEN_CHANNELS.set(self.used_slots())
        metrics.ASR_STEPS_PER_CONNECTION.observe(max(ch.steps, 0))

    def add_marker(self, ch: Channel, marker_id: int) -> None:
        """The marker is due once all audio sent before it has been decoded,
        plus the ASR delay."""
        due = ch.samples_pushed // self.frame_size + self.cfg.asr_delay_in_tokens
        heapq.heappush(ch.markers, (due, marker_id))

    # -- device loop --

    def start(self) -> None:
        if self.cuda_graph and not self._captured():
            self.warmup()  # capture before the threads start
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
        if self.thread is None or not self.thread.is_alive():
            while self._pending:  # tick()-driven: deliver what is in flight
                self._drain_one()
        self._close_shards()

    def _step(self, pcm: np.ndarray, mask: np.ndarray, reset: np.ndarray) -> dict:
        """One step on host arrays -> its outputs on the device, ``packed``
        among them: the replay's static outputs, which the next replay
        overwrites, or the eager step's."""
        if self._pcm_wire_int16:
            pcm = wire_out(pcm)
        if self.cuda_graph:
            if self._graph is None:
                raise RuntimeError("the CUDA graph step is not captured: call warmup() "
                                   "or start() first")
            self._inputs.stage({"pcm": pcm, "mask": mask, "reset": reset,
                                "seeds": self._seeds})
            self._graph.replay()
            return self._static_out
        dev = self.device
        x = torch.as_tensor(pcm, device=dev)
        with torch.inference_mode():
            out, self.state = ASR.step(
                self.cfg, self.params, self.state,
                wire_in(x) if self._pcm_wire_int16 else x,
                torch.as_tensor(mask, device=dev), torch.as_tensor(reset, device=dev),
                seeds=torch.as_tensor(self._seeds, device=dev))
            return dict(out, packed=pack_outputs(out, self.session_logger is not None))

    def _dispatch(self, pcm: np.ndarray, mask: np.ndarray, reset: np.ndarray):
        """Queue one step for host arrays -> its handle for
        ``cuda_graph.fetch``: on the graph, the replay's packed array copied
        into the next of ``pipeline_depth + 1`` pinned host buffers behind an
        event; on the eager step, the packed device tensor.  The host arrays
        may be reused once this returns.  Under a mesh: every shard's, as
        one ``parallel.mesh.MeshHandle``."""
        if self.mesh is not None:
            codes = (self.cfg.mimi.n_q,) if self.session_logger is not None else ()
            return M.MeshHandle(self._on_shards("_dispatch", pcm, mask, reset),
                                self._shard_b, (1, 1, None) + codes)
        packed = self._step(pcm, mask, reset)["packed"]
        return self._outputs.copy(packed) if self.cuda_graph else (packed, None)

    def _invoke_step(self, pcm: np.ndarray, mask: np.ndarray, reset: np.ndarray) -> dict:
        """One step on host arrays -> the step's outputs (``ASR.step``'s keys),
        tensors of their own (the card's checks read them beside the eager
        step's); under a mesh the shards' outputs joined on the first
        shard's device."""
        if self.mesh is not None:
            outs = self._on_shards("_invoke_step", pcm, mask, reset)
            return {k: torch.cat([out[k].to(self.device) for out in outs]) for k in outs[0]}
        with torch.inference_mode():
            return {k: v.clone() for k, v in self._step(pcm, mask, reset).items()
                    if k != "packed"}

    def _body(self) -> dict:
        """The step to capture: the wire's dequantisation, ``step_in_place``
        over the engine's state and the static input buffers, the packing."""
        x = self._inputs.buffers
        pcm = wire_in(x["pcm"]) if self._pcm_wire_int16 else x["pcm"]
        out = ASR.step_in_place(self.cfg, self.params, self.state, pcm, x["mask"],
                                x["reset"], seeds=x["seeds"])
        return dict(out, packed=pack_outputs(out, self.session_logger is not None))

    def _capture(self, steps: int) -> None:
        """Run the step ``steps`` times (at least once) on a side stream, with
        no slot active, then capture it there; raises if capture fails."""
        b, dev = self.batch_size, self.device
        pcm_dtype = torch.int16 if self._pcm_wire_int16 else torch.float32
        self._inputs = StagedInputs({
            "pcm": torch.zeros((b, 1, self.frame_size), dtype=pcm_dtype, device=dev),
            "mask": torch.zeros(b, dtype=torch.bool, device=dev),
            "reset": torch.zeros(b, dtype=torch.bool, device=dev),
            "seeds": torch.zeros(b, dtype=torch.int64, device=dev),
        })
        self._graph, self._static_out = capture(self._body, steps, dev, self._inputs)
        self._outputs = PinnedOutputs(self._static_out["packed"].shape,
                                      self.pipeline_depth + 1)

    def warmup(self, steps: int = 2) -> None:
        """Run zero frames through the whole step (no slot active); with
        ``cuda_graph``, through the step to capture, then capture it.  Then
        the host GC is frozen unless the engine was built with ``gc_tune=False``,
        as the JAX engine does.  Logs which mailboxes the engine serves with.
        Under a mesh every shard warms up (and captures)."""
        try:
            self._warm_all(steps)
            metrics.WARMUP_SUCCESS.inc()
        except Exception:
            metrics.WARMUP_FAILURE.inc()
            raise
        log.info("asr engine B=%d: %s mailboxes", self.batch_size,
                 "native frame packer" if self.packer is not None else "Python deque")
        freeze_after_warmup(self.gc_tune)

    def _warm(self, steps: int) -> None:
        """:meth:`warmup`'s device part: the capture, or eager steps."""
        if self.cuda_graph:
            if self._graph is None:
                self._capture(steps)
            return
        zeros = np.zeros((self.batch_size, 1, self.frame_size), np.float32)
        off = np.zeros(self.batch_size, bool)
        for _ in range(steps):
            handle = self._dispatch(zeros, off, off)
        fetch(handle)  # waits for the device

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
            if self.packer is not None:
                active = self._active
                active[:] = False
                for slot, ch in enumerate(self.slots):
                    if ch is not None and not ch.closed:
                        if ch.pcm:
                            ch.refill()
                        active[slot] = True
                        chans[slot] = ch
                _, mask, _ = self.packer.pack(active)  # into self._pcm_buf
                chans = [ch if mask[s] else None for s, ch in enumerate(chans)]
            else:
                for slot, ch in enumerate(self.slots):
                    if ch is None or ch.closed:
                        continue
                    frame = ch.take_frame()
                    if frame is not None:
                        self._pcm_buf[slot, 0, :] = frame
                        mask[slot] = True
                        chans[slot] = ch

        if not mask.any() and not reset.any():
            if any(ch is not None and not ch.closed for ch in self.slots):
                metrics.PIPELINE_STALLS.inc()  # open sessions, no frame ready
            if self._pending and self._drain_thread is None:
                self._drain_one()
                return True
            return False

        t0 = time.perf_counter()
        metrics.PIPELINE_PREPROCESS_DURATION.observe(t0 - t_pre0)
        handle = self._dispatch(self._pcm_buf, mask, reset)
        self.step_count += 1
        metrics.LM_STEPS_TOTAL.inc()
        metrics.MIMI_FRAMES_ENCODED.inc(int(mask.sum()))  # one codec frame an active slot
        metrics.LM_BATCH_UTILIZATION.observe(float(mask.mean()))
        with self._pending_cv:
            self._pending.append((handle, mask.copy(), chans, t0))
            self._inflight += 1
            metrics.LM_QUEUE_DEPTH.set(self._inflight)
            metrics.PIPELINE_CHANNEL_QUEUE_DEPTH.set(self._inflight)
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
                metrics.record_connection_error("internal", "asr")
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
        handle, mask, chans, t0 = item
        t_deq = time.perf_counter()
        packed = fetch(handle)  # one transfer
        b = self.batch_size
        text_tokens = packed[:b]
        step_idx = packed[b:2 * b]
        end = packed.shape[0]
        if self.session_logger is not None:
            end -= b * self.cfg.mimi.n_q
            codes = packed[end:].reshape(b, -1)
        prs = (packed[2 * b:end].reshape(b, -1).astype(np.float32) * 1e-6
               if end > 2 * b else None)
        dt = time.perf_counter() - t0
        metrics.ASR_MODEL_STEP_DURATION.observe(dt)
        metrics.PIPELINE_BATCH_DURATION.observe(dt)
        if dt > 0:  # text tokens emitted across the active batch
            metrics.LM_TOKENS_PER_SECOND.set(float(mask.sum()) / dt)
        if self.step_observer is not None:
            self.step_observer(dt, float(mask.mean()))
        t_post0 = time.perf_counter()
        if self.session_logger is not None:
            for slot, ch in enumerate(chans):
                if ch is not None and mask[slot]:
                    self.session_logger.log_step(f"asr-{ch.channel_id}",
                                                 int(text_tokens[slot]), codes[slot])

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
        t_post = time.perf_counter() - t_post0
        if self.phase_observer is not None:
            self.phase_observer({"t0": t0, "queue_ms": (t_deq - t0) * 1e3,
                                 "fetch_ms": (t_post0 - t_deq) * 1e3,
                                 "post_ms": t_post * 1e3, "util": float(mask.mean())})
        metrics.PIPELINE_POSTPROCESS_DURATION.observe(t_post)
        # The share of the step window not spent in serial post-processing:
        # 1.0 when the drain thread hides it behind the next dispatch.
        if dt + t_post > 0:
            metrics.PIPELINE_OVERLAP_EFFICIENCY.observe(
                1.0 if self._drain_thread is not None else dt / (dt + t_post))

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
                metrics.record_connection_error("internal", "asr")
                traceback.print_exc()
                time.sleep(0.1)
