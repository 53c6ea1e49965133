"""Continuously batched full-duplex dialogue engine (counterpart of
``dsm_tpu/server/duplex_batched.py``).

N independent dialogues step together, one 80 ms frame per tick:

  Mimi.encode_step(user pcm) -> lm_gen.step -> masked Mimi.decode_step

with per-slot step counters, ``mask`` and ``reset`` as data
(``sessions/lm_gen.py``), so sessions join and leave at any tick.  A slot
opened with ``asr_delay_in_tokens > 0`` is a text-only session: its text
input is hidden inside the delay and its frames are not decoded.  The
tick's host-bound outputs are packed into one int32 tensor (text tokens,
step counters, the decode mask, the pcm's f32 bits): one device-to-host
fetch per tick.

On a CUDA device the tick is one captured CUDA graph, the counterpart of the
JAX engine's ``jax.jit(_fused, donate_argnums=(1, 2, 3))``: :meth:`warmup`
runs the tick on the side stream it captures on, then captures the key
split, ``models.mimi.encode_step_in_place``, ``sessions.lm_gen.step_in_place``
(the LM step and the DepFormer), the in-place codec resets, the gated
``models.mimi.decode_step_in_place`` and the packing once over the engine's
key, state buffers and static inputs; every tick copies pcm, mask, reset
and ASR delays through pinned host staging into those inputs and replays the
graph.  A capture that fails raises; the engine never falls back to the
eager tick.  ``cuda_graph=False`` runs the eager tick (the reference the
card's checks hold the graph to); the CPU has no graph.

Dispatch-ahead (``pipeline_depth = D > 1``, as the JAX engine's): up to D
ticks are in flight, and a tick's outputs are post-processed once D are;
each replay's packed array is copied into one of D pinned host buffers behind
an event, and post-processing waits on that event alone.  A slot's Done
follows its last dispatched outputs, and ``stop()`` delivers the ticks still
in flight.

The serving profile is chosen by arguments, not by the environment:
``kv_quant`` gives the LM int8 KV rings (by default on CUDA and not on the
CPU, as in the JAX engine), ``kv_bits = 4`` with it
nibble-packed int4 rings (half the ring's bytes: room for larger batches),
and the weights run as they are given (the
builder hands over int8 weights, which multiply by the profile they carry:
W8A8, or weight-only with ``w8a8 = false``).

The JAX engine's prometheus calls (``server/metrics.py``) are made at its call
sites, after the fetch, from the host arrays: the step, its duration (the
interval between completions) and the decoded frames of the packed
``dec_mask``.

On a device mesh (``mesh=``, ``parallel/mesh.py``; TOML ``[modules.X.mesh]``)
the engine keeps one engine of its own class a shard and its tick drives
every shard, as ``server/batched_asr.py`` does (``batch % dp`` and ``heads %
tp`` checked, as in the JAX engine): dialogue ``s`` lives on dp shard ``s //
(B/dp)`` with its codec states; under dp each shard's tick is its own
captured graph on its own card, under dp x tp the main LM is split over
heads and MLP hidden (the JAX engine runs GSPMD with its kernels off there;
the port keeps the ASR engine's rule, kernels live) and a replica's tp
shards are one captured graph, as in ``server/batched_asr.py``.  Every shard splits the same key each tick and
draws its rows of the whole batch's draw (``lm_gen.step``'s ``row0``), so
the meshed engine's events are the unmeshed engine's under dp, as the JAX
engine's GSPMD step keeps them.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models import mimi as MIMI
from ..ops import sampling as S
from ..parallel import mesh as M
from ..sessions import lm_gen
from ..utils.gc_tune import freeze_after_warmup
from . import metrics
from .cuda_graph import PinnedOutputs, StagedInputs, capture, fetch


@dataclasses.dataclass
class DuplexTextEvent:
    text: str


@dataclasses.dataclass
class DuplexAudioEvent:
    pcm: np.ndarray


@dataclasses.dataclass
class DuplexDoneEvent:
    pass


class DuplexSlot:
    """One connection's mailbox: queued pcm in, pending text tokens out."""

    def __init__(self, slot: int, deliver: Callable[[object], None], asr_delay: int = 0):
        self.slot = slot
        self.deliver = deliver
        self.asr_delay = asr_delay
        self.lock = threading.Lock()
        self.pcm: deque = deque()
        self.pcm_samples = 0
        self.text_acc: List[int] = []
        self.closed = False
        self.finished = False
        self.eos = False
        self.steps = 0

    def push_pcm(self, pcm: np.ndarray) -> None:
        with self.lock:
            self.pcm.append(np.asarray(pcm, np.float32))
            self.pcm_samples += len(pcm)

    def end_input(self) -> None:
        with self.lock:
            self.eos = True

    def take_frame(self, frame: int) -> Optional[np.ndarray]:
        """The next ``frame`` queued samples, or None while fewer wait."""
        with self.lock:
            if self.pcm_samples < frame:
                return None
            out = np.empty(frame, np.float32)
            pos = 0
            while pos < frame:
                chunk = self.pcm[0]
                need = frame - pos
                if len(chunk) <= need:
                    out[pos:pos + len(chunk)] = chunk
                    pos += len(chunk)
                    self.pcm.popleft()
                else:
                    out[pos:] = chunk[:need]
                    self.pcm[0] = chunk[need:]
                    pos = frame
            self.pcm_samples -= frame
            return out


class BatchedDuplexEngine(M.ShardedEngine):
    """Slot pool and model loop for one dialogue module on one device or on
    the shards of ``mesh``."""

    def __init__(self, cfg: lm_gen.DuplexConfig, params: dict, mimi_cfg: MIMI.MimiConfig,
                 mimi_params: dict, tokenizer, batch_size: int = 8,
                 tick_sleep: float = 0.002, kv_quant: Optional[bool] = None, kv_bits: int = 8,
                 *, device, cuda_graph: Optional[bool] = None, pipeline_depth: int = 1,
                 gc_tune: bool = True, mesh: Optional[M.Mesh] = None):
        """``params``: ``{"lm": ...}``, dense or int8 (``quantize_weights``),
        used as given; ``mimi_params``: both halves of the codec;
        ``kv_quant``: int8 KV rings, packed int4 with ``kv_bits = 4``; None
        (the default) takes them on CUDA and not on the CPU;
        ``device``: where everything lives; ``cuda_graph``: the tick as one
        captured CUDA graph, the default on CUDA (True elsewhere raises);
        ``pipeline_depth``: 1 fetches each tick's outputs before the next
        tick, D > 1 keeps up to D - 1 ticks in flight while the host
        post-processes an older one (dispatch-ahead: the next mic frame never
        depends on a fetched output, so the events are the same); ``mesh``:
        serve on its shards (``device`` is then the first shard's)."""
        self.cfg = cfg
        self.mimi_cfg = mimi_cfg
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.tick_sleep = tick_sleep
        self._place(mesh, device, cuda_graph, "duplex")
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self.gc_tune = gc_tune  # freeze the host GC after warm-up (utils/gc_tune.py)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.kv_quant = self.device.type == "cuda" if kv_quant is None else bool(kv_quant)
        self.kv_bits = kv_bits if self.kv_quant else 8
        self.cache_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.params = params
        self.mimi_params = mimi_params
        dev = self.device
        self._mimi_dtype = mimi_params["quantizer"]["rvq_first"]["embed"].dtype
        self._row0 = 0  # the first row of the batch's draw this engine's slots take

        if mesh is not None:
            self._build_shards()
        else:
            self.state = lm_gen.init_state(cfg, batch_size, self.cache_dtype,
                                           kv_quant=self.kv_quant, device=dev,
                                           kv_bits=self.kv_bits)
            self.enc_state = MIMI.init_encode_state(mimi_cfg, batch_size, self._mimi_dtype, dev)
            self.dec_state = MIMI.init_decode_state(mimi_cfg, batch_size, self._mimi_dtype, dev)
            self.rng = S.prng_key(0, device=dev)  # split once a tick, inside the tick

        self.slots: List[Optional[DuplexSlot]] = [None] * batch_size
        self.free: deque = deque(range(batch_size))
        self.pending_resets = np.zeros(batch_size, bool)
        self._asr_delay = np.zeros(batch_size, np.int32)
        self.slot_lock = threading.Lock()
        self.running = False
        self.thread: Optional[threading.Thread] = None
        self.step_count = 0
        # (dt s, n_active, (gather, dispatch, fetch, post) s) per stepped tick;
        # dt is the completion-to-completion interval
        self.tick_observer = None
        self._pcm_buf = np.zeros((batch_size, 1, mimi_cfg.frame_size), np.float32)
        # (handle, drivers, n_active, t_gather0, t_disp0, t_disp1) per tick in flight
        self._inflight: deque = deque()
        self._last_fetch_t: Optional[float] = None

    def _build_shards(self) -> None:
        """:meth:`ShardedEngine._build_shards` with the engine's options; dp
        shard ``d`` draws rows ``d * B/dp ..`` of the batch's draw."""

        def shard(cfg, params, dev, b, d):
            sh = BatchedDuplexEngine(
                cfg, params, self.mimi_cfg, M.params_to(self.mimi_params, dev),
                self.tokenizer, batch_size=b, kv_quant=self.kv_quant, kv_bits=self.kv_bits,
                device=dev, cuda_graph=self.cuda_graph, pipeline_depth=self.pipeline_depth,
                gc_tune=False)
            sh._row0 = d * b
            return sh

        super()._build_shards("duplex", shard)
        self.state = self.enc_state = self.dec_state = None  # the shards hold them

    # -- session lifecycle --

    def used_slots(self) -> int:
        with self.slot_lock:
            return self.batch_size - len(self.free)

    def open_session(self, deliver: Callable[[object], None],
                     asr_delay_in_tokens: int = 0) -> Optional[DuplexSlot]:
        """A mailbox on a free slot, or None at capacity."""
        with self.slot_lock:
            if not self.free:
                return None
            slot = self.free.popleft()
            drv = DuplexSlot(slot, deliver, asr_delay=asr_delay_in_tokens)
            self.slots[slot] = drv
            self.pending_resets[slot] = True
            self._asr_delay[slot] = np.int32(asr_delay_in_tokens)
            return drv

    def close_session(self, drv: DuplexSlot) -> None:
        with self.slot_lock:
            drv.closed = True
            if self.slots[drv.slot] is drv:
                self.slots[drv.slot] = None
                self.free.append(drv.slot)

    # -- device step --

    def _device_tick(self, x: dict, in_place: bool) -> torch.Tensor:
        """The tick on device inputs ``x`` (``pcm (B, 1, frame)`` f32,
        ``mask``, ``reset``, ``asr_delay``) -> the packed int32 array ``[text
        (n), steps (n), dec_mask (n), pcm bits (n * frame)]``: the key split,
        Mimi encode, the LM step with the DepFormer, the codec resets (after
        the encode, as in the JAX engine), the gated Mimi decode.
        ``in_place``: the fixed-buffer forms over the engine's key and states
        (the body the graph captures); else the functional forms, whose new
        key and states replace the engine's."""
        cfg, mcfg, mp = self.cfg, self.mimi_cfg, self.mimi_params
        mask, reset, delay = x["mask"], x["reset"], x["asr_delay"]
        rng, key = S.split(self.rng)
        pcm = x["pcm"].to(self._mimi_dtype)
        if in_place:
            self.rng.copy_(rng)
            codes = MIMI.encode_step_in_place(mcfg, mp, self.enc_state, pcm, mask)
        else:
            self.rng = rng
            codes, self.enc_state = MIMI.encode_step(mcfg, mp, self.enc_state, pcm, mask)
        user_tokens = codes[:, :cfg.input_audio_codebooks, 0].to(torch.int32)
        kw = dict(asr_delay=delay, mask=mask, reset=reset)
        if in_place:
            out = lm_gen.step_in_place(cfg, self.params, self.state, user_tokens, key,
                                       row0=self._row0, **kw)
            MIMI.reset_encode_state_in_place(self.enc_state, reset)
            MIMI.reset_decode_state_in_place(self.dec_state, reset)
        else:
            out, self.state = lm_gen.step(cfg, self.params, self.state, user_tokens, key,
                                          row0=self._row0, **kw)
            self.enc_state = MIMI.reset_encode_state(self.enc_state, reset)
            self.dec_state = MIMI.reset_decode_state(self.dec_state, reset)
        # Text-only (ASR-delay) slots skip the decode.
        dec_mask = out["frame_valid"] & (delay <= 0)
        frame_codes = torch.where(dec_mask[:, None], out["frame"], 0)[:, :, None]
        if in_place:
            pcm_out = MIMI.decode_step_in_place(mcfg, mp, self.dec_state, frame_codes, dec_mask)
        else:
            pcm_out, self.dec_state = MIMI.decode_step(mcfg, mp, self.dec_state, frame_codes,
                                                       dec_mask)
        return torch.cat([
            out["text_token"].to(torch.int32),
            out["step_idx"].to(torch.int32),
            dec_mask.to(torch.int32),
            pcm_out[:, 0, :].float().contiguous().view(torch.int32).reshape(-1),
        ])

    def _dispatch(self, pcm: np.ndarray, mask: np.ndarray, reset: np.ndarray,
                  asr_delay: np.ndarray):
        """Queue one device tick for host arrays -> its handle for
        ``cuda_graph.fetch``: on the graph, the replay's packed array copied into
        the next of ``pipeline_depth`` pinned host buffers behind an event
        (the oldest in flight has been fetched before its buffer comes round
        again); on the eager tick, the packed device tensor.  The host
        arrays may be reused once this returns.  Under a mesh every shard's,
        as one ``parallel.mesh.MeshHandle``."""
        if self.mesh is not None:
            return M.MeshHandle(self._on_shards("_dispatch", pcm, mask, reset, asr_delay),
                                self._shard_b, (1, 1, 1, None))
        if self.cuda_graph:
            if self._graph is None:
                raise RuntimeError("the CUDA graph tick is not captured: call warmup() "
                                   "or start() first")
            self._inputs.stage({"pcm": pcm, "mask": mask, "reset": reset,
                                "asr_delay": asr_delay})
            self._graph.replay()
            return self._outputs.copy(self._static_out)
        dev = self.device
        x = {"pcm": torch.as_tensor(pcm, device=dev), "mask": torch.as_tensor(mask, device=dev),
             "reset": torch.as_tensor(reset, device=dev),
             "asr_delay": torch.as_tensor(asr_delay, device=dev)}
        with torch.inference_mode():
            return self._device_tick(x, in_place=False), None

    def _invoke_step(self, pcm: np.ndarray, mask: np.ndarray, reset: np.ndarray,
                     asr_delay: np.ndarray) -> np.ndarray:
        """One device tick for host arrays ``(batch_size, ...)``, fetched ->
        the packed int32 host array (on the graph, pinned memory that the
        tick ``pipeline_depth`` later overwrites)."""
        return fetch(self._dispatch(pcm, mask, reset, asr_delay))

    def _capture(self, steps: int) -> None:
        """Run the tick ``steps`` times (at least once) on a side stream with
        no slot active, then capture it there; raises if capture fails."""
        b, dev = self.batch_size, self.device
        self._inputs = StagedInputs({
            "pcm": torch.zeros(self._pcm_buf.shape, dtype=torch.float32, device=dev),
            "mask": torch.zeros(b, dtype=torch.bool, device=dev),
            "reset": torch.zeros(b, dtype=torch.bool, device=dev),
            "asr_delay": torch.zeros(b, dtype=torch.int32, device=dev)})
        off = np.zeros(b, bool)
        self._inputs.stage({"pcm": self._pcm_buf, "mask": off, "reset": off,
                            "asr_delay": self._asr_delay.copy()})
        self._graph, self._static_out = capture(
            lambda: self._device_tick(self._inputs.buffers, in_place=True), steps, dev,
            self._inputs)
        self._outputs = PinnedOutputs(self._static_out.shape, self.pipeline_depth)

    def warmup(self, steps: int = 2) -> None:
        """Run ticks with no slot active through the whole step; with
        ``cuda_graph``, through the tick to capture, then capture it.  Then
        the host GC is frozen unless the engine was built with
        ``gc_tune=False``, as the JAX engine does."""
        try:
            self._warm_all(steps)
            metrics.WARMUP_SUCCESS.inc()
        except Exception:
            metrics.WARMUP_FAILURE.inc()
            raise
        freeze_after_warmup(self.gc_tune)

    def _warm(self, steps: int) -> None:
        """:meth:`warmup`'s device part: the capture, or eager ticks."""
        if self.cuda_graph:
            if self._graph is None:
                self._capture(steps)
            return
        off = np.zeros(self.batch_size, bool)
        for _ in range(steps):
            self._invoke_step(self._pcm_buf, off, off, self._asr_delay.copy())

    # -- loop --

    def start(self) -> None:
        if self.cuda_graph and not self._captured():
            self.warmup()  # capture before the loop starts
        self.running = True
        self.thread = threading.Thread(target=self._loop, name="duplex-model-loop",
                                       daemon=True)
        self.thread.start()

    def stop(self) -> None:
        self.running = False
        if self.thread:
            self.thread.join(timeout=5)
        while self._inflight:  # deliver the trailing dispatched ticks
            self._post_process(self._inflight.popleft())
        self._close_shards()

    def _loop(self) -> None:
        while self.running:
            try:
                if not self.tick():
                    time.sleep(self.tick_sleep)
            except Exception:  # the model loop must outlive one bad tick
                metrics.record_connection_error("internal", "lm")
                traceback.print_exc()
                time.sleep(0.1)

    def tick(self) -> bool:
        """One engine tick; True if any slot stepped or a dispatched tick
        was post-processed."""
        n = self.batch_size
        mask = np.zeros(n, bool)
        reset = np.zeros(n, bool)
        stepped: List[Optional[DuplexSlot]] = [None] * n
        frame = self.mimi_cfg.frame_size

        t_tick0 = time.perf_counter()
        with self.slot_lock:
            reset[:] = self.pending_resets
            self.pending_resets[:] = False
            for slot, drv in enumerate(self.slots):
                if drv is None or drv.closed or drv.finished:
                    continue
                f = drv.take_frame(frame)
                if f is None:
                    # Done only after the slot's last dispatched outputs.
                    if drv.eos and not any(it[1][slot] is drv for it in self._inflight):
                        drv.finished = True
                        if drv.text_acc:  # the trailing partial word
                            drv.deliver(DuplexTextEvent(
                                text=self.tokenizer.decode(drv.text_acc)))
                            drv.text_acc = []
                        drv.deliver(DuplexDoneEvent())
                    continue
                self._pcm_buf[slot, 0, :] = f
                mask[slot] = True
                stepped[slot] = drv
            asr_delay = self._asr_delay.copy()
        if not mask.any() and not reset.any():
            if self._inflight:  # drain the pipeline while input pauses
                self._post_process(self._inflight.popleft())
                return True
            return False

        t0 = time.perf_counter()
        handle = self._dispatch(self._pcm_buf, mask, reset, asr_delay)
        t1 = time.perf_counter()
        self.step_count += 1
        self._inflight.append((handle, stepped, int(mask.sum()), t_tick0, t0, t1))
        if len(self._inflight) >= self.pipeline_depth:
            self._post_process(self._inflight.popleft())
        return True

    def _post_process(self, item) -> None:
        handle, stepped, n_active, t_tick0, t0, t1 = item
        n = self.batch_size
        frame = self.mimi_cfg.frame_size
        packed = fetch(handle)  # the tick's one device-to-host fetch
        t2 = time.perf_counter()
        # Dispatched ahead, one tick's dispatch-to-fetch spans other ticks'
        # host work: the interval between completions is the tick's cost
        # (t2 - t0 at depth 1 and for the first fetch).
        dt = t2 - t0 if self._last_fetch_t is None else min(t2 - t0, t2 - self._last_fetch_t)
        self._last_fetch_t = t2
        metrics.LM_STEP_DURATION.observe(dt)
        metrics.LM_STEPS_TOTAL.inc()
        text_tokens = packed[:n]
        steps = packed[n:2 * n]
        dec_mask = packed[2 * n:3 * n].astype(bool)
        pcm = packed[3 * n:].view(np.float32).reshape(n, frame)
        metrics.MIMI_FRAMES_DECODED.inc(int(dec_mask.sum()))

        cfg = self.cfg
        special = (cfg.text_pad_token, cfg.text_eop_token, cfg.text_start_token)
        for slot, drv in enumerate(stepped):
            if drv is None:
                continue
            drv.steps = int(steps[slot])
            tok = int(text_tokens[slot])
            if tok not in special:
                drv.text_acc.append(tok)
            elif drv.text_acc:
                drv.deliver(DuplexTextEvent(text=self.tokenizer.decode(drv.text_acc)))
                drv.text_acc = []
            if dec_mask[slot]:
                drv.deliver(DuplexAudioEvent(pcm=pcm[slot].copy()))
        if self.tick_observer is not None:
            t3 = time.perf_counter()
            self.tick_observer(dt, n_active, (t0 - t_tick0, t1 - t0, t2 - t1, t3 - t2))
