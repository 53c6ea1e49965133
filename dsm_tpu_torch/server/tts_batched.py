"""Continuously batched TTS serving engine (counterpart of
``dsm_tpu/server/tts_batched.py``).

N independent sessions step together in ``sessions.tts.step``: each slot has
its own step counter and its own voice in the cross-attention store
``(L, rows, H, S, Dh)``, which opening a session writes for its slot only.
With ``ca_quant`` the store is int8 with per-row f32 scales, its rows padded
to a multiple of 128, and the voice cross-attention goes through the
``ca_decode_attend`` kernel.

Host side per slot (:class:`TtsSlot`): the word-feeding driver that picks
each frame's text constraint (a forced word piece, a pad, or the model's
choice of pad or end-of-word), emits words with 12.5 Hz timestamps, pads
out the session once its input has ended, and signals the end.  Completed
frames are Mimi-decoded on the device in the same tick, and each frame
leaves the device as one packed int32 array: text tokens, step counters, the
decode mask and the pcm (f32 bits, or int16 pairs with ``pcm_wire_int16``).

Two paths, as in the JAX engine:

* ``fuse_ticks = 1``: one frame a tick; the host driver picks the
  constraint and patches the final end-of-word to a pad between ticks.
* ``fuse_ticks = K > 1``: K frames a dispatch.  The device script machine
  (``sessions/tts_script.py``) picks each frame's constraint, consumes its
  text token and patches the final end-of-word inside the frame, so no
  frame waits for the host; the :class:`TtsSlot` becomes the host's mirror,
  which replays the fetched text tokens through the same rules for word
  events.  Words and the end of input land in ``pending_*`` and reach the
  device ring at a dispatch boundary, in one staged op table
  (``tts_script.apply_ops``), words under the ring's ``script_cap``; the end
  of input only once every fed word is uploaded.  One fetch a dispatch, of
  the ``(K, ...)`` packed frames.  Dispatch-ahead (``pipeline_depth = D``):
  a dispatch is posted once D are in flight, so D - 1 stay on the device
  while the host replays the older one, at the cost of up to ``K * (D -
  1)`` frames before audio is delivered.

On a CUDA device the tick is a captured CUDA graph, the counterpart of the
JAX engine's jitted ``_step`` / ``_fused_step``: :meth:`warmup` runs the
body on the side stream it captures on, then captures it once over the
engine's state buffers and static input buffers.  For ``fuse_ticks = 1`` the
body is the tick (``sessions.tts.step_in_place``, the gated
``models.mimi.decode_step_in_place``, the packing); every tick copies modes,
tokens, mask, reset, temperatures, seeds and guidance through pinned host
staging into those buffers, replays the graph and fetches the packed array
into pinned memory.  For K > 1 the body is one frame (``constraint``, the
step with the frame's reset, which it then clears with a device fill,
``advance``, the pad patch, the decode, the packing into the row of a
device frame counter); a dispatch stages reset, temperatures, seeds and
guidance once, replays the frame K times and copies the ``(K, ...)`` frames
into the next of ``pipeline_depth`` pinned host buffers behind an event.
The voice writes, the script ops and the single tick's pad overwrite run
between replays, in place, on the same stream, into the buffers the graph
reads.  A capture that fails raises; the engine never falls back to the
eager tick.  ``cuda_graph=False`` runs the eager forms (the reference the
card's checks hold the graph to); the CPU has no graph.

The JAX engine's prometheus calls (``server/metrics.py``) are made at its call
sites, after the fetch, from the host arrays: steps (``fuse`` a dispatch),
the decoded frames of the packed ``dec_mask``, the step duration (a
dispatch's service interval over ``fuse`` on the fused path).

On a device mesh (``mesh=``, ``parallel/mesh.py``; TOML ``[modules.X.mesh]``)
the engine keeps one engine of its own class a shard and its tick drives
every shard, as ``server/batched_asr.py`` does: slot ``s`` lives on dp shard
``s // (B/dp)`` with its guidance twin (a shard's rows are ``[cond | uncond]``
of its own slots: ``rows % dp`` is checked, as in the JAX engine), its voice
(the store split over rows, and over heads under tp), its Mimi decoder state
and, on the fused path, its script machine.  Under dp each shard's tick or
frame is its own captured graph on its own card; under dp x tp the main LM
is split over heads and MLP hidden, the DepFormer, the codec and the
sampling replicated (the JAX engine runs GSPMD with its kernels off there;
the port keeps the ASR engine's rule, kernels live), and a replica's tp
shards are one captured graph (the frame's and the script ops' both), as
in ``server/batched_asr.py``.  Tokens are drawn from per-slot keys, so the meshed engine's
events are the unmeshed engine's under dp.  The audio comes back on the
TOML's wire, the int16 pairs included.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import traceback
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models import mimi as MIMI
from ..ops import transformer as T
from ..parallel import mesh as M
from ..sessions import tts as TTS
from ..sessions import tts_script as SCRIPT
from ..utils.gc_tune import freeze_after_warmup
from . import metrics
from .cuda_graph import PinnedOutputs, StagedInputs, capture, fetch
from .tts_module import AudioEvent, WordEvent

log = logging.getLogger("dsm.torch.tts")


OP_TABLE_ROWS = 512  # script ops a staged copy carries; longer queues go in chunks
# Words a slot of the packed array: text, steps, dec_mask, then the pcm's.
PACKED_WIDTHS = (1, 1, 1, None)


@dataclasses.dataclass
class DoneEvent:
    pass


class TtsSlot:
    """Host word-feeding driver for one session; with ``fused``, the mirror
    of the device script machine."""

    def __init__(self, slot: int, deliver: Callable[[object], None], fused: bool = False):
        self.slot = slot
        self.deliver = deliver
        self.lock = threading.Lock()
        self.word_queue: deque = deque()
        self.eos = False
        # An empty current word waits for the first real word.
        self.word_tokens: Optional[List[int]] = []
        self.token_idx = 0
        self.step_past_last = 0
        self.last_eop_step = 0
        self.steps = 0
        self.finished = False
        self.closed = False
        self.pcm_samples = 0
        # Fused mode: fed words and the end of input wait in pending_* and
        # become visible (word_queue / eos) when the engine uploads them to
        # the device at a dispatch boundary, so that the mirror and the
        # device replay the same script.
        self.fused = fused
        self.pending_words: deque = deque()
        self.pending_eos = False
        self.up_toks = 0  # script tokens uploaded to the device
        self.up_words = 0
        self.consumed = 0  # script tokens consumed (the mirror's count)

    def feed_words(self, words) -> None:
        with self.lock:
            target = self.pending_words if self.fused else self.word_queue
            for w in words:
                target.append(list(w))

    def end_input(self) -> None:
        with self.lock:
            if self.fused:
                self.pending_eos = True
            else:
                self.eos = True

    def next_constraint(self, cfg: TTS.TtsConfig):
        """-> ``(mode, token, stalled)``, or None once the session is over."""
        if self.word_tokens is None:
            self.step_past_last += 1
            if self.step_past_last > cfg.extra_steps + cfg.text_audio_delay_in_tokens:
                return None
            return (TTS.ALLOW_PAD, 0, False)
        if self.token_idx < len(self.word_tokens):
            return (TTS.ALLOW_TEXT, self.word_tokens[self.token_idx], False)
        return (TTS.ALLOW_PAD_OR_EPAD, 0, False)

    def on_text_token(self, cfg: TTS.TtsConfig, tok: int, tokenizer):
        """Advance with the frame's text token.  Returns 'overwrite_pad'
        when the final end-of-word must be patched to a pad."""
        patch = None
        if tok == cfg.text_eop_token:
            if self.word_tokens:
                self.deliver(WordEvent(text=tokenizer.decode(self.word_tokens),
                                       start_s=self.last_eop_step / 12.5,
                                       stop_s=self.steps / 12.5))
            self.last_eop_step = self.steps
            with self.lock:
                if self.word_queue:
                    self.word_tokens = list(self.word_queue.popleft())
                elif self.eos:
                    self.word_tokens = None
                    patch = "overwrite_pad"
                else:
                    self.word_tokens = []  # starved: pad-or-eop again
            self.token_idx = 0
        elif tok != cfg.text_pad_token:
            self.token_idx += 1
            self.consumed += 1
        return patch


class BatchedTtsEngine(M.ShardedEngine):
    """Slot pool and model loop for one TTS module on one device (the card
    unless ``device`` names another, as the JAX engine lands on the
    accelerator) or on the shards of ``mesh``."""

    voices = None  # optional server.voices.VoiceResolver

    def __init__(self, cfg: TTS.TtsConfig, params: dict, mimi_cfg: MIMI.MimiConfig,
                 mimi_params: dict, tokenizer, batch_size: int = 8,
                 ca_len: Optional[int] = None, tick_sleep: float = 0.002,
                 cfg_enabled: bool = False, ca_quant: bool = False, device="cuda",
                 pcm_wire_int16: bool = False, cuda_graph: Optional[bool] = None,
                 fuse_ticks: int = 1, script_cap: int = 1024, pipeline_depth: int = 1,
                 gc_tune: bool = True, mesh: Optional[M.Mesh] = None):
        """``mesh``: serve on its shards (``device`` is then the first
        shard's)."""
        if cfg.cfg_alpha is not None:
            raise ValueError("set cfg_enabled=True for batched guidance (per-request "
                             "alpha); a static cfg_alpha is for unbatched sessions")
        self.gc_tune = gc_tune  # freeze the host GC after warm-up (utils/gc_tune.py)
        self.cfg = cfg
        self.mimi_cfg = mimi_cfg
        self.params = params
        self.mimi_params = mimi_params
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.tick_sleep = tick_sleep
        # The captured tick (default on CUDA); none on the CPU.
        self._place(mesh, device, cuda_graph, "tts")
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self.condition_provider = None
        self.default_condition = None
        # Guidance doubles the model rows [cond..., uncond...]; the uncond
        # twin of a slot runs without a voice, and alpha = 1 slots reduce to
        # unguided output.
        self.cfg_enabled = cfg_enabled
        self.rows = 2 * batch_size if cfg_enabled else batch_size
        on_card = self.device.type == "cuda"
        self.cache_dtype = torch.bfloat16 if on_card else torch.float32
        self.ca_quant = bool(ca_quant)
        self._pcm_wire_i16 = bool(pcm_wire_int16)

        self.ca_len = ca_len or 125 * cfg.speaker_cond_n_speakers
        self._text_temp = np.full(batch_size, cfg.text_temperature, np.float32)
        self._audio_temp = np.full(batch_size, cfg.temperature, np.float32)
        self._cfg_alpha = np.ones(batch_size, np.float32)
        self._seeds = np.zeros(batch_size, np.uint32)
        self._seed_counter = int(time.time()) & 0x7FFFFFFF
        # Voice writes are queued by open_session and applied on the engine
        # loop's thread, under the same lock as the slot gather, so a slot
        # is never stepped before its voice has landed.
        self._pending_voice: List[tuple] = []
        self.fuse = max(1, int(fuse_ticks))
        self.script_cap = int(script_cap)
        self.pipeline_depth = max(1, int(pipeline_depth))
        if mesh is not None:
            self._build_shards()
        else:
            self._init_device_state(mimi_params, on_card)

        self.slots: List[Optional[TtsSlot]] = [None] * batch_size
        self.free: deque = deque(range(batch_size))
        self.pending_resets = np.zeros(batch_size, bool)
        self.slot_lock = threading.Lock()
        self.running = False
        self.thread: Optional[threading.Thread] = None
        self.step_count = 0
        # The JAX engine's observer of each posted tick, None unless the
        # caller sets it (``bench_perf.py``): seconds of the host gather,
        # the dispatch, the device step and fetch (at depth 2 the wait
        # behind the newer dispatch too) and the post-process; on the fused
        # path then the gather's detail: the slot lock's wait and hold, the
        # voice writes' and the script ops' seconds, and their counts.
        self.tick_observer: Optional[Callable[..., None]] = None
        if self.pipeline_depth > 1 and self.fuse == 1:
            log.warning("tts: pipeline_depth=%d has no effect with fuse_ticks=1; set "
                        "fuse_ticks>1 to enable dispatch-ahead", self.pipeline_depth)
        self._inflight_f: deque = deque()
        self._last_fetch_t: Optional[float] = None
        self._pending_script: List[tuple] = []

    def _build_shards(self) -> None:
        """:meth:`ShardedEngine._build_shards` with the engine's options, a
        shard's per-slot sampling arrays views of the engine's rows."""
        if self.rows % self.mesh.dp:
            raise ValueError(f"rows {self.rows} not divisible by dp={self.mesh.dp}")

        def shard(cfg, params, dev, b, d):
            sh = BatchedTtsEngine(
                cfg, params, self.mimi_cfg, M.params_to(self.mimi_params, dev),
                self.tokenizer, batch_size=b, ca_len=self.ca_len, cfg_enabled=self.cfg_enabled,
                ca_quant=self.ca_quant, device=dev, pcm_wire_int16=self._pcm_wire_i16,
                cuda_graph=self.cuda_graph, fuse_ticks=self.fuse, script_cap=self.script_cap,
                pipeline_depth=self.pipeline_depth, gc_tune=False)
            for name in ("_text_temp", "_audio_temp", "_cfg_alpha", "_seeds"):
                setattr(sh, name, getattr(self, name)[self._shard_slots(d)])
            return sh

        super()._build_shards("tts", shard)
        self.state = self.mimi_state = None  # the shards hold them

    def _init_device_state(self, mimi_params: dict, on_card: bool) -> None:
        """The device half of one engine: the voice store, the session and
        Mimi states and, on the fused path, the script machine and the
        frames' buffer."""
        cfg, mimi_cfg, batch_size = self.cfg, self.mimi_cfg, self.batch_size
        tcfg = cfg.lm.transformer
        dev = self.device
        zero = torch.zeros((tcfg.num_layers, 1, tcfg.num_heads, self.ca_len, tcfg.hd),
                           dtype=self.cache_dtype, device=dev)
        if self.ca_quant:
            s_pad = self.ca_len + (-self.ca_len) % 128
            shape = (tcfg.num_layers, self.rows, tcfg.num_heads, s_pad, tcfg.hd)
            self._ca = {
                "k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "ks": torch.zeros(shape[:4], dtype=torch.float32, device=dev),
                "vs": torch.zeros(shape[:4], dtype=torch.float32, device=dev),
                "s_len": self.ca_len,
            }
            # The quantised zero voice (q = 0 with the quantiser's eps scale).
            self._zero_voice = T.quantize_ca_kv((zero, zero), s_len=self.ca_len)
        else:
            shape = (tcfg.num_layers, self.rows, tcfg.num_heads, self.ca_len, tcfg.hd)
            self._ca = (torch.zeros(shape, dtype=self.cache_dtype, device=dev),
                        torch.zeros(shape, dtype=self.cache_dtype, device=dev))
            self._zero_voice = (zero, zero)

        self.state = TTS.init_state(cfg, self.rows, self.cache_dtype, dev)
        mimi_dtype = mimi_params["quantizer"]["rvq_first"]["embed"].dtype
        self.mimi_state = MIMI.init_decode_state(mimi_cfg, batch_size, mimi_dtype, dev)

        # The fused path: K frames a dispatch through the device script
        # machine, with up to pipeline_depth - 1 dispatches left in flight.
        if self.fuse > 1:
            self._cc = SCRIPT.ScriptConsts.from_cfg(cfg)
            self._mstate = SCRIPT.init(batch_size, self.script_cap, dev)
            # The fused frame's outputs: row k of the dispatch, picked by a
            # counter on the device that the frame advances.
            pcm_words = batch_size * mimi_cfg.frame_size // (2 if self._pcm_wire_i16 else 1)
            self._frames = torch.zeros((self.fuse, 3 * batch_size + pcm_words),
                                       dtype=torch.int32, device=dev)
            self._frame_k = torch.zeros(1, dtype=torch.int64, device=dev)
            if on_card:  # the op table's staged copy (OP_TABLE_ROWS rows a flush)
                self._ops_in = StagedInputs({"ops": torch.zeros(
                    (OP_TABLE_ROWS, SCRIPT.OP_COLS), dtype=torch.int32, device=dev)})
            self._ops_graph: Optional[torch.cuda.CUDAGraph] = None  # captured with the frame

    # -- slots --

    def used_slots(self) -> int:
        with self.slot_lock:
            return self.batch_size - len(self.free)

    def open_session(self, deliver: Callable[[object], None], voice_ca=None,
                     text_temperature=None, audio_temperature=None,
                     cfg_alpha=None, seed=None) -> Optional[TtsSlot]:
        """A driver on a free slot, or None at capacity.  ``voice_ca``: the
        voice's per-layer ``(L, 1, H, S, Dh)`` K/V pair (:meth:`voice_kv`)
        or None; ``cfg_alpha`` (needs ``cfg_enabled``) and ``seed`` are per
        request."""
        if cfg_alpha is not None and not self.cfg_enabled:
            raise ValueError("engine built without cfg_enabled")
        if voice_ca is not None and voice_ca[0].shape[3] != self.ca_len:
            raise ValueError(f"voice source length {voice_ca[0].shape[3]} != engine "
                             f"ca_len {self.ca_len}")
        with self.slot_lock:
            if not self.free:
                return None
            slot = self.free.popleft()
            self._text_temp[slot] = (self.cfg.text_temperature if text_temperature is None
                                     else float(text_temperature))
            self._audio_temp[slot] = (self.cfg.temperature if audio_temperature is None
                                      else float(audio_temperature))
            self._cfg_alpha[slot] = 1.0 if cfg_alpha is None else float(cfg_alpha)
            if seed is None:
                self._seed_counter = (self._seed_counter + 1) & 0xFFFFFFFF
                seed = self._seed_counter
            self._seeds[slot] = np.uint32(int(seed) & 0xFFFFFFFF)
            drv = TtsSlot(slot, deliver, fused=self.fuse > 1)
            self.slots[slot] = drv
            self.pending_resets[slot] = True
            if self.fuse > 1:  # applied before the dispatch whose frame 0 resets the slot
                self._pending_script.append((SCRIPT.OP_INIT, slot, None, 0, 0, 0))
            self._pending_voice.append((slot, voice_ca))
            if self.cfg_enabled:  # the uncond twin runs without the voice
                self._pending_voice.append((self.batch_size + slot, None))
        return drv

    def _apply_voice_writes(self, pending) -> None:
        """Engine-loop thread only: write the queued voices into their slots
        (the last write per slot wins), the quantised form with ``ca_quant``.
        Under a mesh each row goes to its dp shard (a guidance twin to its
        slot's shard) and each tp shard takes its heads of the voice."""
        if self.mesh is not None:
            n, b = self.batch_size, self._shard_b
            h = self.cfg.lm.transformer.num_heads // self.mesh.tp
            routed = [[] for _ in range(self.mesh.dp)]
            for row, voice in pending:
                d, j = divmod(row % n, b)
                routed[d].append((j + (b if row >= n else 0), voice))

            def write(d, t, sh):
                heads = slice(t * h, (t + 1) * h)
                local = [(j, None if v is None else tuple(x[:, :, heads] for x in v))
                         for j, v in routed[d]]
                if local:
                    sh._apply_voice_writes(local)

            self._runner.each(write)
            return
        last = {}
        for slot, voice in pending:
            last[slot] = voice
        zero_slots = [s for s, v in last.items() if v is None]
        if self.ca_quant:
            if zero_slots:
                idx = torch.tensor(zero_slots, device=self.device)
                for key in ("k", "v", "ks", "vs"):
                    self._ca[key][:, idx] = self._zero_voice[key]
            for slot, voice in last.items():
                if voice is not None:
                    k, v = (x.to(self.device, self.cache_dtype) for x in voice)
                    q = T.quantize_ca_kv((k, v), s_len=self.ca_len)
                    for key in ("k", "v", "ks", "vs"):
                        self._ca[key][:, slot] = q[key][:, 0]
            return
        if zero_slots:
            idx = torch.tensor(zero_slots, device=self.device)
            self._ca[0][:, idx] = 0
            self._ca[1][:, idx] = 0
        for slot, voice in last.items():
            if voice is not None:
                self._ca[0][:, slot] = voice[0][:, 0].to(self.device, self.cache_dtype)
                self._ca[1][:, slot] = voice[1][:, 0].to(self.device, self.cache_dtype)

    def close_session(self, drv: TtsSlot) -> None:
        with self.slot_lock:
            drv.closed = True
            if self.slots[drv.slot] is drv:
                self.slots[drv.slot] = None
                self.free.append(drv.slot)
                if self.fuse > 1:
                    self._pending_script.append((SCRIPT.OP_DEACT, drv.slot, None, 0, 0, 0))

    # -- device step --

    def _unpack_pcm(self, words: np.ndarray, n: int, frame: int) -> np.ndarray:
        """The packed pcm words of a tick's fetch -> ``(n, frame)`` f32: f32
        bits, or int16 pairs on the int16 wire."""
        if self._pcm_wire_i16:
            return (words.view(np.int16).astype(np.float32) / 32767.0).reshape(n, frame)
        return words.view(np.float32).reshape(n, frame)

    def _rows(self, a: np.ndarray) -> np.ndarray:
        """A per-slot host array -> per model row (doubled with guidance)."""
        return np.concatenate([a, a]) if self.cfg_enabled else a

    def _invoke_step(self, modes, toks, mask, reset) -> np.ndarray:
        """One device tick for host arrays ``(batch_size,)`` -> the packed
        int32 host array ``[text (n), steps (n), dec_mask (n), pcm words]``:
        a replay of the captured tick, whose array is pinned memory that the
        next replay overwrites, or the eager tick.  Under a mesh the shards'
        arrays, merged."""
        return fetch(self._dispatch_single(modes, toks, mask, reset))

    def _dispatch_single(self, modes, toks, mask, reset):
        """Queue one device tick for host arrays ``(batch_size,)`` -> its
        handle for ``cuda_graph.fetch`` (:meth:`_invoke_step` fetches it): on
        the graph, the replay's packed array copied into pinned memory
        behind an event; eagerly, the packed device array.  Under a mesh
        every shard's, as one handle."""
        if self.mesh is not None:
            return M.MeshHandle(self._on_shards("_dispatch_single", modes, toks, mask, reset),
                                self._shard_b, PACKED_WIDTHS)
        if self.cuda_graph:
            if self._graph is None:
                raise RuntimeError("the CUDA graph tick is not captured: call warmup() "
                                   "or start() first")
            arrays = {"modes": self._rows(modes), "toks": self._rows(toks),
                      "mask": self._rows(mask), "reset": self._rows(reset),
                      "text_temp": self._rows(self._text_temp),
                      "audio_temp": self._rows(self._audio_temp),
                      "seeds": self._rows(self._seeds)}
            if self.cfg_enabled:
                arrays["alpha"] = self._cfg_alpha
            self._inputs.stage(arrays)
            self._graph.replay()
            return self._outputs.copy(self._static_out)
        dev = self.device

        def rows(a, dtype=None):
            a = self._rows(a)
            return torch.as_tensor(a if dtype is None else a.astype(dtype), device=dev)

        x = {"modes": rows(modes), "toks": rows(toks), "mask": rows(mask),
             "reset": rows(reset), "text_temp": rows(self._text_temp),
             "audio_temp": rows(self._audio_temp), "seeds": rows(self._seeds, np.int64)}
        if self.cfg_enabled:
            x["alpha"] = torch.as_tensor(self._cfg_alpha, device=dev)
        with torch.inference_mode():
            return self._device_tick(x, in_place=False), None

    def _device_tick(self, x: dict, in_place: bool) -> torch.Tensor:
        """The tick on device inputs ``x`` -> the packed int32 array: the TTS
        step, then :meth:`_pack_frame`.  ``in_place``: the fixed-buffer forms
        over ``self.state`` and ``self.mimi_state`` (the body the graph
        captures); else the functional forms, whose new states replace the
        engine's."""
        kw = dict(ca_kv=self._ca, mask=x["mask"], reset=x["reset"],
                  temps={"text": x["text_temp"], "audio": x["audio_temp"]},
                  seeds=x["seeds"], cfg_alpha=x.get("alpha"))
        if in_place:
            out = TTS.step_in_place(self.cfg, self.params, self.state, x["modes"],
                                    x["toks"], **kw)
        else:
            out, self.state = TTS.step(self.cfg, self.params, self.state, x["modes"],
                                       x["toks"], **kw)
        return self._pack_frame(out, x["mask"][:self.batch_size], in_place)

    def _pack_frame(self, out: dict, stepped: torch.Tensor, in_place: bool) -> torch.Tensor:
        """The shared tail of the single tick and the fused frame: the Mimi
        decode of the completed frames of the ``stepped`` slots, the int16
        wire where it is set, the packed int32 array ``[text (n), steps (n),
        dec_mask (n), pcm words]``."""
        n = self.batch_size
        steps = out["step_idx"][:n]
        delay = self.cfg.text_audio_delay_in_tokens + self.cfg.acoustic_delay
        dec_mask = out["frame_valid"][:n] & (steps > delay) & stepped
        codes = out["frame"][:n, :, None]
        if in_place:
            pcm = MIMI.decode_step_in_place(self.mimi_cfg, self.mimi_params,
                                            self.mimi_state, codes, dec_mask)
        else:
            pcm, self.mimi_state = MIMI.decode_step(self.mimi_cfg, self.mimi_params,
                                                    self.mimi_state, codes, dec_mask)
        row = pcm[:, 0, :].float()
        if self._pcm_wire_i16:
            row = torch.clamp(row * 32767.0, -32767.0, 32767.0).to(torch.int16)
        return torch.cat([out["text_token"][:n].to(torch.int32), steps.to(torch.int32),
                          dec_mask.to(torch.int32),
                          row.contiguous().view(torch.int32).reshape(-1)])

    def _fused_frame(self, x: dict) -> None:
        """One frame of a fused dispatch on device inputs ``x`` (the body the
        graph captures, replayed K times a dispatch): the script machine's
        constraint, the step with the dispatch's reset, which is then cleared
        for the later frames, the machine's advance, the final end-of-word
        patched to a pad before the next frame reads it, and the packed frame
        written into row ``_frame_k`` of ``_frames``, the counter advanced."""
        n = self.batch_size

        def rows(t):
            return torch.cat([t, t]) if self.cfg_enabled else t

        mode, tok, stepped = SCRIPT.constraint_in_place(self._cc, self._mstate)
        out = TTS.step_in_place(
            self.cfg, self.params, self.state, rows(mode), rows(tok), ca_kv=self._ca,
            mask=rows(stepped), reset=rows(x["reset"]),
            temps={"text": x["text_temp"], "audio": x["audio_temp"]}, seeds=x["seeds"],
            cfg_alpha=x.get("alpha"))
        x["reset"].fill_(False)
        patch = SCRIPT.advance_in_place(self._cc, self._mstate, out["text_token"][:n], stepped)
        TTS.overwrite_last_text_token_in_place(self.state, self.cfg.text_pad_token, rows(patch))
        self._frames.index_copy_(0, self._frame_k, self._pack_frame(out, stepped, True)[None])
        self._frame_k.add_(1).remainder_(self.fuse)

    def _dispatch_fused(self, reset: np.ndarray):
        """Queue one fused dispatch of K frames -> its handle for
        ``cuda_graph.fetch``: on the graph, the frame replayed K times and the
        ``(K, ...)`` frames copied into the next of ``pipeline_depth`` pinned
        host buffers behind an event (the oldest dispatch in flight was
        posted before its buffer comes round again); eagerly, a copy of the
        frames on the device.  Under a mesh every shard's, as one handle."""
        if self.mesh is not None:
            return M.MeshHandle(self._on_shards("_dispatch_fused", reset), self._shard_b,
                                PACKED_WIDTHS)
        arrays = {"reset": reset, "text_temp": self._rows(self._text_temp),
                  "audio_temp": self._rows(self._audio_temp),
                  "seeds": self._rows(self._seeds).astype(np.int64)}
        if self.cfg_enabled:
            arrays["alpha"] = self._cfg_alpha
        if self.cuda_graph:
            if self._graph is None:
                raise RuntimeError("the CUDA graph frame is not captured: call warmup() "
                                   "or start() first")
            self._inputs.stage(arrays)
            for _ in range(self.fuse):
                self._graph.replay()
            return self._outputs.copy(self._frames)
        x = {k: torch.as_tensor(v, device=self.device) for k, v in arrays.items()}
        with torch.inference_mode():
            for _ in range(self.fuse):
                self._fused_frame(x)
            return self._frames.clone(), None

    def _apply_script_ops(self, ops: List[tuple]) -> None:
        """Engine-loop thread only: the queued script ops
        ``(kind, slot, toks, count, word_id, start)`` applied to the device
        machine in program order, one table a flush: on the card one staged
        copy of ``OP_TABLE_ROWS`` rows (OP_NOP-padded) and
        ``tts_script.apply_ops`` over it, a replay of its captured graph with
        ``cuda_graph``, ordered on the stream after the dispatch in flight.
        Under a mesh each op goes to its slot's dp shard, in order."""
        if not ops:
            return
        if self.mesh is not None:
            b = self._shard_b
            routed = [[] for _ in range(self.mesh.dp)]
            for kind, slot, *rest in ops:
                d, j = divmod(slot, b)
                routed[d].append((kind, j, *rest))
            self._on_graph_shards(lambda d, t, sh: sh._apply_script_ops(routed[d]))
            return
        table = SCRIPT.op_table(ops)
        with torch.inference_mode():
            for off in range(0, len(table), OP_TABLE_ROWS):
                chunk = table[off:off + OP_TABLE_ROWS]
                if self.device.type != "cuda":
                    SCRIPT.apply_ops(self._mstate, torch.from_numpy(chunk))
                    continue
                padded = np.zeros((OP_TABLE_ROWS, SCRIPT.OP_COLS), np.int32)
                padded[:len(chunk)] = chunk
                self._ops_in.stage({"ops": padded})
                if self._ops_graph is not None:
                    self._ops_graph.replay()
                else:
                    SCRIPT.apply_ops(self._mstate, self._ops_in.buffers["ops"])

    def _capture(self, steps: int) -> None:
        """Run the tick (fused: the frame) ``steps`` times (at least once) on
        a side stream, with no slot active, then capture it there; raises if
        capture fails."""
        r, dev = self.rows, self.device
        dtypes = {"reset": torch.bool, "text_temp": torch.float32,
                  "audio_temp": torch.float32, "seeds": torch.int64}
        if self.fuse == 1:  # the fused frame takes these from the script machine
            dtypes.update(modes=torch.int32, toks=torch.int32, mask=torch.bool)
        buffers = {name: torch.zeros(r, dtype=dt, device=dev) for name, dt in dtypes.items()}
        if self.fuse > 1:  # one reset a slot, doubled in the frame with guidance
            buffers["reset"] = torch.zeros(self.batch_size, dtype=torch.bool, device=dev)
        if self.cfg_enabled:
            buffers["alpha"] = torch.ones(self.batch_size, dtype=torch.float32, device=dev)
        self._inputs = StagedInputs(buffers)
        if self.fuse > 1:
            self._graph, _ = capture(lambda: self._fused_frame(self._inputs.buffers),
                                     steps, dev, self._inputs)
            self._frame_k.zero_()  # the warm-up advanced it; the capture ran nothing
            # The op table's application too: its staged buffer holds OP_NOP
            # rows until a flush stages ops, so the warm-up changes nothing.
            self._ops_graph, _ = capture(
                lambda: SCRIPT.apply_ops(self._mstate, self._ops_in.buffers["ops"]), 1, dev,
                self._ops_in)
            self._outputs = PinnedOutputs(self._frames.shape, self.pipeline_depth)
            return
        self._graph, self._static_out = capture(
            lambda: self._device_tick(self._inputs.buffers, in_place=True), steps, dev,
            self._inputs)
        self._outputs = PinnedOutputs(self._static_out.shape, 1)

    def warmup(self, steps: int = 2) -> None:
        """Run ticks (fused: dispatches) with no slot active through the
        whole step; with ``cuda_graph``, through the body to capture, then
        capture it.  Then the host GC is frozen unless the engine was built
        with ``gc_tune=False``, as the JAX engine does."""
        try:
            self._warm_all(steps)
            metrics.WARMUP_SUCCESS.inc()
        except Exception:
            metrics.WARMUP_FAILURE.inc()
            raise
        freeze_after_warmup(self.gc_tune)

    def _warm(self, steps: int) -> None:
        """:meth:`warmup`'s device part: the capture, or eager ticks."""
        n = self.batch_size
        off = np.zeros(n, bool)
        if self.cuda_graph:
            if self._graph is None:
                self._capture(steps)
        elif self.fuse > 1:
            for _ in range(steps):
                fetch(self._dispatch_fused(off))
        else:
            modes = np.full(n, TTS.ALLOW_PAD, np.int32)
            for _ in range(steps):
                self._invoke_step(modes, np.zeros(n, np.int32), off, off)

    # -- loop --

    def start(self) -> None:
        if self.cuda_graph and not self._captured():
            self.warmup()  # capture before the loop starts
        self.running = True
        self.thread = threading.Thread(target=self._loop, name="tts-model-loop",
                                       daemon=True)
        self.thread.start()

    def stop(self) -> None:
        self.running = False
        if self.thread:
            self.thread.join(timeout=5)
        # Deliver what is still in flight, once the loop has exited (two
        # threads posting at once could reorder a session's events).
        if self.thread is None or not self.thread.is_alive():
            while self._inflight_f:
                self._post_fused(self._inflight_f.popleft())
        self._close_shards()

    def _loop(self) -> None:
        while self.running:
            try:
                if not self.tick():
                    time.sleep(self.tick_sleep)
            except Exception:  # the model loop must outlive one bad tick
                metrics.record_connection_error("internal", "tts")
                traceback.print_exc()
                time.sleep(0.1)

    def tick(self) -> bool:
        """One engine tick (fused: one dispatch of K frames); True if any
        slot stepped or a dispatch in flight was posted."""
        if self.fuse > 1:
            return self._tick_fused()
        return self._tick_single()

    def _tick_fused(self) -> bool:
        """Upload what the slots may now see, dispatch K frames, and post the
        oldest dispatch once ``pipeline_depth`` are in flight."""
        n = self.batch_size
        reset = np.zeros(n, bool)
        drivers: List[Optional[TtsSlot]] = [None] * n
        t_gather0 = time.perf_counter()
        with self.slot_lock:
            t_lock = time.perf_counter()
            pending_voice, self._pending_voice = self._pending_voice, []
            ops, self._pending_script = self._pending_script, []
            reset[:] = self.pending_resets
            self.pending_resets[:] = False
            for slot, drv in enumerate(self.slots):
                if drv is None or drv.closed or drv.finished:
                    continue
                drivers[slot] = drv
                with drv.lock:
                    self._promote(drv, ops)
        t_hold = time.perf_counter()
        if pending_voice:
            with torch.inference_mode():
                self._apply_voice_writes(pending_voice)
        t_voice = time.perf_counter()
        self._apply_script_ops(ops)
        t_script = time.perf_counter()
        # The JAX engine's gather detail: lock wait, lock hold, voice writes,
        # script ops, and how many of each.
        detail = (t_lock - t_gather0, t_hold - t_lock, t_voice - t_hold, t_script - t_voice,
                  len(pending_voice), len(ops))
        if not any(d is not None for d in drivers) and not reset.any():
            if self._inflight_f:  # input paused: deliver what is in flight
                self._post_fused(self._inflight_f.popleft())
                return True
            return False
        t0 = time.perf_counter()
        handle = self._dispatch_fused(reset)
        self._inflight_f.append((handle, drivers, (t_gather0, t0, time.perf_counter()), detail))
        self.step_count += self.fuse
        if len(self._inflight_f) >= self.pipeline_depth:
            self._post_fused(self._inflight_f.popleft())
        return True

    def _promote(self, drv: TtsSlot, ops: List[tuple]) -> None:
        """Move ``drv``'s pending words to the device ring while it has room
        (a word longer than the ring is cut to it, or it would wait for ever),
        as upload ops appended to ``ops``; the end of input once every fed
        word is up."""
        slot = drv.slot
        while drv.pending_words:
            w = drv.pending_words[0]
            if len(w) > self.script_cap:
                log.warning("tts slot %d: word of %d tokens truncated to script_cap=%d",
                            slot, len(w), self.script_cap)
                w = drv.pending_words[0] = w[:self.script_cap]
            if len(w) > self.script_cap - (drv.up_toks - drv.consumed):
                break
            drv.pending_words.popleft()
            drv.word_queue.append(list(w))
            start, wid = drv.up_toks, drv.up_words
            for off in range(0, max(len(w), 1), SCRIPT.WORD_CHUNK):
                chunk = w[off:off + SCRIPT.WORD_CHUNK]
                toks = np.zeros(SCRIPT.WORD_CHUNK, np.int32)
                toks[:len(chunk)] = chunk
                ops.append((SCRIPT.OP_WORD, slot, toks, len(chunk), wid, start + off))
            drv.up_toks += len(w)
            drv.up_words += 1
        if drv.pending_eos and not drv.pending_words and not drv.eos:
            drv.eos = True
            ops.append((SCRIPT.OP_EOS, slot, None, 0, 0, 0))

    def _post_fused(self, item) -> None:
        """One fetch for a dispatch's K frames, replayed frame by frame
        through the slots' mirrors: words, audio, and Done once a mirror has
        no constraint left.  The pad patch already ran on the device."""
        handle, drivers, (t_gather0, t0, t_fetch0), detail = item
        packed = fetch(handle)
        t_fetch = time.perf_counter()
        # Dispatched ahead, one dispatch's dispatch-to-fetch spans others'
        # host work: the interval between completions is its cost.
        dt = t_fetch - t0 if self._last_fetch_t is None else min(t_fetch - t0,
                                                                  t_fetch - self._last_fetch_t)
        self._last_fetch_t = t_fetch
        metrics.LM_STEP_DURATION.observe(dt / self.fuse)
        metrics.LM_STEPS_TOTAL.inc(self.fuse)
        n, frame = self.batch_size, self.mimi_cfg.frame_size
        for row in packed:
            text_tokens = row[:n]
            steps = row[n:2 * n]
            dec_mask = row[2 * n:3 * n].astype(bool)
            pcm = self._unpack_pcm(row[3 * n:], n, frame) if dec_mask.any() else None
            metrics.MIMI_FRAMES_DECODED.inc(int(dec_mask.sum()))
            for slot, drv in enumerate(drivers):
                if drv is None or drv.finished or drv.closed:
                    continue
                if drv.next_constraint(self.cfg) is None:
                    drv.finished = True
                    drv.deliver(DoneEvent())
                    continue
                drv.steps = int(steps[slot])
                drv.on_text_token(self.cfg, int(text_tokens[slot]), self.tokenizer)
                if pcm is not None and dec_mask[slot]:
                    drv.pcm_samples += frame
                    drv.deliver(AudioEvent(pcm=pcm[slot].copy()))
        if self.tick_observer is not None:
            self.tick_observer(t0 - t_gather0, t_fetch0 - t0, t_fetch - t_fetch0,
                               time.perf_counter() - t_fetch, *detail)

    def _tick_single(self) -> bool:
        n = self.batch_size
        modes = np.full(n, TTS.ALLOW_PAD, np.int32)
        toks = np.zeros(n, np.int32)
        mask = np.zeros(n, bool)
        reset = np.zeros(n, bool)
        drivers: List[Optional[TtsSlot]] = [None] * n
        t_gather0 = time.perf_counter()
        with self.slot_lock:
            pending_voice, self._pending_voice = self._pending_voice, []
            reset[:] = self.pending_resets
            self.pending_resets[:] = False
            for slot, drv in enumerate(self.slots):
                if drv is None or drv.closed or drv.finished:
                    continue
                c = drv.next_constraint(self.cfg)
                if c is None:
                    drv.finished = True
                    drv.deliver(DoneEvent())
                    continue
                modes[slot], toks[slot], _ = c
                mask[slot] = True
                drivers[slot] = drv
        if pending_voice:
            with torch.inference_mode():
                self._apply_voice_writes(pending_voice)
        if not mask.any() and not reset.any():
            return False

        t0 = time.perf_counter()
        handle = self._dispatch_single(modes, toks, mask, reset)
        t_fetch0 = time.perf_counter()
        packed = fetch(handle)  # the tick's one fetch
        t_fetch = time.perf_counter()
        self.step_count += 1
        text_tokens = packed[:n]
        steps = packed[n:2 * n]
        dec_mask = packed[2 * n:3 * n].astype(bool)
        frame = self.mimi_cfg.frame_size
        pcm = self._unpack_pcm(packed[3 * n:], n, frame) if dec_mask.any() else None
        metrics.LM_STEP_DURATION.observe(time.perf_counter() - t0)
        metrics.LM_STEPS_TOTAL.inc()
        metrics.MIMI_FRAMES_DECODED.inc(int(dec_mask.sum()))

        overwrite = np.zeros(n, bool)
        for slot, drv in enumerate(drivers):
            if drv is None:
                continue
            drv.steps = int(steps[slot])
            if drv.on_text_token(self.cfg, int(text_tokens[slot]),
                                 self.tokenizer) == "overwrite_pad":
                overwrite[slot] = True
            if pcm is not None and dec_mask[slot]:
                drv.pcm_samples += frame
                drv.deliver(AudioEvent(pcm=pcm[slot].copy()))
        if overwrite.any():
            self._overwrite_pad(overwrite)
        if self.tick_observer is not None:
            self.tick_observer(t0 - t_gather0, t_fetch0 - t0, t_fetch - t_fetch0,
                               time.perf_counter() - t_fetch)
        return True

    def _overwrite_pad(self, overwrite: np.ndarray) -> None:
        """Patch the last text token of the ``overwrite`` slots to a pad, in
        place (a replay reads the state's own buffers); on every shard of a
        mesh."""
        if self.mesh is not None:
            self._runner.each(
                lambda d, t, sh: sh._overwrite_pad(overwrite[self._shard_slots(d)]))
            return
        with torch.inference_mode():
            TTS.overwrite_last_text_token_in_place(
                self.state, self.cfg.text_pad_token,
                torch.as_tensor(self._rows(overwrite), device=self.device))

    # -- the surface the app calls --

    def voice_kv(self, spec):
        """A voice spec -> its per-layer K/V ``(L, 1, H, S, Dh)`` pair, or
        None for no voice."""
        if not spec or self.voices is None:
            return None
        ca = self.voices.resolve(spec)
        if ca is None:
            return None
        with torch.inference_mode():
            return T.precompute_ca_kv(
                self.cfg.lm.transformer, self.params["lm"]["transformer"],
                torch.as_tensor(ca, device=self.device).to(self.cache_dtype))

    def encode_words(self, text: str, inserted_bos: bool):
        """Text -> per-word token ids with a single leading bos."""
        words = []
        for word in text.split(" "):
            if not word:
                continue
            ids = list(self.tokenizer.encode(word))
            if not inserted_bos:
                ids.insert(0, self.cfg.text_bos_token)
                inserted_bos = True
            words.append(ids)
        return words, inserted_bos

    def synthesize(self, text: str, voice_ca=None, seed: int = 0,
                   timeout_s: float = 300.0, cfg_alpha=None):
        """Offline synthesis over the batched engine: occupies one slot.
        Returns ``(pcm (N,) f32, [WordEvent])``."""
        done = threading.Event()
        pcm_chunks: List[np.ndarray] = []
        transcript: List[WordEvent] = []

        def sink(ev):
            if isinstance(ev, AudioEvent):
                pcm_chunks.append(ev.pcm)
            elif isinstance(ev, WordEvent):
                transcript.append(ev)
            elif isinstance(ev, DoneEvent):
                done.set()

        slot = None
        deadline = time.time() + timeout_s
        while slot is None and time.time() < deadline:
            slot = self.open_session(sink, voice_ca=voice_ca, seed=seed if seed else None,
                                     cfg_alpha=cfg_alpha)
            if slot is None:
                time.sleep(0.05)
        if slot is None:
            raise TimeoutError("no free TTS slot")
        try:
            words, _ = self.encode_words(text, inserted_bos=False)
            slot.feed_words(words)
            slot.end_input()
            if self.running:
                done.wait(timeout=timeout_s)
            else:
                while not done.is_set() and time.time() < deadline:
                    if not self.tick():
                        time.sleep(self.tick_sleep)
        finally:
            self.close_session(slot)
        pcm = np.concatenate(pcm_chunks) if pcm_chunks else np.zeros(0, np.float32)
        return pcm, transcript
