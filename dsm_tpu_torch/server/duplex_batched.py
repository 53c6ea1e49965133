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

The serving profile is chosen by arguments, not by the environment:
``kv_quant`` gives the LM int8 KV rings (by default on CUDA and not on the
CPU, as in the JAX engine), ``kv_bits = 4`` with it
nibble-packed int4 rings (half the ring's bytes: room for larger batches),
and the weights run as they are given (the
builder hands over int8 weights, which multiply by the profile they carry:
W8A8, or weight-only with ``w8a8 = false``).

Left out (ROADMAP.md): dispatch-ahead (``pipeline_depth > 1``), the device
mesh and prometheus metrics.  ``server/builder.py`` refuses the options that
select them.
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
from ..sessions import lm_gen


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


class BatchedDuplexEngine:
    """Slot pool and model loop for one dialogue module on one device."""

    def __init__(self, cfg: lm_gen.DuplexConfig, params: dict, mimi_cfg: MIMI.MimiConfig,
                 mimi_params: dict, tokenizer, batch_size: int = 8,
                 tick_sleep: float = 0.002, kv_quant: Optional[bool] = None, kv_bits: int = 8,
                 *, device):
        """``params``: ``{"lm": ...}``, dense or int8 (``quantize_weights``),
        used as given; ``mimi_params``: both halves of the codec;
        ``kv_quant``: int8 KV rings, packed int4 with ``kv_bits = 4``; None
        (the default) takes them on CUDA and not on the CPU;
        ``device``: where everything lives."""
        self.cfg = cfg
        self.mimi_cfg = mimi_cfg
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.tick_sleep = tick_sleep
        self.device = torch.device(device)
        self.kv_quant = self.device.type == "cuda" if kv_quant is None else bool(kv_quant)
        self.kv_bits = kv_bits if self.kv_quant else 8
        self.cache_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.params = params
        self.mimi_params = mimi_params
        dev = self.device
        self._mimi_dtype = mimi_params["quantizer"]["rvq_first"]["embed"].dtype

        self.state = lm_gen.init_state(cfg, batch_size, self.cache_dtype,
                                       kv_quant=self.kv_quant, device=dev,
                                       kv_bits=self.kv_bits)
        self.enc_state = MIMI.init_encode_state(mimi_cfg, batch_size, self._mimi_dtype, dev)
        self.dec_state = MIMI.init_decode_state(mimi_cfg, batch_size, self._mimi_dtype, dev)
        self.rng = S.prng_key(0, device=dev)

        self.slots: List[Optional[DuplexSlot]] = [None] * batch_size
        self.free: deque = deque(range(batch_size))
        self.pending_resets = np.zeros(batch_size, bool)
        self._asr_delay = np.zeros(batch_size, np.int32)
        self.slot_lock = threading.Lock()
        self.running = False
        self.thread: Optional[threading.Thread] = None
        self.step_count = 0
        # (step s, n_active, (gather, dispatch, fetch, post) s) per stepped tick
        self.tick_observer = None
        self._pcm_buf = np.zeros((batch_size, 1, mimi_cfg.frame_size), np.float32)

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

    def _next_key(self) -> torch.Tensor:
        self.rng, sub = S.split(self.rng)
        return sub

    def _invoke_step(self, pcm: np.ndarray, mask: np.ndarray, reset: np.ndarray,
                     asr_delay: np.ndarray, key: torch.Tensor) -> torch.Tensor:
        """One device tick for host arrays -> the packed int32 device tensor
        ``[text (n), steps (n), dec_mask (n), pcm bits (n * frame)]``."""
        dev = self.device
        cfg = self.cfg
        with torch.inference_mode():
            mask_t = torch.as_tensor(mask, device=dev)
            reset_t = torch.as_tensor(reset, device=dev)
            delay_t = torch.as_tensor(asr_delay, device=dev)
            x = torch.as_tensor(pcm, device=dev).to(self._mimi_dtype)
            codes, self.enc_state = MIMI.encode_step(
                self.mimi_cfg, self.mimi_params, self.enc_state, x, mask_t)
            user_tokens = codes[:, :cfg.input_audio_codebooks, 0].to(torch.int32)
            out, self.state = lm_gen.step(cfg, self.params, self.state, user_tokens, key,
                                          asr_delay=delay_t, mask=mask_t, reset=reset_t)
            # The codec's per-slot reset rides the same tick, after the
            # encode, as in the JAX engine; text-only slots skip the decode.
            self.enc_state = MIMI.reset_encode_state(self.enc_state, reset_t)
            self.dec_state = MIMI.reset_decode_state(self.dec_state, reset_t)
            dec_mask = out["frame_valid"] & (delay_t <= 0)
            frame_codes = torch.where(dec_mask[:, None], out["frame"], 0)[:, :, None]
            pcm_out, self.dec_state = MIMI.decode_step(
                self.mimi_cfg, self.mimi_params, self.dec_state, frame_codes, dec_mask)
            return torch.cat([
                out["text_token"].to(torch.int32),
                out["step_idx"].to(torch.int32),
                dec_mask.to(torch.int32),
                pcm_out[:, 0, :].float().contiguous().view(torch.int32).reshape(-1),
            ])

    def warmup(self, steps: int = 2) -> None:
        """Run ticks with no slot active through the whole step."""
        off = np.zeros(self.batch_size, bool)
        for _ in range(steps):
            packed = self._invoke_step(self._pcm_buf, off, off, self._asr_delay.copy(),
                                       self._next_key())
        packed.cpu()

    # -- loop --

    def start(self) -> None:
        self.running = True
        self.thread = threading.Thread(target=self._loop, name="duplex-model-loop",
                                       daemon=True)
        self.thread.start()

    def stop(self) -> None:
        self.running = False
        if self.thread:
            self.thread.join(timeout=5)

    def _loop(self) -> None:
        while self.running:
            try:
                if not self.tick():
                    time.sleep(self.tick_sleep)
            except Exception:  # the model loop must outlive one bad tick
                traceback.print_exc()
                time.sleep(0.1)

    def tick(self) -> bool:
        """One engine tick; True if any slot stepped."""
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
                    if drv.eos:
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
            return False

        t0 = time.perf_counter()
        packed_dev = self._invoke_step(self._pcm_buf, mask, reset, asr_delay,
                                       self._next_key())
        t1 = time.perf_counter()
        self.step_count += 1
        self._post_process(packed_dev, stepped, int(mask.sum()), t_tick0, t0, t1)
        return True

    def _post_process(self, packed_dev, stepped, n_active, t_tick0, t0, t1) -> None:
        n = self.batch_size
        frame = self.mimi_cfg.frame_size
        packed = packed_dev.cpu().numpy()  # the tick's one device-to-host fetch
        t2 = time.perf_counter()
        text_tokens = packed[:n]
        steps = packed[n:2 * n]
        dec_mask = packed[2 * n:3 * n].astype(bool)
        pcm = packed[3 * n:].view(np.float32).reshape(n, frame)

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
            self.tick_observer(t2 - t0, n_active,
                               (t0 - t_tick0, t1 - t0, t2 - t1, t3 - t2))
