"""Single-session TTS serving (counterpart of ``dsm_tpu/server/tts_module.py``):
the word-feeding session driver, offline synthesis, and the event classes
that the batched engine shares.

The host drives each 80 ms frame as the reference's process loop does:

* inside a word: force its next token;
* after a word: pad or end-of-word, the model's choice;
* on end-of-word: emit the word with its 12.5 Hz timestamps and take the
  next one; at the end of the input, teacher-force a pad over the final
  end-of-word;
* once the input has ended: pad for ``extra_steps + text_audio_delay``
  frames.

Frames come back from the step already delay-resolved and are Mimi-decoded
on the device in the same tick, once the step is past the combined text and
acoustic delay; the pcm leaves the device with the tick's text token, step
and decode flag as one packed int32 array.

:class:`TtsEngine` serves one session at a time under its lock, as the
reference does, and owns the one state it steps: a session resets it when it
starts.  On a CUDA device the tick is one captured CUDA graph, the
counterpart of the JAX engine's jitted ``_step`` and ``mimi_decode``: the
key split (the key is a device buffer), ``sessions.tts.step_in_place``, the
gated ``models.mimi.decode_step_in_place`` and the packing, replayed on the
engine's state, its voice buffer and, where the session has one, its
condition buffer; each tick stages the frame's mode and token through pinned
memory and fetches the packed array into pinned memory.  A session without
a voice runs over a zero voice, which leaves every residual bit for bit as
it is without the cross-attention; a condition, which changes the
embedding's dtype, selects a graph of its own.  ``cuda_graph=False`` runs
the same tick eagerly; the CPU has no graph.  The voice store is int8 (the
``ca_decode_attend`` kernel) with ``ca_quant``.

A session ends with the JAX session's prometheus calls (``server/metrics.py``):
its wall time, the request, the audio seconds and the real-time factor.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..models import mimi as MIMI
from ..ops import sampling as S
from ..ops import transformer as T
from ..sessions import tts as TTS
from ..utils.state import copy_into
from . import metrics
from .cuda_graph import PinnedOutputs, StagedInputs, capture, fetch


@dataclasses.dataclass
class WordEvent:
    text: str
    start_s: float
    stop_s: float


@dataclasses.dataclass
class AudioEvent:
    pcm: np.ndarray  # (1920,) float32


class TtsSession:
    """One streaming TTS generation: words in, events out.  :meth:`run`
    steps the engine's state; the caller holds the engine's lock."""

    def __init__(self, engine: "TtsEngine", ca_kv=None, condition=None, seed: int = 0):
        self.engine = engine
        self.cfg = engine.cfg
        self.ca_kv = ca_kv
        self.condition = condition
        self.seed = int(seed)
        self.word_queue: List[Optional[List[int]]] = []
        self.queue_cv = threading.Condition(threading.Lock())
        # An empty current word: the first real word is awaited.
        self.word_tokens: Optional[List[int]] = []
        self.token_idx = 0
        self.step_past_last = 0
        self.last_eop_step = 0
        self.step_idx = 0
        self.done = False

    # -- input side --

    def feed_words(self, words: Iterable[List[int]]) -> None:
        with self.queue_cv:
            for w in words:
                self.word_queue.append(list(w))
            self.queue_cv.notify_all()

    def end_input(self) -> None:
        with self.queue_cv:
            self.word_queue.append(None)
            self.queue_cv.notify_all()

    def _next_word(self, timeout: Optional[float]) -> Optional[List[int]]:
        with self.queue_cv:
            while not self.word_queue:
                if not self.queue_cv.wait(timeout=timeout):
                    raise TimeoutError("word queue starved")
            return self.word_queue.pop(0)

    # -- generation --

    def run(self, on_event: Callable[[object], None], max_steps: Optional[int] = None,
            word_timeout: Optional[float] = None) -> None:
        """Drive the session to its end, calling ``on_event`` with
        :class:`WordEvent` and :class:`AudioEvent` as they come."""
        cfg = self.cfg
        eng = self.engine
        max_steps = max_steps or cfg.max_steps - cfg.acoustic_delay - 1
        t_start = time.perf_counter()
        eng.begin(self.seed, self.ca_kv, self.condition)
        frame = eng.mimi_cfg.frame_size
        pcm_out = 0
        for step_idx in range(max_steps):
            if self.word_tokens is None:
                self.step_past_last += 1
                if self.step_past_last > cfg.extra_steps + cfg.text_audio_delay_in_tokens:
                    break
                mode, tok = TTS.ALLOW_PAD, 0
            elif self.token_idx < len(self.word_tokens):
                mode, tok = TTS.ALLOW_TEXT, self.word_tokens[self.token_idx]
            else:
                mode, tok = TTS.ALLOW_PAD_OR_EPAD, 0

            packed = eng.tick(mode, tok)
            text_token = int(packed[0])
            decoded = bool(packed[2])
            pcm = packed[3:3 + frame].view(np.float32).copy() if decoded else None

            if text_token == cfg.text_eop_token:
                if self.word_tokens:
                    on_event(WordEvent(text=eng.tokenizer.decode(self.word_tokens),
                                       start_s=self.last_eop_step / 12.5,
                                       stop_s=step_idx / 12.5))
                self.last_eop_step = step_idx
                self.word_tokens = self._next_word(word_timeout)
                if self.word_tokens is None:
                    # Teacher-force a pad over the final end-of-word.
                    eng.overwrite_last_text_token(cfg.text_pad_token)
                self.token_idx = 0
            elif text_token != cfg.text_pad_token:
                self.token_idx += 1

            # Audio once past the combined delay (the decode flag says so).
            if pcm is not None:
                pcm_out += len(pcm)
                on_event(AudioEvent(pcm=pcm))
            self.step_idx = step_idx + 1
        self.done = True
        wall = time.perf_counter() - t_start
        metrics.TTS_SYNTHESIS_DURATION.observe(wall)
        metrics.TTS_REQUESTS_TOTAL.inc()
        if pcm_out:
            metrics.TTS_AUDIO_DURATION.inc(pcm_out / 24_000.0)
            metrics.TTS_RTF.set((pcm_out / 24_000.0) / max(wall, 1e-9))


class TtsEngine:
    """The model, its one state and its tick, for one session at a time on
    ``device`` (the card unless it names another).

    ``params``: ``{"lm": ...}``, dense or int8 (``quantize_weights``), used
    as given; ``ca_quant``: the voice store int8 (default: on CUDA);
    ``cuda_graph``: the tick captured as one CUDA graph (default: on CUDA;
    a CPU engine with it raises)."""

    def __init__(self, cfg: TTS.TtsConfig, params: dict, mimi_cfg: MIMI.MimiConfig,
                 mimi_params: dict, tokenizer, *, device="cuda",
                 cuda_graph: Optional[bool] = None, ca_quant: Optional[bool] = None):
        if cfg.cfg_alpha is not None:
            raise ValueError("a static cfg_alpha needs a doubled batch; the single-session "
                             "engine steps one row")
        self.cfg = cfg
        self.params = params
        self.mimi_cfg = mimi_cfg
        self.mimi_params = mimi_params
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        on_card = self.device.type == "cuda"
        self.cuda_graph = on_card if cuda_graph is None else bool(cuda_graph)
        if self.cuda_graph and not on_card:
            raise ValueError(f"cuda_graph: no CUDA graph on {self.device}")
        self.cache_dtype = torch.bfloat16 if on_card else torch.float32
        self.ca_quant = on_card if ca_quant is None else bool(ca_quant)
        self.lock = threading.Lock()  # one inference at a time
        self.voices = None  # optional server.voices.VoiceResolver
        self.condition_provider = None  # models.conditioner.ConditionProvider
        self.default_condition = None  # (1, D) attribute embedding or None

        dev = self.device
        tcfg = cfg.lm.transformer
        # The voice's frames: the speaker encoder's, ``n_speakers`` clips of
        # ``speaker_cond_duration_s`` at the codec's frame rate (125 each at 10 s).
        self.ca_len = cfg.speaker_cond_n_speakers * int(
            cfg.speaker_cond_duration_s * mimi_cfg.frame_rate)
        zero = torch.zeros((tcfg.num_layers, 1, tcfg.num_heads, self.ca_len, tcfg.hd),
                           dtype=self.cache_dtype, device=dev)
        # The voice buffer the tick reads; a session without a voice runs
        # over zeros, which adds an exact zero to every residual.
        self._zero_voice = T.quantize_ca_kv((zero, zero), s_len=self.ca_len) \
            if self.ca_quant else (zero, zero.clone())
        self._ca = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                    for k, v in self._zero_voice.items()} if self.ca_quant \
            else (zero.clone(), zero.clone())
        self._cond = torch.zeros((1, cfg.lm.d_model), dtype=torch.float32, device=dev)
        self._has_cond = False
        self._mimi_dtype = mimi_params["quantizer"]["rvq_first"]["embed"].dtype
        self.state = TTS.init_state(cfg, 1, self.cache_dtype, dev)
        self.mimi_state = MIMI.init_decode_state(mimi_cfg, 1, self._mimi_dtype, dev)
        self.rng = S.prng_key(0, device=dev)
        self._mode = torch.zeros(1, dtype=torch.int32, device=dev)
        self._tok = torch.zeros(1, dtype=torch.int32, device=dev)
        self._graphs: dict = {}  # has_condition -> (graph, packed output)

    # -- the session's state --

    def begin(self, seed: int, ca_kv=None, condition=None) -> None:
        """Start a session: the state reset to a fresh one, the key set from
        ``seed``, the voice (a :meth:`voice_kv` value, or None) and the
        condition (``(1, D)`` or None) written into the buffers the tick
        reads."""
        dev = self.device
        with torch.inference_mode():
            copy_into(self.state, TTS.init_state(self.cfg, 1, self.cache_dtype, dev))
            copy_into(self.mimi_state,
                      MIMI.init_decode_state(self.mimi_cfg, 1, self._mimi_dtype, dev))
            self.rng.copy_(S.prng_key(int(seed) & 0xFFFFFFFF))
            voice = self._zero_voice if ca_kv is None else ca_kv
            if self.ca_quant:
                if not isinstance(voice, dict):
                    voice = T.quantize_ca_kv(voice, s_len=self.ca_len)
                for key in ("k", "v", "ks", "vs"):
                    self._ca[key].copy_(voice[key])
            else:
                self._ca[0].copy_(voice[0])
                self._ca[1].copy_(voice[1])
            self._has_cond = condition is not None
            if self._has_cond:
                c = torch.as_tensor(condition).reshape(1, -1)
                if c.dtype != self._cond.dtype:  # the sum's dtype follows the condition's
                    self._cond = torch.zeros(self._cond.shape, dtype=c.dtype, device=dev)
                    self._graphs.pop(True, None)  # captured over the old buffer
                self._cond.copy_(c)

    def overwrite_last_text_token(self, token: int) -> None:
        """The pad over the final end-of-word, in the state's own buffers,
        so that the next tick reads it."""
        with torch.inference_mode():
            TTS.overwrite_last_text_token_in_place(self.state, token)

    # -- the tick --

    def _device_tick(self, has_cond: bool) -> torch.Tensor:
        """The tick over the engine's buffers -> the packed int32 array
        ``[text, step, dec_mask, pcm bits (frame)]``: the key split, the TTS
        step, the Mimi decode of the completed frame once past the combined
        delay."""
        cfg = self.cfg
        rng, key = S.split(self.rng)
        self.rng.copy_(rng)
        out = TTS.step_in_place(cfg, self.params, self.state, self._mode, self._tok, rng=key,
                                ca_kv=self._ca, condition=self._cond if has_cond else None)
        delay = cfg.text_audio_delay_in_tokens + cfg.acoustic_delay
        dec = out["frame_valid"] & (out["step_idx"] > delay)
        pcm = MIMI.decode_step_in_place(self.mimi_cfg, self.mimi_params, self.mimi_state,
                                        out["frame"][:, :, None], dec)
        return torch.cat([out["text_token"].to(torch.int32), out["step_idx"].to(torch.int32),
                          dec.to(torch.int32),
                          pcm[:, 0, :].float().contiguous().view(torch.int32).reshape(-1)])

    def _capture(self, has_cond: bool, steps: int = 2) -> None:
        """Capture the tick (with or without the condition) on a side
        stream after ``steps`` warm-up runs; the state is left dirty and is
        reset by the next :meth:`begin`."""
        if not hasattr(self, "_inputs"):
            self._inputs = StagedInputs({"mode": self._mode, "tok": self._tok})
            self._outputs = PinnedOutputs((3 + self.mimi_cfg.frame_size,), 1)
        self._inputs.stage({"mode": np.full(1, TTS.ALLOW_PAD, np.int32),
                            "tok": np.zeros(1, np.int32)})
        self._graphs[has_cond] = capture(lambda: self._device_tick(has_cond), steps,
                                         self.device)

    def warmup(self, steps: int = 2) -> None:
        """With ``cuda_graph``: capture the tick, and its form with the
        condition where the engine has a default condition.  Eagerly: run
        ``steps`` ticks.  Sessions reset what this leaves in the state."""
        if self.default_condition is not None:
            self._cond = torch.zeros(self._cond.shape, dtype=self.default_condition.dtype,
                                     device=self.device)
        if self.cuda_graph:
            for has_cond in (False, True) if self.default_condition is not None else (False,):
                if has_cond not in self._graphs:
                    self._capture(has_cond, steps)
            return
        self.begin(0)
        for _ in range(steps):
            self.tick(TTS.ALLOW_PAD, 0)

    def tick(self, mode: int, tok: int) -> np.ndarray:
        """One frame with the text constraint ``(mode, tok)`` -> the packed
        int32 host array (on the graph, pinned memory that the next tick
        overwrites)."""
        if self.cuda_graph:
            if self._has_cond not in self._graphs:
                self._capture(self._has_cond)  # a condition the warm-up did not foresee
            self._inputs.stage({"mode": np.full(1, mode, np.int32),
                                "tok": np.full(1, tok, np.int32)})
            graph, out = self._graphs[self._has_cond]
            graph.replay()
            return fetch(self._outputs.copy(out))
        with torch.inference_mode():
            self._mode.fill_(mode)
            self._tok.fill_(tok)
            return self._device_tick(self._has_cond).cpu().numpy()

    # -- the surface the app calls --

    def voice_kv(self, spec: Optional[str]):
        """A ``?voice=`` spec -> the per-layer cross-attention K/V
        ``(L, 1, H, S, Dh)`` pair, or its int8 store with ``ca_quant``; None
        for no voice."""
        if not spec or self.voices is None:
            return None
        ca = self.voices.resolve(spec)
        if ca is None:
            return None
        with torch.inference_mode():
            kv = T.precompute_ca_kv(self.cfg.lm.transformer, self.params["lm"]["transformer"],
                                    torch.as_tensor(ca, device=self.device).to(self.cache_dtype))
            return T.quantize_ca_kv(kv, s_len=self.ca_len) if self.ca_quant else kv

    def encode_words(self, text: str, inserted_bos: bool) -> Tuple[List[List[int]], bool]:
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

    def synthesize(self, text: str, ca_kv=None, condition=None,
                   seed: int = 0) -> Tuple[np.ndarray, List[WordEvent]]:
        """Offline synthesis: the whole generation, then the concatenated
        pcm and the word transcript."""
        with self.lock:
            session = TtsSession(self, ca_kv=ca_kv, condition=condition, seed=seed)
            words, _ = self.encode_words(text, inserted_bos=False)
            session.feed_words(words)
            session.end_input()
            pcm_chunks: List[np.ndarray] = []
            transcript: List[WordEvent] = []

            def sink(ev):
                if isinstance(ev, AudioEvent):
                    pcm_chunks.append(ev.pcm)
                else:
                    transcript.append(ev)

            session.run(sink)
        pcm = np.concatenate(pcm_chunks) if pcm_chunks else np.zeros(0, np.float32)
        return pcm, transcript
