"""Single-dialogue full-duplex serving and the byte-tag frames of the
duplex WebSocket (counterpart of ``dsm_tpu/server/duplex.py``).

One WebSocket speaks the byte-tag protocol (``protocol.MsgType``): AUDIO
frames carry Ogg pages (``utils/opus.py``; the App encodes and decodes them)
or raw little-endian f32 pcm (``?format=pcm``), TEXT frames the model's
words.  :class:`DuplexEngine` holds
the model for one dialogue at a time (``batch_size = 1``); a
:class:`DuplexSession` runs the 80 ms loop

  Mimi.encode_step(user pcm) -> lm_gen.step -> Mimi.decode_step(model frame)

on the caller's thread and hands audio and text to callbacks.  With
``asr_delay_in_tokens > 0`` the session is text-only.  Several dialogues at
once go through ``duplex_batched.BatchedDuplexEngine``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..models import mimi as MIMI
from ..ops import sampling as S
from ..sessions import lm_gen
from .protocol import MsgType


class DuplexEngine:
    def __init__(self, cfg: lm_gen.DuplexConfig, params: dict, mimi_cfg: MIMI.MimiConfig,
                 mimi_params: dict, tokenizer, kv_quant: Optional[bool] = None, *,
                 device):
        """``kv_quant``: int8 KV rings (None: on CUDA, not on the CPU); ``params`` run as given (int8 weights
        from ``quantize_weights`` multiply by the profile they carry)."""
        self.cfg = cfg
        self.mimi_cfg = mimi_cfg
        self.mimi_params = mimi_params
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.cache_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.kv_quant = self.device.type == "cuda" if kv_quant is None else bool(kv_quant)
        self.params = params
        self.mimi_dtype = mimi_params["quantizer"]["rvq_first"]["embed"].dtype
        self.lock = threading.Lock()  # one dialogue at a time per engine

    def warmup(self) -> None:
        """One frame through encode, step and decode."""
        sess = DuplexSession(self)
        sess._frame(np.zeros(self.mimi_cfg.frame_size, np.float32), lambda pcm: None,
                    lambda text: None, [])


class DuplexSession:
    """One dialogue: pcm frames in, (pcm, text) out through callbacks."""

    def __init__(self, engine: DuplexEngine, seed: int = 0, asr_delay_in_tokens: int = 0):
        self.engine = engine
        dev = engine.device
        self.in_q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(maxsize=100)
        self.rng = S.prng_key(seed, device=dev)
        self.enc_state = MIMI.init_encode_state(engine.mimi_cfg, 1, engine.mimi_dtype, dev)
        self.dec_state = MIMI.init_decode_state(engine.mimi_cfg, 1, engine.mimi_dtype, dev)
        self.state = lm_gen.init_state(engine.cfg, 1, engine.cache_dtype,
                                       kv_quant=engine.kv_quant, device=dev)
        self.steps = 0
        # > 0: text input hidden inside the delay, no audio out.
        self.asr_delay = int(asr_delay_in_tokens)

    def push_pcm(self, pcm: np.ndarray) -> None:
        self.in_q.put(np.asarray(pcm, np.float32))

    def close(self) -> None:
        self.in_q.put(None)

    def _frame(self, chunk, on_audio, on_text, text_acc) -> None:
        eng = self.engine
        cfg = eng.cfg
        with torch.inference_mode():
            x = torch.as_tensor(chunk[None, None, :], device=eng.device).to(eng.mimi_dtype)
            codes, self.enc_state = MIMI.encode_step(eng.mimi_cfg, eng.mimi_params,
                                                     self.enc_state, x)
            user_tokens = codes[:, :cfg.input_audio_codebooks, 0].to(torch.int32)
            self.rng, sub = S.split(self.rng)
            out, self.state = lm_gen.step(cfg, eng.params, self.state, user_tokens, sub,
                                          asr_delay=self.asr_delay)
            self.steps += 1
            tok = int(out["text_token"][0])
            if tok not in (cfg.text_pad_token, cfg.text_eop_token, cfg.text_start_token):
                text_acc.append(tok)
            elif text_acc:
                on_text(eng.tokenizer.decode(text_acc))
                text_acc.clear()
            if self.asr_delay <= 0 and bool(out["frame_valid"][0]):
                pcm, self.dec_state = MIMI.decode_step(
                    eng.mimi_cfg, eng.mimi_params, self.dec_state, out["frame"][:, :, None])
                on_audio(pcm[0, 0].float().cpu().numpy())

    def run(self, on_audio: Callable[[np.ndarray], None],
            on_text: Callable[[str], None]) -> None:
        """Serve until :meth:`close`; holds the engine's lock throughout."""
        frame = self.engine.mimi_cfg.frame_size
        buf = np.zeros(0, np.float32)
        text_acc: list = []
        with self.engine.lock:
            while True:
                item = self.in_q.get()
                if item is None:
                    break
                buf = np.concatenate([buf, item])
                while len(buf) >= frame:
                    chunk, buf = buf[:frame], buf[frame:]
                    self._frame(chunk, on_audio, on_text, text_acc)
            if text_acc:
                on_text(self.engine.tokenizer.decode(text_acc))


def audio_frame(pcm: np.ndarray) -> bytes:
    return bytes([MsgType.AUDIO]) + np.asarray(pcm, "<f4").tobytes()


def text_frame(text: str) -> bytes:
    return bytes([MsgType.TEXT]) + text.encode()


def parse_frame(data: bytes):
    """-> ``(MsgType, payload)``."""
    if not data:
        raise ValueError("empty frame")
    return MsgType(data[0]), data[1:]
