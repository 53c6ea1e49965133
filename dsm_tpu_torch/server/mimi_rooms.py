"""Mimi codec-as-a-service broadcast rooms (counterpart of
``dsm_tpu/server/mimi_rooms.py``; reference: moshi-server/src/mimi.rs).

A sender websocket posts codebook frames; the server decodes each once and
broadcasts the audio to every receiver websocket of the room; text frames
pass through.

Wire format (byte-tag protocol, protocol.rs MsgType):
  sender  -> CODES (9) + little-endian u32 codes, one frame = n_q values
  server  -> AUDIO (1) + little-endian f32 pcm to all receivers
             TEXT  (2) passthrough
The broadcast is raw pcm; a receiver asking ``format=OggOpus`` gets Ogg
pages of an encoder of its own (the reference broadcasts ogg/opus pages), or
raw pcm where the codec does not load, as the JAX route does (``server/app.py``).

Each room keeps its own B=1 decode state on the engine's device (the card
unless the caller names another); :meth:`MimiRoomsEngine.decode_frame` runs
``models.mimi.decode_step`` on it eagerly, so the codec transformer's
``rope_commit`` runs on the card, once a layer a frame.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Dict, Optional, Set

import numpy as np
import torch

from ..models import mimi as MIMI
from .protocol import MsgType


class Room:
    def __init__(self, name: str, engine: "MimiRoomsEngine"):
        self.name = name
        self.engine = engine
        self.receivers: Set[asyncio.Queue] = set()
        self.dec_state = None
        self.lock = threading.Lock()

    def subscribe(self) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue(maxsize=256)
        self.receivers.add(q)
        return q

    def unsubscribe(self, q: asyncio.Queue) -> None:
        self.receivers.discard(q)

    def broadcast(self, payload: bytes, loop) -> None:
        """One event-loop wakeup a broadcast: the fan-out runs on the loop's
        thread (the only one that changes ``receivers``); a full receiver
        drops its oldest message."""
        targets = list(self.receivers)

        def fan_out():
            for qq in targets:
                if qq.full():
                    try:
                        qq.get_nowait()
                    except asyncio.QueueEmpty:
                        pass
                qq.put_nowait(payload)

        loop.call_soon_threadsafe(fan_out)


class MimiRoomsEngine:
    """The codec and the rooms.  ``params``: the codec's (random ones from a
    generator seeded 0 when None, bf16 on CUDA and f32 elsewhere); their
    dtype sets the rooms' decode states."""

    def __init__(self, cfg: Optional[MIMI.MimiConfig] = None, params=None, device="cuda"):
        self.cfg = cfg or MIMI.v0_1(16)
        self.device = torch.device(device)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
            params = MIMI.init(self.cfg, gen, dtype)
        self.params = params
        self._dtype = params["quantizer"]["rvq_first"]["embed"].dtype
        self.rooms: Dict[str, Room] = {}
        self.lock = threading.Lock()

    def init_state(self) -> dict:
        """A fresh B=1 decode state."""
        return MIMI.init_decode_state(self.cfg, 1, self._dtype, self.device)

    def decode(self, state: dict, codes: np.ndarray):
        """One frame from ``state``: codes (n_q,) -> (pcm (frame_size,) f32,
        the next state); the state's rings are written in place."""
        c = torch.as_tensor(np.asarray(codes, np.int32).reshape(1, -1, 1), device=self.device)
        with torch.inference_mode():
            pcm, state = MIMI.decode_step(self.cfg, self.params, state, c)
            return pcm[0, 0].float().cpu().numpy(), state

    def warmup(self) -> None:
        """Decode one frame before serving, so that the first room frame pays
        no build or first-launch cost."""
        self.decode(self.init_state(), np.zeros(self.cfg.n_q, np.int32))

    def room(self, name: str) -> Room:
        with self.lock:
            if name not in self.rooms:
                self.rooms[name] = Room(name, self)
            return self.rooms[name]

    def decode_frame(self, room: Room, codes: np.ndarray) -> np.ndarray:
        """codes (n_q,) -> pcm (frame_size,), keeping the room's decode state."""
        with room.lock:
            if room.dec_state is None:
                room.dec_state = self.init_state()
            pcm, room.dec_state = self.decode(room.dec_state, codes)
        return pcm


def parse_codes(payload: bytes, n_q: int) -> Optional[np.ndarray]:
    codes = np.frombuffer(payload, "<u4")
    if len(codes) != n_q:
        return None
    return codes.astype(np.int32)


def audio_message(pcm: np.ndarray) -> bytes:
    return bytes([MsgType.AUDIO]) + np.asarray(pcm, "<f4").tobytes()


def text_message(text: str) -> bytes:
    return bytes([MsgType.TEXT]) + text.encode()
