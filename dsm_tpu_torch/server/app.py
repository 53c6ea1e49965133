"""HTTP/WebSocket server of the port (aiohttp; counterpart of
``dsm_tpu/server/app.py``, the routes the port serves).

  GET  /api/asr-streaming   msgpack WS, continuously batched STT
  POST /api/asr             one-shot transcription (WAV or JSON pcm)
  GET  /api/tts_streaming   words in (text frames), msgpack audio out
  POST /api/tts             offline synthesis -> WAV or JSON
  GET  /api/chat            full-duplex dialogue, byte-tag WS (Opus or pcm)
  GET  /api/lm-streaming    the same dialogue route (moshi-server's path)
  GET  /api/mimi/send/{room}  codes in, decoded once for the room
  GET  /api/mimi/recv/{room}  the room's audio and text out
  GET  /api/status          capacity and uptime JSON
  GET  /api/health          200 ok
  GET  /metrics             prometheus text (``server/metrics.py``)
  GET  /api/build_info      build metadata
  GET  /api/modules_info    configured modules
  GET  /{file}              files under ``static_dir``, ``index.html`` at ``/``

Close codes, auth and message schemas are the JAX package's.  Word events
are checked against the port's own classes (``sessions.asr`` and
``server.tts_module``) and ASR words are decoded with the engine's
tokenizer.  The TTS routes serve either engine, as the JAX routes do: a
``BatchedTtsEngine`` opens a slot, the single-session ``TtsEngine`` runs a
``TtsSession`` on a worker thread under the engine's lock.

The Opus wire (``utils/opus.py``) is the JAX App's, route by route, and so is
what each route does where libopus or libogg does not load: the ASR socket
decodes ``OggOpus`` messages (else an error message and it carries on); the
single-session TTS socket sends ``?format=OggOpus`` pages or
``OggOpusMessagePack`` messages (else an error message, then pcm msgpack),
and the batched one sends pcm msgpack whatever ``format`` says; the duplex
route speaks Opus both ways unless ``?format=pcm`` (raw f32 AUDIO frames),
and answers 501 to ``?format=opus`` without the codec; a room receiver
asking ``format=OggOpus`` gets pages of its own encoder (else raw pcm).
Opus is encoded where the pcm is handed over and decoded inline on the event
loop, as the JAX App does it.  The handlers make the JAX App's metric calls
(auth errors, close codes, connections, the opt-in stream counters).  aiohttp
and msgpack are needed here only: the rest of the port imports neither.
:meth:`App.run` serves over HTTP or TLS (:func:`make_self_signed_cert` makes a
development certificate).
"""

from __future__ import annotations

import asyncio
import base64
import os
import subprocess
import threading
import time
from typing import Optional

import numpy as np
import torch
from aiohttp import WSMsgType, web

from .. import __version__
from ..sessions.asr import EndWordEvent, WordEvent
from ..utils import opus as opus_mod
from ..utils.audio import decode_audio_bytes, wav_bytes
from . import auth as auth_mod
from . import metrics
from . import protocol as proto
from .batched_asr import BatchedAsrEngine, Events
from .duplex import DuplexSession, audio_frame, parse_frame, text_frame
from .duplex_batched import DuplexAudioEvent, DuplexDoneEvent, DuplexTextEvent
from .mimi_rooms import audio_message, parse_codes, text_message
from .tts_batched import BatchedTtsEngine, DoneEvent
from .tts_module import AudioEvent, TtsSession
from .tts_module import WordEvent as TtsWordEvent

RECV_TIMEOUT_S = 120.0
SESSION_TIMEOUT_S = 360.0
PING_INTERVAL_S = 10.0

START_TIME = time.time()


def build_info() -> dict:
    return {
        "version": __version__,
        "framework": "dsm-tpu torch port (pytorch/cuda)",
        "torch_version": torch.__version__,
        "backend": "cuda" if torch.cuda.is_available() else "cpu",
    }


def _parse_seed(value):
    """?seed= -> int or None (malformed input falls back to auto-seeding)."""
    if not value:
        return None
    try:
        return int(value)
    except ValueError:
        return None


class _EventPump:
    """Coalesce cross-thread event deliveries into one event-loop wakeup
    per burst; per-queue order is kept."""

    def __init__(self, loop):
        self.loop = loop
        self._lock = threading.Lock()
        self._buf: list = []
        self._armed = False

    def post(self, q, ev) -> None:
        with self._lock:
            self._buf.append((q, ev))
            if self._armed:
                return
            self._armed = True
        try:
            self.loop.call_soon_threadsafe(self._flush)
        except RuntimeError:  # loop closed during shutdown: receivers are gone
            with self._lock:
                self._buf.clear()
                self._armed = False

    def _flush(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, []
            self._armed = False
        for q, ev in buf:
            q.put_nowait(ev)


class App:
    def __init__(self, asr_engine: Optional[BatchedAsrEngine] = None,
                 tts_engine=None,
                 auth_ctx: Optional[auth_mod.AuthContext] = None,
                 instance_name: str = "dsm-tpu", asr_path: str = "/api/asr-streaming",
                 tts_path: str = "/api/tts", tts_streaming_path: str = "/api/tts_streaming",
                 rate_limit_per_minute: Optional[int] = None,
                 duplex_engine=None, mimi_rooms_engine=None,
                 static_dir: Optional[str] = None):
        """``tts_engine``: a ``BatchedTtsEngine`` or a single-session
        ``TtsEngine``; ``duplex_engine``: a ``BatchedDuplexEngine`` or a
        single-dialogue ``DuplexEngine``; ``mimi_rooms_engine``: a
        ``MimiRoomsEngine``; ``static_dir``: files served at ``/``."""
        self.asr_engine = asr_engine
        self.tts_engine = tts_engine
        self.duplex_engine = duplex_engine
        self.mimi_rooms_engine = mimi_rooms_engine
        self.static_dir = static_dir
        self.auth = auth_ctx or auth_mod.AuthContext(enabled=False)
        self.instance_name = instance_name
        self.rate_limit = rate_limit_per_minute  # new connections per peer
        self._buckets: dict = {}
        self._pumps: dict = {}
        self.web_app = web.Application()
        r = self.web_app.router
        if asr_engine is not None:
            r.add_get(asr_path, self.handle_asr_ws)
            r.add_post("/api/asr", self.handle_asr_post)
        if tts_engine is not None:
            r.add_post(tts_path, self.handle_tts_post)
            r.add_get(tts_streaming_path, self.handle_tts_ws)
        if duplex_engine is not None:
            # moshi-backend's /api/chat and moshi-server's /api/lm-streaming.
            r.add_get("/api/chat", self.handle_duplex_ws)
            r.add_get("/api/lm-streaming", self.handle_duplex_ws)
        if mimi_rooms_engine is not None:
            r.add_get("/api/mimi/send/{room}", self.handle_mimi_send)
            r.add_get("/api/mimi/recv/{room}", self.handle_mimi_recv)
        r.add_get("/api/status", self.handle_status)
        r.add_get("/api/health", self.handle_health)
        if static_dir:
            # The static-file fallback (main.rs:989-1009): files under
            # static_dir at '/', index.html for the root.
            r.add_get("/", self.handle_static)
            r.add_get("/{tail:(?!api/|metrics).*}", self.handle_static)
        r.add_get("/metrics", self.handle_metrics)
        r.add_get("/api/build_info", self.handle_build_info)
        r.add_get("/api/modules_info", self.handle_modules_info)

    # -- helpers --

    def _pump(self, loop) -> _EventPump:
        p = self._pumps.get(id(loop))
        if p is None or p.loop is not loop:
            p = self._pumps[id(loop)] = _EventPump(loop)
        return p

    def _check_auth(self, request) -> Optional[web.Response]:
        try:
            self.auth.check(request.headers, dict(request.query), request.cookies)
            return None
        except auth_mod.AuthError as e:
            metrics.record_auth_error(e.code)
            return web.json_response(e.to_json(), status=e.status)

    def _rate_limited(self, request) -> bool:
        """Token bucket per peer, burst = one minute's allowance."""
        if self.rate_limit is None:
            return False
        peer = request.remote or "?"
        now = time.time()
        tokens, last = self._buckets.get(peer, (float(self.rate_limit), now))
        tokens = min(float(self.rate_limit), tokens + (now - last) * self.rate_limit / 60.0)
        if tokens < 1.0:
            self._buckets[peer] = (tokens, now)
            return True
        self._buckets[peer] = (tokens - 1.0, now)
        return False

    async def _close_ws(self, request, code: proto.CloseCode, ws=None):
        """Refuse a connection with ``code`` (rate limit, capacity), counted
        in ``ws_close_total``."""
        metrics.record_ws_close(code)
        if ws is None:
            ws = web.WebSocketResponse()
            await ws.prepare(request)
        await ws.close(code=int(code), message=code.reason.encode())
        return ws

    def _decode_words(self, tokens) -> str:
        tok = getattr(self.asr_engine, "tokenizer", None)
        if tok is None:
            return " ".join(str(t) for t in tokens)
        return tok.decode(list(tokens))

    # -- plain endpoints --

    async def handle_health(self, request):
        return web.json_response({"status": "ok"})

    async def handle_status(self, request):
        used = self.asr_engine.used_slots() if self.asr_engine else 0
        cap = self.asr_engine.batch_size if self.asr_engine else 0
        body = {
            "instance_name": self.instance_name,
            "uptime_s": round(time.time() - START_TIME, 1),
            "capacity": {"total": cap, "used": used, "available": cap - used},
            "modules": self._modules(),
        }
        if self._batched_tts():
            t_cap, t_used = self.tts_engine.batch_size, self.tts_engine.used_slots()
            body["tts_capacity"] = {"total": t_cap, "used": t_used,
                                    "available": t_cap - t_used}
        return web.json_response(body)

    def _device(self):
        """The first engine's device, for the memory gauges."""
        for eng in (self.asr_engine, self.tts_engine, self.duplex_engine,
                    self.mimi_rooms_engine):
            if getattr(eng, "device", None) is not None:
                return eng.device
        return None

    async def handle_metrics(self, request):
        dev = self._device()
        if dev is not None:
            metrics.update_device_memory(dev)
        return web.Response(body=metrics.render(), content_type="text/plain", charset="utf-8")

    async def handle_build_info(self, request):
        return web.json_response(build_info())

    def _modules(self):
        mods = []
        if self.asr_engine is not None:
            mods.append({"type": "BatchedAsr", "batch_size": self.asr_engine.batch_size})
        if self.tts_engine is not None:
            mods.append({"type": "Tts"})
        if self.duplex_engine is not None:
            mods.append({"type": "Lm",
                         "batch_size": getattr(self.duplex_engine, "batch_size", 1)})
        return mods

    async def handle_modules_info(self, request):
        return web.json_response({"modules": self._modules()})

    # -- ASR --

    async def handle_asr_ws(self, request):
        err = self._check_auth(request)
        if err is not None:
            return err
        if self._rate_limited(request):
            return await self._close_ws(request, proto.CloseCode.RATE_LIMITED)
        ws = web.WebSocketResponse(heartbeat=PING_INTERVAL_S)
        await ws.prepare(request)
        metrics.ASR_CONNECT.inc()
        loop = asyncio.get_running_loop()
        out_q: asyncio.Queue = asyncio.Queue()
        pump = self._pump(loop)
        ch = self.asr_engine.open_channel(lambda ev: pump.post(out_q, ev),
                                          seed=_parse_seed(request.query.get("seed")))
        if ch is None:
            return await self._close_ws(request, proto.CloseCode.SERVER_AT_CAPACITY, ws)
        await ws.send_bytes(proto.asr_ready())
        session_deadline = time.time() + SESSION_TIMEOUT_S
        close_code = proto.CloseCode.NORMAL
        opus_dec = None  # made on the first OggOpus message

        def frames_for(ev: Events):
            frames = []
            for w in ev.words:
                if isinstance(w, WordEvent):
                    frames.append(proto.asr_word(self._decode_words(w.tokens),
                                                 w.start_time))
                elif isinstance(w, EndWordEvent):
                    frames.append(proto.asr_end_word(w.stop_time))
            if ev.prs is not None:
                frames.append(proto.asr_step(ev.step_idx, [float(p) for p in ev.prs],
                                             ch.buffered_samples()))
            frames.extend(proto.asr_marker(mid) for mid in ev.markers)
            return frames

        async def sender():
            # Pack every queued tick's events before yielding to the socket.
            while True:
                ev = await out_q.get()
                frames = []
                while True:
                    frames.extend(frames_for(ev))
                    try:
                        ev = out_q.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                for f in frames:
                    await ws.send_bytes(f)

        send_task = asyncio.create_task(sender())
        try:
            while True:
                timeout = min(RECV_TIMEOUT_S, session_deadline - time.time())
                if timeout <= 0:
                    close_code = proto.CloseCode.SESSION_TIMEOUT
                    break
                try:
                    msg = await ws.receive(timeout=timeout)
                except asyncio.TimeoutError:
                    close_code = (proto.CloseCode.SESSION_TIMEOUT
                                  if time.time() >= session_deadline
                                  else proto.CloseCode.CLIENT_TIMEOUT)
                    break
                if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING, WSMsgType.CLOSED,
                                WSMsgType.ERROR):
                    break
                if msg.type != WSMsgType.BINARY:
                    continue
                if metrics.stream_metrics_enabled():
                    metrics.stream_in("asr", len(msg.data))
                try:
                    m = proto.asr_in_msg(msg.data)
                except Exception:
                    close_code = proto.CloseCode.INVALID_MESSAGE
                    break
                if m["type"] == "Audio":
                    ch.push_pcm(np.asarray(m["pcm"], np.float32))
                elif m["type"] == "Marker":
                    self.asr_engine.add_marker(ch, int(m["id"]))
                elif m["type"] == "OggOpus":
                    # asr.rs InMsg::OggOpus: the pages' pcm into the mailbox.
                    if not opus_mod.available():
                        await ws.send_bytes(proto.asr_error(
                            "opus decode not available; send pcm"))
                        continue
                    if opus_dec is None:
                        opus_dec = opus_mod.OggOpusDecoder()
                    pcm = opus_dec.decode(bytes(m["data"]))
                    if pcm.size:
                        ch.push_pcm(pcm)
        finally:
            self.asr_engine.close_channel(ch)
            send_task.cancel()
            if close_code != proto.CloseCode.NORMAL:
                metrics.record_ws_close(close_code)
            if not ws.closed:
                await ws.close(code=int(close_code), message=close_code.reason.encode())
        return ws

    async def handle_asr_post(self, request):
        """One-shot transcription: a WAV body or JSON ``{pcm: [f32...]}``;
        trailing silence and a marker flush the decode delay."""
        err = self._check_auth(request)
        if err is not None:
            return err
        if "json" in request.headers.get("content-type", ""):
            body = await request.json()
            pcm = np.asarray(body.get("pcm", []), np.float32)
        else:
            try:
                pcm = decode_audio_bytes(await request.read(), 24_000)
            except Exception as e:
                return web.json_response({"error": f"bad audio payload: {e}"}, status=400)
        loop = asyncio.get_running_loop()
        events_q: asyncio.Queue = asyncio.Queue()
        pump = self._pump(loop)
        ch = None
        deadline = time.time() + 30.0
        while ch is None and time.time() < deadline:
            ch = self.asr_engine.open_channel(lambda ev: pump.post(events_q, ev))
            if ch is None:
                await asyncio.sleep(0.1)
        if ch is None:
            return web.json_response({"error": "server at capacity"}, status=503)
        try:
            ch.push_pcm(pcm)
            marker_id = -1
            self.asr_engine.add_marker(ch, marker_id)
            tail = (self.asr_engine.cfg.asr_delay_in_tokens + 8) * self.asr_engine.frame_size
            ch.push_pcm(np.zeros(tail, np.float32))
            words = []
            t_end = time.time() + 300.0
            done = False
            while not done and time.time() < t_end:
                ev = await asyncio.wait_for(events_q.get(), timeout=60.0)
                for w in ev.words:
                    if isinstance(w, WordEvent):
                        words.append({"text": self._decode_words(w.tokens),
                                      "start_s": w.start_time, "stop_s": None})
                    elif isinstance(w, EndWordEvent) and words:
                        words[-1]["stop_s"] = w.stop_time
                done = marker_id in ev.markers
            return web.json_response({"text": " ".join(w["text"] for w in words),
                                      "words": words})
        except asyncio.TimeoutError:
            return web.json_response({"error": "transcription timed out"}, status=504)
        finally:
            self.asr_engine.close_channel(ch)

    # -- TTS --

    def _batched_tts(self) -> bool:
        return isinstance(self.tts_engine, BatchedTtsEngine)

    async def handle_tts_post(self, request):
        err = self._check_auth(request)
        if err is not None:
            return err
        body = await request.json()
        try:
            voice_ca = self.tts_engine.voice_kv(body.get("voice"))
        except FileNotFoundError as e:
            return web.json_response({"error": str(e)}, status=404)
        kw = {"seed": int(body.get("seed", 0))}
        if self._batched_tts():
            kw["voice_ca"] = voice_ca
            if body.get("cfg_alpha") is not None and self.tts_engine.cfg_enabled:
                kw["cfg_alpha"] = float(body["cfg_alpha"])
        else:
            kw["ca_kv"] = voice_ca
        text = body.get("text", "")
        loop = asyncio.get_running_loop()
        pcm, transcript = await loop.run_in_executor(
            None, lambda: self.tts_engine.synthesize(text, **kw))
        wav = wav_bytes(pcm, 24_000)
        if "application/json" in request.headers.get("accept", ""):
            return web.json_response({
                "audio_base64": base64.b64encode(wav).decode(),
                "transcript": [{"text": w.text, "start_s": w.start_s, "stop_s": w.stop_s}
                               for w in transcript],
            })
        return web.Response(body=wav, content_type="audio/wav")

    async def handle_tts_ws(self, request):
        """A TTS session: text frames are words, the binary ``\\0`` frame
        ends the input; Text and Audio messages out."""
        err = self._check_auth(request)
        if err is not None:
            return err
        if not self._batched_tts():
            return await self._handle_tts_ws_single(request)
        ws = web.WebSocketResponse(heartbeat=PING_INTERVAL_S)
        await ws.prepare(request)
        loop = asyncio.get_running_loop()
        out_q: asyncio.Queue = asyncio.Queue()
        pump = self._pump(loop)
        try:
            voice_ca = self.tts_engine.voice_kv(request.query.get("voice"))
        except FileNotFoundError as e:
            await ws.send_bytes(proto.tts_error(str(e)))
            await ws.close(code=int(proto.CloseCode.RESOURCE_UNAVAILABLE))
            return ws

        def qf(name):
            v = request.query.get(name)
            try:
                return float(v) if v is not None else None
            except ValueError:
                return None

        slot = self.tts_engine.open_session(
            lambda ev: pump.post(out_q, ev), voice_ca=voice_ca,
            text_temperature=qf("text_temperature") or qf("temperature"),
            audio_temperature=qf("audio_temperature") or qf("temperature"),
            cfg_alpha=qf("cfg_alpha") if self.tts_engine.cfg_enabled else None,
            seed=_parse_seed(request.query.get("seed")))
        if slot is None:
            return await self._close_ws(request, proto.CloseCode.SERVER_AT_CAPACITY, ws)
        await ws.send_bytes(proto.tts_ready())
        inserted_bos = False
        done = asyncio.Event()

        async def sender():
            while True:
                ev = await out_q.get()
                if isinstance(ev, DoneEvent):
                    done.set()
                    return
                if isinstance(ev, AudioEvent):
                    await ws.send_bytes(proto.tts_audio([float(x) for x in ev.pcm]))
                elif isinstance(ev, TtsWordEvent):
                    await ws.send_bytes(proto.tts_text(ev.text, ev.start_s, ev.stop_s))

        send_task = asyncio.create_task(sender())
        try:
            while not done.is_set():
                try:
                    msg = await ws.receive(timeout=1.0)
                except asyncio.TimeoutError:
                    continue
                if msg.type == WSMsgType.TEXT:
                    words, inserted_bos = self.tts_engine.encode_words(msg.data,
                                                                       inserted_bos)
                    slot.feed_words(words)
                elif msg.type == WSMsgType.BINARY and msg.data == proto.TTS_EOS:
                    slot.end_input()
                elif msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING, WSMsgType.CLOSED,
                                  WSMsgType.ERROR):
                    break
            await asyncio.wait_for(send_task, timeout=5)
        except (asyncio.TimeoutError, asyncio.CancelledError):
            send_task.cancel()
        finally:
            self.tts_engine.close_session(slot)
            if not ws.closed:
                await ws.close()
        return ws

    async def _handle_tts_ws_single(self, request):
        """A session of the single-session engine, run on a worker thread
        under the engine's lock (one inference at a time): the JAX route's
        behaviour, with the default condition of the engine.  ``?format=``
        ``OggOpus`` sends raw Ogg pages, ``OggOpusMessagePack`` the pages in
        ``OggOpus`` messages (tts.rs Encoder), each chunk padded to whole
        packets; pcm msgpack otherwise."""
        ws = web.WebSocketResponse(heartbeat=PING_INTERVAL_S)
        await ws.prepare(request)
        await ws.send_bytes(proto.tts_ready())
        loop = asyncio.get_running_loop()
        out_q: asyncio.Queue = asyncio.Queue()
        try:
            ca_kv = self.tts_engine.voice_kv(request.query.get("voice"))
        except FileNotFoundError as e:
            await ws.send_bytes(proto.tts_error(str(e)))
            await ws.close(code=int(proto.CloseCode.RESOURCE_UNAVAILABLE))
            return ws
        session = TtsSession(self.tts_engine, ca_kv=ca_kv,
                             condition=self.tts_engine.default_condition)
        inserted_bos = False
        pump = self._pump(loop)
        fmt = request.query.get("format", "PcmMessagePack")
        opus_enc = None
        if fmt in ("OggOpus", "OggOpusMessagePack"):
            if opus_mod.available():
                opus_enc = opus_mod.OggOpusEncoder()
            else:
                await ws.send_bytes(proto.tts_error("opus not available"))

        async def send_audio(pcm):
            if opus_enc is None:
                await ws.send_bytes(proto.tts_audio([float(x) for x in pcm]))
                return
            data = opus_enc.encode(opus_mod.pad_to_packets(pcm))
            await ws.send_bytes(data if fmt == "OggOpus" else proto.tts_audio_opus(data))

        def run_session():
            try:
                with self.tts_engine.lock:
                    session.run(lambda ev: pump.post(out_q, ev), word_timeout=RECV_TIMEOUT_S)
            finally:
                pump.post(out_q, None)

        run_task = loop.run_in_executor(None, run_session)

        async def sender():
            while True:
                ev = await out_q.get()
                if ev is None:
                    return
                if isinstance(ev, AudioEvent):
                    await send_audio(ev.pcm)
                elif isinstance(ev, TtsWordEvent):
                    await ws.send_bytes(proto.tts_text(ev.text, ev.start_s, ev.stop_s))

        send_task = asyncio.create_task(sender())
        deadline = time.time() + RECV_TIMEOUT_S
        try:
            # A short receive timeout, so that a finished (or failed) session
            # thread releases the socket promptly.
            while not session.done and not run_task.done():
                if time.time() > deadline:
                    break
                try:
                    msg = await ws.receive(timeout=0.5)
                except asyncio.TimeoutError:
                    continue
                deadline = time.time() + RECV_TIMEOUT_S
                if msg.type == WSMsgType.TEXT:
                    words, inserted_bos = self.tts_engine.encode_words(msg.data, inserted_bos)
                    session.feed_words(words)
                elif msg.type == WSMsgType.BINARY:
                    if msg.data == proto.TTS_EOS:
                        session.end_input()
                elif msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING, WSMsgType.CLOSED,
                                  WSMsgType.ERROR):
                    break
        finally:
            session.end_input()
            await run_task
            await send_task
            if not ws.closed:
                await ws.close()
        return ws

    # -- duplex dialogue (byte-tag protocol) --

    async def handle_duplex_ws(self, request):
        """One dialogue: AUDIO frames in, AUDIO and TEXT frames out, after a
        HANDSHAKE frame.  The AUDIO frames carry Ogg pages where the codec
        loads (the reference clients' wire, lm.rs:77-318): the header pages
        in one frame right after the handshake, then a page an 80 ms frame;
        ``?format=pcm`` makes them raw f32 pcm.  ``?asr_delay_in_tokens=N``
        makes it a text-only session."""
        err = self._check_auth(request)
        if err is not None:
            return err
        fmt = request.query.get("format", "")
        have_opus = opus_mod.available()
        if fmt == "opus" and not have_opus:
            return web.json_response({"error": "opus codec unavailable"}, status=501)
        use_opus = fmt != "pcm" and have_opus
        asr_delay = _parse_seed(request.query.get("asr_delay_in_tokens")) or 0
        batched = hasattr(self.duplex_engine, "open_session")

        ws = web.WebSocketResponse(heartbeat=PING_INTERVAL_S)
        await ws.prepare(request)
        # Handshake payload: protocol version u32 (0) + model version u32.
        await ws.send_bytes(bytes([proto.MsgType.HANDSHAKE]) + b"\x00" * 8)
        enc = dec = None
        if use_opus:
            enc, dec = opus_mod.OggOpusEncoder(), opus_mod.OggOpusDecoder()
            await ws.send_bytes(bytes([proto.MsgType.AUDIO]) + enc.header_pages())

        loop = asyncio.get_running_loop()
        out_q: asyncio.Queue = asyncio.Queue()
        pump = self._pump(loop)

        def on_audio(pcm):
            if enc is None:
                pump.post(out_q, audio_frame(pcm))
                return
            data = enc.encode(pcm)  # one page: four 20 ms packets a frame
            if data:
                pump.post(out_q, bytes([proto.MsgType.AUDIO]) + data)

        def on_text(text):
            pump.post(out_q, text_frame(text))

        run_task = session = slot = None
        if batched:
            # The shared engine loop steps all dialogues; this handler feeds
            # the slot's mailbox and relays its events.
            def deliver(ev):
                if isinstance(ev, DuplexAudioEvent):
                    on_audio(ev.pcm)
                elif isinstance(ev, DuplexTextEvent):
                    on_text(ev.text)
                elif isinstance(ev, DuplexDoneEvent):
                    pump.post(out_q, None)

            slot = self.duplex_engine.open_session(deliver, asr_delay_in_tokens=asr_delay)
            if slot is None:
                return await self._close_ws(request, proto.CloseCode.SERVER_AT_CAPACITY, ws)
            push_pcm = slot.push_pcm
        else:
            session = DuplexSession(self.duplex_engine, asr_delay_in_tokens=asr_delay)

            def run_session():
                try:
                    session.run(on_audio, on_text)
                finally:
                    pump.post(out_q, None)

            run_task = loop.run_in_executor(None, run_session)
            push_pcm = session.push_pcm

        async def sender():
            while True:
                frame = await out_q.get()
                if frame is None:
                    return
                if metrics.stream_metrics_enabled():
                    metrics.stream_out("lm", len(frame))
                await ws.send_bytes(frame)

        send_task = asyncio.create_task(sender())
        metrics.LM_ACTIVE_CONNECTIONS.inc()
        try:
            async for msg in ws:
                if msg.type != WSMsgType.BINARY:
                    continue
                if metrics.stream_metrics_enabled():
                    metrics.stream_in("lm", len(msg.data))
                tag, payload = parse_frame(msg.data)
                if tag == proto.MsgType.AUDIO:
                    if dec is None:
                        push_pcm(np.frombuffer(payload, "<f4"))
                    else:
                        pcm = dec.decode(payload)
                        if len(pcm):
                            push_pcm(pcm)
                elif tag == proto.MsgType.PING:
                    await ws.send_bytes(bytes([proto.MsgType.PING]))
        finally:
            metrics.LM_ACTIVE_CONNECTIONS.dec()
            if batched:
                self.duplex_engine.close_session(slot)
                out_q.put_nowait(None)
            else:
                session.close()
                await run_task
            await send_task
            if not ws.closed:
                await ws.close()
        return ws

    # -- Mimi broadcast rooms --

    async def handle_mimi_send(self, request):
        """A sender: CODES frames decoded once and broadcast as AUDIO, TEXT
        frames passed through."""
        err = self._check_auth(request)
        if err is not None:
            return err
        eng = self.mimi_rooms_engine
        room = eng.room(request.match_info["room"])
        ws = web.WebSocketResponse(heartbeat=5.0)
        await ws.prepare(request)
        loop = asyncio.get_running_loop()
        async for msg in ws:
            if msg.type != WSMsgType.BINARY or not msg.data:
                continue
            tag, payload = msg.data[0], msg.data[1:]
            if tag == proto.MsgType.CODES:
                codes = parse_codes(payload, eng.cfg.n_q)
                if codes is None:
                    continue
                pcm = await loop.run_in_executor(None, eng.decode_frame, room, codes)
                room.broadcast(audio_message(pcm), loop)
            elif tag == proto.MsgType.TEXT:
                room.broadcast(text_message(payload.decode(errors="replace")), loop)
        return ws

    async def handle_mimi_recv(self, request):
        """A receiver of the room's broadcast: AUDIO and TEXT frames.  With
        ``format=OggOpus`` the AUDIO frames carry the pages of an encoder of
        the receiver's own, so that a late joiner gets its own header pages
        (mimi.rs:12-215); raw pcm without the codec."""
        err = self._check_auth(request)
        if err is not None:
            return err
        room = self.mimi_rooms_engine.room(request.match_info["room"])
        ws = web.WebSocketResponse(heartbeat=5.0)
        await ws.prepare(request)
        opus_enc = None
        if request.query.get("format") == "OggOpus" and opus_mod.available():
            opus_enc = opus_mod.OggOpusEncoder()
        q = room.subscribe()
        sender = asyncio.create_task(self._room_sender(ws, q, opus_enc))
        try:
            async for msg in ws:
                if msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                    break
        finally:
            sender.cancel()
            room.unsubscribe(q)
            if not ws.closed:
                await ws.close()
        return ws

    async def _room_sender(self, ws, q, opus_enc):
        while True:
            payload = await q.get()
            if opus_enc is None or not payload or payload[0] != proto.MsgType.AUDIO:
                await ws.send_bytes(payload)
                continue
            data = opus_enc.encode(opus_mod.pad_to_packets(np.frombuffer(payload[1:], "<f4")))
            if data:
                await ws.send_bytes(bytes([proto.MsgType.AUDIO]) + data)

    # -- static files --

    async def handle_static(self, request):
        """A file under ``static_dir``, guarded against path traversal (403);
        ``/`` and a directory map to its ``index.html``; 404 otherwise."""
        tail = request.match_info.get("tail", "") or "index.html"
        root = os.path.realpath(self.static_dir)
        path = os.path.realpath(os.path.join(root, tail))
        if not path.startswith(root + os.sep) and path != root:
            return web.Response(status=403, text="forbidden")
        if os.path.isdir(path):
            path = os.path.join(path, "index.html")
        if not os.path.isfile(path):
            return web.Response(status=404, text="not found")
        return web.FileResponse(path)

    def run(self, host: str = "0.0.0.0", port: int = 8080, ssl_cert: Optional[str] = None,
            ssl_key: Optional[str] = None) -> None:
        """Serve until interrupted, over TLS when both a certificate and a key
        (PEM paths) are given."""
        ctx = None
        if ssl_cert and ssl_key:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(ssl_cert, ssl_key)
        web.run_app(self.web_app, host=host, port=port, ssl_context=ctx)


def make_self_signed_cert(cert_path: str, key_path: str, cn: str = "localhost") -> None:
    """A self-signed TLS certificate and its key (PEM) for development
    serving, made with ``openssl`` (the reference makes one with rcgen,
    moshi-backend/src/main.rs)."""
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", key_path,
         "-out", cert_path, "-days", "365", "-subj", f"/CN={cn}",
         "-addext", f"subjectAltName=DNS:{cn},IP:127.0.0.1"],
        check=True, capture_output=True)
