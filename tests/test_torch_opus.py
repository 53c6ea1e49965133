"""The port's Opus wire (``dsm_tpu_torch/utils/opus.py`` and the routes of
``server/app.py`` that speak it) against the JAX package, on the CPU at small
sizes, with inputs made with numpy from a seed.

* ``OggOpusEncoder`` gives the JAX encoder's bytes: the header pages, frames
  of 1,920 and 480 samples, a chunk padded to whole packets as the routes pad
  it, a ragged tail carried to the next call, ``eos``; ``OggOpusDecoder``
  gives the JAX decoder's samples bit for bit on the same bytes, whole and fed
  in 97-byte pieces; ``decode_audio(_bytes)`` of an ogg/opus stream without
  libvorbisfile (straight to opus) equals JAX's.
* Each route against the JAX App on stub engines (the same events into both
  Apps): the ASR socket's messages and the pcm it pushes into the channel,
  the single-session TTS socket's frames in each ``format``, the duplex
  route's frames and the pcm it pushes, the room receivers' frames: byte for
  byte, with the library and with ``available`` patched false (the 501, the
  ASR error, the TTS fall-back to pcm, the pcm receiver).
* Each route on the port's engines: the Opus bytes are the port's encoder
  applied to the pcm that the same seeded session gives on the pcm route,
  and Opus input gives the events that the pcm route gives when fed the
  decoded bytes (ASR, single-session TTS, the single and batched duplex
  engines); the batched TTS socket sends pcm msgpack whatever ``format``
  says, as the JAX route does.

Those that need libopus and libogg skip where they do not load; the cases
without the library run everywhere.
"""

import asyncio
import threading
import types

import msgpack
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import dsm_tpu.server.tts_module as jTM
from dsm_tpu.server import app as japp
from dsm_tpu.server import duplex_batched as jDB
from dsm_tpu.utils import audio as jAU
from dsm_tpu.utils import codecs as jcodecs
from dsm_tpu.utils import opus as jopus
from dsm_tpu_torch.server import app as tapp
from dsm_tpu_torch.server import duplex_batched as tDB
from dsm_tpu_torch.server import tts_module as tTM
from dsm_tpu_torch.server.protocol import MsgType
from dsm_tpu_torch.utils import audio as tAU
from dsm_tpu_torch.utils import codecs as tcodecs
from dsm_tpu_torch.utils import opus as topus

torch.set_num_threads(2)

needs_opus = pytest.mark.skipif(not (topus.available() and jopus.available()),
                                reason="libopus or libogg does not load")


def _pcm(seed, n, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.int32)


def _no_opus(monkeypatch):
    """Both packages as where libopus or libogg does not load."""
    monkeypatch.setattr(topus, "available", lambda: False)
    monkeypatch.setattr(jopus, "available", lambda: False)


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------


def _jax_pad(pcm):
    """The JAX routes' padding to whole packets, written as they write it."""
    rem = len(pcm) % jopus.PACKET_SAMPLES
    return np.pad(np.asarray(pcm, np.float32), (0, jopus.PACKET_SAMPLES - rem)) if rem else pcm


ENCODE_CASES = {
    "frames-1920": [(_pcm(1, 1920), False), (_pcm(2, 1920), False),
                    (np.zeros(1920, np.float32), False), (_pcm(3, 1920, 0.6), False)],
    "frames-480": [(_pcm(4, 480), False) for _ in range(5)],
    "padded-chunk": [(_pcm(5, 1920), False), ("pad", _pcm(6, 1000)), ("pad", _pcm(7, 48))],
    "ragged-tail": [(_pcm(8, 1000), False), (_pcm(9, 700), False), (_pcm(10, 220), False),
                    (_pcm(11, 1), False)],
    "eos": [(_pcm(12, 1920), False), (_pcm(13, 1440), True)],
}


@needs_opus
@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encoder_bytes_equal_jax(case):
    te, je = topus.OggOpusEncoder(), jopus.OggOpusEncoder()
    for a, b in ENCODE_CASES[case]:
        if isinstance(a, str):  # the routes' padding: port helper against JAX's inline pad
            tx, jx = topus.pad_to_packets(b), _jax_pad(b)
            assert len(tx) % topus.PACKET_SAMPLES == 0
            assert tx.dtype == np.float32 and np.array_equal(_bits(tx), _bits(jx))
            got, want = te.encode(tx), je.encode(jx)
        else:
            got, want = te.encode(a, eos=b), je.encode(a, eos=b)
        assert got == want
    assert te._granule == je._granule and te._packetno == je._packetno


@needs_opus
def test_header_pages_equal_jax_at_each_serial():
    for serial in (0x64736D, 7):
        h = topus.OggOpusEncoder(serial).header_pages()
        assert h == jopus.OggOpusEncoder(serial).header_pages()
        assert h.startswith(b"OggS") and b"OpusHead" in h and b"OpusTags" in h
    assert topus.SAMPLE_RATE == jopus.SAMPLE_RATE and topus.PACKET_SAMPLES == 480


def _stream():
    enc = jopus.OggOpusEncoder()
    pcm = np.concatenate([_pcm(20, 1920 * 6), np.zeros(960, np.float32)])
    return b"".join(enc.encode(pcm[i:i + 1920], eos=i + 1920 >= len(pcm))
                    for i in range(0, len(pcm), 1920)), len(pcm)


@needs_opus
@pytest.mark.parametrize("piece", [None, 97], ids=["whole", "dribbled"])
def test_decoder_samples_equal_jax(piece):
    data, n = _stream()
    td, jd = topus.OggOpusDecoder(), jopus.OggOpusDecoder()
    step = piece or len(data)
    got = [td.decode(data[i:i + step]) for i in range(0, len(data), step)]
    want = [jd.decode(data[i:i + step]) for i in range(0, len(data), step)]
    assert [len(g) for g in got] == [len(w) for w in want]
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.dtype == np.float32 and len(got) == n and np.abs(got).max() > 0
    assert np.array_equal(_bits(got), _bits(want))


@needs_opus
def test_decode_audio_of_opus_without_vorbis_equals_jax(tmp_path, monkeypatch):
    """With libvorbisfile out of the way both packages go straight to opus."""
    monkeypatch.setattr(tcodecs, "vorbis_available", lambda: False)
    monkeypatch.setattr(jcodecs, "vorbis_available", lambda: False)
    data, _ = _stream()
    p = tmp_path / "s.opus.ogg"
    p.write_bytes(data)
    for rate in (24_000, 16_000):
        got = tAU.decode_audio(str(p), rate)
        assert got.size and np.array_equal(_bits(got), _bits(jAU.decode_audio(str(p), rate)))
        got = tAU.decode_audio_bytes(data, rate)
        assert np.array_equal(_bits(got), _bits(jAU.decode_audio_bytes(data, rate)))
    monkeypatch.setattr(topus, "available", lambda: False)
    with pytest.raises(NotImplementedError, match="no ogg codec"):
        tAU.decode_audio(str(p))
    with pytest.raises(NotImplementedError, match="no ogg codec"):
        tAU.decode_audio_bytes(data)


# ---------------------------------------------------------------------------
# The routes against the JAX App, on stub engines
# ---------------------------------------------------------------------------


async def _both(apps, fn):
    """``fn(client, app)`` against the port's App, then the JAX App."""
    out = []
    for app in apps:
        async with TestClient(TestServer(app.web_app)) as client:
            out.append(await fn(client, app))
    return out


class _StubAsr:
    """Records the pcm pushed into its one channel; a marker comes straight
    back as an event, which orders it after every message before it."""

    batch_size = 1
    tokenizer = None

    def __init__(self):
        self.pushed = []

    def open_channel(self, deliver, seed=None):
        self.deliver = deliver
        return types.SimpleNamespace(push_pcm=lambda pcm: self.pushed.append(np.array(pcm)),
                                     buffered_samples=lambda: 0)

    def close_channel(self, ch):
        pass

    def add_marker(self, ch, marker_id):
        self.deliver(types.SimpleNamespace(words=[], prs=None, markers=[marker_id]))

    def used_slots(self):
        return 0


@pytest.mark.parametrize("lib", [pytest.param(True, marks=needs_opus), False],
                         ids=["opus", "no-library"])
def test_asr_route_equals_jax(lib, monkeypatch):
    if not lib:
        _no_opus(monkeypatch)
    enc = jopus.OggOpusEncoder()
    pages = [enc.encode(topus.pad_to_packets(c)) for c in (_pcm(30, 1920), _pcm(31, 1000),
                                                          np.zeros(1920, np.float32))]
    engines = (_StubAsr(), _StubAsr())

    async def session(client, app):
        ws = await client.ws_connect("/api/asr-streaming")
        msgs = [(await ws.receive()).data]
        for p in pages:
            await ws.send_bytes(msgpack.packb({"type": "OggOpus", "data": p}))
        await ws.send_bytes(msgpack.packb({"type": "Marker", "id": 3}))
        async with asyncio.timeout(30):
            while msgpack.unpackb(msgs[-1])["type"] != "Marker":
                msgs.append((await ws.receive()).data)
        await ws.close()
        return msgs

    got, want = asyncio.run(_both((tapp.App(asr_engine=engines[0]),
                                   japp.App(asr_engine=engines[1])), session))
    assert got == want
    kinds = [msgpack.unpackb(m)["type"] for m in got]
    if lib:
        assert kinds == ["Ready", "Marker"]
        pushed = np.concatenate(engines[0].pushed)
        dec = topus.OggOpusDecoder()
        assert np.array_equal(_bits(pushed), _bits(np.concatenate([dec.decode(p)
                                                                   for p in pages])))
        assert np.array_equal(_bits(pushed), _bits(np.concatenate(engines[1].pushed)))
    else:
        assert kinds == ["Ready", "Error", "Error", "Error", "Marker"]
        assert msgpack.unpackb(got[1])["message"] == "opus decode not available; send pcm"
        assert engines[0].pushed == engines[1].pushed == []


TTS_CHUNKS = (_pcm(40, 1920), _pcm(41, 1920), _pcm(42, 1000), _pcm(43, 480))


def _stub_session(mod):
    """A ``TtsSession`` stand-in of ``mod``'s events: once the input ends, a
    word and the chunks of TTS_CHUNKS (one of them ragged)."""

    class Session:
        def __init__(self, engine, ca_kv=None, condition=None):
            self.done = False
            self._ended = threading.Event()

        def feed_words(self, words):
            pass

        def end_input(self):
            self._ended.set()

        def run(self, on_event, word_timeout=None):
            self._ended.wait(30)
            on_event(mod.WordEvent("ab", 0.0, 0.08))
            for c in TTS_CHUNKS:
                on_event(mod.AudioEvent(c.copy()))
            self.done = True

    return Session


class _StubTts:
    default_condition = None

    def __init__(self):
        self.lock = threading.Lock()

    def voice_kv(self, name):
        return None

    def encode_words(self, text, inserted_bos):
        return [], True


@pytest.mark.parametrize("fmt,lib", [
    ("PcmMessagePack", True), pytest.param("OggOpus", True, marks=needs_opus),
    pytest.param("OggOpusMessagePack", True, marks=needs_opus), ("OggOpus", False),
    ("OggOpusMessagePack", False)])
def test_single_tts_route_equals_jax(fmt, lib, monkeypatch):
    if not lib:
        _no_opus(monkeypatch)
    monkeypatch.setattr(tapp, "TtsSession", _stub_session(tTM))
    monkeypatch.setattr(jTM, "TtsSession", _stub_session(jTM))

    async def session(client, app):
        ws = await client.ws_connect(f"/api/tts_streaming?format={fmt}")
        await ws.send_str("ab")
        await ws.send_bytes(b"\0")
        frames = []
        async with asyncio.timeout(30):
            while True:
                msg = await ws.receive()
                if msg.type.name in ("CLOSE", "CLOSED", "ERROR"):
                    return frames
                frames.append(msg.data)

    got, want = asyncio.run(_both((tapp.App(tts_engine=_StubTts()),
                                   japp.App(tts_engine=_StubTts())), session))
    assert got == want
    opus = lib and fmt != "PcmMessagePack"
    assert msgpack.unpackb(got[0]) == {"type": "Ready"}
    if fmt != "PcmMessagePack" and not lib:
        assert msgpack.unpackb(got[1]) == {"type": "Error", "message": "opus not available"}
        got = got[1:]
    assert msgpack.unpackb(got[1])["type"] == "Text"
    audio = got[2:]
    assert len(audio) == len(TTS_CHUNKS)
    if not opus:
        for m, c in zip(audio, TTS_CHUNKS):
            m = msgpack.unpackb(m)
            assert m["type"] == "Audio" and np.array_equal(_bits(m["pcm"]), _bits(c))
        return
    enc = topus.OggOpusEncoder()
    want_pages = [enc.encode(topus.pad_to_packets(c)) for c in TTS_CHUNKS]
    if fmt == "OggOpusMessagePack":
        audio = [msgpack.unpackb(m) for m in audio]
        assert {m["type"] for m in audio} == {"OggOpus"}
        audio = [m["data"] for m in audio]
    assert audio == want_pages and audio[0].startswith(jopus.OggOpusEncoder().header_pages())


class _StubDuplex:
    """A batched duplex engine that answers each 1,920 samples it is fed
    with a word and the frame halved, as ``mod``'s events."""

    batch_size = 1

    def __init__(self, mod):
        self.mod = mod
        self.pushed = []

    def open_session(self, deliver, asr_delay_in_tokens=0):
        buf = []

        def push_pcm(pcm):
            self.pushed.append(np.array(pcm))
            buf.append(np.asarray(pcm, np.float32))
            pcm = np.concatenate(buf)
            while len(pcm) >= 1920:
                deliver(self.mod.DuplexTextEvent(text=f" w{len(self.pushed)}"))
                deliver(self.mod.DuplexAudioEvent(pcm=pcm[:1920] * np.float32(0.5)))
                pcm = pcm[1920:]
            buf[:] = [pcm]

        return types.SimpleNamespace(push_pcm=push_pcm)

    def close_session(self, slot):
        pass

    def used_slots(self):
        return 0


@pytest.mark.parametrize("query,lib", [
    pytest.param("", True, marks=needs_opus), pytest.param("?format=opus", True, marks=needs_opus),
    ("?format=pcm", True), ("", False), ("?format=opus", False)])
def test_duplex_route_equals_jax(query, lib, monkeypatch):
    if not lib:
        _no_opus(monkeypatch)
    opus = lib and query != "?format=pcm"
    pcm = _pcm(50, 1920 * 3)
    if opus:
        enc = jopus.OggOpusEncoder()
        up = [enc.encode(pcm[:2400]), enc.encode(pcm[2400:])]
    else:
        up = [pcm[:2400].tobytes(), pcm[2400:].tobytes()]
    engines = (_StubDuplex(tDB), _StubDuplex(jDB))

    async def session(client, app):
        if query == "?format=opus" and not lib:
            r = await client.get("/api/chat" + query)
            return r.status, await r.json()
        ws = await client.ws_connect("/api/chat" + query)
        frames = [(await ws.receive()).data]
        for u in up:
            await ws.send_bytes(bytes([MsgType.AUDIO]) + u)
        async with asyncio.timeout(30):
            while len(frames) < 1 + opus + 6:  # the header pages, three words and frames
                frames.append((await ws.receive()).data)
        await ws.close()
        return frames

    got, want = asyncio.run(_both((tapp.App(duplex_engine=engines[0]),
                                   japp.App(duplex_engine=engines[1])), session))
    assert got == want
    if query == "?format=opus" and not lib:
        assert got == (501, {"error": "opus codec unavailable"})
        return
    assert got[0] == bytes([MsgType.HANDSHAKE]) + b"\x00" * 8
    pushed = np.concatenate(engines[0].pushed)
    assert np.array_equal(_bits(pushed), _bits(np.concatenate(engines[1].pushed)))
    body = got[1:]
    if opus:
        assert body[0] == bytes([MsgType.AUDIO]) + jopus.OggOpusEncoder().header_pages()
        body = body[1:]
        dec = topus.OggOpusDecoder()
        assert np.array_equal(_bits(pushed), _bits(np.concatenate([dec.decode(u) for u in up])))
        enc = topus.OggOpusEncoder()
        enc.header_pages()
    else:
        assert np.array_equal(_bits(pushed), _bits(pcm))
    # Three frames answered: a word and the halved frame each, as one page.
    assert [f[0] for f in body] == [MsgType.TEXT, MsgType.AUDIO] * 3
    for i, f in enumerate(body[1::2]):
        half = pushed[1920 * i:1920 * (i + 1)] * np.float32(0.5)
        assert f[1:] == (enc.encode(half) if opus else half.astype("<f4").tobytes())


class _StubRooms:
    """One room whose broadcast the test puts into the receivers' queues."""

    def __init__(self):
        self.receivers = []

    def room(self, name):
        return self

    def subscribe(self):
        q = asyncio.Queue()
        self.receivers.append(q)
        return q

    def unsubscribe(self, q):
        self.receivers.remove(q)

    def put(self, payload):
        for q in self.receivers:
            q.put_nowait(payload)


@pytest.mark.parametrize("lib", [pytest.param(True, marks=needs_opus), False],
                         ids=["opus", "no-library"])
def test_room_receivers_equal_jax(lib, monkeypatch):
    """A pcm receiver, an OggOpus one, and an OggOpus one that joins after
    the first frame: its own header pages come first."""
    if not lib:
        _no_opus(monkeypatch)
    frames = [bytes([MsgType.AUDIO]) + _pcm(60 + i, n).astype("<f4").tobytes()
              for i, n in enumerate((1920, 48, 1000))]
    text = bytes([MsgType.TEXT]) + b"hi"
    rooms = (_StubRooms(), _StubRooms())

    async def main(client, app):
        stub = app.mimi_rooms_engine

        async def joined(n):
            for _ in range(200):
                if len(stub.receivers) == n:
                    return
                await asyncio.sleep(0.01)
            raise AssertionError("the receiver did not subscribe")

        rx = [await client.ws_connect("/api/mimi/recv/r"),
              await client.ws_connect("/api/mimi/recv/r?format=OggOpus")]
        await joined(2)
        stub.put(frames[0])
        rx.append(await client.ws_connect("/api/mimi/recv/r?format=OggOpus"))
        await joined(3)
        for f in frames[1:] + [text]:
            stub.put(f)
        got = []
        async with asyncio.timeout(30):
            for i, w in enumerate(rx):
                got.append([(await w.receive()).data for _ in range(4 if i < 2 else 3)])
        for w in rx:
            await w.close()
        return got

    got, want = asyncio.run(_both((tapp.App(mimi_rooms_engine=rooms[0]),
                                   japp.App(mimi_rooms_engine=rooms[1])), main))
    assert got == want
    pcm_rx, early, late = got
    assert pcm_rx == frames + [text]
    if not lib:
        assert early == pcm_rx and late == pcm_rx[1:]
        return
    for rx, sent in ((early, frames), (late, frames[1:])):
        enc = topus.OggOpusEncoder()
        want_rx = [bytes([MsgType.AUDIO]) + enc.encode(
            topus.pad_to_packets(np.frombuffer(f[1:], "<f4"))) for f in sent]
        assert rx == want_rx + [text]
        assert rx[0][1:].startswith(jopus.OggOpusEncoder().header_pages())


# ---------------------------------------------------------------------------
# The routes on the port's engines: Opus against the pcm route
# ---------------------------------------------------------------------------


async def _serve(app, fn):
    async with TestClient(TestServer(app.web_app)) as client:
        return await fn(client)


@needs_opus
def test_asr_route_opus_input_gives_the_pcm_routes_events(tmp_path):
    """One fresh engine a route (the smoke config's, sampling from
    ``?seed=42``): OggOpus messages, and Audio messages of the same bytes
    decoded, then a marker and silence the same way; the messages up to the
    marker equal but for ``buffered_pcm`` (the mailbox at send time)."""
    from tests.test_torch_client import _asr_engine

    pcm = np.concatenate([_pcm(70, 1920 * 4), np.zeros(1920 * 12, np.float32)])
    enc, dec = topus.OggOpusEncoder(), topus.OggOpusDecoder()
    pages = [enc.encode(pcm[i:i + 1920]) for i in range(0, len(pcm), 1920)]
    decoded = [dec.decode(p) for p in pages]
    assert sum(map(len, decoded)) == len(pcm)
    out = []
    for msgs in ([{"type": "OggOpus", "data": p} for p in pages],
                 [{"type": "Audio", "pcm": d.tolist()} for d in decoded]):
        msgs = msgs[:4] + [{"type": "Marker", "id": 8}] + msgs[4:]
        engine = _asr_engine(tmp_path)

        async def session(client, msgs=msgs):
            ws = await client.ws_connect("/api/asr-streaming?seed=42")
            got = [msgpack.unpackb((await ws.receive()).data)]
            for m in msgs:
                await ws.send_bytes(msgpack.packb(m, use_single_float=True))
            async with asyncio.timeout(120):
                while got[-1]["type"] != "Marker":
                    got.append(msgpack.unpackb((await ws.receive()).data))
            await ws.close()
            return got

        try:
            out.append(asyncio.run(_serve(tapp.App(asr_engine=engine), session)))
        finally:
            engine.stop()
    for got in out:
        for m in got:
            m.pop("buffered_pcm", None)
    assert out[0] == out[1]
    kinds = [m["type"] for m in out[0]]
    assert kinds[0] == "Ready" and kinds[-1] == "Marker" and kinds.count("Step") >= 4
    assert "Word" in kinds


def single_tts_engine():
    """The single-session TTS engine at tests/test_torch_tts_single.py's
    shapes on weights made with numpy from a seed; every session starts from
    seed 0, so that two sessions of the same words give the same pcm."""
    from dsm_tpu_torch.server.voices import VoiceResolver
    from dsm_tpu_torch.utils import tokenizer as tTOK
    from tests.test_mimi import small_cfg as small_mimi_cfg
    from tests.test_torch_moshi import np_lm_params, np_mimi_params
    from tests.test_torch_ops import to_port
    from tests.test_torch_tts import port_mimi_cfg
    from tests.test_torch_tts_serving import port_tts_cfg, spm_bytes
    from tests.test_tts import small_tts_cfg

    jcfg = small_tts_cfg(max_steps=96, text_temperature=0.6, temperature=0.8,
                         speaker_cond_n_speakers=1, speaker_cond_duration_s=0.5)
    mcfg = small_mimi_cfg()
    engine = tTM.TtsEngine(port_tts_cfg(jcfg), {"lm": to_port(np_lm_params(jcfg.lm, 0))},
                           port_mimi_cfg(mcfg), to_port(np_mimi_params(mcfg, 1)),
                           tTOK.SentencePieceModel.from_bytes(spm_bytes()), device="cpu")
    engine.voices = VoiceResolver()
    return engine


@pytest.fixture(scope="module")
def single_tts():
    return single_tts_engine()


async def _tts_frames(client, query, text="fab ked"):
    ws = await client.ws_connect("/api/tts_streaming" + query)
    await ws.send_str(text)
    await ws.send_bytes(b"\0")
    frames = []
    async with asyncio.timeout(120):
        while True:
            msg = await ws.receive()
            if msg.type.name in ("CLOSE", "CLOSED", "ERROR"):
                return frames
            frames.append(msg.data)


@needs_opus
@pytest.mark.parametrize("fmt", ["OggOpus", "OggOpusMessagePack"])
def test_single_tts_route_opus_is_the_pcm_routes_pcm_encoded(single_tts, fmt):
    app = tapp.App(tts_engine=single_tts)

    async def both(client):
        return await _tts_frames(client, ""), await _tts_frames(client, "?format=" + fmt)

    pcm_frames, opus_frames = asyncio.run(_serve(app, both))
    enc = topus.OggOpusEncoder()
    want, chunks = [], 0
    for f in pcm_frames:
        m = msgpack.unpackb(f)
        if m["type"] != "Audio":
            want.append(f)
            continue
        chunks += 1
        page = enc.encode(topus.pad_to_packets(np.asarray(m["pcm"], np.float32)))
        want.append(page if fmt == "OggOpus" else msgpack.packb({"type": "OggOpus",
                                                                  "data": page}))
    assert chunks >= 4 and opus_frames == want
    msgs = [msgpack.unpackb(f) for f in pcm_frames]
    assert [m["text"] for m in msgs if m["type"] == "Text"] == ["fab", "ked"]


@needs_opus
def test_batched_tts_route_stays_pcm_msgpack():
    """``?format=OggOpus`` on the batched engine: the pcm route's messages,
    on a fresh engine a route (the JAX batched route has no Opus)."""
    from tests.test_torch_client import _tts_engine

    out = []
    for fmt in ("", "&format=OggOpus"):
        engine = _tts_engine()
        engine.start()
        try:
            out.append(asyncio.run(_serve(tapp.App(tts_engine=engine), lambda c, fmt=fmt:
                                          _tts_frames(c, "?seed=9&audio_temperature=0.8" + fmt,
                                                      "ab cd"))))
        finally:
            engine.stop()
    assert out[0] == out[1]
    kinds = [msgpack.unpackb(f)["type"] for f in out[0]]
    assert kinds[0] == "Ready" and "Audio" in kinds and "Text" in kinds


def _batched_duplex():
    from tests.test_mimi import small_cfg as small_mimi_cfg
    from tests.test_torch_duplex import port_duplex_cfg, small_duplex_cfg
    from tests.test_torch_moshi import np_lm_params, np_mimi_params
    from tests.test_torch_ops import to_port
    from tests.test_torch_tts import port_mimi_cfg
    from dsm_tpu_torch.utils.tokenizer import FallbackTokenizer

    jcfg = small_duplex_cfg(n=4, audio_vocab=33, max_steps=64, audio_temperature=0.0,
                            text_temperature=0.0)
    mcfg = small_mimi_cfg()
    engine = tDB.BatchedDuplexEngine(
        port_duplex_cfg(jcfg), {"lm": to_port(np_lm_params(jcfg.lm, 0))}, port_mimi_cfg(mcfg),
        to_port(np_mimi_params(mcfg, 1)), FallbackTokenizer(), batch_size=1, device="cpu")
    engine.warmup()
    engine.start()
    return engine


@needs_opus
@pytest.mark.parametrize("kind", ["single", "batched"])
def test_duplex_route_opus_is_the_pcm_route_encoded(kind):
    """40 frames of the small codec (1,920 samples, whole packets) in: as
    Ogg pages, and as the pages' decoded pcm on ``?format=pcm``.  The Opus
    route's frames are the pcm route's with each audio frame through the
    port's encoder (a page every ten 48-sample frames) and the header first,
    up to the 30th frame out (the model answers two frames behind); the
    dialogue on a fresh engine a route (single: each session starts
    fresh)."""
    from tests.test_torch_tui_client import _duplex_engine

    pcm = _pcm(80, 1920)
    enc, dec = topus.OggOpusEncoder(), topus.OggOpusDecoder()
    pages = [enc.encode(pcm[:960]), enc.encode(pcm[960:])]
    decoded = np.concatenate([dec.decode(p) for p in pages])
    single = _duplex_engine()[0] if kind == "single" else None
    frame = 48
    out = []
    for query, up, n_audio in (("?format=pcm", [decoded.astype("<f4").tobytes()], 30),
                               ("", pages, 4)):
        engine = single or _batched_duplex()

        async def session(client, query=query, up=up, n_audio=n_audio):
            ws = await client.ws_connect("/api/chat" + query)
            frames = [(await ws.receive()).data]
            for u in up:
                await ws.send_bytes(bytes([MsgType.AUDIO]) + u)
            async with asyncio.timeout(120):
                while sum(f[0] == MsgType.AUDIO for f in frames) < n_audio:
                    frames.append((await ws.receive()).data)
            await ws.close()
            return frames

        try:
            out.append(asyncio.run(_serve(tapp.App(duplex_engine=engine), session)))
        finally:
            if single is None:
                engine.stop()
    pcm_frames, opus_frames = out
    enc = topus.OggOpusEncoder()
    header = enc.header_pages()
    assert header == jopus.OggOpusEncoder().header_pages()
    want = [pcm_frames[0], bytes([MsgType.AUDIO]) + header]
    for f in pcm_frames[1:]:
        if f[0] != MsgType.AUDIO:
            want.append(f)
            continue
        pcm_out = np.frombuffer(f[1:], "<f4")
        assert len(pcm_out) == frame and np.isfinite(pcm_out).all()
        data = enc.encode(pcm_out)
        if data:
            want.append(bytes([MsgType.AUDIO]) + data)
    assert opus_frames[0] == bytes([MsgType.HANDSHAKE]) + b"\x00" * 8
    assert opus_frames == want
