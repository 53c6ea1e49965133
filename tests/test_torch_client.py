"""The port's STT and TTS clients (``dsm_tpu_torch/client``) against the JAX
package's clients, both talking to the port's own App through aiohttp's
``TestServer`` with CPU engines: the same words and timestamps from
``SttClient`` (the smoke config's ASR engine, greedy), the same pcm and words
from ``TtsClient`` (the small batched TTS engine, a fixed ``?seed=``); and the
same over the Opus wire: ``SttClient(compress=True)``'s ``OggOpus`` upload,
``TtsClient`` decoding raw ``OggS`` pages, ``OggOpus`` messages and ``Audio``
messages carrying ``data`` (the single-session TTS engine).
"""

import asyncio
import tomllib

import msgpack
import numpy as np
import pytest
import torch
from aiohttp import ClientSession, web
from aiohttp.test_utils import TestServer

import dsm_tpu.client.stt as jstt
import dsm_tpu_torch.client.stt as tstt
from dsm_tpu.client.tts import TtsClient as JaxTtsClient
from dsm_tpu_torch.client.tts import TtsClient
from dsm_tpu_torch.server import builder as tbuilder
from dsm_tpu_torch.server import config as tCFG
from dsm_tpu_torch.server import tts_batched as tTB
from dsm_tpu_torch.server import voices as tV
from dsm_tpu_torch.server.app import App
from dsm_tpu_torch.utils import opus as topus
from dsm_tpu_torch.utils import tokenizer as tTOK

torch.set_num_threads(2)


async def _serve(app, fn):
    server = TestServer(app.web_app)
    await server.start_server()
    try:
        return await fn(lambda path: str(server.make_url(path)))
    finally:
        await server.close()


def _asr_engine(tmp_path):
    from tests.test_torch_tts_serving import spm_bytes

    (tmp_path / "tok.model").write_bytes(spm_bytes())
    with open("configs/config-smoke.toml", "rb") as f:
        raw = tomllib.load(f)
    asr = raw["modules"]["asr"]
    asr.update(temperature=0.7, text_tokenizer_file=str(tmp_path / "tok.model"))
    asr["model"].update(text_in_vocab_size=17, text_out_vocab_size=16)
    engine = tbuilder.build_batched_asr(tCFG.Config.from_dict(raw).modules["asr"], "cpu")
    engine.warmup()
    engine.start()
    return engine


def _stt_clients(tmp_path, monkeypatch, compress):
    """Each client against its own App on a fresh engine of the smoke
    config's seeded weights, sampling at 0.7 from ``?seed=42``: the first
    session of an engine, so that the slot and the batch are the same."""
    pcm = None
    out = {}
    for name, mod in (("jax", jstt), ("port", tstt)):
        engine = _asr_engine(tmp_path)
        # The clients' frame is the model's (1,920 at 24 kHz); the smoke codec's
        # here, and 1,920 still over Opus, whose packets are 480 samples.
        frame = 1920 if compress else engine.frame_size
        monkeypatch.setattr(mod, "FRAME", frame)
        if pcm is None:
            pcm = (np.random.default_rng(0).standard_normal(engine.frame_size * 6) * 0.1
                   ).astype(np.float32)
        events = []

        async def run(url, mod=mod, events=events):
            return await mod.SttClient(url("/api/asr-streaming?seed=42"),
                                       compress=compress).transcribe_pcm(
                pcm, on_event=events.append)

        try:
            out[name] = (asyncio.run(_serve(App(asr_engine=engine), run)), events)
        finally:
            engine.stop()
    return out["jax"], out["port"]


def test_stt_clients_give_the_same_words_and_timestamps(tmp_path, monkeypatch):
    (jt, je), (tt, te) = _stt_clients(tmp_path, monkeypatch, compress=False)
    assert tt.words and any(w.text.strip() for w in tt.words)
    assert [(w.text, w.start_s, w.stop_s) for w in tt.words] == \
        [(w.text, w.start_s, w.stop_s) for w in jt.words]
    assert tt.text == jt.text
    kinds = [e.type for e in te]
    assert "ready" in kinds and "step" in kinds and kinds[-1] == "marker"
    assert te[-1].marker_id == tstt.SHUTDOWN_MARKER

    # Words and steps come in the same order with the same fields; how many
    # silence steps pass before the marker returns depends on the timing.
    def words(evs):
        return [(e.type, e.text, e.start_time, e.stop_time) for e in evs
                if e.type in ("word", "end_word")]

    assert words(te) == words(je)
    steps = [e.step_idx for e in te if e.type == "step"]
    assert steps == list(range(1, len(steps) + 1)) and len(steps) >= 6


@pytest.mark.skipif(not topus.available(), reason="libopus or libogg does not load")
def test_stt_clients_give_the_same_words_over_opus(tmp_path, monkeypatch):
    """``compress=True``: each 1,920-sample chunk (the last padded to whole
    packets) goes up as an ``OggOpus`` message; the same words and times."""
    (jt, je), (tt, te) = _stt_clients(tmp_path, monkeypatch, compress=True)
    assert [(w.text, w.start_s, w.stop_s) for w in tt.words] == \
        [(w.text, w.start_s, w.stop_s) for w in jt.words]
    assert tt.text == jt.text and any(w.text.strip() for w in tt.words)
    assert te[-1].type == "marker" and te[-1].marker_id == tstt.SHUTDOWN_MARKER
    words = [(e.type, e.text, e.start_time, e.stop_time) for e in te
             if e.type in ("word", "end_word")]
    assert words == [(e.type, e.text, e.start_time, e.stop_time) for e in je
                     if e.type in ("word", "end_word")]


def _tts_engine():
    """The small batched TTS engine of ``test_torch_tts_serving`` on weights
    made with numpy from a seed (no JAX init to compile)."""
    from tests.test_mimi import small_cfg as small_mimi_cfg
    from tests.test_torch_moshi import np_lm_params, np_mimi_params
    from tests.test_torch_ops import to_port
    from tests.test_torch_tts import port_mimi_cfg
    from tests.test_torch_tts_serving import port_tts_cfg, spm_bytes
    from tests.test_tts import small_tts_cfg

    jcfg, mimi_cfg = small_tts_cfg(max_steps=96), small_mimi_cfg()
    engine = tTB.BatchedTtsEngine(
        port_tts_cfg(jcfg), {"lm": to_port(np_lm_params(jcfg.lm, 0))},
        port_mimi_cfg(mimi_cfg), to_port(np_mimi_params(mimi_cfg, 1)),
        tTOK.SentencePieceModel.from_bytes(spm_bytes()), batch_size=2, ca_len=6,
        device="cpu")
    engine.voices = tV.VoiceResolver()
    return engine


def test_tts_clients_give_the_same_pcm():
    """Each client against its own App on a fresh engine of the same seeded
    weights (the first session of an engine, so that no earlier session's
    slot or batch position differs), the same ``?seed=``."""
    chunks = []

    async def synth(client_cls, url, **kw):
        u = url("/api/tts_streaming?seed=9&audio_temperature=0.8").replace("http", "ws", 1)
        return await client_cls(u).synthesize("ab cd", **kw)

    results = []
    for client_cls, kw in ((JaxTtsClient, {}), (TtsClient, {"on_audio": chunks.append})):
        engine = _tts_engine()
        engine.start()
        try:
            results.append(asyncio.run(_serve(
                App(tts_engine=engine), lambda url: synth(client_cls, url, **kw))))
        finally:
            engine.stop()
    jr, tr = results
    assert tr.pcm.dtype == np.float32 and tr.pcm.size > 0 and np.isfinite(tr.pcm).all()
    np.testing.assert_array_equal(tr.pcm, jr.pcm)
    np.testing.assert_array_equal(np.concatenate(chunks), tr.pcm)
    assert [w["text"] for w in tr.words] == ["ab", "cd"]
    assert tr.words == jr.words
    assert tr.ttfb_s is not None and tr.rtf is not None


@pytest.mark.skipif(not topus.available(), reason="libopus or libogg does not load")
@pytest.mark.parametrize("frame", ["page", "oggopus-message", "audio-with-data"])
def test_tts_clients_decode_opus_audio(frame):
    """The single-session TTS engine's App: ``?format=OggOpus`` (raw pages),
    ``OggOpusMessagePack`` (``OggOpus`` messages), and a route of the same
    App that replays the latter's messages as ``Audio`` messages carrying
    ``data`` (an older emitter's).  Both clients get the same pcm and words,
    the pcm every chunk of the server's pages decoded."""
    from tests.test_torch_opus import single_tts_engine

    app = App(tts_engine=single_tts_engine())
    recorded = []

    async def replay(request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        await ws.receive()  # the text
        for data in recorded:
            m = msgpack.unpackb(data, raw=False)
            if m["type"] == "OggOpus":
                m["type"] = "Audio"
            await ws.send_bytes(msgpack.packb(m))
        await ws.close()
        return ws

    app.web_app.router.add_get("/replay", replay)
    fmt = "OggOpus" if frame == "page" else "OggOpusMessagePack"
    chunks = []

    async def run(url):
        ws_url = url(f"/api/tts_streaming?format={fmt}").replace("http", "ws", 1)
        async with ClientSession() as session:
            async with session.ws_connect(ws_url) as ws:
                await ws.send_str("fab ked")
                await ws.send_bytes(b"\0")
                async for msg in ws:
                    recorded.append(msg.data)
        if frame == "audio-with-data":
            ws_url = url("/replay").replace("http", "ws", 1)
        return [await JaxTtsClient(ws_url).synthesize("fab ked"),
                await TtsClient(ws_url).synthesize("fab ked", on_audio=chunks.append)]

    jr, tr = asyncio.run(_serve(app, run))
    pages = [d if d[:4] == b"OggS" else msgpack.unpackb(d, raw=False).get("data")
             for d in recorded]
    dec = topus.OggOpusDecoder()
    want = np.concatenate([dec.decode(p) for p in pages if p is not None])
    assert tr.pcm.dtype == np.float32 and tr.pcm.size > 0 and np.isfinite(tr.pcm).all()
    np.testing.assert_array_equal(tr.pcm.view(np.int32), jr.pcm.view(np.int32))
    np.testing.assert_array_equal(tr.pcm.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(np.concatenate(chunks), tr.pcm)
    assert [w["text"] for w in tr.words] == ["fab", "ked"] and tr.words == jr.words
    assert tr.ttfb_s is not None and jr.ttfb_s is not None
