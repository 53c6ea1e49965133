"""The port's STT and TTS clients (``dsm_tpu_torch/client``) against the JAX
package's clients, both talking to the port's own App through aiohttp's
``TestServer`` with CPU engines: the same words and timestamps from
``SttClient`` (the smoke config's ASR engine, greedy), the same pcm and words
from ``TtsClient`` (the small batched TTS engine, a fixed ``?seed=``); and
every Opus request refused, naming the wire.
"""

import asyncio
import tomllib

import msgpack
import numpy as np
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestServer

import dsm_tpu.client.stt as jstt
import dsm_tpu_torch.client.stt as tstt
from dsm_tpu.client.tts import TtsClient as JaxTtsClient
from dsm_tpu_torch.client import OpusUnavailable
from dsm_tpu_torch.client.tts import TtsClient
from dsm_tpu_torch.server import builder as tbuilder
from dsm_tpu_torch.server import config as tCFG
from dsm_tpu_torch.server import tts_batched as tTB
from dsm_tpu_torch.server import voices as tV
from dsm_tpu_torch.server.app import App
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


def test_stt_clients_give_the_same_words_and_timestamps(tmp_path, monkeypatch):
    """Each client against its own App on a fresh engine of the smoke
    config's seeded weights, sampling at 0.7 from ``?seed=42``: the first
    session of an engine, so that the slot and the batch are the same."""
    pcm = None
    out = {}
    for name, mod in (("jax", jstt), ("port", tstt)):
        engine = _asr_engine(tmp_path)
        frame = engine.frame_size
        # The clients' frame is the model's (1,920 at 24 kHz); the smoke codec's here.
        monkeypatch.setattr(mod, "FRAME", frame)
        if pcm is None:
            pcm = (np.random.default_rng(0).standard_normal(frame * 6) * 0.1).astype(np.float32)
        events = []

        async def run(url, mod=mod, events=events):
            return await mod.SttClient(url("/api/asr-streaming?seed=42")).transcribe_pcm(
                pcm, on_event=events.append)

        try:
            out[name] = (asyncio.run(_serve(App(asr_engine=engine), run)), events)
        finally:
            engine.stop()
    (jt, je), (tt, te) = out["jax"], out["port"]
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


def test_stt_client_refuses_the_opus_upload():
    with pytest.raises(OpusUnavailable, match="Opus wire"):
        tstt.SttClient("ws://127.0.0.1:1/api/asr-streaming", compress=True)


@pytest.mark.parametrize("frame", [
    b"OggS\x00\x02" + b"\x00" * 21,  # a raw Ogg page (?format=OggOpus)
    msgpack.packb({"type": "OggOpus", "data": b"OggS"}),
    msgpack.packb({"type": "Audio", "data": b"OggS"}),
], ids=["page", "oggopus-message", "audio-with-data"])
def test_tts_client_refuses_opus_audio(frame):
    async def handler(request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        await ws.receive()  # the text
        await ws.send_bytes(frame)
        await ws.close()
        return ws

    class Stub:
        web_app = web.Application()

    Stub.web_app.router.add_get("/api/tts_streaming", handler)

    async def run(url):
        await TtsClient(url("/api/tts_streaming").replace("http", "ws", 1)).synthesize("a")

    with pytest.raises(OpusUnavailable, match="Opus wire"):
        asyncio.run(_serve(Stub, run))
