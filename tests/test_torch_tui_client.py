"""The port's terminal duplex client (``dsm_tpu_torch/client/tui.py``)
against the JAX package's: the pure render state bit for bit, and both
clients over ``/api/chat`` of the port's App (a small greedy single-dialogue
duplex engine on the CPU), on raw pcm and on the Opus wire: the same frames
and text; and the wire each client picks, with and without the codec.

The clients stop reading once their upload has ended and they have heard
the model, so how many frames each receives depends on the timing; the
frames both received, in order, are equal bit for bit, and the text of the
one is a prefix of the other's.
"""

import asyncio

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestServer

from dsm_tpu.client import tui as jtui
from dsm_tpu.utils import opus as jopus
from dsm_tpu_torch.client import tui as ttui
from dsm_tpu_torch.server import duplex as tDX
from dsm_tpu_torch.server.app import App
from dsm_tpu_torch.utils import opus as topus
from dsm_tpu_torch.utils.tokenizer import FallbackTokenizer

torch.set_num_threads(2)


def test_pcm_frames_and_level_match_jax():
    pcm = np.random.default_rng(0).standard_normal(ttui.FRAME_SIZE * 2 + 100).astype(np.float32)
    for a, b in zip(ttui.pcm_frames(pcm, 5), jtui.pcm_frames(pcm, 5)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert all(not f.any() for f in ttui.pcm_frames(None, 2))
    for x in (np.zeros(10, np.float32), pcm, np.ones(4, np.float32)):
        assert ttui.level_db(x) == jtui.level_db(x)


def test_render_lines_match_jax():
    states = (ttui.TuiState(), jtui.TuiState())
    for st in states:
        st.on_text("hello world " * 30)
        st.on_audio(np.full(ttui.FRAME_SIZE, 0.25, np.float32))
        st.on_sent(np.full(ttui.FRAME_SIZE, 0.5, np.float32))
        st.frames_sent = 7
    for width, height in ((40, 12), (80, 24), (20, 6)):
        assert states[0].render_lines(width, height) == states[1].render_lines(width, height)
    assert states[0].meter(-30.0) == "#" * 10 + "-" * 10
    assert states[0].rx_seconds == ttui.FRAME_SIZE / 24_000


def test_tui_client_picks_the_wire_as_jax(monkeypatch):
    """Opus where the codec loads, pcm where it does not; a named wire kept."""
    url = "ws://127.0.0.1:1/api/chat"

    def picks():
        return [(ttui.DuplexTuiClient(url, fmt=f).fmt, jtui.DuplexTuiClient(url, fmt=f).fmt)
                for f in (None, "pcm", "opus")]

    lib = "opus" if topus.available() else "pcm"
    assert picks() == [(lib, lib), ("pcm", "pcm"), ("opus", "opus")]
    monkeypatch.setattr(topus, "available", lambda: False)
    monkeypatch.setattr(jopus, "available", lambda: False)
    assert picks() == [("pcm", "pcm"), ("pcm", "pcm"), ("opus", "opus")]


def _duplex_engine():
    """The single-dialogue duplex engine at ``test_torch_duplex_serving``'s
    small shapes, greedy, on weights made with numpy from a seed.  Each
    dialogue steps from a fresh state exactly on its own frames; the batched
    engine's shared ring position would follow the server's timing."""
    from tests.test_mimi import small_cfg as small_mimi_cfg
    from tests.test_torch_duplex import port_duplex_cfg, small_duplex_cfg
    from tests.test_torch_moshi import np_lm_params, np_mimi_params
    from tests.test_torch_ops import to_port
    from tests.test_torch_tts import port_mimi_cfg

    jcfg = small_duplex_cfg(n=4, audio_vocab=33, max_steps=64, audio_temperature=0.0,
                            text_temperature=0.0)
    mimi_cfg = small_mimi_cfg()
    engine = tDX.DuplexEngine(
        port_duplex_cfg(jcfg), {"lm": to_port(np_lm_params(jcfg.lm, 0))},
        port_mimi_cfg(mimi_cfg), to_port(np_mimi_params(mimi_cfg, 1)), FallbackTokenizer(),
        device="cpu")
    engine.warmup()
    return engine, mimi_cfg.frame_size


def test_tui_clients_give_the_same_frames_and_text(tmp_path, monkeypatch):
    """Both clients stream the same 8 frames of a wav (the small codec's
    frame in place of 1,920 samples) to one App, one after the other."""
    _same_frames_and_text(tmp_path, monkeypatch, "pcm")


@pytest.mark.skipif(not topus.available(), reason="libopus or libogg does not load")
def test_tui_clients_give_the_same_frames_and_text_over_opus(tmp_path, monkeypatch):
    """The same over the Opus wire (each client's default where the codec
    loads): 8 frames of 480 samples up, a page each; the server's pages
    decoded, a chunk a page of ten 48-sample frames."""
    _same_frames_and_text(tmp_path, monkeypatch, None, frame_in=480)


def _same_frames_and_text(tmp_path, monkeypatch, fmt, frame_in=None):
    from dsm_tpu_torch.utils.audio import write_wav

    engine, frame = _duplex_engine()
    frame = frame_in or frame
    app = App(duplex_engine=engine)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), (np.random.default_rng(3).standard_normal(frame * 8) * 0.1)
              .astype(np.float32), 24_000)
    got = {}

    async def both(url):
        for name, mod in (("jax", jtui), ("port", ttui)):
            monkeypatch.setattr(mod, "FRAME_SIZE", frame)
            frames, texts, updates = [], [], []
            client = mod.DuplexTuiClient(url("/api/chat").replace("http", "ws", 1),
                                         wav_path=str(wav), seconds=8 * 0.080, drain_s=60,
                                         fmt=fmt)
            assert client.fmt == (fmt or "opus")
            on_audio, on_text = client.state.on_audio, client.state.on_text
            client.state.on_audio = lambda pcm, f=on_audio, frames=frames: (
                frames.append(np.array(pcm)), f(pcm))
            client.state.on_text = lambda text, f=on_text, texts=texts: (texts.append(text),
                                                                          f(text))
            st = await client.run(on_update=updates.append)
            assert st.frames_sent == 8 and st.status == "done" and updates
            assert st.frames_recv == len(frames) >= 1
            got[name] = (frames, "".join(texts))

    asyncio.run(_serve(app, both))
    (jf, jt), (tf, tt) = got["jax"], got["port"]
    n = min(len(jf), len(tf))
    for a, b in zip(tf[:n], jf[:n]):
        assert a.dtype == b.dtype == np.float32 and np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)
    assert tt.startswith(jt) or jt.startswith(tt)


async def _serve(app, fn):
    server = TestServer(app.web_app)
    await server.start_server()
    try:
        return await fn(lambda path: str(server.make_url(path)))
    finally:
        await server.close()
