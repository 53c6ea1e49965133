"""The port's full-duplex serving layer against the JAX package's, on the
CPU at small sizes: the ``Lm`` module config, ``build_duplex``, the
continuously batched engine against the JAX engine on bridged weights
(f32, no quantisation: text and audio frames' tokens equal, so the events
are the same and the pcm agrees within 1e-4, the codec's f32 summation
order), the single-dialogue engine, and the duplex WebSocket route of the
port's own App.
"""

import asyncio
import time
import tomllib

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from dsm_tpu.models import lm as jLM
from dsm_tpu.models import mimi as jMIMI
from dsm_tpu.server import config as jCFG
from dsm_tpu.server.duplex_batched import BatchedDuplexEngine as JaxEngine
from dsm_tpu.utils.tokenizer import FallbackTokenizer as JaxFallback
from dsm_tpu_torch.models import lm as tLM
from dsm_tpu_torch.server import builder as tbuilder
from dsm_tpu_torch.server import config as tCFG
from dsm_tpu_torch.server import duplex as tDX
from dsm_tpu_torch.server import duplex_batched as tDB
from dsm_tpu_torch.server.app import App
from dsm_tpu_torch.server.protocol import CloseCode, MsgType
from dsm_tpu_torch.utils import opus as topus
from dsm_tpu_torch.utils.tokenizer import FallbackTokenizer
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_duplex import port_duplex_cfg, small_duplex_cfg
from tests.test_torch_ops import to_port
from tests.test_torch_tts import port_lm_cfg, port_mimi_cfg

torch.set_num_threads(2)

TOML = "configs/config-duplex-tpu-serving.toml"


# ---------------------------------------------------------------------------
# Config and builder
# ---------------------------------------------------------------------------


def test_serving_toml_lm_config_matches_jax_and_the_preset():
    t = tCFG.Config.load(TOML).modules["duplex"]
    j = jCFG.Config.load(TOML).modules["duplex"]
    assert t.type == "Lm" and t.path == "/api/chat" and t.batch_size == 24
    assert t.lm == port_lm_cfg(j.lm) == tLM.s2s_2b_16rvq_202501()
    assert t.generation == {"generated_audio_codebooks": 16, "input_audio_codebooks": 16,
                            "acoustic_delay": 2}
    assert (t.raw["kv_quant"], t.raw["kv_bits"], t.raw["pipeline_depth"]) == (True, 8, 2)


def _small_duplex_module(**over):
    """The serving TOML at two layers and narrow widths (same keys)."""
    with open(TOML, "rb") as f:
        raw = tomllib.load(f)
    mod = raw["modules"]["duplex"]
    mod.update(batch_size=3, pipeline_depth=1, kv_quant=False)
    mod.update(over)
    mod["model"].update(audio_codebooks=8, text_in_vocab_size=301, text_out_vocab_size=300)
    mod["model"]["transformer"].update(d_model=128, num_heads=4, num_layers=2,
                                       dim_feedforward=512, context=40)
    mod["model"]["depformer"].update(num_slices=4)
    mod["model"]["depformer"]["transformer"].update(d_model=32, num_heads=2, num_layers=2,
                                                    dim_feedforward=64, context=4)
    mod["generation"].update(generated_audio_codebooks=4, input_audio_codebooks=4)
    return tCFG.Config.from_dict(raw).modules["duplex"]


@pytest.mark.parametrize("key,value,match", [
    ("pipeline_depth", 2, "pipeline_depth"), ("kv_bits", 4, None),
    ("mesh", {"dp": 2}, None), ("mesh", "cuda", "devices, have"),
    ("w8a8_sites", ["mlp"], "w8a8_sites")])
def test_build_duplex_refuses_unported_options(key, value, match):
    """``match``: what the refusal of an unported option says.  The options
    that were refused once and are served now (``kv_bits = 4``,
    ``pipeline_depth = 2``, ``mesh``) reach the engine: ``mesh`` dp = 2 on
    the CPU, and on CUDA a mesh of more shards than cards raises."""
    if key == "mesh":
        if value == "cuda":
            n = torch.cuda.device_count()
            mod = _small_duplex_module(batch_size=n + 2, mesh={"dp": n + 2})
            with pytest.raises(ValueError, match=match):
                tbuilder.build_mesh_from_config(mod, "cuda")
            return
        eng = tbuilder.build_duplex(_small_duplex_module(batch_size=4, mesh=value), "cpu")
        assert eng.mesh.shape == {"dp": 2, "tp": 1} and eng.state is None
        assert [sh.batch_size for sh, in eng.shards] == [2, 2]
        assert [sh._row0 for sh, in eng.shards] == [0, 2]
        return
    if key in ("kv_bits", "pipeline_depth"):
        eng = tbuilder.build_duplex(_small_duplex_module(kv_quant=True, **{key: value}), "cpu")
        if key == "kv_bits":
            assert eng.kv_bits == 4
            assert eng.state["lm"]["t"]["layers"][0]["k"].dtype == torch.uint8
        else:
            assert eng.pipeline_depth == 2 and eng.kv_bits == 8 and not eng.cuda_graph
        return
    with pytest.raises(NotImplementedError, match=match):
        tbuilder.build_duplex(_small_duplex_module(**{key: value}), "cpu")


def test_build_duplex_refuses_the_serving_toml_as_it_stands():
    """The serving TOML's options as shipped all pass ``build_duplex`` and
    reach the engine (its model narrowed: s2s-2b in f32 is too large for a
    CPU test): 24 slots, dispatch-ahead at depth 2, int8 KV rings, int8
    weights with W8A8; on the CPU no graph.  Then one dialogue runs through
    the depth-2 pipeline to its Done."""
    with open(TOML, "rb") as f:
        shipped = tomllib.load(f)["modules"]["duplex"]
    mod = _small_duplex_module(**{k: shipped[k] for k in (
        "batch_size", "pipeline_depth", "kv_quant", "kv_bits")})
    assert {k: mod.raw[k] for k in shipped if not isinstance(shipped[k], dict)} == {
        k: v for k, v in shipped.items() if not isinstance(v, dict)}
    eng = tbuilder.build_duplex(mod, "cpu")
    assert isinstance(eng, tDB.BatchedDuplexEngine)
    assert (eng.batch_size, eng.pipeline_depth, eng.kv_quant, eng.kv_bits) == (24, 2, True, 8)
    assert eng.state["lm"]["t"]["layers"][0]["k"].dtype == torch.int8
    lp = eng.params["lm"]["transformer"][0]["in_proj_w"]
    assert isinstance(lp, dict) and lp["q"].dtype == torch.int8 and "w8a8" not in lp
    assert eng.cuda_graph is False and eng._graph is None
    eng.warmup(1)
    events = []
    drv = eng.open_session(events.append)
    drv.push_pcm(np.random.default_rng(1).standard_normal(1920 * 4).astype(np.float32) * 0.1)
    drv.end_input()
    for _ in range(8):
        eng.tick()
    kinds = [type(e).__name__ for e in events]
    assert drv.steps == 4 and kinds.count("DuplexAudioEvent") == 2
    assert kinds[-1] == "DuplexDoneEvent" and not eng._inflight


@pytest.mark.parametrize("kv_quant", [False, True])
def test_build_duplex_builds_both_profiles_on_the_cpu(kv_quant):
    eng = tbuilder.build_duplex(_small_duplex_module(kv_quant=kv_quant), "cpu")
    assert isinstance(eng, tDB.BatchedDuplexEngine) and eng.batch_size == 3
    assert eng.kv_quant == kv_quant and eng.mimi_cfg.n_q == 4
    assert eng.cfg.text_start_token == 300 and eng.cfg.acoustic_delay == 2
    lp = eng.params["lm"]["transformer"][0]
    ring = eng.state["lm"]["t"]["layers"][0]["k"]
    assert isinstance(lp["in_proj_w"], dict) == kv_quant  # int8 weights run as W8A8
    assert ring.dtype == (torch.int8 if kv_quant else torch.float32)
    assert ring.shape == (3, 4, 128 if kv_quant else 64, 32)
    eng.warmup(1)
    events = []
    drv = eng.open_session(events.append)
    rng = np.random.default_rng(0)
    drv.push_pcm(rng.standard_normal(1920 * 5).astype(np.float32) * 0.1)
    drv.end_input()
    while eng.tick():
        pass
    eng.tick()
    audio = [e for e in events if isinstance(e, tDB.DuplexAudioEvent)]
    assert drv.steps == 5 and isinstance(events[-1], tDB.DuplexDoneEvent)
    assert len(audio) == 3 and all(a.pcm.shape == (1920,) and np.isfinite(a.pcm).all()
                                   for a in audio)


@pytest.mark.parametrize("kv_quant", [None, True, False])
def test_build_duplex_kv_quant_follows_the_device_unless_set(kv_quant):
    """Without ``kv_quant`` the rings and weights follow the device, as in
    the JAX builder and engine: on the CPU bf16/f32 rings and dense weights
    (on CUDA int8: tests/test_torch_cuda.py).  An explicit value wins, and
    ``kv_bits = 4`` takes effect with it."""
    mod = _small_duplex_module()
    if kv_quant is None:
        del mod.raw["kv_quant"]
    else:
        mod.raw["kv_quant"] = kv_quant
    eng = tbuilder.build_duplex(mod, "cpu")
    want = bool(kv_quant)
    ring = eng.state["lm"]["t"]["layers"][0]["k"]
    assert eng.kv_quant is want and ring.dtype == (torch.int8 if want else torch.float32)
    assert isinstance(eng.params["lm"]["transformer"][0]["in_proj_w"], dict) == want
    mod.raw["kv_bits"] = 4
    packed = tbuilder.build_duplex(mod, "cpu").state["lm"]["t"]["layers"][0]["k"]
    assert packed.dtype == (torch.uint8 if want else torch.float32)
    single = tbuilder.build_duplex(_small_duplex_module(batch_size=1), "cpu")
    args = (single.cfg, single.params, single.mimi_cfg, single.mimi_params,
            FallbackTokenizer())
    for cls in (tDB.BatchedDuplexEngine, tDX.DuplexEngine):
        assert not cls(*args, device="cpu").kv_quant  # the engines' default too


def test_build_duplex_single_dialogue_engine():
    eng = tbuilder.build_duplex(_small_duplex_module(batch_size=1), "cpu")
    assert isinstance(eng, tDX.DuplexEngine) and not eng.kv_quant


@pytest.mark.parametrize("cls", [tDB.BatchedDuplexEngine, tDX.DuplexEngine])
def test_engines_take_no_default_device(cls):
    """The device is the caller's choice: neither engine falls to the CPU
    by default, and the weights run as they are handed over."""
    eng = tbuilder.build_duplex(_small_duplex_module(batch_size=1), "cpu")
    args = (eng.cfg, eng.params, eng.mimi_cfg, eng.mimi_params, FallbackTokenizer())
    with pytest.raises(TypeError, match="device"):
        cls(*args)
    made = cls(*args, kv_quant=True, device="cpu")
    assert made.device.type == "cpu" and made.params is eng.params


# ---------------------------------------------------------------------------
# BatchedDuplexEngine against the JAX engine
# ---------------------------------------------------------------------------


def _engines(batch=3, **cfg_over):
    jcfg = small_duplex_cfg(n=4, audio_vocab=33, max_steps=64, **cfg_over)
    mimi_cfg = small_mimi_cfg()  # n_q = 4, 48 samples a frame
    key = jax.random.PRNGKey(0)
    params = {"lm": jLM.init(jcfg.lm, key),
              "mimi": jMIMI.init(mimi_cfg, jax.random.fold_in(key, 1))}
    ej = JaxEngine(jcfg, params, mimi_cfg, params["mimi"], JaxFallback(), batch_size=batch)
    et = tDB.BatchedDuplexEngine(port_duplex_cfg(jcfg), {"lm": to_port(params["lm"])},
                                 port_mimi_cfg(mimi_cfg), to_port(params["mimi"]),
                                 FallbackTokenizer(), batch_size=batch, device="cpu")
    return ej, et, mimi_cfg.frame_size


def _pcm(seed, frames, frame):
    return np.random.default_rng(seed).standard_normal(frame * frames).astype(np.float32) * 0.1


def _scenario(eng, frame):
    """Staggered joins, a text-only (ASR-delay) slot, a closed dialogue
    whose slot a new one reuses.  Returns each dialogue's events and
    slot mailboxes."""
    events = [[] for _ in range(4)]
    eng.warmup()
    a = eng.open_session(events[0].append)
    a.push_pcm(_pcm(1, 9, frame))
    a.end_input()
    for _ in range(3):
        eng.tick()
    b = eng.open_session(events[1].append, asr_delay_in_tokens=4)
    b.push_pcm(_pcm(2, 12, frame)[:frame * 12 - 7])  # a ragged tail stays queued
    c = eng.open_session(events[2].append)
    c.push_pcm(_pcm(3, 5, frame))
    assert eng.open_session(lambda e: None) is None  # at capacity
    for _ in range(8):
        eng.tick()
    assert a.finished
    eng.close_session(a)
    d = eng.open_session(events[3].append)
    assert d.slot == a.slot
    d.push_pcm(_pcm(4, 6, frame))
    c.push_pcm(_pcm(5, 4, frame))
    for drv in (b, c, d):
        drv.end_input()
    for _ in range(12):
        eng.tick()
    return events, (a, b, c, d)


def _summary(events):
    kinds, texts, frames = [], [], []
    for e in events:
        name = type(e).__name__
        kinds.append(name)
        if name == "DuplexTextEvent":
            texts.append(e.text)
        elif name == "DuplexAudioEvent":
            frames.append(np.asarray(e.pcm, np.float32))
    return kinds, texts, frames


@pytest.mark.parametrize("variant", ["sampled", "greedy"])
def test_engine_matches_jax_engine(variant):
    over = {} if variant == "sampled" else dict(audio_temperature=0.0, text_temperature=0.0,
                                                repetition_penalty=(8, 1.5))
    ej, et, frame = _engines(**over)
    ev_j, drv_j = _scenario(ej, frame)
    ev_t, drv_t = _scenario(et, frame)
    assert [d.steps for d in drv_t] == [d.steps for d in drv_j] == [9, 11, 9, 6]
    n_audio = []
    for sj, st in zip(ev_j, ev_t):
        kj, tj, fj = _summary(sj)
        kt, tt, ft = _summary(st)
        assert kt == kj and kt[-1] == "DuplexDoneEvent"
        assert tt == tj
        for x, y in zip(ft, fj):
            assert x.shape == (frame,)
            np.testing.assert_allclose(x, y, atol=1e-4, rtol=0)
        n_audio.append(len(ft))
    # Audio starts after the acoustic delay; the ASR-delay slot is text only.
    assert n_audio == [9 - 2, 0, 9 - 2, 6 - 2]
    np.testing.assert_array_equal(et.state["audio_tokens"].numpy(),
                                  np.asarray(ej.state["audio_tokens"]))
    np.testing.assert_array_equal(et.state["text_tokens"].numpy(),
                                  np.asarray(ej.state["text_tokens"]))
    assert et.used_slots() == 3 and et.step_count > 0


def test_engine_text_events_decode_words():
    """With a vocabulary this small most sampled tokens are words: the
    engine accumulates them and flushes at pad/eop and at the end."""
    _ej, et, frame = _engines()
    events = []
    drv = et.open_session(events.append)
    drv.push_pcm(_pcm(7, 20, frame))
    drv.end_input()
    while et.tick():
        pass
    et.tick()
    kinds, texts, _ = _summary(events)
    assert kinds[-1] == "DuplexDoneEvent" and kinds.count("DuplexDoneEvent") == 1
    assert texts and all(isinstance(t, str) for t in texts)
    assert drv.steps == 20 and not drv.text_acc


def test_engine_observer_and_loop_thread():
    _ej, et, frame = _engines()
    seen = []
    et.tick_observer = lambda dt, n, phases: seen.append((dt, n, phases))
    done = []
    # The session and its frames are in place before the loop runs: a tick
    # between open_session and push_pcm would step the reset alone.
    drv = et.open_session(done.append)
    drv.push_pcm(_pcm(8, 4, frame))
    et.start()
    try:
        drv.end_input()
        for _ in range(600):
            if any(isinstance(e, tDB.DuplexDoneEvent) for e in done):
                break
            time.sleep(0.05)
    finally:
        et.stop()
    assert isinstance(done[-1], tDB.DuplexDoneEvent) and drv.steps == 4
    assert len(seen) == 4 and all(n == 1 and len(p) == 4 and dt > 0 for dt, n, p in seen)


def test_take_frame_reassembles_chunks():
    slot = tDB.DuplexSlot(0, lambda e: None)
    data = np.arange(25, dtype=np.float32)
    for chunk in (data[:3], data[3:11], data[11:25]):
        slot.push_pcm(chunk)
    np.testing.assert_array_equal(slot.take_frame(10), data[:10])
    np.testing.assert_array_equal(slot.take_frame(10), data[10:20])
    assert slot.take_frame(10) is None and slot.pcm_samples == 5


# ---------------------------------------------------------------------------
# Single dialogue, frames, and the App's duplex route
# ---------------------------------------------------------------------------


def test_frames_roundtrip():
    pcm = np.array([0.5, -0.25], np.float32)
    tag, payload = tDX.parse_frame(tDX.audio_frame(pcm))
    assert tag == MsgType.AUDIO and np.array_equal(np.frombuffer(payload, "<f4"), pcm)
    assert tDX.parse_frame(tDX.text_frame("héllo")) == (MsgType.TEXT, "héllo".encode())
    with pytest.raises(ValueError):
        tDX.parse_frame(b"")


def test_single_session_matches_batched_slot():
    """The batch-1 DuplexSession runs the same step: greedy, its tokens are
    those of a lone slot of the batched engine."""
    over = dict(audio_temperature=0.0, text_temperature=0.0)
    _ej, et, frame = _engines(**over)
    single = tDX.DuplexEngine(et.cfg, et.params, et.mimi_cfg, et.mimi_params,
                              FallbackTokenizer(), device="cpu")
    single.warmup()
    pcm = _pcm(9, 7, frame)
    ev = []
    drv = et.open_session(ev.append)
    drv.push_pcm(pcm)
    drv.end_input()
    while et.tick():
        pass
    want = [e.pcm for e in ev if isinstance(e, tDB.DuplexAudioEvent)]
    sess = tDX.DuplexSession(single)
    audio, text = [], []
    sess.push_pcm(pcm[:100])
    sess.push_pcm(pcm[100:])
    sess.close()
    sess.run(audio.append, text.append)
    assert sess.steps == 7 and len(audio) == len(want) == 5
    for x, y in zip(audio, want):
        np.testing.assert_allclose(x, y, atol=1e-4, rtol=0)
    quiet = tDX.DuplexSession(single, asr_delay_in_tokens=3)
    quiet.push_pcm(pcm)
    quiet.close()
    audio2 = []
    quiet.run(audio2.append, text.append)
    assert quiet.steps == 7 and not audio2


async def _chat(client, query, pcm, frame, want_audio):
    ws = await client.ws_connect("/api/chat" + query)
    hello = await ws.receive()
    assert hello.data[0] == MsgType.HANDSHAKE and len(hello.data) == 9
    await ws.send_bytes(bytes([MsgType.PING]))
    await ws.send_bytes(bytes([MsgType.AUDIO]) + pcm.astype("<f4").tobytes())
    audio = text = pings = 0
    async with asyncio.timeout(120):
        while audio < want_audio or (want_audio == 0 and pings == 0):
            msg = await ws.receive()
            if msg.type.name in ("CLOSE", "CLOSED", "ERROR"):
                break
            tag = msg.data[0]
            if tag == MsgType.AUDIO:
                out = np.frombuffer(msg.data[1:], "<f4")
                assert len(out) == frame and np.isfinite(out).all()
                audio += 1
            elif tag == MsgType.TEXT:
                msg.data[1:].decode()
                text += 1
            elif tag == MsgType.PING:
                pings += 1
    await ws.close()
    return audio, text, pings


def test_app_serves_duplex_ws_batched(monkeypatch):
    """Without the codec (``available`` patched false, as where libopus or
    libogg does not load): the pcm wire by default and a 501 for
    ``?format=opus``; the Opus wire is tests/test_torch_opus.py's."""
    monkeypatch.setattr(topus, "available", lambda: False)
    _ej, et, frame = _engines(batch=2)
    et.warmup()
    et.start()
    app = App(duplex_engine=et)

    async def main():
        async with TestClient(TestServer(app.web_app)) as client:
            r = await client.get("/api/chat?format=opus")
            assert r.status == 501 and "opus" in (await r.json())["error"]
            (a1, _, p1), (a2, _, _) = await asyncio.gather(
                _chat(client, "?format=pcm", _pcm(1, 8, frame), frame, 4),
                _chat(client, "", _pcm(2, 8, frame), frame, 4))
            assert a1 >= 4 and a2 >= 4 and p1 <= 1
            info = await (await client.get("/api/modules_info")).json()
            assert {"type": "Lm", "batch_size": 2} in info["modules"]
            # Text-only session: words may come, audio never.
            ws = await client.ws_connect("/api/chat?format=pcm&asr_delay_in_tokens=3")
            assert (await ws.receive()).data[0] == MsgType.HANDSHAKE
            await ws.send_bytes(bytes([MsgType.AUDIO])
                                + _pcm(3, 8, frame).astype("<f4").tobytes())
            for _ in range(200):
                if any(s is not None and s.steps == 8 for s in et.slots):
                    break
                await asyncio.sleep(0.05)
            assert any(s is not None and s.steps == 8 for s in et.slots)
            await ws.send_bytes(bytes([MsgType.PING]))
            async with asyncio.timeout(30):
                while True:
                    msg = await ws.receive()
                    assert msg.data[0] != MsgType.AUDIO
                    if msg.data[0] == MsgType.PING:
                        break
            # At capacity: the third connection is closed with the code.
            held = await client.ws_connect("/api/chat?format=pcm")
            assert (await held.receive()).data[0] == MsgType.HANDSHAKE
            full = await client.ws_connect("/api/chat?format=pcm")
            assert (await full.receive()).data[0] == MsgType.HANDSHAKE
            closed = await full.receive()
            assert closed.type.name == "CLOSE"
            assert closed.data == int(CloseCode.SERVER_AT_CAPACITY)
            await held.close()
            await ws.close()
            for _ in range(100):
                if et.used_slots() == 0:
                    break
                await asyncio.sleep(0.05)
            assert et.used_slots() == 0

    try:
        asyncio.run(main())
    finally:
        et.stop()


def test_app_serves_duplex_ws_single_dialogue():
    _ej, et, frame = _engines()
    single = tDX.DuplexEngine(et.cfg, et.params, et.mimi_cfg, et.mimi_params,
                              FallbackTokenizer(), device="cpu")
    single.warmup()
    app = App(duplex_engine=single)

    async def main():
        async with TestClient(TestServer(app.web_app)) as client:
            audio, _text, pings = await _chat(client, "?format=pcm", _pcm(4, 6, frame),
                                              frame, 3)
            assert audio >= 3 and pings <= 1

    asyncio.run(main())
