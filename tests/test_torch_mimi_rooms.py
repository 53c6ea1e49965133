"""The port's Mimi rooms (``dsm_tpu_torch/server/mimi_rooms.py``) against the
JAX package's.

Bars: ``decode_frame`` gives the JAX ``MimiRoomsEngine.decode_frame``'s pcm
within 1e-4 (atol and rtol, the port's Mimi-decode tolerance of
``tests/test_torch_tts.py::test_mimi_decode_step_matches_jax``) over 40
frames, past the decoder ring's wrap, with the JAX weights carried across by
the bridge; two interleaved rooms give each room's pcm alone, bit for bit;
the broadcast routes behave as ``tests/test_duplex_server.py`` tests the JAX
ones (both receivers get the audio and the text, another room nothing,
``format=OggOpus`` raw pcm without the codec); ``cli.build_engines`` builds a ``type = "Mimi"``
module (``n_q`` from the module) and ``worker`` serves it.
"""

import asyncio
import logging

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from dsm_tpu.models import mimi as jMIMI
from dsm_tpu.server.mimi_rooms import MimiRoomsEngine as JaxRooms
from dsm_tpu_torch import cli as tcli
from dsm_tpu_torch.server import app as tapp
from dsm_tpu_torch.server import builder as tbuilder
from dsm_tpu_torch.server import config as tCFG
from dsm_tpu_torch.server.mimi_rooms import MimiRoomsEngine, audio_message, parse_codes
from dsm_tpu_torch.server.protocol import MsgType
from dsm_tpu_torch.utils import opus as topus
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_ops import to_port
from tests.test_torch_tts import port_mimi_cfg
from tests.test_torch_tts_single import _small_v0_1

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


def _engines():
    mcfg = small_mimi_cfg()
    params = jMIMI.init(mcfg, jax.random.PRNGKey(3))
    ej = JaxRooms(cfg=mcfg, params=params)
    et = MimiRoomsEngine(cfg=port_mimi_cfg(mcfg), params=to_port(params), device="cpu")
    return ej, et


def _codes(n, n_q, seed):
    return np.random.default_rng(seed).integers(0, 32, size=(n, n_q)).astype(np.int32)


def test_decode_frame_matches_jax_past_the_ring():
    ej, et = _engines()
    ej.warmup()
    et.warmup()
    rj, rt = ej.room("a"), et.room("a")
    codes = _codes(40, et.cfg.n_q, 0)
    for c in codes:
        pj, pt = ej.decode_frame(rj, c), et.decode_frame(rt, c)
        assert pt.dtype == np.float32 and pt.shape == (et.cfg.frame_size,)
        np.testing.assert_allclose(pt, pj, **TOL)
    ring = rt.dec_state["dec_t"]["valid"].shape[1]
    assert int(rt.dec_state["dec_t"]["pos"]) > ring
    assert float(np.abs(pt).max()) > 0


def test_interleaved_rooms_equal_each_room_alone():
    _, et = _engines()
    a, b = _codes(24, et.cfg.n_q, 1), _codes(24, et.cfg.n_q, 2)
    ra, rb = et.room("a"), et.room("b")
    mixed_a, mixed_b = [], []
    for ca, cb in zip(a, b):
        mixed_a.append(et.decode_frame(ra, ca))
        mixed_b.append(et.decode_frame(rb, cb))
    for codes, mixed in ((a, mixed_a), (b, mixed_b)):
        state, alone = et.init_state(), []
        for c in codes:
            pcm, state = et.decode(state, c)
            alone.append(pcm)
        np.testing.assert_array_equal(np.stack(mixed).view(np.int32),
                                      np.stack(alone).view(np.int32))
    assert et.room("a") is ra and set(et.rooms) == {"a", "b"}


def test_wire_helpers():
    assert parse_codes(np.arange(4, dtype="<u4").tobytes(), 4).tolist() == [0, 1, 2, 3]
    assert parse_codes(np.arange(3, dtype="<u4").tobytes(), 4) is None
    msg = audio_message(np.ones(3, np.float32))
    assert msg[0] == MsgType.AUDIO and np.frombuffer(msg[1:], "<f4").tolist() == [1, 1, 1]


def test_broadcast_routes(monkeypatch):
    """Without the codec (``available`` patched false, as where libopus or
    libogg does not load) a ``format=OggOpus`` receiver gets raw pcm; its
    Ogg pages are tests/test_torch_opus.py's."""
    monkeypatch.setattr(topus, "available", lambda: False)
    _, engine = _engines()
    engine.warmup()
    app = tapp.App(mimi_rooms_engine=engine)

    async def main():
        async with TestClient(TestServer(app.web_app)) as client:
            recv1 = await client.ws_connect("/api/mimi/recv/r1")
            recv2 = await client.ws_connect("/api/mimi/recv/r1?format=OggOpus")
            other = await client.ws_connect("/api/mimi/recv/r2")
            send = await client.ws_connect("/api/mimi/send/r1")
            await asyncio.sleep(0.1)  # the receivers subscribe before the first frame
            codes = np.arange(engine.cfg.n_q, dtype="<u4")
            await send.send_bytes(bytes([MsgType.CODES]) + codes.tobytes())
            await send.send_bytes(bytes([MsgType.CODES]) + codes[:2].tobytes())  # dropped
            await send.send_bytes(bytes([MsgType.TEXT]) + b"hello room")
            async with asyncio.timeout(60):
                m1 = await recv1.receive()
                m2 = await recv2.receive()
            assert m1.data[0] == MsgType.AUDIO and m2.data == m1.data
            pcm = np.frombuffer(m1.data[1:], "<f4")
            assert len(pcm) == engine.cfg.frame_size
            want = engine.decode(engine.init_state(), codes.astype(np.int32))[0]
            np.testing.assert_array_equal(pcm, want)
            async with asyncio.timeout(30):
                t1, t2 = await recv1.receive(), await recv2.receive()
            assert t1.data == t2.data == bytes([MsgType.TEXT]) + b"hello room"
            with pytest.raises(asyncio.TimeoutError):
                async with asyncio.timeout(0.5):
                    await other.receive()
            for w in (recv1, recv2, other, send):
                await w.close()

    asyncio.run(main())
    assert all(not r.receivers for r in engine.rooms.values())


MIMI_TOML = """instance_name = "rooms"

[modules.mimi]
type = "Mimi"
path = "/api/mimi"
n_q = 8
"""


def test_build_engines_builds_a_mimi_module(tmp_path, monkeypatch):
    monkeypatch.setattr(tbuilder.MIMI, "v0_1", _small_v0_1(True))
    path = tmp_path / "rooms.toml"
    path.write_text(MIMI_TOML)
    cfg = tCFG.Config.load(str(path))
    assert cfg.modules["mimi"].n_q == 8 and not cfg.validate()
    engines = tcli.build_engines(cfg, "cpu")
    rooms = engines["mimi_rooms"]
    assert isinstance(rooms, MimiRoomsEngine) and rooms.cfg.n_q == 8
    assert rooms.device.type == "cpu" and engines["asr"] is engines["tts"] is None
    assert rooms.params["quantizer"]["rvq_first"]["embed"].dtype == torch.float32
    tcli.start_engines(engines)  # warms the rooms up
    pcm = rooms.decode_frame(rooms.room("x"), np.zeros(8, np.int32))
    assert pcm.shape == (rooms.cfg.frame_size,)

    served = {}
    monkeypatch.setattr(tapp.App, "run", lambda self, **kw: served.update(app=self, **kw))
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        assert tcli.main(["worker", "--config", str(path), "--device", "cpu"]) == 0
    finally:
        root.handlers[:], root.level = handlers, level
    app = served["app"]
    assert isinstance(app.mimi_rooms_engine, MimiRoomsEngine)
    paths = {r.resource.canonical for r in app.web_app.router.routes()}
    assert {"/api/mimi/send/{room}", "/api/mimi/recv/{room}", "/metrics"} <= paths
