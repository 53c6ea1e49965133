"""The rest of the port's App (``dsm_tpu_torch/server/app.py``): ``/metrics``,
static files, both duplex paths, the development certificate, and the App's
metric calls, against the JAX App's behaviour.

Bars: ``/metrics`` is ``text/plain`` and parses as the text exposition with
every JAX family; static files as
``tests/test_server_e2e.py::test_static_file_fallback`` (``index.html`` at
``/``, files by path, 404, traversal 403, the API routes first) with the
JAX App beside it; the duplex WebSocket opens on ``/api/chat`` and on
``/api/lm-streaming`` (moshi-server's path) and the JAX App has the same
two paths; ``make_self_signed_cert`` and ``worker --self-signed-tls`` write
a certificate that serves TLS; a refused token moves ``auth_error_total``
and a full server ``ws_close_total`` and ``lm_active_connections`` returns
to where it was.
"""

import asyncio
import logging
import ssl

import aiohttp
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from dsm_tpu.server import app as japp
from dsm_tpu.server import metrics as J
from dsm_tpu_torch import cli as tcli
from dsm_tpu_torch.server import app as tapp
from dsm_tpu_torch.server import auth as tauth
from dsm_tpu_torch.server import builder as tbuilder
from dsm_tpu_torch.server import metrics as P
from dsm_tpu_torch.server.protocol import CloseCode, MsgType
from dsm_tpu_torch.utils import opus as topus
from tests import test_torch_duplex_serving as DS
from tests.test_torch_mimi_rooms import MIMI_TOML, _small_v0_1

torch.set_num_threads(2)


def _parse(text):
    """The exposition -> ({family: type}, {sample line name: value})."""
    types, values = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            types[name] = kind
        elif line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            values[name] = float(value)
    return types, values


def test_metrics_route_parses_with_every_family():
    async def main():
        async with TestClient(TestServer(tapp.App().web_app)) as client:
            r = await client.get("/metrics")
            assert r.status == 200 and r.content_type == "text/plain"
            return await r.text()

    types, values = _parse(asyncio.run(main()))
    assert set(types) == J.rendered_families() == P.rendered_families()
    assert set(J.REFERENCE_FAMILIES) <= set(types)
    assert types["ws_close_total"] == "counter" and "lm_steps_total" in values
    assert values['lm_batch_utilization_bucket{le="+Inf"}'] == values["lm_batch_utilization_count"]


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_static_file_fallback(tmp_path, impl):
    root = tmp_path / "site"
    root.mkdir()
    (root / "index.html").write_text("<h1>dsm-tpu</h1>")
    (root / "assets").mkdir()
    (root / "assets" / "app.js").write_text("console.log(1)")
    (root / "assets" / "index.html").write_text("assets index")
    (tmp_path / "secret.txt").write_text("nope")
    App = tapp.App if impl == "port" else japp.App

    async def get(path):
        async with TestClient(TestServer(App(static_dir=str(root)).web_app)) as client:
            r = await client.get(path)
            return r.status, await r.text()

    async def traversal():
        # The client normalises "..": the raw request keeps it.
        server = TestServer(App(static_dir=str(root)).web_app)
        await server.start_server()
        try:
            reader, writer = await asyncio.open_connection(server.host, server.port)
            writer.write(b"GET /assets/../../secret.txt HTTP/1.1\r\nHost: x\r\n"
                         b"Connection: close\r\n\r\n")
            await writer.drain()
            head = (await reader.read(64)).decode()
            writer.close()
            return int(head.split()[1])
        finally:
            await server.close()

    assert asyncio.run(get("/")) == (200, "<h1>dsm-tpu</h1>")
    assert asyncio.run(get("/assets/app.js")) == (200, "console.log(1)")
    assert asyncio.run(get("/assets/")) == (200, "assets index")
    assert asyncio.run(get("/missing.png"))[0] == 404
    assert asyncio.run(get("/api/health"))[0] == 200  # the API routes come first
    assert asyncio.run(get("/metrics"))[0] == 200
    assert asyncio.run(traversal()) == 403


def test_both_duplex_paths_open_the_websocket(monkeypatch):
    _ej, et, frame = DS._engines(batch=2)
    et.warmup()
    et.start()
    app = tapp.App(duplex_engine=et)
    assert {"/api/chat", "/api/lm-streaming"} <= {
        r.resource.canonical for r in japp.App(duplex_engine=object()).web_app.router.routes()}
    active = P.LM_ACTIVE_CONNECTIONS.get()

    async def chat(client, path):
        ws = await client.ws_connect(path + "?format=pcm")
        hello = await ws.receive()
        assert hello.data == bytes([MsgType.HANDSHAKE]) + b"\x00" * 8
        await ws.send_bytes(bytes([MsgType.AUDIO]) + DS._pcm(1, 6, frame).astype("<f4").tobytes())
        got = 0
        async with asyncio.timeout(60):
            while got < 2:
                msg = await ws.receive()
                if msg.data[0] == MsgType.AUDIO:
                    assert len(msg.data) == 1 + 4 * frame
                    got += 1
        await ws.close()
        return got

    async def main():
        async with TestClient(TestServer(app.web_app)) as client:
            assert await asyncio.gather(chat(client, "/api/chat"),
                                        chat(client, "/api/lm-streaming")) == [2, 2]
            # Without the codec (libopus or libogg not loaded) Opus is refused.
            monkeypatch.setattr(topus, "available", lambda: False)
            r = await client.get("/api/lm-streaming?format=opus")
            assert r.status == 501
            for _ in range(100):
                if et.used_slots() == 0 and P.LM_ACTIVE_CONNECTIONS.get() == active:
                    break
                await asyncio.sleep(0.05)

    try:
        asyncio.run(main())
    finally:
        et.stop()
    assert et.used_slots() == 0 and P.LM_ACTIVE_CONNECTIONS.get() == active


def test_app_metric_calls_on_refusals(monkeypatch):
    monkeypatch.setenv(tauth.SECRET_ENV, "s3cret")
    _ej, et, frame = DS._engines(batch=1)
    app = tapp.App(duplex_engine=et, auth_ctx=tauth.AuthContext(enabled=True))
    full = P.WS_CLOSE_ERRORS.labels(code="4000", reason="server_at_capacity")
    before_full = full.get()
    before_auth = sum(s.value for f in P.collect() if f.name == "auth_error"
                      for s in f.samples)
    token = tauth.generate_token("u", "u@x", secret="s3cret")

    async def main():
        async with TestClient(TestServer(app.web_app)) as client:
            r = await client.get("/api/chat", params={"token": "not.a.token"})
            assert r.status in (401, 403)
            held = et.open_session(lambda e: None)  # the one slot taken
            ws = await client.ws_connect("/api/chat?format=pcm&token=" + token)
            assert (await ws.receive()).data[0] == MsgType.HANDSHAKE
            closed = await ws.receive()
            assert closed.data == int(CloseCode.SERVER_AT_CAPACITY)
            et.close_session(held)

    asyncio.run(main())
    after_auth = sum(s.value for f in P.collect() if f.name == "auth_error" for s in f.samples)
    assert after_auth == before_auth + 1 and full.get() == before_full + 1


def test_self_signed_certificate_serves_tls(tmp_path, monkeypatch):
    cert, key = str(tmp_path / "cert.pem"), str(tmp_path / "key.pem")
    tapp.make_self_signed_cert(cert, key)
    assert open(cert).read().startswith("-----BEGIN CERTIFICATE-----")

    async def main():
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert, key)
        runner = web.AppRunner(tapp.App().web_app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0, ssl_context=ctx)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        client_ctx = ssl.create_default_context(cafile=cert)
        client_ctx.check_hostname = False
        try:
            async with aiohttp.ClientSession() as s:
                async with s.get(f"https://127.0.0.1:{port}/api/health", ssl=client_ctx) as r:
                    return r.status, await r.json()
        finally:
            await runner.cleanup()

    assert asyncio.run(main()) == (200, {"status": "ok"})

    # The worker makes one when asked and hands it to App.run.
    monkeypatch.setattr(tbuilder.MIMI, "v0_1", _small_v0_1(True))
    toml = tmp_path / "rooms.toml"
    toml.write_text(MIMI_TOML)
    served = {}
    monkeypatch.setattr(tapp.App, "run", lambda self, **kw: served.update(kw))
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        assert tcli.main(["worker", "--config", str(toml), "--device", "cpu",
                          "--self-signed-tls"]) == 0
    finally:
        root.handlers[:], root.level = handlers, level
    with open(served["ssl_cert"]) as f:
        assert f.read().startswith("-----BEGIN CERTIFICATE-----")
    ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER).load_cert_chain(served["ssl_cert"],
                                                          served["ssl_key"])
