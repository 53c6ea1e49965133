"""The port's auth issuance service (``dsm_tpu_torch/server/auth_server.py``):
the flow of ``tests/test_auth_server.py`` (sign-up pending, duplicate
refused, a pending token refused by the serving layer, a wrong password,
admin approval, then a token that the port's ``server/auth.py`` and the JAX
package's both accept, the admin route gated), and the CLI subcommand.
"""

import asyncio
import os
import subprocess
import sys

import pytest
from aiohttp.test_utils import TestClient, TestServer

from dsm_tpu.server import auth as jauth
from dsm_tpu_torch.server import auth as tauth
from dsm_tpu_torch.server.auth_server import AuthServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_auth_flow_end_to_end():
    srv = AuthServer(db_path=":memory:", secret="shared-secret")

    async def main():
        async with TestClient(TestServer(srv.web_app)) as client:
            assert (await (await client.get("/health")).json()) == {"status": "ok"}
            body = {"email": "A@b.c ", "password": "longenough"}
            r = await client.post("/api/auth/sign-up", json=body)
            assert r.status == 200 and (await r.json())["status"] == "pending"
            r = await client.post("/api/auth/sign-up", json=body)
            assert r.status == 409
            r = await client.post("/api/auth/sign-up", json={"email": "x@y", "password": "short"})
            assert r.status == 400
            r = await client.post("/api/auth/sign-in", json=body)
            pending = (await r.json())["token"]
            for mod in (tauth, jauth):
                with pytest.raises(mod.AuthError) as e:
                    mod.validate_token(pending, secret="shared-secret")
                assert e.value.code == "pending_approval"
            r = await client.post("/api/auth/sign-in",
                                  json={"email": "a@b.c", "password": "nope1234"})
            assert r.status == 401
            r = await client.post("/api/auth/admin/approve",
                                  json={"email": "a@b.c", "status": "approved"},
                                  headers={"X-Admin-Secret": srv.admin_secret})
            assert r.status == 200
            r = await client.post("/api/auth/admin/approve",
                                  json={"email": "who@b.c", "status": "approved"},
                                  headers={"X-Admin-Secret": srv.admin_secret})
            assert r.status == 404
            r = await client.post("/api/auth/sign-in", json=body)
            token = (await r.json())["token"]
            for mod in (tauth, jauth):
                claims = mod.validate_token(token, secret="shared-secret")
                assert claims["user"]["email"] == "a@b.c"
            r = await client.post("/api/auth/admin/approve", json={"email": "a@b.c"},
                                  headers={"X-Admin-Secret": "wrong"})
            assert r.status == 403

    asyncio.run(main())


def test_tokens_of_the_jax_service_pass_the_ports_check():
    """Both services mint tokens that both serving layers accept."""
    from dsm_tpu.server.auth_server import AuthServer as JaxAuthServer

    for cls in (AuthServer, JaxAuthServer):
        srv = cls(db_path=":memory:", secret="k", admin_secret="adm")

        async def main():
            async with TestClient(TestServer(srv.web_app)) as client:
                body = {"email": "q@r.s", "password": "12345678"}
                await client.post("/api/auth/sign-up", json=body)
                await client.post("/api/auth/admin/approve", json={"email": "q@r.s"},
                                  headers={"X-Admin-Secret": "adm"})
                return (await (await client.post("/api/auth/sign-in", json=body)).json())["token"]

        token = asyncio.run(main())
        ctx = tauth.AuthContext(enabled=True, secret="k")
        assert ctx.check({"Authorization": f"Bearer {token}"}, {}, {})["user"]["email"] == "q@r.s"
        assert jauth.validate_token(token, secret="k")["user"]["email"] == "q@r.s"


def test_cli_auth_server_subcommand():
    res = subprocess.run([sys.executable, "-m", "dsm_tpu_torch.cli", "auth-server", "--help"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120, check=False)
    assert res.returncode == 0 and "--db" in res.stdout
