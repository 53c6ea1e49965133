"""Auth issuance service of the port (counterpart of
``dsm_tpu/server/auth_server.py``; reference: server/typescript/auth-server).

A Better Auth-compatible JWT issuer: sign-up creates a *pending* account,
an admin approves/rejects it, sign-in returns an HS256 session token with
the claims layout the serving stack validates (``server/auth.py``, the
port's and the JAX package's alike).  The reference uses Hono +
Postgres/Drizzle; this is aiohttp + sqlite: the HTTP surface and the token
format are what matter for parity.

Routes:
  POST /api/auth/sign-up        {email, password}
  POST /api/auth/sign-in        {email, password} -> {token}
  POST /api/auth/admin/approve  {email, status}   (X-Admin-Secret header)
  GET  /health
"""

from __future__ import annotations

import hashlib
import hmac
import os
import secrets
import sqlite3
import threading
import time

from aiohttp import web

from . import auth as auth_mod


def _hash_password(password: str, salt: str) -> str:
    return hashlib.pbkdf2_hmac(
        "sha256", password.encode(), salt.encode(), 100_000
    ).hex()


class AuthServer:
    def __init__(self, db_path: str = ":memory:",
                 secret: str | None = None,
                 admin_secret: str | None = None):
        self.secret = secret or os.environ.get(auth_mod.SECRET_ENV) or secrets.token_hex(32)
        self.admin_secret = admin_secret or os.environ.get(
            "AUTH_ADMIN_SECRET", secrets.token_hex(16)
        )
        self._lock = threading.Lock()
        self.db = sqlite3.connect(db_path, check_same_thread=False)
        self.db.execute(
            "CREATE TABLE IF NOT EXISTS users ("
            " id TEXT PRIMARY KEY, email TEXT UNIQUE, salt TEXT,"
            " password_hash TEXT, status TEXT, role TEXT, created REAL)"
        )
        self.web_app = web.Application()
        r = self.web_app.router
        r.add_post("/api/auth/sign-up", self.sign_up)
        r.add_post("/api/auth/sign-in", self.sign_in)
        r.add_post("/api/auth/admin/approve", self.approve)
        r.add_get("/health", self.health)

    async def health(self, request):
        return web.json_response({"status": "ok"})

    async def sign_up(self, request):
        body = await request.json()
        email = (body.get("email") or "").strip().lower()
        password = body.get("password") or ""
        if not email or len(password) < 8:
            return web.json_response(
                {"error": "email and password (>=8 chars) required"}, status=400
            )
        salt = secrets.token_hex(8)
        uid = f"u_{secrets.token_hex(8)}"
        with self._lock:
            try:
                self.db.execute(
                    "INSERT INTO users VALUES (?,?,?,?,?,?,?)",
                    (uid, email, salt, _hash_password(password, salt),
                     "pending", "user", time.time()),
                )
                self.db.commit()
            except sqlite3.IntegrityError:
                return web.json_response(
                    {"error": "email already registered"}, status=409
                )
        return web.json_response({"id": uid, "email": email, "status": "pending"})

    async def sign_in(self, request):
        body = await request.json()
        email = (body.get("email") or "").strip().lower()
        password = body.get("password") or ""
        with self._lock:
            row = self.db.execute(
                "SELECT id, salt, password_hash, status, role FROM users"
                " WHERE email = ?", (email,),
            ).fetchone()
        if row is None or not hmac.compare_digest(
            row[2], _hash_password(password, row[1])
        ):
            return web.json_response({"error": "invalid credentials"}, status=401)
        uid, _salt, _ph, status, role = row
        token = auth_mod.generate_token(
            user_id=uid, email=email, secret=self.secret,
            status=status, role=role,
        )
        return web.json_response({"token": token, "status": status})

    async def approve(self, request):
        if request.headers.get("X-Admin-Secret") != self.admin_secret:
            return web.json_response({"error": "forbidden"}, status=403)
        body = await request.json()
        email = (body.get("email") or "").strip().lower()
        status = body.get("status", "approved")
        if status not in ("approved", "pending", "rejected"):
            return web.json_response({"error": "bad status"}, status=400)
        with self._lock:
            cur = self.db.execute(
                "UPDATE users SET status = ? WHERE email = ?", (status, email)
            )
            self.db.commit()
        if cur.rowcount == 0:
            return web.json_response({"error": "unknown user"}, status=404)
        return web.json_response({"email": email, "status": status})

    def run(self, host="0.0.0.0", port=8081):
        web.run_app(self.web_app, host=host, port=port)
