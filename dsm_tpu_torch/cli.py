"""The port's command line (counterpart of ``dsm_tpu/cli.py``, the
subcommands the port serves):

  worker       run the server from a TOML config, on the card by default
  validate     check a config
  token-gen    mint a JWT for the server's auth
  auth-server  run the JWT issuance service

Usage: ``python -m dsm_tpu_torch.cli <subcommand> [...]``.  The JAX CLI's
``stt``, ``tts``, ``bench``, client, ``gen`` and ``tui`` subcommands are not
ported (ROADMAP.md): argparse refuses them.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def cmd_validate(args) -> int:
    from .server.config import Config

    cfg = Config.load(args.config)
    problems = cfg.validate()
    print(f"instance: {cfg.instance_name}")
    for name, m in cfg.modules.items():
        print(f"  module {name}: type={m.type} path={m.path}")
    if problems:
        print("problems:")
        for p in problems:
            print(f"  - {p}")
        return 1
    print("config ok")
    return 0


def build_engines(cfg, device) -> dict:
    """Every module of ``cfg`` built on ``device`` (the first of each kind,
    as the JAX worker takes them) -> ``{"asr", "tts", "duplex",
    "mimi_rooms"}`` engines or None, and ``"asr_path"``.  Needs neither
    aiohttp nor msgpack."""
    from .server import builder

    out = {"asr": None, "tts": None, "duplex": None, "mimi_rooms": None,
           "asr_path": "/api/asr-streaming"}
    for m in cfg.modules.values():
        if m.type in ("BatchedAsr", "Asr") and out["asr"] is None:
            out["asr"] = builder.build_batched_asr(m, device)
            out["asr_path"] = m.path
        elif m.type == "Tts" and out["tts"] is None:
            out["tts"] = builder.build_tts(m, device)
        elif m.type == "Lm" and out["duplex"] is None:
            out["duplex"] = builder.build_duplex(m, device)
        elif m.type == "Mimi" and out["mimi_rooms"] is None:
            out["mimi_rooms"] = builder.build_mimi_rooms(m, device)
    return out


def start_engines(engines: dict) -> None:
    """Warm up each engine (capturing its graph on CUDA), then start the
    model loops of those that have one."""
    for kind in ("asr", "tts", "duplex", "mimi_rooms"):
        eng = engines[kind]
        if eng is None:
            continue
        eng.warmup()
        if hasattr(eng, "start"):
            eng.start()


def cmd_worker(args) -> int:
    from .server.config import Config
    from .utils.banner import print_banner
    from .utils.logging import setup_logging

    setup_logging(args.log_style)
    cfg = Config.load(args.config)
    engines = build_engines(cfg, args.device)
    start_engines(engines)
    from .server import auth
    from .server.app import App  # aiohttp, only to serve

    auth_ctx = auth.AuthContext(enabled=bool(os.environ.get(auth.SECRET_ENV)))
    print_banner(cfg, engines["asr"], engines["tts"], args.port, args.device)
    static_dir = cfg.static_dir if cfg.static_dir and os.path.isdir(cfg.static_dir) else None
    app = App(asr_engine=engines["asr"], tts_engine=engines["tts"],
              duplex_engine=engines["duplex"], mimi_rooms_engine=engines["mimi_rooms"],
              auth_ctx=auth_ctx, instance_name=cfg.instance_name,
              asr_path=engines["asr_path"], static_dir=static_dir)
    cert, key = args.ssl_cert, args.ssl_key
    if args.self_signed_tls and not (cert and key):
        import tempfile

        from .server.app import make_self_signed_cert

        d = tempfile.mkdtemp(prefix="dsm-tls-")
        cert, key = os.path.join(d, "cert.pem"), os.path.join(d, "key.pem")
        make_self_signed_cert(cert, key)
        logging.getLogger(__name__).info("self-signed TLS cert at %s", cert)
    app.run(host=args.host, port=args.port, ssl_cert=cert, ssl_key=key)
    return 0


def cmd_auth_server(args) -> int:
    from .server.auth_server import AuthServer

    srv = AuthServer(db_path=args.db)
    print(f"admin secret: {srv.admin_secret}")
    srv.run(host=args.host, port=args.port)
    return 0


def cmd_token_gen(args) -> int:
    from .server.auth import generate_token

    print(generate_token(args.user, args.email, ttl_s=args.ttl))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dsm-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    w = sub.add_parser("worker", help="run the server")
    w.add_argument("--config", required=True)
    w.add_argument("--host", default="0.0.0.0")
    w.add_argument("--port", type=int, default=8080)
    w.add_argument("--device", default="cuda", help="where the engines run (cuda, cpu)")
    w.add_argument("--log-style", default="compact",
                   choices=["compact", "pretty", "verbose", "json"])
    w.add_argument("--ssl-cert", default=None, help="TLS certificate PEM")
    w.add_argument("--ssl-key", default=None, help="TLS private key PEM")
    w.add_argument("--self-signed-tls", action="store_true",
                   help="generate a throwaway self-signed cert (dev only)")
    w.set_defaults(fn=cmd_worker)

    v = sub.add_parser("validate", help="validate a config")
    v.add_argument("config")
    v.set_defaults(fn=cmd_validate)

    g = sub.add_parser("token-gen", help="mint a JWT")
    g.add_argument("--user", default="cli-user")
    g.add_argument("--email", default="cli@localhost")
    g.add_argument("--ttl", type=int, default=7 * 24 * 3600)
    g.set_defaults(fn=cmd_token_gen)

    a = sub.add_parser("auth-server", help="run the JWT issuance service")
    a.add_argument("--host", default="0.0.0.0")
    a.add_argument("--port", type=int, default=8081)
    a.add_argument("--db", default="auth.sqlite3")
    a.set_defaults(fn=cmd_auth_server)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
