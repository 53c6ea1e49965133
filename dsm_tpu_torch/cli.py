"""The port's command line (counterpart of ``dsm_tpu/cli.py``, the
subcommands the port serves):

  worker       run the server from a TOML config
  validate     check a config
  stt          transcribe audio files offline
  tts          synthesize text (or a tts.jsonl file) to wav offline
  gen          offline generation with a model preset (token level)
  token-gen    mint a JWT for the server's auth
  auth-server  run the JWT issuance service
  stt-client   stream a wav (or the microphone) to a server
  tts-client   synthesize through a server, write a wav (or play it)
  tui          terminal duplex client
  bench        component and sustained benchmarks (``bench_perf.py``)

Usage: ``python -m dsm_tpu_torch.cli <subcommand> [...]``; the subcommands
that run a model take ``--device`` (``cuda`` by default, ``cpu``).  The
clients need ``aiohttp`` and ``msgpack``, the microphone and the speaker
``sounddevice``; without it ``--mic`` and ``--play`` exit 2 with the error,
as ``tui`` does without a terminal.  ``bench`` hands the rest of its
arguments to ``bench_perf.main`` (``bench --help`` lists them); the JAX CLI's
``bench`` runs the root ``bench.py``, which imports JAX (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import contextlib
import json
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


def cmd_stt(args) -> int:
    """Offline transcription; several files share one batched run."""
    from .offline import transcribe_file, transcribe_files

    if len(args.audio) > 1:
        results = transcribe_files(args.audio, config_path=args.config, vad=args.vad,
                                   device=args.device)
        if args.json:
            print(json.dumps([{"path": p, **r} for p, r in zip(args.audio, results)]))
        else:
            for p, r in zip(args.audio, results):
                print(f"== {p}")
                for w in r["words"]:
                    print(f"[{w['start_s']:7.2f}s] {w['text']}")
        return 0
    result = transcribe_file(args.audio[0], config_path=args.config, vad=args.vad,
                             device=args.device)
    if args.json:
        print(json.dumps(result))
    else:
        for w in result["words"]:
            print(f"[{w['start_s']:7.2f}s] {w['text']}")
        print(result["text"])
    return 0


def cmd_tts(args) -> int:
    """Offline synthesis of one text, or of a tts.jsonl file with ``--jsonl``."""
    if args.jsonl:
        from .offline import synthesize_jsonl

        print(json.dumps(synthesize_jsonl(args.text, args.out, config_path=args.config,
                                          device=args.device)))
        return 0
    from .offline import synthesize_file

    print(json.dumps(synthesize_file(args.text, args.out, config_path=args.config,
                                     device=args.device)))
    return 0


def cmd_gen(args) -> int:
    """Offline generation with a model preset and seeded random weights
    (moshi-cli gen): prints the text tokens and the audio frames' count;
    ``--out-tokens`` writes both as safetensors, ``--trace`` a profile."""
    import numpy as np
    import torch

    from .models import lm as LM
    from .sessions import lm_gen_simple as G
    from .utils.checkpoint import save_safetensors

    device = torch.device(args.device)
    lm_cfg = getattr(LM, args.preset)()
    delays = (tuple([0] + [2] * (lm_cfg.generated_codebooks - 1))
              if lm_cfg.generated_codebooks else (0,))
    cfg = G.GenConfig(lm=lm_cfg, audio_delays=delays, text_start_token=lm_cfg.text_start_token,
                      max_steps=args.steps + 8)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = {"lm": LM.init(lm_cfg, gen, dtype=torch.bfloat16)}
    if args.trace:
        from .utils.tracing import device_trace

        tracer = device_trace(args.trace)
    else:
        tracer = contextlib.nullcontext()
    with tracer:
        texts, frames = G.generate(cfg, params, args.steps, seed=args.seed)
    print(json.dumps({
        "text_tokens": texts,
        "audio_frames": int(frames.shape[0]),
        "codebooks": int(frames.shape[1]) if frames.size else 0,
    }))
    if args.out_tokens:
        save_safetensors(args.out_tokens, {"text_tokens": np.asarray(texts, np.int32),
                                           "audio_tokens": frames.astype(np.int32)})
    return 0


def cmd_bench(args) -> int:
    """The benchmarks of ``bench_perf.py`` on the rest of the arguments."""
    from . import bench_perf

    return bench_perf.main(args.rest)


def cmd_stt_client(args) -> int:
    """Stream an audio file (or the microphone) to a server and print the
    transcript (``--json``: the words with their times)."""
    import asyncio

    from .client.stt import SttClient

    client = SttClient(args.url, token=args.token)

    def on_event(ev):
        if ev.type == "word" and (args.mic or args.verbose):
            print(ev.text, end=" ", flush=True, file=sys.stderr)
        elif args.verbose and ev.type == "step":
            print(f"\rstep {ev.step_idx}", end="", file=sys.stderr)

    if args.mic:
        # One 80 ms frame a read, bounded by --duration; a clear error where
        # no audio backend exists.
        from .client.audio_io import AudioUnavailable, MicSource, require_backend

        try:
            require_backend()
        except AudioUnavailable as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

        def frames():
            import time as _t

            try:
                with MicSource() as mic:
                    t_end = _t.monotonic() + args.duration if args.duration else None
                    while t_end is None or _t.monotonic() < t_end:
                        f = mic.read_frame()
                        if f is None:
                            break
                        yield f
            except AudioUnavailable as e:
                raise SystemExit(f"error: {e}")

        transcript = asyncio.run(client.transcribe_frames(frames(), on_event=on_event))
        print(file=sys.stderr)
    else:
        if not args.audio:
            print("error: audio file required without --mic", file=sys.stderr)
            return 2
        from .utils.audio import decode_audio

        pcm = decode_audio(args.audio, 24_000)
        transcript = asyncio.run(client.transcribe_pcm(pcm, rtf=args.rtf, on_event=on_event))
    if args.json:
        print(json.dumps({
            "text": transcript.text,
            "words": [{"text": w.text, "start_s": w.start_s, "stop_s": w.stop_s}
                      for w in transcript.words],
        }))
    else:
        print(transcript.text)
    return 0


def cmd_tts_client(args) -> int:
    """Synthesize through a server, write the wav, print the time to first
    audio and the realtime factor as JSON; ``--play`` plays it live."""
    import asyncio

    from .client.tts import TtsClient
    from .utils.audio import write_wav

    on_audio = None
    sink = None
    if args.play:
        from .client.audio_io import AudioUnavailable, SpeakerSink

        try:
            sink = SpeakerSink().__enter__()
        except AudioUnavailable as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        on_audio = sink.push
    try:
        result = asyncio.run(TtsClient(args.url, token=args.token).synthesize(
            args.text, on_audio=on_audio))
    finally:
        # Close the output stream on a failure too (connection refused, a
        # server error).
        if sink is not None:
            sink.__exit__(None, None, None)
    write_wav(args.out, result.pcm, 24_000)
    print(json.dumps({
        "out": args.out,
        "duration_s": round(len(result.pcm) / 24_000.0, 3),
        "ttfb_s": result.ttfb_s,
        "rtf": result.rtf,
        "words": result.words,
    }))
    return 0


def cmd_tui(args) -> int:
    """Terminal duplex client; exits 2 with the error where curses finds no
    terminal to draw on."""
    import curses

    from .client.tui import run_tui

    try:
        st = run_tui(args.url, token=args.token, wav_path=args.audio, seconds=args.seconds)
    except curses.error as e:
        print(f"error: the terminal UI needs a terminal: {e}", file=sys.stderr)
        return 2
    print(json.dumps({
        "transcript": st.transcript,
        "frames_sent": st.frames_sent,
        "frames_recv": st.frames_recv,
        "rx_seconds": round(st.rx_seconds, 2),
    }))
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

    s = sub.add_parser("stt", help="offline transcription")
    s.add_argument("audio", nargs="+", help="audio file(s); several share one batched run")
    s.add_argument("--config", default=None)
    s.add_argument("--vad", action="store_true")
    s.add_argument("--json", action="store_true")
    s.add_argument("--device", default="cuda", help="where the model runs (cuda, cpu)")
    s.set_defaults(fn=cmd_stt)

    t = sub.add_parser("tts", help="offline synthesis")
    t.add_argument("text", help="text, or a tts.jsonl path with --jsonl")
    t.add_argument("out", help="output wav, or a directory with --jsonl")
    t.add_argument("--config", default=None)
    t.add_argument("--jsonl", action="store_true",
                   help="batch mode: input is the reference tts.jsonl format")
    t.add_argument("--device", default="cuda", help="where the model runs (cuda, cpu)")
    t.set_defaults(fn=cmd_tts)

    g = sub.add_parser("token-gen", help="mint a JWT")
    g.add_argument("--user", default="cli-user")
    g.add_argument("--email", default="cli@localhost")
    g.add_argument("--ttl", type=int, default=7 * 24 * 3600)
    g.set_defaults(fn=cmd_token_gen)

    gn = sub.add_parser("gen", help="offline generation (token level)")
    gn.add_argument("--preset", default="moshi_v0_1_streaming")
    gn.add_argument("--steps", type=int, default=50)
    gn.add_argument("--seed", type=int, default=0)
    gn.add_argument("--out-tokens", default=None)
    gn.add_argument("--trace", default=None,
                    help="write a profile (Chrome trace, for Perfetto) into this dir")
    gn.add_argument("--device", default="cuda", help="where the model runs (cuda, cpu)")
    gn.set_defaults(fn=cmd_gen)

    b = sub.add_parser("bench", add_help=False,
                       help="component and sustained benchmarks (bench --help)")
    b.set_defaults(fn=cmd_bench)

    sc = sub.add_parser("stt-client", help="stream a wav (or live mic) to a server")
    sc.add_argument("audio", nargs="?", default=None)
    sc.add_argument("--url", default="ws://127.0.0.1:8080/api/asr-streaming")
    sc.add_argument("--token", default=None)
    sc.add_argument("--rtf", type=float, default=None, help="pace upload (1.0 = realtime)")
    sc.add_argument("--mic", action="store_true",
                    help="capture from the default input device "
                         "(requires the optional sounddevice backend)")
    sc.add_argument("--duration", type=float, default=None,
                    help="stop mic capture after N seconds")
    sc.add_argument("--json", action="store_true")
    sc.add_argument("--verbose", action="store_true")
    sc.set_defaults(fn=cmd_stt_client)

    tc = sub.add_parser("tts-client", help="synthesize via a server")
    tc.add_argument("text")
    tc.add_argument("out")
    tc.add_argument("--url", default="ws://127.0.0.1:8080/api/tts_streaming")
    tc.add_argument("--token", default=None)
    tc.add_argument("--play", action="store_true",
                    help="play audio live through the default output device "
                         "(requires the optional sounddevice backend)")
    tc.set_defaults(fn=cmd_tts_client)

    tu = sub.add_parser("tui", help="terminal duplex client")
    tu.add_argument("--url", default="ws://127.0.0.1:8080/api/chat")
    tu.add_argument("--token", default=None)
    tu.add_argument("--audio", default=None, help="WAV to stream (else silence)")
    tu.add_argument("--seconds", type=float, default=30.0)
    tu.set_defaults(fn=cmd_tui)

    a = sub.add_parser("auth-server", help="run the JWT issuance service")
    a.add_argument("--host", default="0.0.0.0")
    a.add_argument("--port", type=int, default=8081)
    a.add_argument("--db", default="auth.sqlite3")
    a.set_defaults(fn=cmd_auth_server)

    args, rest = p.parse_known_args(argv)
    if rest and args.cmd != "bench":
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    args.rest = rest
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
