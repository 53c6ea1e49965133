"""dsm_tpu_torch stands alone: every module imports with JAX blocked and
pulls in nothing of the JAX package."""

import os
import pkgutil
import subprocess
import sys
import textwrap

import dsm_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    names = ["dsm_tpu_torch"]
    for info in pkgutil.walk_packages(dsm_tpu_torch.__path__, "dsm_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax():
    names = _all_modules()
    for mod in ("server.batched_asr", "ops.decode_attn", "server.tts_batched",
                "server.app", "server.protocol", "server.auth", "server.voices",
                "server.tts_module", "server.tts_preprocess", "sessions.tts",
                "models.conditioner", "utils.tokenizer", "utils.audio",
                "sessions.lm_gen", "server.duplex", "server.duplex_batched",
                "ops.qmm", "server.autoconfig", "ops.attn_tune", "tools.attn_kernel_tune",
                "server.metrics", "server.native", "server.mimi_rooms", "server.model_presets",
                "server.auth_server", "utils.session_log", "offline", "sessions.lm_gen_simple",
                "sessions.tts_legacy", "utils.bench", "utils.tracing", "utils.flac",
                "utils.codecs", "utils.opus", "train", "client", "client.audio_io",
                "client.stt", "client.tts", "client.tui", "parallel", "parallel.mesh",
                "bench_perf"):
        assert f"dsm_tpu_torch.{mod}" in names
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None  # any import of jax now raises
        sys.modules["optax"] = None
        for name in {names!r}:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m == "dsm_tpu" or m.startswith("dsm_tpu."))
        assert not leaked, leaked
        print("ok", len({names!r}))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=False)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_engines_import_without_the_web_packages():
    """The builder and the three engines load where aiohttp and msgpack are
    absent (only ``server.app`` needs them), so a machine with a card and
    neither package can build and drive every path."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("jax", "aiohttp", "msgpack"):
            sys.modules[name] = None
        for name in ("server.builder", "server.duplex", "server.duplex_batched",
                     "server.protocol", "sessions.lm_gen", "server.autoconfig", "ops.qmm",
                     "ops.attn_tune", "tools.attn_kernel_tune", "server.metrics",
                     "server.native", "server.mimi_rooms", "server.model_presets", "offline",
                     "sessions.lm_gen_simple", "sessions.tts_legacy", "utils.bench",
                     "utils.tracing", "utils.audio", "utils.opus", "train", "client",
                     "client.audio_io",
                     "client.stt", "client.tts", "client.tui", "bench_perf"):
            importlib.import_module("dsm_tpu_torch." + name)
        from dsm_tpu_torch.server import duplex
        assert duplex.parse_frame(duplex.text_frame("a")) == (2, b"a")
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=False)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_chip_smoke_imports_nothing_of_jax():
    """The root chip_smoke.py names neither jax nor the JAX package."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    for line in src.splitlines():
        stripped = line.strip()
        if stripped.startswith(("import ", "from ")):
            assert "jax" not in stripped
            assert not stripped.split()[1].startswith("dsm_tpu.")
            assert stripped.split()[1] != "dsm_tpu"


def test_no_file_of_the_port_names_jax_or_reads_the_environment_for_routing():
    """No ``import jax`` / ``from jax`` / ``optax`` / ``dsm_tpu`` import in any file of
    the port, and no environment variable read in the modules that route
    (ops, models, sessions, tools, the engines and ``server/builder.py``)."""
    pkg = os.path.dirname(dsm_tpu_torch.__file__)
    seen = 0
    for folder, _dirs, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            seen += 1
            path = os.path.join(folder, name)
            with open(path) as f:
                src = f.read()
            for line in src.splitlines():
                stripped = line.strip()
                if stripped.startswith(("import ", "from ")):
                    target = stripped.split()[1]
                    assert target != "jax" and not target.startswith("jax."), (path, line)
                    assert target != "dsm_tpu" and not target.startswith("dsm_tpu."), (path, line)
                    assert target != "optax" and not target.startswith("optax."), (path, line)
            rel = os.path.relpath(path, pkg)
            if rel.split(os.sep)[0] in ("ops", "models", "sessions", "tools") or rel in (
                    "server/builder.py", "server/duplex_batched.py", "server/batched_asr.py",
                    "server/tts_batched.py"):
                if rel == os.path.join("ops", "_build.py"):
                    continue  # looks for nvcc on the PATH
                assert "os.environ" not in src and "getenv" not in src, path
    assert seen >= 35


def test_load_and_start_path_imports_without_web_or_checkpoint_packages():
    """The card's machine has no aiohttp, msgpack, safetensors or
    sentencepiece: the CLI's ``build_engines``, the loaders, the speaker
    encoder and the single-session engine load without them."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("jax", "aiohttp", "msgpack", "safetensors", "sentencepiece"):
            sys.modules[name] = None
        for name in ("cli", "utils.checkpoint", "utils.gguf", "utils.gc_tune",
                     "utils.logging", "utils.banner", "models.speaker",
                     "models.conditioner", "server.voices", "server.tts_module",
                     "server.builder", "utils.session_log", "server.batched_asr"):
            importlib.import_module("dsm_tpu_torch." + name)
        from dsm_tpu_torch import cli
        assert callable(cli.build_engines) and callable(cli.start_engines)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=False)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
