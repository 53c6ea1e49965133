"""The port's command line (``dsm_tpu_torch/cli.py``) against the JAX CLI.

Bars: ``validate`` prints exactly what the JAX CLI prints, with the same exit
code, for every TOML the repo ships (no download cache: every ``hf://``
file is reported missing on both sides) and for a TOML whose files are all
local; ``worker --device cpu`` builds, warms up and starts the engines of
every shipped TOML (its model cut to one narrow layer, its batch to two
slots, Mimi to the small codec of tests/test_mimi.py) and hands them to
``App.run`` with the host, port and TLS files it was given.
"""

import argparse
import glob
import logging
import os
import subprocess
import sys
import tomllib

import pytest

from dsm_tpu import cli as jcli
from dsm_tpu_torch import cli as tcli
from dsm_tpu_torch.server import app as tapp
from dsm_tpu_torch.server import builder as tbuilder
from dsm_tpu_torch.server.duplex import DuplexEngine
from dsm_tpu_torch.server.tts_module import TtsEngine
from tests.test_torch_tts_single import _small_v0_1

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOMLS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.toml")))


@pytest.fixture
def no_cache(tmp_path, monkeypatch):
    """An empty download cache and no downloads, for the JAX resolver."""
    monkeypatch.setenv("DSM_HF_CACHE", str(tmp_path / "hf"))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    monkeypatch.setenv("DSM_HF_DOWNLOAD", "0")


def _validate_both(path, capsys):
    rj = jcli.cmd_validate(argparse.Namespace(config=path))
    out_j = capsys.readouterr().out
    rt = tcli.main(["validate", path])
    out_t = capsys.readouterr().out
    return (rj, out_j), (rt, out_t)


@pytest.mark.parametrize("toml", [os.path.basename(p) for p in TOMLS])
def test_validate_prints_what_the_jax_cli_prints(toml, capsys, no_cache):
    (rj, out_j), (rt, out_t) = _validate_both(os.path.join(ROOT, "configs", toml), capsys)
    assert out_t == out_j and rt == rj
    assert out_t.startswith("instance: ")


def test_validate_of_local_files(tmp_path, capsys, no_cache):
    with open(os.path.join(ROOT, "configs", "config-stt.toml"), "rb") as f:
        raw = tomllib.load(f)
    for key in ("lm_model_file", "text_tokenizer_file", "audio_tokenizer_file"):
        (tmp_path / key).write_bytes(b"x")
        raw["modules"]["asr"][key] = str(tmp_path / key)
    raw["modules"]["asr"]["audio_tokenizer_file"] = "$DSM_TEST_DIR/audio_tokenizer_file"
    os.environ["DSM_TEST_DIR"] = str(tmp_path)
    try:
        path = tmp_path / "c.toml"
        path.write_text(_dump(raw))
        (rj, out_j), (rt, out_t) = _validate_both(str(path), capsys)
    finally:
        del os.environ["DSM_TEST_DIR"]
    assert out_t == out_j and rt == rj == 0 and out_t.endswith("config ok\n")


def _dump(raw, prefix=""):
    """A TOML writer for the shipped configs' tables (no tomli_w here)."""
    lines, tables = [], []
    for k, v in raw.items():
        if isinstance(v, dict):
            tables.append((k, v))
        else:
            lines.append(f"{k} = {_value(v)}")
    out = "\n".join(lines) + "\n"
    for k, v in tables:
        name = f"{prefix}.{k}" if prefix else k
        out += f"\n[{name}]\n" + _dump(v, name)
    return out


def _value(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, list):
        return "[" + ", ".join(_value(x) for x in v) + "]"
    return repr(v)


def _shrink(raw):
    """Every module's model at one narrow layer, at most two slots."""
    for m in raw["modules"].values():
        if "batch_size" in m:
            m["batch_size"] = min(int(m["batch_size"]), 2)
        model = m.get("model")
        if model is None:
            continue
        model.update(text_in_vocab_size=301, text_out_vocab_size=300, audio_codebooks=8)
        model["transformer"].update(d_model=64, num_heads=4, num_layers=1,
                                    dim_feedforward=128,
                                    context=min(model["transformer"]["context"], 48))
        model["transformer"].pop("head_dim", None)
        if "depformer" in model:
            dep = model["depformer"]
            dep["num_slices"] = 4 if m["type"] == "Lm" else 8
            if "low_rank_embeddings" in dep:
                dep["low_rank_embeddings"] = 8
            dep["transformer"].update(d_model=32, num_heads=2, num_layers=1,
                                      dim_feedforward=64, context=8)
        for cond in (model.get("conditioners") or {}).values():
            cond["dim"] = 16
        gen = m.get("generation")
        if gen is not None and m["type"] == "Tts":
            gen.update(speaker_cond_dim=64, speaker_cond_n_speakers=1,
                       text_audio_delay_in_tokens=3, text_start_token=300)
        if gen is not None and m["type"] == "Lm":
            gen.update(generated_audio_codebooks=4, input_audio_codebooks=4)
    return raw


@pytest.mark.parametrize("toml", [os.path.basename(p) for p in TOMLS])
def test_worker_builds_and_starts_every_shipped_toml(toml, tmp_path, monkeypatch):
    with open(os.path.join(ROOT, "configs", toml), "rb") as f:
        raw = _shrink(tomllib.load(f))
    path = tmp_path / toml
    path.write_text(_dump(raw))
    monkeypatch.setattr(tbuilder.MIMI, "v0_1", _small_v0_1(True))
    served = {}

    def run(self, host="0.0.0.0", port=8080, ssl_cert=None, ssl_key=None):
        served.update(app=self, host=host, port=port, tls=(ssl_cert, ssl_key))

    monkeypatch.setattr(tapp.App, "run", run)
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        rc = tcli.main(["worker", "--config", str(path), "--device", "cpu", "--host",
                        "127.0.0.1", "--port", "8123", "--ssl-cert", "c.pem",
                        "--ssl-key", "k.pem", "--log-style", "pretty"])
    finally:
        root.handlers[:], root.level = handlers, level
    app = served["app"]
    engines = [e for e in (app.asr_engine, app.tts_engine, app.duplex_engine) if e is not None]
    try:
        assert rc == 0 and served["host"] == "127.0.0.1" and served["port"] == 8123
        assert served["tls"] == ("c.pem", "k.pem")
        kinds = {m["type"] for m in raw["modules"].values()}
        assert len(engines) == len(kinds) >= 1
        assert app.instance_name == raw["instance_name"]
        for eng in engines:
            assert eng.device.type == "cpu"
            if isinstance(eng, (TtsEngine, DuplexEngine)):
                continue  # no model loop: sessions run on the app's threads
            assert eng.running
        if app.tts_engine is not None:
            batched = int(raw["modules"]["tts"].get("batch_size", 1)) > 1
            assert isinstance(app.tts_engine, TtsEngine) != batched
    finally:
        for eng in engines:
            if hasattr(eng, "stop"):
                eng.stop()


def test_module_entry_point_and_refused_subcommands():
    for argv, rc in ((["validate", "configs/config-smoke.toml"], 0), (["stt", "--help"], 0),
                     (["tts", "--help"], 0), (["gen", "--help"], 0), (["bench", "--help"], 0),
                     (["tui", "--help"], 0), (["stt-client", "--help"], 0),
                     (["tts-client", "--help"], 0), (["auth-server", "--help"], 0),
                     (["worker", "--help"], 0)):
        res = subprocess.run([sys.executable, "-m", "dsm_tpu_torch.cli", *argv], cwd=ROOT,
                             capture_output=True, text=True, timeout=120, check=False)
        assert res.returncode == rc, (argv, res.stderr)
        if argv[0] == "worker":  # ported with the rest of the server
            assert "--self-signed-tls" in res.stdout
        if argv[0] in ("stt", "tts", "gen"):  # ported with the offline entry points
            assert "--device" in res.stdout
        if argv[0] == "gen":
            assert "--preset" in res.stdout and "--trace" in res.stdout
        if argv[0] == "bench":  # ported with bench_perf.py
            assert "--server-sustained" in res.stdout and "--device" in res.stdout
        if argv[0] in ("stt-client", "tts-client", "tui"):  # ported with the clients
            assert "--url" in res.stdout
            assert {"stt-client": "--mic", "tts-client": "--play",
                    "tui": "--seconds"}[argv[0]] in res.stdout
    res = subprocess.run([sys.executable, "-m", "dsm_tpu_torch.cli", "token-gen"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, check=False,
                         env={**os.environ, "BETTER_AUTH_SECRET": "s3cret"})
    assert res.returncode == 0 and res.stdout.count(".") == 2


def test_bench_dispatches_the_rest_of_its_arguments_to_bench_perf(monkeypatch):
    """``bench`` hands every argument after it to ``bench_perf.main`` (the
    JAX CLI's runs the root bench.py, which imports JAX); the other
    subcommands still refuse an argument they do not know."""
    from dsm_tpu_torch import bench_perf

    seen = []
    monkeypatch.setattr(bench_perf, "main", lambda argv: seen.append(argv) or 0)
    assert tcli.main(["bench", "--device", "cpu", "--memory", "--batch", "2"]) == 0
    assert seen == [["--device", "cpu", "--memory", "--batch", "2"]]
    with pytest.raises(SystemExit) as e:
        tcli.main(["validate", "configs/config-smoke.toml", "--device", "cpu"])
    assert e.value.code == 2
