"""The port's batched duplex engine on a device mesh of the CPU against the
JAX package's meshed engine on its 8-device virtual mesh
(``tests/conftest.py``), and the builders and ``cli worker`` on a TOML with
``[modules.X.mesh]`` (the TTS engine's cases are in
``tests/test_torch_mesh_engines.py``).

Each duplex shard draws its rows of the batch's draw (``lm_gen.step``'s
``row0``), so at dp = 8 the sampled events are those of the JAX engine's
GSPMD step and of the port's unmeshed engine; at dp = 4 x tp = 2 too, the
joins rounding within the audio's 1e-4.  Odd sizes raise as in JAX.
"""

import dataclasses
import logging
import os
import tomllib

import numpy as np
import pytest
import torch

from dsm_tpu.parallel import mesh as jM
from dsm_tpu.server.duplex_batched import BatchedDuplexEngine as JaxDuplex
from dsm_tpu.utils import tokenizer as jTOK
from dsm_tpu_torch import cli as tcli
from dsm_tpu_torch.parallel import mesh as tM
from dsm_tpu_torch.server import app as tapp
from dsm_tpu_torch.server import builder as tbuilder
from dsm_tpu_torch.server import duplex_batched as tDB
from dsm_tpu_torch.utils import tokenizer as tTOK
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_cli import ROOT, _dump, _shrink, _small_v0_1
from tests.test_torch_duplex import port_duplex_cfg, small_duplex_cfg
from tests.test_torch_duplex_serving import _pcm
from tests.test_torch_duplex_serving import _summary as _duplex_summary
from tests.test_torch_mesh_engines import CPU8, MESHES, _dep48, _same_events, eight_devices
from tests.test_torch_moshi import np_lm_params, np_mimi_params
from tests.test_torch_ops import to_port
from tests.test_torch_tts import port_mimi_cfg

torch.set_num_threads(1)

__all__ = ["eight_devices"]  # the autouse fixture, shared


# ---------------------------------------------------------------------------
# Duplex
# ---------------------------------------------------------------------------


def _duplex_drive(eng, frame):
    """Four dialogues on eight slots (one text-only), then the first closed
    and a fifth opened."""
    ev = [[] for _ in range(5)]
    eng.warmup()
    drivers = []
    for i in range(4):
        drv = eng.open_session(ev[i].append, asr_delay_in_tokens=4 if i == 2 else 0)
        drv.push_pcm(_pcm(i, 8 + i, frame))
        drv.end_input()
        drivers.append(drv)
    for _ in range(14):
        eng.tick()
    eng.close_session(drivers[0])
    drv = eng.open_session(ev[4].append)
    drv.push_pcm(_pcm(9, 6, frame))
    drv.end_input()
    for _ in range(10):
        eng.tick()
    eng.stop()
    return [_duplex_summary(e) for e in ev]


def _duplex_engines(mesh_shape, batch=8, **over):
    jcfg = _dep48(small_duplex_cfg(n=4, audio_vocab=33, max_steps=64, **over))
    mimi_cfg = small_mimi_cfg()
    params = {"lm": np_lm_params(jcfg.lm, 0), "mimi": np_mimi_params(mimi_cfg, 1)}

    def port(mesh):
        return tDB.BatchedDuplexEngine(port_duplex_cfg(jcfg), {"lm": to_port(params["lm"])},
                                       port_mimi_cfg(mimi_cfg), to_port(params["mimi"]),
                                       tTOK.FallbackTokenizer(), batch_size=batch,
                                       device="cpu", mesh=mesh)

    dp, tp = mesh_shape
    ej = JaxDuplex(jcfg, params, mimi_cfg, params["mimi"], jTOK.FallbackTokenizer(),
                   batch_size=batch, mesh=jM.make_mesh(dp=dp, tp=tp))
    return mimi_cfg.frame_size, ej, port(tM.make_mesh(dp, tp, devices=CPU8)), port(None)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_duplex_engine_on_a_mesh_matches_the_jax_meshed_engine(dp, tp):
    """Sampled text and audio: every dialogue's events as the JAX meshed
    engine's (GSPMD: the batch's one draw) and the port's unmeshed engine's;
    audio within 1e-4 and 1e-5; the text-only dialogue has no audio."""
    frame, ej, et, e1 = _duplex_engines((dp, tp))
    assert [sh._row0 for sh, *_ in et.shards] == [i * 8 // dp for i in range(dp)]
    got, want, one = (_duplex_drive(e, frame) for e in (et, ej, e1))
    assert [k[-1] for k, _, _ in got] == ["DuplexDoneEvent"] * 5
    assert not got[2][2] and all(len(f) > 0 for i, (_, _, f) in enumerate(got) if i != 2)
    _same_events(got, want, 1e-4, 2)
    _same_events(got, one, 1e-5, 2)


def test_duplex_engine_checks_batch_and_heads_as_jax():
    frame, _, _, _ = _duplex_engines((8, 1))
    with pytest.raises(ValueError, match="batch 6 not divisible by dp=4"):
        _duplex_engines((4, 2), batch=6)
    jcfg = _dep48(small_duplex_cfg(n=4, audio_vocab=33, max_steps=64))
    mimi_cfg = small_mimi_cfg()
    params = {"lm": np_lm_params(jcfg.lm, 0), "mimi": np_mimi_params(mimi_cfg, 1)}
    with pytest.raises(ValueError, match="num_heads 4 not divisible by tp=3"):
        tDB.BatchedDuplexEngine(port_duplex_cfg(jcfg), {"lm": to_port(params["lm"])},
                                port_mimi_cfg(mimi_cfg), to_port(params["mimi"]),
                                tTOK.FallbackTokenizer(), batch_size=6, device="cpu",
                                mesh=tM.make_mesh(2, 3, devices=CPU8))


# ---------------------------------------------------------------------------
# Builders and cli worker on a TOML with [modules.X.mesh]
# ---------------------------------------------------------------------------

SERVING = {"stt": "config-stt-tpu-serving.toml", "tts": "config-tts-tpu-serving.toml",
           "duplex": "config-duplex-tpu-serving.toml"}


def _meshed_raw(name, mesh):
    """A serving TOML shrunk (``tests/test_torch_cli._shrink``) with a gated
    MLP of hidden 176 (a tp split of whole blocks), four slots and
    ``[modules.X.mesh]``."""
    with open(os.path.join(ROOT, "configs", SERVING[name]), "rb") as f:
        raw = _shrink(tomllib.load(f))
    for m in raw["modules"].values():
        m["batch_size"] = 4
        m["model"]["transformer"]["dim_feedforward"] = 256
        m["mesh"] = dict(mesh)
    return raw


@pytest.mark.parametrize("name", sorted(SERVING))
def test_cli_worker_serves_a_toml_with_a_mesh(name, tmp_path, monkeypatch):
    """``cli worker --device cpu`` builds and starts the engine of a serving
    TOML with ``[modules.X.mesh] dp = 2, tp = 2`` unchanged: four shards of
    the CPU, the tp-local config (half the heads, the joins summed), the
    eager step said in the log, the int16 wire not taken (ASR); a tick runs."""
    raw = _meshed_raw(name, {"dp": 2, "tp": 2})
    path = tmp_path / SERVING[name]
    path.write_text(_dump(raw))
    monkeypatch.setattr(tbuilder.MIMI, "v0_1", _small_v0_1(True))
    served = {}
    monkeypatch.setattr(tapp.App, "run", lambda self, **kw: served.update(app=self))
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        assert tcli.main(["worker", "--config", str(path), "--device", "cpu"]) == 0
    finally:
        root.handlers[:], root.level = handlers, level
    app = served["app"]
    eng = next(e for e in (app.asr_engine, app.tts_engine, app.duplex_engine) if e is not None)
    try:
        assert eng.running and eng.mesh.shape == {"dp": 2, "tp": 2} and not eng.cuda_graph
        assert eng.state is None and len(eng.shards) == 2 and len(eng.shards[0]) == 2
        local = eng.shards[1][1].cfg.lm.transformer
        assert (local.num_heads, local.tp_shard) == (2, True) and local.hd == 16
        if name == "stt":
            assert not eng._pcm_wire_int16  # the file's int16 wire is not taken
    finally:
        eng.stop()
    if name == "duplex":  # a dialogue through the meshed engine after its loop
        events = []
        drv = eng.open_session(events.append)
        drv.push_pcm(np.zeros(eng.mimi_cfg.frame_size * 3, np.float32))
        for _ in range(3):
            eng.tick()
        eng.stop()
        assert drv.steps == 3


def test_builders_refuse_a_mesh_larger_than_the_cards():
    """On CUDA the shards are the cards and a mesh of more raises before any
    weight is made, as the JAX builder raises for its devices; the
    single-session engines take no mesh."""
    raw = _meshed_raw("tts", {"dp": torch.cuda.device_count() + 2})
    mod = tbuilder.CFG.Config.from_dict(raw).modules["tts"]
    with pytest.raises(ValueError, match="devices, have"):
        tbuilder.build_batched_tts(mod, "cuda")
    assert tbuilder.build_mesh_from_config(mod, "cpu").shape == {
        "dp": torch.cuda.device_count() + 2, "tp": 1}
    single = dataclasses.replace(mod, batch_size=1, raw=dict(mod.raw, batch_size=1))
    eng = tbuilder.build_tts(single, "cpu")
    assert not hasattr(eng, "mesh") or eng.mesh is None
    assert tbuilder.build_mesh_from_config(
        dataclasses.replace(mod, raw=dict(mod.raw, mesh={"dp": 1})), "cuda") is None
