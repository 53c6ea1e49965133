"""The port's batched TTS engine on a device mesh of the CPU against the JAX
package's meshed engine on its 8-device virtual mesh (``tests/conftest.py``);
the duplex engine, the builders and ``cli worker`` are in
``tests/test_torch_mesh_serving.py``.

At dp = 8 and dp = 4 x tp = 2 the port's engine gives the JAX meshed
engine's events (words, times, Done; audio within 1e-4) and the port's
unmeshed engine's: the TTS draws from per-slot keys, so under dp the draws
are the unmeshed ones at any temperature.  It runs its fused path (K = 2,
depth 2) with guidance and voices, and the single-tick path with the int8
voice store.  Odd sizes raise as in JAX.  The DepFormers here have an MLP
hidden of 32, which the JAX engines' GSPMD tp split needs (the port's
DepFormer runs whole on every shard).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dsm_tpu.parallel import mesh as jM
from dsm_tpu.server.tts_batched import BatchedTtsEngine as JaxTts
from dsm_tpu.utils import tokenizer as jTOK
from dsm_tpu_torch.parallel import mesh as tM
from dsm_tpu_torch.server import tts_batched as tTB
from dsm_tpu_torch.utils import tokenizer as tTOK
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_moshi import np_lm_params, np_mimi_params
from tests.test_torch_ops import to_port
from tests.test_torch_tts import port_mimi_cfg
from tests.test_torch_tts_fused import _to_port_voice
from tests.test_torch_tts_serving import _summary as _tts_summary
from tests.test_torch_tts_serving import _voice, port_tts_cfg, spm_bytes
from tests.test_tts import small_tts_cfg

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
MESHES = [(8, 1), (4, 2)]


@pytest.fixture(autouse=True)
def eight_devices():
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")


def _dep48(cfg):
    """``cfg`` with a DepFormer MLP hidden of 32 (feed-forward 48)."""
    dep = cfg.lm.depformer
    return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, depformer=dataclasses.replace(
        dep, transformer=dataclasses.replace(dep.transformer, dim_feedforward=48))))


def _same_events(got, want, atol, frames_at):
    """Per session a summary whose item ``frames_at`` holds the audio frames
    (TTS: ``(words, frames, done)``, duplex: ``(kinds, texts, frames)``):
    everything equal but the frames, which agree within ``atol``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [x for i, x in enumerate(g) if i != frames_at] == [
            x for i, x in enumerate(w) if i != frames_at]
        assert len(g[frames_at]) == len(w[frames_at])
        for a, b in zip(g[frames_at], w[frames_at]):
            np.testing.assert_allclose(a, b, atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# TTS
# ---------------------------------------------------------------------------

TTS_TEXTS = ["abc fed", "gab c", "hak kij", "a b", "fig"]


def _tts_drive(eng, params, jcfg, to_voice):
    """Four sessions on eight slots (voices on three, guidance and text
    temperature 0.8 on two), then a fifth once the first has finished."""
    ev = [[] for _ in range(5)]

    def open_(i):
        kw = dict(seed=7 + i, text_temperature=0.8 if i % 2 else 0.0, audio_temperature=0.9,
                  cfg_alpha=1.5 if i % 2 else None)
        voice = _voice(jcfg, params, 2 + i) if i % 3 != 1 else None
        drv = eng.open_session(ev[i].append, voice_ca=to_voice(voice), **kw)
        words, _ = eng.encode_words(TTS_TEXTS[i], inserted_bos=False)
        drv.feed_words(words)
        drv.end_input()
        return drv

    live = {i: open_(i) for i in range(4)}
    for _ in range(150):
        if not eng.tick():
            break
        for i, drv in list(live.items()):
            if any(type(e).__name__ == "DoneEvent" for e in ev[i]):
                eng.close_session(drv)
                del live[i]
                if 4 not in live and not ev[4]:
                    live[4] = open_(4)
    for drv in live.values():
        eng.close_session(drv)
    eng.stop()
    return [_tts_summary(e) for e in ev]


def _tts_engines(mesh_shape, with_jax=True, **kw):
    jcfg = _dep48(small_tts_cfg(max_steps=96))
    mimi_cfg = small_mimi_cfg()
    params = {"lm": np_lm_params(jcfg.lm, 0)}
    mimi_params = np_mimi_params(mimi_cfg, 1)
    kw = dict(batch_size=8, ca_len=6, cfg_enabled=True, fuse_ticks=2, pipeline_depth=2, **kw)

    def port(mesh):
        return tTB.BatchedTtsEngine(port_tts_cfg(jcfg), to_port(params), port_mimi_cfg(mimi_cfg),
                                    to_port(mimi_params),
                                    tTOK.SentencePieceModel.from_bytes(spm_bytes()),
                                    device="cpu", mesh=mesh, **kw)

    dp, tp = mesh_shape
    ej = JaxTts(jcfg, params, mimi_cfg, mimi_params,
                jTOK.SentencePieceModel.from_bytes(spm_bytes()),
                mesh=jM.make_mesh(dp=dp, tp=tp), **kw) if with_jax else None
    return jcfg, params, ej, port(tM.make_mesh(dp, tp, devices=CPU8)), port(None)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_tts_engine_on_a_mesh_matches_the_jax_meshed_engine(dp, tp):
    """The fused path (2 frames a dispatch, two in flight), guidance rows
    split with their slots, voices split over rows and heads: every
    session's words, times, Done and frame count as the JAX meshed engine's
    and the port's unmeshed engine's; audio within 1e-4 and 1e-5."""
    jcfg, params, ej, et, e1 = _tts_engines((dp, tp))
    assert et.state is None and len(et.shards) == dp and len(et.shards[0]) == tp
    sh = et.shards[-1][-1]
    assert sh.rows == 2 * 8 // dp and sh.cfg.lm.transformer.num_heads == 4 // tp
    assert sh._ca[0].shape[1:3] == (2 * 8 // dp, 4 // tp)
    want = _tts_drive(ej, params, jcfg, lambda v: v)
    got = _tts_drive(et, params, jcfg, _to_port_voice)
    one = _tts_drive(e1, params, jcfg, _to_port_voice)
    assert all(done == 1 for _, _, done in got) and sum(len(w) for w, _, _ in got) >= 8
    _same_events(got, want, 1e-4, 1)
    _same_events(got, one, 1e-5, 1)
    assert not et._inflight_f


def test_tts_engine_on_a_mesh_single_tick_and_int8_voices():
    """The single-tick path with the int8 voice store at dp = 2 x tp = 2: the
    pad overwrite between ticks reaches every shard; events as the port's
    unmeshed engine's."""
    jcfg, params, _, et, e1 = _tts_engines((4, 2), with_jax=False, ca_quant=True)
    for e in (et, e1):
        e.fuse, e.pipeline_depth = 1, 1
        for sh in (s for row in getattr(e, "shards", []) for s in row):
            sh.fuse, sh.pipeline_depth = 1, 1
    assert isinstance(et.shards[0][1]._ca, dict)
    _same_events(_tts_drive(et, params, jcfg, _to_port_voice),
                 _tts_drive(e1, params, jcfg, _to_port_voice), 1e-5, 1)


def test_tts_engine_checks_rows_and_heads_as_jax():
    jcfg, params, _, _, _ = _tts_engines((8, 1), with_jax=False)
    kw = dict(batch_size=6, ca_len=6)
    tok = tTOK.SentencePieceModel.from_bytes(spm_bytes())
    args = (port_tts_cfg(jcfg), to_port(params), port_mimi_cfg(small_mimi_cfg()),
            to_port(np_mimi_params(small_mimi_cfg(), 1)), tok)
    with pytest.raises(ValueError, match="rows 6 not divisible by dp=4"):
        tTB.BatchedTtsEngine(*args, device="cpu", mesh=tM.make_mesh(4, 1, devices=CPU8), **kw)
    with pytest.raises(ValueError, match="num_heads 4 not divisible by tp=3"):
        tTB.BatchedTtsEngine(*args, device="cpu", mesh=tM.make_mesh(2, 3, devices=CPU8), **kw)
    with pytest.raises(ValueError, match="no CUDA graph on cpu"):
        tTB.BatchedTtsEngine(*args, device="cpu", mesh=tM.make_mesh(2, 1, devices=CPU8),
                             cuda_graph=True, **kw)
