"""The port's legacy T5-conditioned TTS (``sessions/tts_legacy.py``) against
the JAX package's, on the CPU, at the layout of ``tts_v0_1`` cut to narrow
widths (LayerNorm blocks, a GELU MLP without gating, cross-attention over
the model's width, 16 codebooks, the DepFormer's 16 slices, delay 2; an
audio vocab of 66: 64 bins, the end-of-generation id and the pad).

* ``conditions`` within 1e-5 (f32 sums in other orders), with and without
  a speaker sample through the small Mimi of tests/test_mimi.py.
* ``step`` over 20 steps against the jitted JAX step, guidance off and on,
  bf16 rings: the tokens, the end-of-generation flags and the delayed
  buffer equal.
* ``sample`` equal to JAX's for several seeds, guidance off and on, the
  end-of-generation flush and the cut to the leading valid frames included.
* ``encode_text_t5`` raises without ``transformers``.
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.models import lm as jLM
from dsm_tpu.ops import transformer as jT
from dsm_tpu.sessions import tts_legacy as jL
from dsm_tpu_torch.ops import sampling as tS
from dsm_tpu_torch.ops import transformer as tT
from dsm_tpu_torch.sessions import tts_legacy as tL
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_moshi import np_lm_params, np_mimi_params
from tests.test_torch_ops import to_port
from tests.test_torch_tts import _fields, port_lm_cfg, port_mimi_cfg

torch.set_num_threads(2)

MAX_STEPS = 30


def _cfgs(**over):
    v = jLM.tts_v0_1()
    lm = dataclasses.replace(
        v, transformer=dataclasses.replace(v.transformer, d_model=32, num_heads=4, num_layers=2,
                                           dim_feedforward=64, context=64),
        depformer=dataclasses.replace(v.depformer, transformer=dataclasses.replace(
            v.depformer.transformer, d_model=16, num_heads=2, num_layers=1,
            dim_feedforward=32)),
        text_in_vocab_size=11, text_out_vocab_size=11, audio_vocab_size=66)
    kw = dict(lm=lm, mimi=small_mimi_cfg(), max_duration_s=3.0, temperature=0.8, top_k=20)
    kw.update(over)
    jcfg = jL.LegacyTtsConfig(**kw)
    return jcfg, _fields(tL.LegacyTtsConfig, jcfg, lm=port_lm_cfg(lm),
                         mimi=port_mimi_cfg(jcfg.mimi))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    assert (tcfg.lm.transformer.norm, tcfg.lm.transformer.gating, tcfg.lm.audio_codebooks,
            tcfg.lm.generated_codebooks, tcfg.quantizer_bins) == ("layer_norm", False, 16, 16, 64)
    params = {"lm": np_lm_params(jcfg.lm, 0), "mimi": np_mimi_params(jcfg.mimi, 1)}
    rng = np.random.default_rng(2)
    inputs = {
        "text_states": rng.standard_normal((1, 6, 12)).astype(np.float32),
        "t5_proj": (rng.standard_normal((12, 32)) * 0.3).astype(np.float32),
        "speaker_proj": (rng.standard_normal((32, 32)) * 0.3).astype(np.float32),
        "speaker_pcm": (rng.standard_normal((1, 1, int(0.48 * jcfg.mimi.sample_rate)))
                        * 0.3).astype(np.float32),
    }
    return jcfg, tcfg, params, to_port(params), inputs


def _sources(model, speaker):
    jcfg, tcfg, params, pt, x = model
    keys = ("text_states", "t5_proj") + (("speaker_pcm", "speaker_proj") if speaker else ())
    cj = jL.conditions(jcfg, params, *[jnp.asarray(x[k]) for k in keys])
    ct = tL.conditions(tcfg, pt, *[torch.from_numpy(x[k]) for k in keys])
    return cj, ct


@pytest.mark.parametrize("speaker", [False, True])
def test_conditions_match_jax(model, speaker):
    cj, ct = _sources(model, speaker)
    assert ct.dtype == torch.float32
    assert ct.shape == ((2, 6 + 2 * 6, 32) if speaker else (1, 6, 32))  # 6 codec frames
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("alpha", [None, 2.0])
def test_step_matches_jitted_jax_over_20_steps(model, alpha):
    jcfg, tcfg, params, pt, _ = model
    cj, ct = _sources(model, alpha is not None)
    ca_j = jT.precompute_ca_kv(jcfg.lm.transformer, params["lm"]["transformer"], cj)
    ca_t = tT.precompute_ca_kv(tcfg.lm.transformer, pt["lm"]["transformer"], ct)
    rows = 1 if alpha is None else 2
    sj, st = jL.init_state(jcfg, rows), tL.init_state(tcfg, rows)
    assert st["lm"]["t"]["layers"][0]["k"].dtype == torch.bfloat16
    jstep = jax.jit(functools.partial(jL.step, jcfg, cfg_alpha=alpha))
    eogs = []
    for i in range(20):
        oj, sj = jstep(params, sj, jax.random.PRNGKey(30 + i), ca_j)
        ot, st = tL.step(tcfg, pt, st, tS.prng_key(30 + i), ca_t, cfg_alpha=alpha)
        np.testing.assert_array_equal(ot["tokens"].numpy(), np.asarray(oj["tokens"]),
                                      err_msg=f"step {i}")
        assert bool(ot["end_of_gen"]) == bool(oj["end_of_gen"])
        eogs.append(bool(ot["end_of_gen"]))
    np.testing.assert_array_equal(st["audio_tokens"].numpy(), np.asarray(sj["audio_tokens"]))
    assert int(st["step_idx"]) == 20 and any(eogs)
    # Codebook 0 written at its step, the acoustic ones two steps behind.
    buf = st["audio_tokens"].numpy()
    assert (buf[:20, 0] >= 0).all() and (buf[20:, 0] == tL.UNSET).all()
    assert (buf[:18, 1:] >= 0).all() and (buf[18:, 1:] == tL.UNSET).all()


@pytest.mark.parametrize("alpha", [None, 2.0])
def test_sample_matches_jax_with_the_end_of_gen_flush(model, alpha):
    jcfg, tcfg, params, pt, _ = model
    cj, ct = _sources(model, alpha is not None)
    lengths = []
    for seed in range(4):
        want = jL.sample(jcfg, params, cj, seed=seed, cfg_alpha=alpha, max_steps=MAX_STEPS)
        got = tL.sample(tcfg, pt, ct, seed=seed, cfg_alpha=alpha, max_steps=MAX_STEPS)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
        assert ((got >= 0) & (got < tcfg.quantizer_bins)).all()
        lengths.append(len(got))
    assert 0 < max(lengths) < MAX_STEPS - 2  # generation ended on its own


def test_sample_refuses_a_source_of_the_wrong_rows(model):
    _, tcfg, _, pt, _ = model
    with pytest.raises(ValueError, match="rows"):
        tL.sample(tcfg, pt, torch.zeros(1, 3, 32), cfg_alpha=2.0)


def test_encode_text_t5_raises_without_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="transformers"):
        tL.encode_text_t5("hello")
