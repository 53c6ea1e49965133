"""The Moshi 7B family in the port against the JAX package, on the CPU.

* The presets ``tts_v0_1``, ``moshi_v0_1`` and ``moshi_v0_1_streaming``
  (and its 8-slice dialogue layout) field for field; tts-1.6b as
  configs/config-tts.toml gives it.
* ``build_duplex``'s default model: ``moshi_v0_1_streaming(8)``, the layout
  of configs/models/moshi_7b.json (16 codebooks in, 8 generated); resolved
  without building weights, then an engine built on it.
* The dialogue step at that layout, cut to narrow widths (its codebook
  counts, delays and norms kept), token for token against the jitted JAX
  ``lm_gen.step`` over 12 steps on f32 rings and on int8 rings (the JAX
  side through its Pallas kernels in interpret mode): the tokens, frames and
  buffers equal.
* The JAX builder's default, ``moshi_v0_1_streaming(16)`` beside 8 input
  codebooks, cannot take a step: recorded.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.models import lm as jLM
from dsm_tpu.sessions import lm_gen as jGEN
from dsm_tpu_torch.models import lm as tLM
from dsm_tpu_torch.ops import sampling as tS
from dsm_tpu_torch.ops import transformer as tT
from dsm_tpu_torch.server import builder as tbuilder
from dsm_tpu_torch.server import config as tCFG
from dsm_tpu_torch.server import model_presets as tPRE
from dsm_tpu_torch.sessions import lm_gen as tGEN
from tests.test_torch_duplex import _state_equal, port_duplex_cfg
from tests.test_torch_ops import to_port
from tests.test_torch_tts import port_lm_cfg

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_EMB_LEAVES = {"text_emb", "audio_embs", "text_linear", "extra_heads", "linear_in",
               "linear_out", "low_rank"}


def np_lm_params(lm, seed: int) -> dict:
    """A JAX LM param tree of ``lm``'s shapes, distributed as the JAX init
    but made with numpy from ``seed`` (the JAX init compiles a program for
    each of its draws, some 15 s a model on the CPU): embeddings and the output
    and DepFormer projections ``N(0, 0.02)``, other linears ``U(+-1 /
    sqrt(in))``, norms at one and zero."""
    shapes = jax.eval_shape(functools.partial(jLM.init, lm), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [getattr(p, "key", None) for p in path]
        if names[-1] == "alpha":
            x = np.ones(s.shape)
        elif names[-1] == "bias":
            x = np.zeros(s.shape)
        elif names[-1] in _EMB_LEAVES and "mlp" not in names:
            x = 0.02 * rng.standard_normal(s.shape)
        else:
            x = rng.uniform(-1.0, 1.0, s.shape) / np.sqrt(s.shape[-1])
        return jnp.asarray(x.astype(np.float32))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def np_mimi_params(cfg, seed: int) -> dict:
    """A JAX Mimi param tree of ``cfg``'s shapes made with numpy from
    ``seed`` (see :func:`np_lm_params`): conv kernels ``U(+-1 / sqrt(in x
    k))``, biases zero, layer scales at ``cfg``'s, codebooks ``N(0, 1)``,
    other linears ``U(+-1 / sqrt(in))``, norms at one and zero."""
    from dsm_tpu.models import mimi as jMIMI

    shapes = jax.eval_shape(functools.partial(jMIMI.init, cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", None)
        if name == "alpha":
            x = np.ones(s.shape)
        elif name in ("bias", "b"):
            x = np.zeros(s.shape)
        elif name.startswith("layer_scale"):
            x = np.full(s.shape, cfg.transformer.layer_scale or 1.0)
        elif name == "embed":
            x = rng.standard_normal(s.shape)
        elif name == "w":
            x = rng.uniform(-1.0, 1.0, s.shape) / np.sqrt(s.shape[1] * s.shape[2])
        else:
            x = rng.uniform(-1.0, 1.0, s.shape) / np.sqrt(s.shape[-1])
        return jnp.asarray(x.astype(np.float32))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package takes its Pallas kernels (interpret mode on the CPU)."""
    monkeypatch.setenv("DSM_RING_KERNEL", "1")
    monkeypatch.setenv("DSM_DECODE_ATTN", "1")
    for var in ("DSM_FUSED_ATTN", "DSM_KERNELS", "DSM_KV_BITS"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("name,args", [("tts_v0_1", ()), ("moshi_v0_1", ()),
                                       ("moshi_v0_1_streaming", ()),
                                       ("moshi_v0_1_streaming", (8,))])
def test_presets_match_jax_field_for_field(name, args):
    j, t = getattr(jLM, name)(*args), getattr(tLM, name)(*args)
    assert t == port_lm_cfg(j)


def test_preset_values():
    m = tLM.moshi_v0_1()
    tc = m.transformer
    assert (tc.d_model, tc.num_heads, tc.hd, tc.num_layers, tc.dim_feedforward, tc.context,
            tc.max_period, tc.norm, tc.gating) == (4096, 32, 128, 32, 16384, 3000, 10_000.0,
                                                   "rms_norm", True)
    assert (m.audio_codebooks, m.generated_codebooks, m.text_in_vocab_size,
            m.text_out_vocab_size, m.text_start_token) == (8, 8, 32001, 32000, 32000)
    s = tLM.moshi_v0_1_streaming()
    assert (s.audio_codebooks, s.generated_codebooks) == (16, 16)
    v = tLM.tts_v0_1()
    tc = v.transformer
    assert (tc.d_model, tc.num_heads, tc.hd, tc.num_layers, tc.context, tc.norm, tc.gating,
            tc.cross_attention, tc.ca_dim, tc.ca_norm) == (2048, 32, 64, 48, 4096, "layer_norm",
                                                          False, True, None, "layer_norm")
    assert (v.audio_vocab_size, v.audio_codebooks, v.generated_codebooks) == (2050, 16, 16)
    # The rings of this slice's bf16 paths: (1, 32, 3008, 128) and (2, 32, 4096, 64).
    assert tT.capacity(m.transformer, 1, False) == 3008
    assert tT.capacity(tc, 1, False) == 4096
    assert tT.capacity(m.transformer, 1, True) == 3072


def test_offline_tts_default_is_the_shipped_toml_model():
    """The offline default TTS deployment is configs/config-tts.toml; the JAX
    tts-1.6b preset differs from its model only in its DepFormer's heads (11,
    ROADMAP's reference defects)."""
    from dsm_tpu_torch import offline as toffline

    assert toffline.DEFAULT_TTS_CONFIG == os.path.join(ROOT, "configs", "config-tts.toml")
    toml = tCFG.Config.load(toffline.DEFAULT_TTS_CONFIG).modules["tts"].lm
    j = port_lm_cfg(jLM.tts_1_6b_en_fr())
    assert j.depformer.transformer.num_heads == 11 != toml.depformer.transformer.num_heads
    fixed = dataclasses.replace(j, depformer=dataclasses.replace(
        j.depformer, transformer=dataclasses.replace(j.depformer.transformer, num_heads=16)))
    assert fixed == toml


def _lm_module(**raw):
    return tCFG.Config.from_dict({"modules": {"duplex": {"type": "Lm", **raw}}}).modules["duplex"]


def test_default_duplex_model_is_the_moshi_7b_layout():
    mod = _lm_module()
    assert mod.lm is None
    lm = tbuilder.duplex_model(mod)
    assert lm == tLM.moshi_v0_1_streaming(8)
    preset = tPRE.load_preset(os.path.join(ROOT, "configs", "models", "moshi_7b.json"))
    assert (lm.audio_codebooks, lm.generated_codebooks) == (
        preset.lm.audio_codebooks, preset.lm.generated_codebooks) == (16, 8)
    assert (lm.d_model, lm.transformer.num_heads, lm.transformer.num_layers) == (
        preset.lm.d_model, preset.lm.transformer.num_heads, preset.lm.transformer.num_layers)
    # A TOML that names its model keeps it.
    named = tCFG.Config.load(os.path.join(ROOT, "configs", "config-duplex-tpu-serving.toml"))
    mod = next(m for m in named.modules.values() if m.type == "Lm")
    assert tbuilder.duplex_model(mod) == mod.lm == tLM.s2s_2b_16rvq_202501()


def _cut(lm, **over):
    """``lm`` at narrow widths: its codebook counts, slices, norms, MLP and
    rope kept."""
    t = dataclasses.replace(lm.transformer, d_model=64, num_heads=4, num_layers=2,
                            dim_feedforward=128, context=24)
    d = lm.depformer
    dt = dataclasses.replace(d.transformer, d_model=32, num_heads=2, num_layers=2,
                             dim_feedforward=64)
    kw = dict(transformer=t, depformer=dataclasses.replace(d, transformer=dt),
              text_in_vocab_size=41, text_out_vocab_size=40, audio_vocab_size=33)
    kw.update(over)
    return dataclasses.replace(lm, **kw)


def test_build_duplex_without_a_model_builds_moshi_streaming_8(monkeypatch):
    """The engine's model is what ``moshi_v0_1_streaming(8)`` returns (cut
    here, so that the CPU can build it), with 8 generated and 8 input
    codebooks."""
    full = tLM.moshi_v0_1_streaming
    asked = []

    def cut(num_slices=16):
        asked.append(num_slices)
        return _cut(full(num_slices))

    monkeypatch.setattr(tbuilder.LM, "moshi_v0_1_streaming", cut)
    from tests.test_torch_tts_single import _small_v0_1

    monkeypatch.setattr(tbuilder.MIMI, "v0_1", _small_v0_1(True))
    eng = tbuilder.build_duplex(_lm_module(batch_size=2), "cpu")
    try:
        assert asked == [8]
        assert eng.cfg.lm == _cut(full(8))
        assert (eng.cfg.generated_audio_codebooks, eng.cfg.input_audio_codebooks) == (8, 8)
        assert eng.cfg.total_codebooks == eng.cfg.lm.audio_codebooks == 16
    finally:
        if hasattr(eng, "stop"):
            eng.stop()


def _duplex_cfg(lm):
    """The DuplexConfig both builders make of ``lm`` with no [generation]."""
    return jGEN.DuplexConfig(lm=lm, generated_audio_codebooks=lm.generated_codebooks or 8,
                             input_audio_codebooks=8, acoustic_delay=2,
                             text_start_token=lm.text_start_token, max_steps=32)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_moshi_dialogue_step_matches_jitted_jax(kv_quant, request):
    """12 steps, 2 slots, masks from step 3, slot 1 reset at step 7."""
    if kv_quant:
        request.getfixturevalue("jax_kernels")
    jcfg = _duplex_cfg(_cut(jLM.moshi_v0_1_streaming(8)))
    tcfg = port_duplex_cfg(jcfg)
    assert tcfg.lm == _cut(tLM.moshi_v0_1_streaming(8))
    params = {"lm": np_lm_params(jcfg.lm, 0)}
    pt = to_port(params)
    b = 2
    sj = jGEN.init_state(jcfg, b, cache_dtype=jnp.float32, kv_quant=kv_quant)
    st = tGEN.init_state(tcfg, b, cache_dtype=torch.float32, kv_quant=kv_quant)
    jstep = jax.jit(functools.partial(jGEN.step, jcfg))
    rng = np.random.default_rng(7)
    valid = 0
    for i in range(12):
        user = rng.integers(0, 32, (b, 8)).astype(np.int32)
        mask = rng.uniform(size=b) < 0.75 if i >= 3 else np.ones(b, bool)
        reset = np.array([False, i == 7])
        oj, sj = jstep(params, sj, jnp.asarray(user), jax.random.PRNGKey(200 + i),
                       mask=jnp.asarray(mask), reset=jnp.asarray(reset))
        ot, st = tGEN.step(tcfg, pt, st, torch.from_numpy(user), tS.prng_key(200 + i),
                           mask=torch.from_numpy(mask), reset=torch.from_numpy(reset))
        for key in ("text_token", "audio_tokens", "frame", "frame_valid"):
            np.testing.assert_array_equal(ot[key].numpy(), np.asarray(oj[key]),
                                          err_msg=f"step {i} {key}")
        valid += int(ot["frame_valid"].sum())
        assert ot["frame"].shape == (b, 8) and ot["audio_tokens"].shape == (b, 8)
    _state_equal(st, sj)
    assert valid >= 10
    if kv_quant:
        # Layer 0's int8 rows equal; their f32 scales within 1e-6 (the norm's
        # rsqrt rounds apart from XLA:CPU's: ROADMAP.md queue 3, item 2).
        layer_t, layer_j = st["lm"]["t"]["layers"][0], sj["lm"]["t"]["layers"][0]
        assert layer_t["k"].dtype == torch.int8
        for key in ("k", "v"):
            np.testing.assert_array_equal(layer_t[key].numpy(), np.asarray(layer_j[key]))
        for key in ("ks", "vs"):
            np.testing.assert_allclose(layer_t[key].numpy(), np.asarray(layer_j[key]),
                                       rtol=1e-6, atol=0)


def test_the_jax_builders_default_cannot_step():
    """``moshi_v0_1_streaming(16)`` has 16 embedding tables, but the JAX
    builder pairs its 16 generated codebooks with 8 input ones: 24 columns.
    The port's default is the 8-slice layout instead (ROADMAP.md, reference
    defects)."""
    jcfg = _duplex_cfg(_cut(jLM.moshi_v0_1_streaming(16)))
    assert (jcfg.generated_audio_codebooks, jcfg.input_audio_codebooks,
            jcfg.lm.audio_codebooks) == (16, 8, 16)
    params = {"lm": np_lm_params(jcfg.lm, 0)}
    sj = jGEN.init_state(jcfg, 1, cache_dtype=jnp.float32)
    with pytest.raises(ValueError, match="inconsistent sizes"):
        jGEN.step(jcfg, params, sj, jnp.zeros((1, 8), jnp.int32), jax.random.PRNGKey(0))
