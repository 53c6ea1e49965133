"""The port's speaker encoder (``models/speaker.py``), Mimi's
pre-quantisation encode, ``.wav`` voices and the conditioners against the
JAX package, at the small config of tests/test_voices.py (a 4-filter
SEANet, a 2-layer codec transformer, 600 Hz audio).

Bars: ``encode_pre_quantize``, ``speaker.encode``, ``speaker.empty`` and a
``.wav`` voice through the resolver within atol 2e-5 and rtol 1e-5 of the
JAX values (the convolutions, the codec transformer and the sinusoids sum
and round in other orders); ``conv.forward`` / ``tr_forward`` and
``transformer.forward`` within 1e-5; the continuous conditioner within
atol 1e-5 (``pow``, ``cos`` and ``sin`` of f32 round apart by an ulp); the
weights ``load_params`` adopts, and its count, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.models import conditioner as jCOND
from dsm_tpu.models import mimi as jMIMI
from dsm_tpu.models import speaker as jSPK
from dsm_tpu.ops import conv as jC
from dsm_tpu.ops import transformer as jT
from dsm_tpu.server import voices as jV
from dsm_tpu.utils.audio import write_wav
from dsm_tpu_torch.models import conditioner as tCOND
from dsm_tpu_torch.models import mimi as tMIMI
from dsm_tpu_torch.models import speaker as tSPK
from dsm_tpu_torch.ops import conv as tC
from dsm_tpu_torch.ops import transformer as tT
from dsm_tpu_torch.server import voices as tV
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_ops import to_port
from tests.test_torch_tts import _fields, port_mimi_cfg, port_tcfg

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=1e-5)


def _setup():
    jm = small_mimi_cfg()
    jcfg = jSPK.SpeakerEncoderConfig(cond_dim=24, n_speakers=2, duration_s=0.96, mimi=jm)
    tcfg = tSPK.SpeakerEncoderConfig(cond_dim=24, n_speakers=2, duration_s=0.96,
                                     mimi=port_mimi_cfg(jm))
    sp = jSPK.init(jcfg, jax.random.PRNGKey(0))
    mp = jMIMI.init(jm, jax.random.PRNGKey(1))
    return jcfg, tcfg, sp, mp


@pytest.mark.parametrize("k,stride,dilation,pad_mode,t", [
    (7, 1, 1, "constant", 50), (3, 1, 4, "constant", 33), (8, 4, 1, "replicate", 30),
    (4, 2, 1, "replicate", 7), (1, 1, 1, "constant", 5)])
def test_conv_forward_matches_jax(k, stride, dilation, pad_mode, t):
    jcfg = jC.ConvConfig(3, 5, k, stride=stride, dilation=dilation, pad_mode=pad_mode)
    params = jC.init(jcfg, jax.random.PRNGKey(k))
    x = np.random.default_rng(t).standard_normal((2, 3, t)).astype(np.float32)
    yj = np.asarray(jC.forward(jcfg, params, jnp.asarray(x)))
    yt = tC.forward(_fields(tC.ConvConfig, jcfg), to_port(params), torch.from_numpy(x))
    assert yt.shape == yj.shape
    np.testing.assert_allclose(yt.numpy(), yj, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("groups", [1, 4])
def test_conv_transpose_forward_matches_jax(groups):
    jcfg = jC.ConvTrConfig(4, 4, 6, stride=3, groups=groups, bias=groups == 1)
    params = jC.tr_init(jcfg, jax.random.PRNGKey(groups))
    x = np.random.default_rng(groups).standard_normal((2, 4, 9)).astype(np.float32)
    yj = np.asarray(jC.tr_forward(jcfg, params, jnp.asarray(x)))
    yt = tC.tr_forward(_fields(tC.ConvTrConfig, jcfg), to_port(params), torch.from_numpy(x))
    assert yt.shape == yj.shape == (2, 4, 27)
    np.testing.assert_allclose(yt.numpy(), yj, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pe", ["rope", "sin", "none"])
def test_transformer_forward_matches_jax(pe):
    jcfg = jT.TransformerConfig(d_model=32, num_heads=4, num_layers=2, dim_feedforward=64,
                                context=6, positional_embedding=pe, norm="layer_norm",
                                gating=pe != "none", layer_scale=0.1)
    params = jT.init(jcfg, jax.random.PRNGKey(3))
    x = np.random.default_rng(4).standard_normal((2, 13, 32)).astype(np.float32)
    yj = np.asarray(jT.forward(jcfg, params, jnp.asarray(x)))
    layers = to_port({"transformer": params})["transformer"]
    yt = tT.forward(port_tcfg(jcfg), layers, torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), yj, atol=1e-5, rtol=1e-5)


def test_encode_pre_quantize_matches_jax():
    jcfg, tcfg, _sp, mp = _setup()
    pcm = np.random.default_rng(5).standard_normal((2, 1, 24 * 30)).astype(np.float32) * 0.1
    yj = np.asarray(jMIMI.encode_pre_quantize(jcfg.mimi, mp, jnp.asarray(pcm)))
    yt = tMIMI.encode_pre_quantize(tcfg.mimi, to_port(mp), torch.from_numpy(pcm))
    assert yt.shape == yj.shape == (2, 32, 15)
    np.testing.assert_allclose(yt.numpy(), yj, **TOL)


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_speaker_encode_and_empty_match_jax(n):
    jcfg, tcfg, sp, mp = _setup()
    rng = np.random.default_rng(6 + n)
    pcms = [rng.standard_normal(576).astype(np.float32) * (0.05 + i) for i in range(n)]
    yj = np.asarray(jSPK.encode(jcfg, sp, mp, [jnp.asarray(p) for p in pcms]))
    yt = tSPK.encode(tcfg, to_port(sp), to_port(mp), [torch.from_numpy(p) for p in pcms])
    assert yt.shape == yj.shape == (1, 24, 24)
    np.testing.assert_allclose(yt.numpy(), yj, **TOL)
    ej = np.asarray(jSPK.empty(jcfg, sp))
    et = tSPK.empty(tcfg, to_port(sp))
    np.testing.assert_allclose(et.numpy(), ej, **TOL)


def test_wav_voice_through_the_resolver_matches_jax(tmp_path):
    jcfg, tcfg, sp, mp = _setup()
    vd = tmp_path / "voices"
    vd.mkdir()
    sr = int(jcfg.mimi.sample_rate)
    write_wav(str(vd / "w.wav"), np.random.default_rng(7).standard_normal(sr * 2)
              .astype(np.float32) * 0.1, sr)
    write_wav(str(vd / "short.wav"), np.random.default_rng(8).standard_normal(200)
              .astype(np.float32) * 0.1, sr)
    rj = jV.VoiceResolver(voice_dir=str(vd), speaker_cfg=jcfg, speaker_params=sp,
                          mimi_params=mp)
    rt = tV.VoiceResolver(voice_dir=str(vd), speaker_cfg=tcfg, speaker_params=to_port(sp),
                          mimi_params=to_port(mp))
    for spec in ("w.wav+0.5", "w", "short.wav"):  # an offset, the probe, zero padding
        cj, ct = rj.resolve(spec), rt.resolve(spec)
        assert ct.dtype == np.float32 and ct.shape == cj.shape == (1, 24, 24)
        np.testing.assert_allclose(ct, cj, **TOL)
    assert rt.resolve("w") is rt.resolve("w")  # cached
    with pytest.raises(RuntimeError, match="speaker encoder"):
        tV.VoiceResolver(voice_dir=str(vd)).resolve("w")


def test_voice_cache_projects_once():
    jcfg = jT.TransformerConfig(d_model=32, num_heads=4, num_layers=2, dim_feedforward=64,
                                context=8, cross_attention=True, ca_dim=24)
    params = to_port({"transformer": jT.init(jcfg, jax.random.PRNGKey(9))})["transformer"]
    cache = tSPK.VoiceCache(port_tcfg(jcfg), params, capacity=1)
    calls = []

    def tokens():
        calls.append(1)
        return torch.ones((1, 5, 24))

    k, v = cache.get("a", tokens)
    assert k.shape == (2, 1, 4, 5, 8) and cache.get("a", tokens)[0] is k
    cache.get("b", tokens)
    cache.get("a", tokens)
    assert len(calls) == 3


def _provider_pair():
    raw = {"delay": {"type": "ContinuousAttribute", "dim": 16, "scale_factor": 0.5,
                     "max_period": 100.0},
           "description": {"type": "Lut", "n_bins": 3, "dim": 8,
                           "possible_values": ["bad", "ok", "good"]}}
    pj = jCOND.ConditionProvider(32, jCOND.configs_from_toml(raw), jax.random.PRNGKey(10))
    pt = tCOND.ConditionProvider(32, tCOND.configs_from_toml(raw), torch.Generator())
    return pj, pt


def test_continuous_attribute_conditioner_matches_jax():
    pj, pt = _provider_pair()
    assert isinstance(pt.configs["delay"], tCOND.ContinuousAttributeConfig)
    assert set(pt.params["delay"]) == set(pj.params["delay"])
    assert set(pt.params["description"]) == set(pj.params["description"])
    pt.params = to_port(jax.tree_util.tree_map(np.asarray, pj.params))
    for value in (0.0, -2.0, 6.5, 120.0):
        cj = np.asarray(pj.condition_cont("delay", value))
        ct = pt.condition_cont("delay", value).numpy()
        assert ct.shape == cj.shape == (1, 32)
        np.testing.assert_allclose(ct, cj, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(pt.learnt_padding("delay").numpy(),
                                  np.asarray(pj.learnt_padding("delay")))
    with pytest.raises(TypeError):
        pt.condition_cont("description", 1.0)
    with pytest.raises(TypeError):
        pt.condition_lut("delay", "ok")


def test_load_params_adopts_the_checkpoint_conditioners():
    pj, pt = _provider_pair()
    rng = np.random.default_rng(11)
    prefix = "condition_provider.conditioners"
    tensors = {
        f"{prefix}.description.embed.weight": rng.standard_normal((4, 8)).astype(np.float32),
        f"{prefix}.description.output_proj.weight":
            rng.standard_normal((32, 8)).astype(np.float32),
        f"{prefix}.description.learnt_padding": rng.standard_normal((1, 1, 32))
            .astype(np.float32),
        f"{prefix}.delay.output_proj.weight": rng.standard_normal((32, 16)).astype(np.float32),
        f"{prefix}.delay.embed.weight": rng.standard_normal((4, 8)).astype(np.float32),
        "transformer.layers.0.x": np.zeros(3, np.float32),
    }
    nj, nt = pj.load_params(tensors), pt.load_params(tensors)
    assert nt == nj == 4
    adopted = [("description", "embed"), ("description", "output_proj"),
               ("description", "learnt_padding"), ("delay", "output_proj")]
    for name, key in adopted:
        got = pt.params[name][key]
        assert got.shape == pj.params[name][key].shape == (
            (1, 32) if key == "learnt_padding" else got.shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pj.params[name][key]))
    np.testing.assert_allclose(pt.condition_lut("description", "good").numpy(),
                               np.asarray(pj.condition_lut("description", "good")),
                               atol=1e-6, rtol=1e-6)
