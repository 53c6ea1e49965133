"""The port's TTS slice against the JAX package, piece by piece.

Inputs are made with numpy from a seed; weights come from the JAX init and
are carried over by the bridge.  Bars:

* threefry keys, random bits and Gumbel draws: bit for bit;
* sampled tokens (greedy, seeded, top-k, CFG halves): equal;
* int8 quantisation of the voice source: bit for bit;
* f32 paths: 1e-5 (the two frameworks sum in other orders), 1e-4 through
  a whole transformer or codec;
* the CA kernel's plain version against the Pallas kernel in interpret
  mode: 2e-2, the bar of tests/test_decode_attn.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.models import lm as jLM
from dsm_tpu.models import mimi as jMIMI
from dsm_tpu.ops import attention as jattn
from dsm_tpu.ops import decode_attn as jda
from dsm_tpu.ops import sampling as jS
from dsm_tpu.ops import transformer as jT
from dsm_tpu_torch.models import lm as tLM
from dsm_tpu_torch.models import mimi as tMIMI
from dsm_tpu_torch.ops import attention as tattn
from dsm_tpu_torch.ops import decode_attn as tda
from dsm_tpu_torch.ops import sampling as tS
from dsm_tpu_torch.ops import transformer as tT
from tests.test_torch_ops import JitStep, as_np, to_port

torch.set_num_threads(2)

F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _fields(cls, obj, **over):
    kw = {f: getattr(obj, f) for f in cls.__dataclass_fields__ if hasattr(obj, f)}
    kw.update(over)
    return cls(**kw)


def port_tcfg(j):
    return _fields(tT.TransformerConfig, j)


def port_lm_cfg(j):
    dep = None
    if j.depformer is not None:
        dep = _fields(tLM.DepFormerConfig, j.depformer,
                      transformer=port_tcfg(j.depformer.transformer))
    return _fields(tLM.LmConfig, j, transformer=port_tcfg(j.transformer), depformer=dep)


def port_mimi_cfg(m):
    return _fields(tMIMI.MimiConfig, m, seanet=_fields(tMIMI.SeaNetConfig, m.seanet),
                   transformer=port_tcfg(m.transformer))


def np64(x):
    return np.asarray(x).astype(np.int64)


# ---------------------------------------------------------------------------
# Seeded sampling: threefry, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 12345, 2**31 - 1, 4_000_000_000])
def test_keys_bits_and_gumbel_bit_exact(seed):
    jseed = jnp.asarray([seed], jnp.uint32)
    kj = jS.slot_keys(jseed, jnp.asarray([3], jnp.int32))
    kt = tS.slot_keys(torch.tensor([seed]), torch.tensor([3]))
    np.testing.assert_array_equal(kt.numpy(), np64(kj))
    np.testing.assert_array_equal(tS.fold_keys(kt, 101).numpy(), np64(jS.fold_keys(kj, 101)))
    key = jax.random.PRNGKey(seed % 2**31)
    tkey = tS.prng_key(seed % 2**31)
    np.testing.assert_array_equal(tkey.numpy(), np64(key))
    np.testing.assert_array_equal(tS.split(tkey, 3).numpy(), np64(jax.random.split(key, 3)))
    np.testing.assert_array_equal(tS.random_bits(tkey, (3, 257)).numpy(),
                                  np64(jax.random.bits(key, (3, 257))))
    gj = np.asarray(jax.random.gumbel(key, (4, 2048), jnp.float32))
    gt = tS.gumbel(tkey, (4, 2048)).numpy()
    np.testing.assert_array_equal(gt.view(np.int32), gj.view(np.int32))
    # Per-row keys: the vmapped draws of sample_per_slot.
    rows = jax.vmap(lambda k: jax.random.gumbel(k, (300,), jnp.float32))(kj)
    np.testing.assert_array_equal(tS.gumbel(kt, (300,)).numpy().view(np.int32),
                                  np.asarray(rows).view(np.int32))


def test_xla_log_matches_jax_log():
    u = np.random.default_rng(0).uniform(1e-30, 50.0, 100_000).astype(np.float32)
    u = np.concatenate([u, np.array([1.0, 2.0, 3e38], np.float32)])
    lj = np.asarray(jax.jit(jnp.log)(jnp.asarray(u)))
    lt = tS.xla_log(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(lt.view(np.int32), lj.view(np.int32))


@pytest.mark.parametrize("top_k", [None, 5, 250])
def test_sample_per_slot_tokens_equal(top_k):
    rng = np.random.default_rng(top_k or 1)
    logits = (rng.standard_normal((6, 300)) * 3).astype(np.float32)
    seeds = np.array([1, 2, 3, 4, 5, 6], np.uint32)
    steps = np.array([0, 1, 2, 3, 40, 500], np.int32)
    temp = np.array([0.8, 0.0, 1.0, 0.6, 2.0, -1.0], np.float32)
    kj = jS.fold_keys(jS.slot_keys(jnp.asarray(seeds), jnp.asarray(steps)), 1)
    kt = tS.fold_keys(tS.slot_keys(torch.from_numpy(seeds.astype(np.int64)),
                                   torch.from_numpy(steps)), 1)
    tj = jS.sample_per_slot(jnp.asarray(logits), kj, jnp.asarray(temp), top_k)
    tt = tS.sample_per_slot(torch.from_numpy(logits), kt, torch.from_numpy(temp), top_k)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    # The global-key samplers.
    key = jax.random.PRNGKey(9)
    cfg_j, cfg_t = jS.SamplingConfig(0.7, top_k), tS.SamplingConfig(0.7, top_k)
    np.testing.assert_array_equal(
        tS.sample(cfg_t, torch.from_numpy(logits), tS.prng_key(9)).numpy(),
        np.asarray(jax.jit(jS.sample, static_argnums=0)(cfg_j, jnp.asarray(logits), key)))
    np.testing.assert_array_equal(
        tS.sample_dynamic(torch.from_numpy(logits), tS.prng_key(9),
                          torch.from_numpy(temp), top_k).numpy(),
        np.asarray(jS.sample_dynamic(jnp.asarray(logits), key, jnp.asarray(temp), top_k)))


# ---------------------------------------------------------------------------
# Cross-attention
# ---------------------------------------------------------------------------


def _ca_cfg(d=512, heads=8, ca_dim=48, gating="normal"):
    return jT.TransformerConfig(d_model=d, num_heads=heads, num_layers=2,
                                dim_feedforward=2 * d, context=16, cross_attention=True,
                                ca_dim=ca_dim, ca_norm="layer_norm", ca_gating=gating)


def test_precompute_and_quantize_ca_kv_match_jax():
    cfg = _ca_cfg()
    params = jT.init(cfg, jax.random.PRNGKey(1))
    src = np.random.default_rng(2).standard_normal((2, 200, 48)).astype(np.float32)
    kj, vj = jT.precompute_ca_kv(cfg, params, jnp.asarray(src))
    pt = to_port({"transformer": params})["transformer"]
    kt, vt = tT.precompute_ca_kv(port_tcfg(cfg), pt, torch.from_numpy(src))
    assert kt.shape == kj.shape == (2, 2, 8, 200, 64)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **F32_TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **F32_TOL)
    # Quantisation of the same source: bit for bit.
    qj = jax.jit(jT.quantize_ca_kv, static_argnames="s_len")((kj, vj), s_len=200)
    qt = tT.quantize_ca_kv((torch.from_numpy(np.asarray(kj)),
                            torch.from_numpy(np.asarray(vj))), s_len=200)
    assert qt["k"].shape[3] == 256 and qt["s_len"] == int(qj["s_len"]) == 200
    for key in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(qt[key].numpy(), np.asarray(qj[key]))


def _ca_inputs(b, h, s, dh, seed, dtype=jnp.bfloat16):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, 1, dh)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, h, s, dh)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, h, s, dh)).astype(np.float32)
    qj = jnp.asarray(q).astype(dtype)
    cq = jT.quantize_ca_kv((jnp.asarray(k)[None], jnp.asarray(v)[None]), s_len=s)
    src = {key: cq[key][0] for key in ("k", "v", "ks", "vs")}
    return qj, src, cq["s_len"]


def test_cross_attend_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((2, 4, 3, 16), (2, 4, 9, 16), (2, 4, 9, 16)))
    yj = jattn.cross_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    yt = tattn.cross_attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32_TOL)
    qj, src, s_len = _ca_inputs(2, 4, 200, 16, 4, jnp.float32)
    yj = jattn.cross_attend_q(qj, src["k"], src["v"], src["ks"], src["vs"], s_len)
    st = {key: torch.from_numpy(np.asarray(x)) for key, x in src.items()}
    yt = tattn.cross_attend_q(torch.from_numpy(np.asarray(qj)), st["k"], st["v"],
                              st["ks"], st["vs"], int(s_len))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32_TOL)


@pytest.mark.parametrize("b,h,s,dh", [
    (2, 8, 200, 64),
    (1, 16, 625, 128),   # one slot of the TTS serving shape (625 -> 640)
    (2, 32, 256, 64),    # Dh=64 at H=32 (the JAX package takes kernel 10 there)
])
def test_ca_decode_attend_plain_matches_pallas_interpret(b, h, s, dh):
    qj, src, s_len = _ca_inputs(b, h, s, dh, seed=s + h)
    assert src["k"].shape[2] % 128 == 0
    n = jnp.asarray(s_len, jnp.int32).reshape((1,))
    yj = jda._ca_decode_attend_q_4d(qj[:, :, 0, :], src["k"], src["v"], src["ks"],
                                    src["vs"], n, interpret=True)[:, :, None, :]
    st = {key: torch.from_numpy(np.asarray(x)) for key, x in src.items()}
    qt = torch.from_numpy(np.asarray(qj.astype(jnp.float32))).bfloat16()
    assert tda.ca_supported(qt, st["k"])
    before = tda.ca_decode_attend.launches
    yt = tda.ca_decode_attend(qt, st["k"], st["v"], st["ks"], st["vs"], int(s_len))
    assert tda.ca_decode_attend.launches == before  # CPU tensors: the plain version
    assert yt.shape == (b, h, 1, dh) and yt.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(yt), as_np(yj), atol=2e-2, rtol=2e-2)


def test_ca_supported_matches_jax():
    for h, s, dh, t in ((8, 128, 64, 1), (4, 128, 64, 1), (8, 100, 64, 1),
                        (8, 256, 32, 1), (16, 640, 128, 2), (16, 640, 256, 1)):
        qj = jnp.zeros((1, h, t, dh), jnp.bfloat16)
        kj = jnp.zeros((1, h, s, dh), jnp.int8)
        qt = torch.zeros((1, h, t, dh), dtype=torch.bfloat16)
        kt = torch.zeros((1, h, s, dh), dtype=torch.int8)
        assert tda.ca_supported(qt, kt) == jda.ca_supported(qj, kj)


@pytest.mark.parametrize("form", ["bf16_tuple", "int8_dict"])
@pytest.mark.parametrize("gating", ["normal", "conditional_sigmoid"])
def test_transformer_step_with_cross_attention(monkeypatch, form, gating):
    """Both sides take the kernel order for the int8 source: the JAX step
    under DSM_DECODE_ATTN=1 (Pallas in interpret mode), the port the
    kernel's plain version."""
    monkeypatch.setenv("DSM_DECODE_ATTN", "1")
    cfg = _ca_cfg(gating=gating)
    params = jT.init(cfg, jax.random.PRNGKey(5))
    pt = to_port({"transformer": params})["transformer"]
    src = np.random.default_rng(6).standard_normal((2, 130, 48)).astype(np.float32)
    ca_j = jT.precompute_ca_kv(cfg, params, jnp.asarray(src))
    ca_t = tT.precompute_ca_kv(port_tcfg(cfg), pt, torch.from_numpy(src))
    if form == "int8_dict":
        ca_j = jax.jit(jT.quantize_ca_kv)(ca_j)
        ca_t = tT.quantize_ca_kv(tuple(torch.from_numpy(np.asarray(x)) for x in
                                       (jT.precompute_ca_kv(cfg, params, jnp.asarray(src)))))
        assert ca_t["k"].shape[3] == 256
    sj = jT.init_state(cfg, 2, jnp.float32)
    st = tT.init_state(port_tcfg(cfg), 2, torch.float32)
    rng = np.random.default_rng(7)
    tol = 2e-2 if form == "int8_dict" else 1e-4
    jstep = JitStep(cfg)
    for i in range(3):
        x = rng.standard_normal((2, 1, 512)).astype(np.float32)
        yj, sj = jstep(params, sj, jnp.asarray(x), ca_kv=ca_j)
        yt, st = tT.step(port_tcfg(cfg), pt, st, torch.from_numpy(x), ca_kv=ca_t)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=tol, rtol=tol)


def test_micro_step_matches_jax():
    cfg = jT.TransformerConfig(d_model=32, num_heads=2, num_layers=2, dim_feedforward=64,
                               context=4, positional_embedding="none")
    params = jT.init(cfg, jax.random.PRNGKey(8))
    pt = to_port({"transformer": params})["transformer"]
    kvj = jT.micro_init(cfg, 3, 4, jnp.float32)
    kvt = tT.micro_init(port_tcfg(cfg), 3, 4, torch.float32)
    rng = np.random.default_rng(9)
    for idx in range(4):
        x = rng.standard_normal((3, 32)).astype(np.float32)
        yj, kvj = jT.micro_step(cfg, params, kvj, jnp.asarray(x), jnp.int32(idx))
        yt, kvt = tT.micro_step(port_tcfg(cfg), pt, kvt, torch.from_numpy(x), idx)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
    for kj, kt in zip(kvj["k"], kvt["k"]):
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# DepFormer
# ---------------------------------------------------------------------------


def _small_lm(low_rank=None):
    from tests.test_tts import small_tts_cfg

    lm = small_tts_cfg().lm
    if low_rank:
        lm = jLM.LmConfig(**{**lm.__dict__, "depformer": jLM.DepFormerConfig(
            transformer=lm.depformer.transformer, num_slices=lm.depformer.num_slices,
            low_rank_embeddings=low_rank)})
    return lm


@pytest.mark.parametrize("mode", ["greedy", "seeded", "seeded_cfg", "key"])
@pytest.mark.parametrize("low_rank", [None, 8])
def test_depformer_sample_tokens_equal(mode, low_rank):
    lm = _small_lm(low_rank)
    params = jLM.init(lm, jax.random.PRNGKey(10))
    pt = to_port(params)
    assert len(pt["depformer"]["transformer"]) == 4  # slices
    assert len(pt["depformer"]["transformer"][0]) == 2  # layers
    cfg_t = port_lm_cfg(lm)
    b = 4
    rng = np.random.default_rng(11)
    for trial in range(3):
        hidden = (rng.standard_normal((b, 32)) * 2).astype(np.float32)
        text = rng.integers(0, 33, b).astype(np.int32)
        forced = np.where(rng.uniform(size=(b, 4)) < 0.3, 8, -1).astype(np.int32)
        kw_j, kw_t = {}, {}
        temp = 0.0 if mode == "greedy" else 1.0
        samp_j, samp_t = jS.SamplingConfig(temp, 3), tS.SamplingConfig(temp, 3)
        if mode.startswith("seeded"):
            n = b // 2 if mode == "seeded_cfg" else b
            seeds = np.arange(1, n + 1, dtype=np.uint32) * 7 + trial
            steps = np.full(n, trial, np.int32)
            kw_j["slot_keys"] = jS.fold_keys(
                jS.slot_keys(jnp.asarray(seeds), jnp.asarray(steps)), 2)
            kw_t["slot_keys"] = tS.fold_keys(
                tS.slot_keys(torch.from_numpy(seeds.astype(np.int64)),
                             torch.from_numpy(steps)), 2)
            temps = np.array([0.9, 0.0, 1.2, 0.5][:n], np.float32)
            kw_j["temperature"] = jnp.asarray(temps)
            kw_t["temperature"] = torch.from_numpy(temps)
        if mode == "seeded_cfg":
            alpha = np.array([1.0, 2.5], np.float32)
            kw_j["cfg_alpha"] = jnp.asarray(alpha)
            kw_t["cfg_alpha"] = torch.from_numpy(alpha)
        tj = jLM.depformer_sample(lm, params, jnp.asarray(hidden), jnp.asarray(text),
                                  jnp.asarray(forced), jax.random.PRNGKey(trial),
                                  samp_j, **kw_j)
        tt = tLM.depformer_sample(cfg_t, pt, torch.from_numpy(hidden),
                                  torch.from_numpy(text), torch.from_numpy(forced),
                                  tS.prng_key(trial), samp_t, **kw_t)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        if mode == "seeded_cfg":
            np.testing.assert_array_equal(tt[:2].numpy(), tt[2:].numpy())


def test_forced_audio_tokens_match_jax():
    lm = _small_lm()
    for lt in (True, False):
        np.testing.assert_array_equal(
            tLM.forced_audio_tokens(port_lm_cfg(lm), lt).numpy(),
            np.asarray(jLM.forced_audio_tokens(lm, lt)))


# ---------------------------------------------------------------------------
# Mimi decode
# ---------------------------------------------------------------------------


def test_mimi_decode_step_matches_jax():
    from tests.test_mimi import small_cfg

    mj = small_cfg()
    mt = port_mimi_cfg(mj)
    params = jMIMI.init(mj, jax.random.PRNGKey(12))
    pt = to_port(params)
    b = 3
    sj = jMIMI.init_decode_state(mj, b)
    st = tMIMI.init_decode_state(mt, b)
    rng = np.random.default_rng(13)
    for i in range(6):
        codes = rng.integers(0, mj.bins, (b, mj.n_q, 1)).astype(np.int32)
        m = np.array([True, i % 2 == 0, True])
        if i == 4:
            r = np.array([False, True, False])
            sj = jMIMI.reset_decode_state(sj, jnp.asarray(r))
            st = tMIMI.reset_decode_state(st, torch.from_numpy(r))
        pj, sj = jMIMI.decode_step(mj, params, sj, jnp.asarray(codes), jnp.asarray(m))
        pt_, st = tMIMI.decode_step(mt, pt, st, torch.from_numpy(codes), torch.from_numpy(m))
        assert pt_.shape == (b, 1, mj.frame_size)
        np.testing.assert_allclose(pt_.numpy(), np.asarray(pj), atol=1e-4, rtol=1e-4)
