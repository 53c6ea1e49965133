"""The port's tts_202501 path (48 layers of 32 heads x 64 in the model; two
layers and narrow widths here) against the JAX package's, on the CPU.

* The preset field for field; the DepFormer of 32 slices x 6 layers without
  low-rank embeddings crossing the bridge.
* ``ca_decode_attend_plain`` at h = 32, Dh = 64 against the head-major Pallas
  kernel ``_ca_decode_attend_q`` in interpret mode: atol = rtol = 2e-2, the
  bar of tests/test_decode_attn.py for a kernel against the XLA path.
* ``transformer.step`` with 32 heads x 64, int8 rings and the int8 voice
  source, both sides' routes counted: bf16, 3e-2.
* A small engine (32 heads x 64, DepFormer of 6 layers, int8 voice store of
  128 rows) against the JAX engine, which takes its Pallas kernels in
  interpret mode: f32, words and their times equal, frames within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.models import lm as jLM
from dsm_tpu.models import mimi as jMIMI
from dsm_tpu.ops import decode_attn as jda
from dsm_tpu.ops import ring_kernels as jrk
from dsm_tpu.ops import transformer as jT
from dsm_tpu.server.tts_batched import BatchedTtsEngine as JaxEngine
from dsm_tpu.sessions import tts as jTTS
from dsm_tpu.utils import tokenizer as jTOK
from dsm_tpu_torch.models import lm as tLM
from dsm_tpu_torch.ops import decode_attn as tda
from dsm_tpu_torch.ops import ring_kernels as trk
from dsm_tpu_torch.ops import transformer as tT
from dsm_tpu_torch.server import tts_batched as tTB
from dsm_tpu_torch.utils import tokenizer as tTOK
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_ops import JitStep, as_np, to_port
from tests.test_torch_stt26 import _Counts
from tests.test_torch_tts import _ca_inputs, port_lm_cfg, port_mimi_cfg, port_tcfg
from tests.test_torch_tts_serving import _drive, _summary, port_tts_cfg, spm_bytes

torch.set_num_threads(2)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package takes its Pallas kernels (interpret mode on the CPU)."""
    monkeypatch.setenv("DSM_RING_KERNEL", "1")
    monkeypatch.setenv("DSM_DECODE_ATTN", "1")
    for var in ("DSM_FUSED_ATTN", "DSM_KERNELS"):
        monkeypatch.delenv(var, raising=False)


def test_tts_202501_preset_matches_jax_field_for_field():
    j, t = jLM.tts_202501(), tLM.tts_202501()
    assert t == port_lm_cfg(j)
    tc, dc = t.transformer, t.depformer.transformer
    assert (tc.d_model, tc.num_heads, tc.hd, tc.num_layers, tc.dim_feedforward, tc.context,
            tc.max_period, tc.cross_attention, tc.ca_norm) == (
        2048, 32, 64, 48, 8192, 500, 10_000.0, True, "layer_norm")
    assert (t.depformer.num_slices, t.depformer.low_rank_embeddings, dc.d_model, dc.num_heads,
            dc.num_layers, dc.dim_feedforward, dc.context, dc.positional_embedding) == (
        32, None, 1024, 16, 6, 4096, 32, "none")
    assert (t.text_in_vocab_size, t.text_out_vocab_size, t.audio_vocab_size,
            t.audio_codebooks, t.generated_codebooks) == (8001, 8000, 2049, 32, 32)
    # Its rings take the split pipeline; its voice source is head-major in
    # the JAX package (kernel 10), one kernel through (b, h) strides here.
    assert tT.capacity(tc, 1, True) == 512
    q = torch.zeros(64, 32, 1, 64, dtype=torch.bfloat16)
    ring = torch.zeros(1, dtype=torch.int8).expand(64, 32, 512, 64)
    src = torch.zeros(1, dtype=torch.int8).expand(64, 32, 640, 64)
    plan = {"w": [5], "q_pos": [5]}
    assert not tda.fused_commit_supported(q, ring, plan) and tda.supported(q, ring, plan)
    assert tda.ca_supported(q, src) and not jda._legacy_4d(32, 64)


@pytest.mark.parametrize("b,s_real", [(2, 625), (1, 100), (3, 128)])
def test_ca_decode_attend_plain_matches_the_head_major_pallas_kernel(b, s_real):
    h, dh = 32, 64
    qj, src, s_len = _ca_inputs(b, h, s_real, dh, seed=s_real)
    s = src["k"].shape[2]
    assert s % 128 == 0 and int(s_len) == s_real  # quantize_ca_kv pads to 128 rows at h = 32
    g = b * h
    n = jnp.asarray(s_len, jnp.int32).reshape((1,))
    yj = jda._ca_decode_attend_q(
        qj[:, :, 0, :].reshape(g, 1, dh), src["k"].reshape(g, s, dh),
        src["v"].reshape(g, s, dh), src["ks"].reshape(g, 1, s), src["vs"].reshape(g, 1, s), n,
        h=h, interpret=True).reshape(b, h, 1, dh)
    # The dispatcher of the JAX package goes to the same kernel at this shape.
    yd = jda.ca_decode_attend(qj, src["k"], src["v"], src["ks"], src["vs"], s_len,
                              interpret=True)
    np.testing.assert_array_equal(as_np(yd), as_np(yj))
    st = {key: torch.from_numpy(np.asarray(x)) for key, x in src.items()}
    qt = torch.from_numpy(np.asarray(qj.astype(jnp.float32))).bfloat16()
    assert tda.ca_supported(qt, st["k"])
    before = tda.ca_decode_attend.launches
    yt = tda.ca_decode_attend(qt, st["k"], st["v"], st["ks"], st["vs"], int(s_len))
    assert tda.ca_decode_attend.launches == before  # CPU tensors: the plain version
    assert yt.shape == (b, h, 1, dh) and yt.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(yt), as_np(yj), atol=2e-2, rtol=2e-2)
    # A head-major copy of the source ((B*H, S, Dh) addressed as (1, B*H, ...)).
    flat = {key: x.reshape(1, g, *x.shape[2:]) for key, x in st.items()}
    yf = tda.ca_decode_attend(qt.reshape(1, g, 1, dh), flat["k"], flat["v"], flat["ks"],
                              flat["vs"], int(s_len))
    assert torch.equal(yf.reshape(b, h, 1, dh), yt)


def _small_202501(slices=4, dep_layers=6):
    """tts_202501 at 2 layers: 32 heads x 64 on a narrow model width,
    LayerNorm ``norm_cross``, DepFormer of 6 layers without low-rank
    embeddings."""
    return jLM.LmConfig(
        transformer=jT.TransformerConfig(
            d_model=64, num_heads=32, head_dim=64, num_layers=2, dim_feedforward=128,
            context=250, cross_attention=True, ca_norm="layer_norm", ca_dim=16),
        depformer=jLM.DepFormerConfig(
            transformer=jT.TransformerConfig(
                d_model=16, num_heads=2, num_layers=dep_layers, dim_feedforward=32,
                context=slices, positional_embedding="none"),
            num_slices=slices),
        text_in_vocab_size=33, text_out_vocab_size=32, audio_vocab_size=9,
        audio_codebooks=slices)


def test_tts_202501_tree_crosses_the_bridge():
    """32 slices x 6 stacked layers, no ``low_rank`` leaf, the
    cross-attention leaves of every LM layer."""
    lm = _small_202501(slices=32)
    params = jLM.init(lm, jax.random.PRNGKey(0))
    assert "low_rank" not in params["depformer"]
    pt = to_port(params)
    dep = pt["depformer"]
    assert "low_rank" not in dep and len(dep["transformer"]) == 32
    assert all(len(s) == 6 for s in dep["transformer"])
    assert dep["linear_in"].shape == (32, 16, 64) and dep["audio_embs"].shape == (31, 9, 16)
    assert len(pt["transformer"]) == 2
    for lp in pt["transformer"]:
        assert {"ca_q_w", "ca_kv_w", "ca_out_w", "norm_cross"} <= set(lp)
        assert lp["in_proj_w"].shape == (3 * 32 * 64, 64) and lp["ca_kv_w"].shape == (4096, 16)
    gen = torch.Generator().manual_seed(0)
    own = tLM.init(port_lm_cfg(lm), gen)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(own) == shapes(pt)


def test_step_at_32_heads_with_the_voice_matches_the_pallas_kernels(jax_kernels, monkeypatch):
    lm = _small_202501()
    cfg = lm.transformer
    params = jT.init(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    pt = to_port({"transformer": params})["transformer"]
    tcfg = port_tcfg(cfg)
    b, d = 2, cfg.d_model
    rng = np.random.default_rng(0)
    ca_tokens = (rng.standard_normal((b, 100, 16)) * 0.5).astype(np.float32)
    ca_j = jax.jit(jT.quantize_ca_kv)(jT.precompute_ca_kv(
        cfg, params, jnp.asarray(ca_tokens).astype(jnp.bfloat16)))
    ca_t = tT.quantize_ca_kv(tT.precompute_ca_kv(
        tcfg, pt, torch.from_numpy(ca_tokens).to(torch.bfloat16)))
    assert ca_t["k"].shape == (2, b, 32, 128, 64) and ca_t["s_len"] == 100
    for key in ("k", "v", "ks", "vs"):
        assert ca_t[key].shape == tuple(np.asarray(ca_j[key]).shape)
    sj = jT.init_state(cfg, b, jnp.bfloat16, kv_quant=True)
    st = tT.init_state(tcfg, b, kv_quant=True)
    assert st["layers"][0]["k"].shape == (b, 32, 256, 64)
    jcounts = _Counts(monkeypatch, [(jda, "_ca_decode_attend_q"), (jda, "_ca_decode_attend_q_4d"),
                                    (jda, "_decode_attend_q"), (jda, "_decode_attend_q_4d"),
                                    (jda, "_decode_attend_commit_q_4d"),
                                    (jrk, "_ring_commit_q"), (jrk, "_scale_commit")])
    tcounts = _Counts(monkeypatch, [(tda, "ca_decode_attend"), (trk, "ring_commit_q"),
                                    (tda, "decode_attend"), (trk, "scale_commit"),
                                    (tda, "decode_attend_commit"), (trk, "quantize_commit"),
                                    (trk, "quantize_scale_commit")])
    steps = 5
    jstep = JitStep(cfg)
    for i in range(steps):
        x = (rng.standard_normal((b, 1, d)) * 0.3).astype(np.float32)
        m = None if i != 3 else np.array([True, False])
        yj, sj = jstep(params, sj, jnp.asarray(x).astype(jnp.bfloat16),
                       None if m is None else jnp.asarray(m), ca_kv=ca_j)
        yt, st = tT.step(tcfg, pt, st, torch.from_numpy(x).to(torch.bfloat16),
                         None if m is None else torch.from_numpy(m), ca_kv=ca_t)
        np.testing.assert_allclose(as_np(yt), as_np(yj), atol=3e-2, rtol=3e-2)
    n, nj = 2 * steps, 2 * jstep.traces  # the JAX side counts its kernels per trace
    assert jcounts.nonzero() == {"_ca_decode_attend_q": nj, "_decode_attend_q": nj,
                                 "_ring_commit_q": nj}
    assert tcounts.nonzero() == {"ca_decode_attend": n, "quantize_commit": n, "decode_attend": n}
    np.testing.assert_array_equal(st["valid"].numpy(), np.asarray(sj["valid"]))


def _tts_cfg(**kw):
    defaults = dict(lm=_small_202501(), acoustic_delay=2, text_audio_delay_in_tokens=5,
                    max_steps=96, text_start_token=32, temperature=0.0, text_temperature=0.0)
    defaults.update(kw)
    return jTTS.TtsConfig(**defaults)


def test_small_tts_202501_engine_matches_the_jax_engine(jax_kernels):
    """Three sessions on two slots, two with voices of 100 rows in the int8
    voice store (128 rows: a shape both sides' T=1 kernels' order serves)."""
    jcfg = _tts_cfg()
    mimi_cfg = small_mimi_cfg()
    params = {"lm": jLM.init(jcfg.lm, jax.random.PRNGKey(0))}
    mimi_params = jMIMI.init(mimi_cfg, jax.random.PRNGKey(1))
    kw = dict(batch_size=2, ca_len=100, ca_quant=True)
    ej = JaxEngine(jcfg, params, mimi_cfg, mimi_params,
                   jTOK.SentencePieceModel.from_bytes(spm_bytes()), **kw)
    et = tTB.BatchedTtsEngine(port_tts_cfg(jcfg), to_port(params), port_mimi_cfg(mimi_cfg),
                              to_port(mimi_params),
                              tTOK.SentencePieceModel.from_bytes(spm_bytes()), device="cpu",
                              **kw)
    assert et._ca["k"].shape == (2, 2, 32, 128, 64) and et._ca["k"].dtype == torch.int8
    assert len(et.params["lm"]["depformer"]["transformer"][0]) == 6

    def voice(seed):
        tokens = jax.random.normal(jax.random.PRNGKey(seed), (1, 100, 16))
        return jT.precompute_ca_kv(jcfg.lm.transformer, params["lm"]["transformer"], tokens)

    voices = [voice(2), None, voice(3)]
    open_kw = [dict(seed=7, text_temperature=0.8, audio_temperature=0.9),
               dict(seed=8, audio_temperature=1.0),
               dict(seed=9, text_temperature=0.0, audio_temperature=0.7)]
    ev_j = _drive(ej, voices, lambda v: v, open_kw)
    ev_t = _drive(et, voices, lambda v: None if v is None else
                  tuple(torch.from_numpy(np.asarray(x)) for x in v), open_kw)
    for sj, st in zip(ev_j, ev_t):
        wj, fj, dj = _summary(sj)
        wt, ft, dt = _summary(st)
        assert dj == dt == 1
        assert wt == wj and len(wt) >= 2
        assert len(ft) == len(fj) >= 1
        for a, b in zip(ft, fj):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    assert et.step_count > 0 and et.used_slots() == 0
