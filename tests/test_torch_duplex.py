"""The port's full-duplex dialogue step against the JAX package's, at small
sizes, on weights carried over by the bridge.

* ``transformer.step`` on int8 rings: the shape rule picks the split
  pipeline (``ring_commit`` with the scales, then ``decode_attend``) where
  the JAX package takes its c-blocked Pallas kernel (interpret mode here),
  and the fused pipeline where it takes the fused kernel; bf16, 3e-2, the
  bar of tests/test_decode_attn.py for a kernel against the XLA path.
* The s2s-2b preset, the 16-slice x 6-layer DepFormer with one key for the
  whole batch, and ``lm_gen.step`` over 14 steps with masks, a reset and
  the ASR-delay mode: f32, the tokens equal (the port's threefry and its
  copy of XLA's ``log`` make the Gumbel noise bit for bit the same).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.models import lm as jLM
from dsm_tpu.ops import sampling as jS
from dsm_tpu.ops import transformer as jT
from dsm_tpu.sessions import lm_gen as jGEN
from dsm_tpu_torch.models import lm as tLM
from dsm_tpu_torch.ops import decode_attn as tda
from dsm_tpu_torch.ops import ring_kernels as trk
from dsm_tpu_torch.ops import sampling as tS
from dsm_tpu_torch.ops import transformer as tT
from dsm_tpu_torch.sessions import lm_gen as tGEN
from tests.test_torch_ops import JitStep, as_np, to_port
from tests.test_torch_tts import _fields, port_lm_cfg, port_tcfg

torch.set_num_threads(2)


def port_duplex_cfg(j):
    return _fields(tGEN.DuplexConfig, j, lm=port_lm_cfg(j.lm))


# ---------------------------------------------------------------------------
# transformer.step: the shape rule and the split route
# ---------------------------------------------------------------------------


class _Routes:
    """Counts which seam of the port's step each call went through."""

    def __init__(self, monkeypatch):
        self.calls = {"quantize_scale_commit": 0, "decode_attend_commit": 0,
                      "quantize_commit": 0, "decode_attend": 0, "scale_commit": 0,
                      "ring_commit_q": 0}
        for mod, name in ((trk, "quantize_scale_commit"), (tda, "decode_attend_commit"),
                          (trk, "quantize_commit"), (tda, "decode_attend"),
                          (trk, "scale_commit"), (trk, "ring_commit_q")):
            monkeypatch.setattr(mod, name, self._counted(getattr(mod, name), name))

    def _counted(self, fn, name):
        def wrapped(*a, **kw):
            self.calls[name] += 1
            return fn(*a, **kw)
        return wrapped


@pytest.mark.parametrize("d,heads,head_dim,ctx,route", [
    (512, 4, 128, 250, "split"),    # h % 8 != 0: the TPU's c-blocked kernel, one chunk
    (512, 4, 128, 520, "split"),    # several chunks (ring 640 = 5 x 128)
    (1024, 8, 128, 250, "fused"),   # mono and 4-D: the fused commit
    (512, 8, 64, 250, "split"),     # Dh = 64: not the 4-D fused shape
    (384, 4, 96, 250, "split"),     # a width no kernel takes: still decode_attend, no gate
])
def test_step_routes_int8_rings_by_the_jax_shape_rule(monkeypatch, d, heads, head_dim,
                                                      ctx, route):
    monkeypatch.setenv("DSM_RING_KERNEL", "1")
    monkeypatch.setenv("DSM_DECODE_ATTN", "1")
    monkeypatch.delenv("DSM_FUSED_ATTN", raising=False)
    cfg = jT.TransformerConfig(d_model=d, num_heads=heads, num_layers=2,
                               dim_feedforward=512, context=ctx, head_dim=head_dim)
    params = jT.init(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    pt = to_port({"transformer": params})["transformer"]
    tcfg = port_tcfg(cfg)
    b = 2
    sj = jT.init_state(cfg, b, jnp.bfloat16, kv_quant=True)
    st = tT.init_state(tcfg, b, kv_quant=True)
    routes = _Routes(monkeypatch)
    rng = np.random.default_rng(1)
    masks = [None, None, np.array([True, False]), None, None]
    jstep = JitStep(cfg)
    for m in masks:
        x = (rng.standard_normal((b, 1, d)) * 0.3).astype(np.float32)
        yj, sj = jstep(params, sj, jnp.asarray(x).astype(jnp.bfloat16),
                       None if m is None else jnp.asarray(m))
        yt, st = tT.step(tcfg, pt, st, torch.from_numpy(x).to(torch.bfloat16),
                         None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(as_np(yt), as_np(yj), atol=3e-2, rtol=3e-2)
    n = 2 * len(masks)
    want = ({"quantize_commit": n, "decode_attend": n} if route == "split"
            else {"quantize_scale_commit": n, "decode_attend_commit": n})
    assert {k: v for k, v in routes.calls.items() if v} == want
    np.testing.assert_array_equal(st["valid"].numpy(), np.asarray(sj["valid"]))
    for key in ("k", "v", "ks", "vs"):  # layer 0 sees the same input on both sides
        np.testing.assert_array_equal(st["layers"][0][key].numpy(),
                                      np.asarray(sj["layers"][0][key]))


def test_split_route_equals_fused_route(monkeypatch):
    """At a shape both pipelines serve, the port's split route gives the
    JAX fused kernels' result: the committed row is masked, the fresh row
    joins in bf16."""
    monkeypatch.setenv("DSM_RING_KERNEL", "1")
    monkeypatch.setenv("DSM_DECODE_ATTN", "1")
    cfg = jT.TransformerConfig(d_model=1024, num_heads=8, num_layers=2,
                               dim_feedforward=512, context=250)
    params = jT.init(cfg, jax.random.PRNGKey(3), dtype=jnp.bfloat16)
    pt = to_port({"transformer": params})["transformer"]
    sj = jT.init_state(cfg, 2, jnp.bfloat16, kv_quant=True)
    st = {r: tT.init_state(port_tcfg(cfg), 2, kv_quant=True) for r in ("fused", "split")}
    rng = np.random.default_rng(4)
    jstep = JitStep(cfg)
    for _ in range(4):
        x = (rng.standard_normal((2, 1, 1024)) * 0.3).astype(np.float32)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        yj, sj = jstep(params, sj, jnp.asarray(x).astype(jnp.bfloat16))
        y_fused, st["fused"] = tT.step(port_tcfg(cfg), pt, st["fused"], xt)
        with monkeypatch.context() as mp:
            mp.setattr(tda, "fused_commit_supported", lambda *a: False)
            y_split, st["split"] = tT.step(port_tcfg(cfg), pt, st["split"], xt)
        np.testing.assert_allclose(as_np(y_split), as_np(yj), atol=3e-2, rtol=3e-2)
        np.testing.assert_allclose(as_np(y_split), as_np(y_fused), atol=3e-2, rtol=3e-2)
    for key in ("k", "v", "ks", "vs"):
        assert torch.equal(st["split"]["layers"][0][key], st["fused"]["layers"][0][key])


# ---------------------------------------------------------------------------
# The model: preset, DepFormer at 16 slices x 6 layers
# ---------------------------------------------------------------------------


def test_s2s_preset_matches_jax():
    j, t = jLM.s2s_2b_16rvq_202501(), tLM.s2s_2b_16rvq_202501()
    assert t == port_lm_cfg(j)
    assert (t.d_model, t.transformer.num_heads, t.transformer.hd, t.transformer.num_layers,
            t.audio_codebooks, t.generated_codebooks, t.depformer.transformer.num_layers,
            t.text_start_token) == (2560, 20, 128, 24, 32, 16, 6, 48000)
    assert tT.capacity(t.transformer, 1, True) == 3072
    q = torch.zeros(24, 20, 1, 128, dtype=torch.bfloat16)
    ring = torch.zeros(1, 20, 3072, 128, dtype=torch.int8).expand(24, 20, 3072, 128)
    plan = {"w": [5], "q_pos": [5]}
    assert not tda.fused_commit_supported(q, ring, plan) and tda.supported(q, ring, plan)


def _dep_lm(slices=16, layers=6):
    return jLM.LmConfig(
        transformer=jT.TransformerConfig(d_model=32, num_heads=4, num_layers=1,
                                         dim_feedforward=64, context=16),
        depformer=jLM.DepFormerConfig(
            transformer=jT.TransformerConfig(
                d_model=16, num_heads=2, num_layers=layers, dim_feedforward=32,
                context=slices, positional_embedding="none"),
            num_slices=slices),
        text_in_vocab_size=41, text_out_vocab_size=40, audio_vocab_size=33,
        audio_codebooks=2 * slices)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_depformer_16_slices_6_layers_global_key(temperature):
    """The duplex DepFormer layout (32 codebooks in, 16 slices out, 6 layers
    a slice) with one key for the batch: slice i draws with split(key, 16)[i]."""
    lm = _dep_lm()
    params = jLM.init(lm, jax.random.PRNGKey(2))
    pt = to_port(params)
    assert len(pt["depformer"]["transformer"]) == 16
    assert len(pt["depformer"]["transformer"][0]) == 6
    assert pt["audio_embs"].shape[0] == 32 and pt["depformer"]["audio_embs"].shape[0] == 15
    rng = np.random.default_rng(3)
    b = 3
    for trial in range(2):
        hidden = (rng.standard_normal((b, 32)) * 2).astype(np.float32)
        text = rng.integers(0, 40, b).astype(np.int32)
        forced = np.where(rng.uniform(size=(b, 16)) < 0.2, 32, -1).astype(np.int32)
        tj = jLM.depformer_sample(lm, params, jnp.asarray(hidden), jnp.asarray(text),
                                  jnp.asarray(forced), jax.random.PRNGKey(40 + trial),
                                  jS.SamplingConfig(temperature, 5))
        tt = tLM.depformer_sample(port_lm_cfg(lm), pt, torch.from_numpy(hidden),
                                  torch.from_numpy(text), torch.from_numpy(forced),
                                  tS.prng_key(40 + trial), tS.SamplingConfig(temperature, 5))
        assert tt.shape == (b, 16)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


# ---------------------------------------------------------------------------
# lm_gen: the session step
# ---------------------------------------------------------------------------


def small_duplex_cfg(n=3, audio_vocab=9, **over):
    """``n`` generated and ``n`` input codebooks."""
    lm_cfg = jLM.LmConfig(
        transformer=jT.TransformerConfig(d_model=32, num_heads=4, num_layers=2,
                                         dim_feedforward=64, context=32),
        depformer=jLM.DepFormerConfig(
            transformer=jT.TransformerConfig(
                d_model=16, num_heads=2, num_layers=2, dim_feedforward=32, context=n,
                positional_embedding="none"),
            num_slices=n),
        text_in_vocab_size=41, text_out_vocab_size=40, audio_vocab_size=audio_vocab,
        audio_codebooks=2 * n)
    kw = dict(lm=lm_cfg, generated_audio_codebooks=n, input_audio_codebooks=n,
              acoustic_delay=2, text_start_token=40, max_steps=32)
    kw.update(over)
    return jGEN.DuplexConfig(**kw)


def _state_equal(st, sj):
    for key in ("audio_tokens", "text_tokens", "prev_text", "step_idx"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(sj[key]), err_msg=key)
    np.testing.assert_array_equal(st["lm"]["t"]["valid"].numpy(),
                                  np.asarray(sj["lm"]["t"]["valid"]))


@pytest.mark.parametrize("variant", ["sampled", "greedy_penalty_padmult", "asr_delay",
                                     "forced_text"])
def test_lm_gen_step_matches_jax(variant):
    """14 steps, 3 slots, f32: masks from step 2, slot 1 reset at step 7.
    Text tokens, audio tokens, frames, validity and every token buffer equal."""
    over = {}
    if variant == "greedy_penalty_padmult":
        over = dict(audio_temperature=0.0, text_temperature=0.0,
                    repetition_penalty=(4, 1.5), pad_mult=0.7)
    if variant == "sampled":
        over = dict(repetition_penalty=(8, 1.3))
    jcfg = small_duplex_cfg(**over)
    tcfg = port_duplex_cfg(jcfg)
    params = {"lm": jLM.init(jcfg.lm, jax.random.PRNGKey(0))}
    pt = to_port(params)
    b = 3
    sj = jGEN.init_state(jcfg, b, cache_dtype=jnp.float32)
    st = tGEN.init_state(tcfg, b, cache_dtype=torch.float32)
    _state_equal(st, sj)
    rng = np.random.default_rng(5)
    asr_delay = np.array([0, 4, 0], np.int32) if variant == "asr_delay" else None
    seen_valid = 0
    for i in range(14):
        user = rng.integers(0, 8, (b, 3)).astype(np.int32)
        mask = rng.uniform(size=b) < 0.75 if i >= 2 else np.ones(b, bool)
        reset = np.array([False, i == 7, False])
        force = None
        if variant == "forced_text":
            force = np.where(rng.uniform(size=b) < 0.5, rng.integers(4, 40, b), -1).astype(
                np.int32)
        kj = {} if asr_delay is None else {"asr_delay": jnp.asarray(asr_delay)}
        kt = {} if asr_delay is None else {"asr_delay": torch.from_numpy(asr_delay)}
        oj, sj = jGEN.step(jcfg, params, sj, jnp.asarray(user), jax.random.PRNGKey(100 + i),
                           force_text_token=None if force is None else jnp.asarray(force),
                           mask=jnp.asarray(mask), reset=jnp.asarray(reset), **kj)
        ot, st = tGEN.step(tcfg, pt, st, torch.from_numpy(user), tS.prng_key(100 + i),
                           force_text_token=None if force is None else torch.from_numpy(force),
                           mask=torch.from_numpy(mask), reset=torch.from_numpy(reset), **kt)
        for key in ("text_token", "audio_tokens", "frame", "frame_valid"):
            np.testing.assert_array_equal(ot[key].numpy(), np.asarray(oj[key]),
                                          err_msg=f"step {i} {key}")
        np.testing.assert_array_equal(ot["step_idx"].numpy(), np.asarray(sj["step_idx"]))
        _state_equal(st, sj)
        seen_valid += int(ot["frame_valid"].sum())
    assert seen_valid >= 10
    assert int(st["step_idx"][1]) < int(st["step_idx"][0])  # the reset slot restarted


def test_lm_gen_step_without_mask_and_scalar_asr_delay():
    jcfg = small_duplex_cfg()
    tcfg = port_duplex_cfg(jcfg)
    params = {"lm": jLM.init(jcfg.lm, jax.random.PRNGKey(1))}
    pt = to_port(params)
    sj = jGEN.init_state(jcfg, 2, cache_dtype=jnp.float32)
    st = tGEN.init_state(tcfg, 2, cache_dtype=torch.float32)
    rng = np.random.default_rng(6)
    for i in range(6):
        user = rng.integers(0, 8, (2, 3)).astype(np.int32)
        oj, sj = jGEN.step(jcfg, params, sj, jnp.asarray(user), jax.random.PRNGKey(i),
                           asr_delay=jnp.int32(3))
        ot, st = tGEN.step(tcfg, pt, st, torch.from_numpy(user), tS.prng_key(i), asr_delay=3)
        for key in ("text_token", "audio_tokens", "frame", "frame_valid"):
            np.testing.assert_array_equal(ot[key].numpy(), np.asarray(oj[key]))
    _state_equal(st, sj)


def test_lm_gen_step_with_int8_rings_runs_the_fused_or_split_route():
    """kv_quant state through the session step on the CPU (plain versions):
    finite logits' tokens in range, rings written."""
    tcfg = port_duplex_cfg(small_duplex_cfg())
    gen = torch.Generator().manual_seed(0)
    pt = {"lm": tLM.init(tcfg.lm, gen)}
    st = tGEN.init_state(tcfg, 2, kv_quant=True)
    assert st["lm"]["t"]["layers"][0]["k"].dtype == torch.int8
    for i in range(3):
        out, st = tGEN.step(tcfg, pt, st, torch.zeros(2, 3, dtype=torch.int32),
                            tS.prng_key(i))
        assert int(out["text_token"].min()) >= 0 and int(out["text_token"].max()) < 40
    assert st["lm"]["t"]["layers"][0]["ks"][:, :, :3].gt(0).all()


@pytest.mark.parametrize("context,penalty", [(2, 1.5), (8, 2.0), (8, 1.0)])
def test_rep_penalty_matches_jax(context, penalty):
    jcfg = small_duplex_cfg(repetition_penalty=(context, penalty))
    tcfg = port_duplex_cfg(jcfg)
    rng = np.random.default_rng(context)
    b, v, cap = 4, 40, 34
    logits = rng.standard_normal((b, v)).astype(np.float32) * 3
    # Duplicates, specials (pad 3, eop 0, start 40) and unwritten entries.
    buf = rng.integers(0, 12, (b, cap)).astype(np.int32)
    buf[:, 20:] = -1
    buf[1, :] = 5
    s = np.array([0, 19, 7, 33], np.int32)
    want = jGEN._rep_penalty(jcfg, jnp.asarray(logits), jnp.asarray(buf), jnp.asarray(s))
    got = tGEN._rep_penalty(tcfg, torch.from_numpy(logits), torch.from_numpy(buf),
                            torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if penalty != 1.0:
        assert (got.numpy() != logits).any()
    want1 = jGEN._rep_penalty(jcfg, jnp.asarray(logits[:1]), jnp.asarray(buf[:1]), 9)
    got1 = tGEN._rep_penalty(tcfg, torch.from_numpy(logits[:1]), torch.from_numpy(buf[:1]), 9)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))


def test_reset_slots_and_buffer_end():
    """reset_slots wipes the chosen slots in place; a slot past the end of
    its buffers writes nothing and does not fault (JAX drops such writes)."""
    jcfg = small_duplex_cfg(max_steps=4, audio_temperature=0.0, text_temperature=0.0)
    tcfg = port_duplex_cfg(jcfg)
    params = {"lm": jLM.init(jcfg.lm, jax.random.PRNGKey(0))}
    pt = to_port(params)
    sj = jGEN.init_state(jcfg, 2, cache_dtype=jnp.float32)
    st = tGEN.init_state(tcfg, 2, cache_dtype=torch.float32)
    for i in range(8):  # cap = 6: two steps past the end
        user = np.full((2, 3), i % 8, np.int32)
        oj, sj = jGEN.step(jcfg, params, sj, jnp.asarray(user), jax.random.PRNGKey(i))
        ot, st = tGEN.step(tcfg, pt, st, torch.from_numpy(user), tS.prng_key(i))
        np.testing.assert_array_equal(ot["text_token"].numpy(), np.asarray(oj["text_token"]))
    _state_equal(st, sj)
    buf = st["audio_tokens"]
    st2 = tGEN.reset_slots(tcfg, st, torch.tensor([True, False]))
    assert st2["audio_tokens"] is buf and buf[0].eq(-1).all() and not buf[1].eq(-1).all()
    assert st2["step_idx"].tolist() == [0, 8] and st2["prev_text"][0] == 40
