"""The port's packed-int4 KV rings (``kv_bits = 4``) against the JAX
package's, at small sizes, on the CPU.

* ``pack4``, ``unpack4``, ``quantize_kv_rows_packed4`` and the uint8 ring
  commit: bit for bit.
* ``decode_attend_plain`` on packed rings against the Pallas kernels
  ``_decode_attend_q4_4d`` (4-D blocks, Dh = 128) and ``_decode_attend_q4``
  (head-major, Dh = 64) in interpret mode: atol = rtol = 2e-2, the bar of
  tests/test_kv_int4.py for the kernel against the XLA path (bf16 outputs;
  the two sum in other orders).
* ``transformer.step`` over 12 steps with a mask and a reset, both sides'
  routes counted: bf16, 3e-2 (two layers of bf16 matmuls between the
  attention calls); layer 0's rings bit for bit.
* ``lm_gen.step``, a small ``BatchedDuplexEngine`` and a small
  ``BatchedAsrEngine`` with int4 rings against the JAX ones, the JAX side
  through its Pallas kernels in interpret mode (the port's plain versions
  keep the kernels' order): f32 weights, tokens and events equal.
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
from dsm_tpu.ops import ring_kernels as jrk
from dsm_tpu.ops import transformer as jT
from dsm_tpu.server.batched_asr import BatchedAsrEngine as JaxAsrEngine
from dsm_tpu.server.duplex_batched import BatchedDuplexEngine as JaxDuplexEngine
from dsm_tpu.sessions import asr as jASR
from dsm_tpu.sessions import lm_gen as jGEN
from dsm_tpu.utils.tokenizer import FallbackTokenizer as JaxFallback
from dsm_tpu_torch import bridge
from dsm_tpu_torch.ops import attention as tattn
from dsm_tpu_torch.ops import decode_attn as tda
from dsm_tpu_torch.ops import ring_kernels as trk
from dsm_tpu_torch.ops import sampling as tS
from dsm_tpu_torch.ops import transformer as tT
from dsm_tpu_torch.server import builder as tbuilder
from dsm_tpu_torch.server import duplex_batched as tDB
from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine
from dsm_tpu_torch.sessions import asr as tASR
from dsm_tpu_torch.sessions import lm_gen as tGEN
from dsm_tpu_torch.utils.tokenizer import FallbackTokenizer
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_duplex import port_duplex_cfg
from tests.test_torch_duplex_serving import _scenario, _small_duplex_module, _summary
from tests.test_torch_ops import JitStep, as_np, np_tree, to_port
from tests.test_torch_stt26 import _Counts, _serve
from tests.test_torch_tts import _fields, port_lm_cfg, port_mimi_cfg, port_tcfg

torch.set_num_threads(2)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package takes its Pallas kernels (interpret mode on the CPU)."""
    monkeypatch.setenv("DSM_RING_KERNEL", "1")
    monkeypatch.setenv("DSM_DECODE_ATTN", "1")
    for var in ("DSM_FUSED_ATTN", "DSM_KERNELS", "DSM_KV_BITS"):
        monkeypatch.delenv(var, raising=False)


# ---------------------------------------------------------------------------
# Packing and quantisation
# ---------------------------------------------------------------------------


def test_pack4_unpack4_bit_exact():
    rng = np.random.default_rng(0)
    q = rng.integers(-7, 8, (2, 3, 5, 64)).astype(np.int32)
    pj = jattn.pack4(jnp.asarray(q))
    pt = tattn.pack4(torch.from_numpy(q))
    assert pt.dtype == torch.uint8 and pt.shape == (2, 3, 5, 32)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    # Deinterleaved: byte d = dims (d, d + Dh/2), excess-8.
    assert int(pt[0, 0, 0, 3]) == (q[0, 0, 0, 3] + 8) | ((q[0, 0, 0, 35] + 8) << 4)
    back = tattn.unpack4(pt)
    np.testing.assert_array_equal(back.numpy(), q.astype(np.float32))
    np.testing.assert_array_equal(back.numpy(), np.asarray(jattn.unpack4(pj)))
    assert tattn.unpack4(pt, torch.bfloat16).dtype == torch.bfloat16
    # A never-written ring row (zero bytes) unpacks to -8 everywhere.
    assert tattn.unpack4(torch.zeros(4, dtype=torch.uint8)).eq(-8).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_packed4_bit_exact(dtype):
    rng = np.random.default_rng(1)
    k = rng.standard_normal((2, 4, 3, 128)).astype(np.float32)
    v = (rng.standard_normal((2, 4, 3, 128)) * 5).astype(np.float32)
    k[0, 0, 0] = 0.0  # the 1e-8 floor
    v[0, 1, 0, :7] = np.arange(7) + 0.5  # ties: both sides round half to even
    v[0, 1, 0, 7:] = 0.0
    v[0, 1, 0, 7] = 7.0
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    want = jax.jit(jattn.quantize_kv_rows_packed4)(jnp.asarray(k).astype(jd),
                                                   jnp.asarray(v).astype(jd))
    got = tattn.quantize_kv_rows_packed4(torch.from_numpy(k).to(td), torch.from_numpy(v).to(td))
    assert got[0].dtype == torch.uint8 and got[0].shape == (2, 4, 3, 64)
    assert got[2].dtype == torch.float32 and got[2].shape == (2, 4, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("w", [0, 5, 255])
def test_ring_commit_uint8_rows_bit_exact(w):
    rng = np.random.default_rng(2)
    b, h, c, dh2 = 2, 8, 256, 64
    rings = [rng.integers(0, 256, (b, h, c, dh2)).astype(np.uint8) for _ in range(2)]
    scales = [rng.uniform(size=(b, h, c)).astype(np.float32) for _ in range(2)]
    rows = [rng.integers(0, 256, (b, h, 1, dh2)).astype(np.uint8) for _ in range(2)]
    new_s = [rng.uniform(size=(b, h, 1)).astype(np.float32) for _ in range(2)]
    assert jrk.supported(jnp.asarray(rings[0]), jnp.asarray(rows[0]), True)
    want = jrk.ring_commit(*map(jnp.asarray, rings), *map(jnp.asarray, rows), jnp.int32(w),
                           *map(jnp.asarray, scales), *map(jnp.asarray, new_s), interpret=True)
    t_rings = [torch.from_numpy(x.copy()) for x in rings]
    t_scales = [torch.from_numpy(x.copy()) for x in scales]
    trk.ring_commit(*t_rings, *map(torch.from_numpy, rows), torch.tensor(w, dtype=torch.int32),
                    *t_scales, *map(torch.from_numpy, new_s))
    for got, ref in zip(t_rings + t_scales, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert t_rings[0].dtype == torch.uint8
    np.testing.assert_array_equal(t_rings[0][:, :, w].numpy(), rows[0][:, :, 0])


def test_state_with_uint8_rings_crosses_the_bridge():
    cfg = jT.TransformerConfig(d_model=256, num_heads=4, num_layers=2, dim_feedforward=64,
                               context=100)
    sj = jT.init_state(cfg, 3, jnp.bfloat16, kv_quant=True, kv_bits=4)
    st = tT.init_state(port_tcfg(cfg), 3, kv_quant=True, kv_bits=4)
    carried = bridge.from_numpy_tree(np_tree(sj))
    assert carried["pos"] == 0 and len(carried["layers"]) == 2
    for a, b in zip(carried["layers"], st["layers"]):
        for key in ("k", "v", "ks", "vs"):
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
    assert st["layers"][0]["k"].dtype == torch.uint8
    assert st["layers"][0]["k"].shape == (3, 4, 128, 32)
    assert st["layers"][0]["ks"].shape == (3, 4, 128) and st["valid"].shape == (3, 128)
    with pytest.raises(ValueError, match="kv_bits"):
        tT.init_state(port_tcfg(cfg), 3, kv_quant=True, kv_bits=3)


# ---------------------------------------------------------------------------
# Attention over packed rings
# ---------------------------------------------------------------------------


def _packed_inputs(b, h, c, dh, valid_frac, seed):
    rng = np.random.default_rng(seed)
    x = {name: (rng.standard_normal((b, h, 1, dh)) * 0.5).astype(np.float32)
         for name in ("q", "k_new", "v_new")}
    x["kc"] = np.array(jattn.pack4(jnp.asarray(rng.integers(-7, 8, (b, h, c, dh)))))
    x["vc"] = np.array(jattn.pack4(jnp.asarray(rng.integers(-7, 8, (b, h, c, dh)))))
    x["ks"] = rng.uniform(0.01, 0.1, (b, h, c)).astype(np.float32)
    x["vs"] = rng.uniform(0.01, 0.1, (b, h, c)).astype(np.float32)
    x["valid"] = rng.uniform(size=(b, c)) < valid_frac
    return x


def _bf(x):
    return torch.from_numpy(x).to(torch.bfloat16)


# Every split the packed picker chooses on the H100 at these rings (1 or 2),
# more spans, and None: decode_attend's own choice on the CPU (one span).
@pytest.mark.parametrize("n_split", [1, 2, 3, 5, None])
@pytest.mark.parametrize("kernel,B,H,C,Dh,pos,window,valid_frac", [
    ("4d", 2, 8, 256, 128, 0, 250, 1.0),       # nothing committed yet: the fresh row alone
    ("4d", 2, 8, 256, 128, 40, 250, 0.8),
    ("4d", 2, 16, 256, 128, 1000, 250, 0.8),   # wrapped
    ("head_major", 2, 8, 256, 64, 40, 250, 0.8),
    ("head_major", 2, 32, 384, 64, 3000, 375, 1.0),  # the stt-2.6b heads
    ("head_major", 1, 8, 512, 64, 700, 100, 0.6),    # window < ring
])
def test_decode_attend_plain_on_packed_rings_matches_pallas(kernel, B, H, C, Dh, pos, window,
                                                            valid_frac, n_split):
    x = _packed_inputs(B, H, C, Dh, valid_frac, seed=pos + H)
    jb = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in x.items()
          if k in ("q", "k_new", "v_new")}
    rows = [jb[k][:, :, 0, :] for k in ("q", "k_new", "v_new")]
    va = jnp.asarray(x["valid"]).astype(jnp.int8)[:, None, :]
    p = jnp.asarray([pos], jnp.int32)
    if kernel == "4d":
        assert jda._legacy_4d(H, Dh)
        want = jda._decode_attend_q4_4d(
            rows[0], jnp.asarray(x["kc"]), jnp.asarray(x["vc"]), jnp.asarray(x["ks"]),
            jnp.asarray(x["vs"]), rows[1], rows[2], va, p, window=window, interpret=True)
    else:
        g = B * H
        want = jda._decode_attend_q4(
            rows[0].reshape(g, 1, Dh), jnp.asarray(x["kc"]).reshape(g, C, Dh // 2),
            jnp.asarray(x["vc"]).reshape(g, C, Dh // 2), jnp.asarray(x["ks"]).reshape(g, 1, C),
            jnp.asarray(x["vs"]).reshape(g, 1, C), rows[1].reshape(g, 1, Dh),
            rows[2].reshape(g, 1, Dh), va, p, h=H, window=window, interpret=True
        ).reshape(B, H, Dh)
    tensors = [_bf(x["q"]), torch.from_numpy(x["kc"]), torch.from_numpy(x["vc"]),
               torch.from_numpy(x["ks"]), torch.from_numpy(x["vs"]), _bf(x["k_new"]),
               _bf(x["v_new"])]
    plan = tattn.global_ring_plan(pos, C, 1)
    valid = torch.from_numpy(x["valid"])
    assert tda.supported(tensors[0], tensors[1], plan)
    got = tda.decode_attend(*tensors, plan, valid, window=window, n_split=n_split)
    assert got.shape == (B, H, 1, Dh) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(got[:, :, 0]), as_np(want), atol=2e-2, rtol=2e-2)
    # The any-T path (unpack, then the int8 math) agrees too.
    xla = tattn.attend_global_split_q4(*tensors, plan, valid, window)
    np.testing.assert_allclose(as_np(got), as_np(xla), atol=2e-2, rtol=2e-2)
    if pos == 0:
        np.testing.assert_allclose(as_np(got), as_np(_bf(x["v_new"])), atol=1e-2)


def test_swapped_nibble_halves_fail_the_bar():
    """The layout is deinterleaved; a reader that takes the high nibbles for
    the first half of the feature dim is far outside the bar."""
    x = _packed_inputs(2, 8, 256, 128, 1.0, seed=3)
    x["ks"] *= 4  # a peaked softmax: the outputs follow single rows
    plan = tattn.global_ring_plan(300, 256, 1)
    valid = torch.from_numpy(x["valid"])

    def run(kc, vc):
        return as_np(tda.decode_attend(
            _bf(x["q"]), kc, vc, torch.from_numpy(x["ks"]), torch.from_numpy(x["vs"]),
            _bf(x["k_new"]), _bf(x["v_new"]), plan, valid, window=250))

    def swap(p):
        return (p >> 4) | ((p & 15) << 4)

    kc, vc = torch.from_numpy(x["kc"]), torch.from_numpy(x["vc"])
    good = run(kc, vc)
    for bad in (run(swap(kc), vc), run(kc, swap(vc))):
        assert not np.all(np.abs(bad - good) <= 2e-2 + 2e-2 * np.abs(good))


@pytest.mark.parametrize("t", [1, 2])
def test_attend_global_split_q4_matches_jax(t):
    rng = np.random.default_rng(4)
    b, h, c, dh, pos = 2, 4, 64, 64, 100
    x = _packed_inputs(b, h, c, dh, 0.8, seed=5)
    rows = {k: (rng.standard_normal((b, h, t, dh)) * 0.5).astype(np.float32)
            for k in ("q", "k_new", "v_new")}
    jplan = jattn.global_ring_plan(jnp.int32(pos), c, t)
    want = jattn.attend_global_split_q4(
        jnp.asarray(rows["q"]), jnp.asarray(x["kc"]), jnp.asarray(x["vc"]), jnp.asarray(x["ks"]),
        jnp.asarray(x["vs"]), jnp.asarray(rows["k_new"]), jnp.asarray(rows["v_new"]), jplan,
        jnp.asarray(x["valid"]), window=50)
    got = tattn.attend_global_split_q4(
        torch.from_numpy(rows["q"]), torch.from_numpy(x["kc"]), torch.from_numpy(x["vc"]),
        torch.from_numpy(x["ks"]), torch.from_numpy(x["vs"]), torch.from_numpy(rows["k_new"]),
        torch.from_numpy(rows["v_new"]), tattn.global_ring_plan(pos, c, t),
        torch.from_numpy(x["valid"]), 50)
    # f32 inputs: the two differ by summation order and one bf16 rounding of
    # the probabilities, taken at the same place.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("H,C,Dh,row_bytes,dtype", [
    (16, 768, 128, 64, "uint8"), (32, 384, 64, 32, "uint8"), (20, 3072, 128, 64, "uint8"),
    (16, 768, 128, 128, "uint8"), (16, 768, 128, 64, "int8"), (8, 256, 96, 48, "uint8")])
def test_supported_takes_packed_rings_of_half_width(H, C, Dh, row_bytes, dtype):
    """Dh/2 bytes a row is the JAX rule; ring length and head count are free
    in the port (one kernel body for every H and C: the second known
    divergence of routing, the s2s-2b ring runs the kernel here)."""
    q = torch.zeros(2, H, 1, Dh, dtype=torch.bfloat16)
    ring = torch.zeros(1, dtype=getattr(torch, dtype)).expand(2, H, C, row_bytes)
    plan = {"w": [5], "q_pos": [5]}
    jring = jnp.zeros((2, H, C, row_bytes), getattr(jnp, dtype))
    jplan = {"w": jnp.zeros((1,), jnp.int32)}
    # An int8 ring's width is not looked at, on either side.
    want = Dh in (64, 128) and (dtype == "int8" or 2 * row_bytes == Dh)
    assert tda.supported(q, ring, plan) == want
    jq = jnp.zeros((2, H, 1, Dh), jnp.bfloat16)
    if H == 20:  # no flash int4 body in the JAX package: its XLA path serves it
        assert not jda.supported(jq, jring, jplan)
    else:
        assert jda.supported(jq, jring, jplan) == want
    if dtype == "uint8":
        assert not tda.fused_commit_supported(q, ring, plan, True)


# ---------------------------------------------------------------------------
# transformer.step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,heads,head_dim,jax_kernel", [
    (1024, 8, 128, "_decode_attend_q4_4d"), (512, 8, 64, "_decode_attend_q4")])
@pytest.mark.parametrize("fused_attn", [None, True])
def test_step_with_int4_rings_matches_jax(jax_kernels, monkeypatch, d, heads, head_dim,
                                          jax_kernel, fused_attn):
    """12 steps, a mask from step 3, slot 1 reset at step 7.  ``fused_attn =
    True`` must not reach the fused pipeline with an int4 ring."""
    cfg = jT.TransformerConfig(d_model=d, num_heads=heads, num_layers=2,
                               dim_feedforward=256, context=250, head_dim=head_dim)
    params = jT.init(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    pt = to_port({"transformer": params})["transformer"]
    tcfg = _fields(tT.TransformerConfig, cfg, fused_attn=fused_attn)
    b = 2
    sj = jT.init_state(cfg, b, jnp.bfloat16, kv_quant=True, kv_bits=4)
    st = tT.init_state(tcfg, b, kv_quant=True, kv_bits=4)
    assert st["layers"][0]["k"].shape == (b, heads, 256, head_dim // 2)
    jcounts = _Counts(monkeypatch, [(jda, "_decode_attend_q4"), (jda, "_decode_attend_q4_4d"),
                                    (jda, "_decode_attend_q"), (jda, "_decode_attend_q_4d"),
                                    (jda, "_decode_attend_commit_q_4d"),
                                    (jrk, "_ring_commit_q"), (jrk, "_scale_commit")])
    tcounts = _Counts(monkeypatch, [(trk, "scale_commit"), (tda, "decode_attend_commit"),
                                    (trk, "ring_commit_q"), (tda, "decode_attend"),
                                    (trk, "quantize_commit"), (trk, "quantize_scale_commit"),
                                    (tattn, "quantize_kv_rows_packed4"),
                                    (tattn, "quantize_kv_rows")])
    rng = np.random.default_rng(1)
    steps = 12
    jstep = JitStep(cfg)
    for i in range(steps):
        x = (rng.standard_normal((b, 1, d)) * 0.3).astype(np.float32)
        m = np.array([True, i % 3 != 0]) if i >= 3 else None
        if i == 7:
            reset = np.array([False, True])
            sj = jT.reset_state(sj, jnp.asarray(reset))
            st = tT.reset_state(st, torch.from_numpy(reset))
        yj, sj = jstep(params, sj, jnp.asarray(x).astype(jnp.bfloat16),
                       None if m is None else jnp.asarray(m))
        yt, st = tT.step(tcfg, pt, st, torch.from_numpy(x).to(torch.bfloat16),
                         None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(as_np(yt), as_np(yj), atol=3e-2, rtol=3e-2)
    n, nj = 2 * steps, 2 * jstep.traces  # the JAX side counts its kernels per trace
    assert jcounts.nonzero() == {jax_kernel: nj, "_ring_commit_q": nj}
    assert tcounts.nonzero() == {"quantize_commit": n, "decode_attend": n,
                                 "quantize_kv_rows_packed4": n}
    np.testing.assert_array_equal(st["valid"].numpy(), np.asarray(sj["valid"]))
    assert st["pos"] == int(sj["pos"]) == steps
    for key in ("k", "v", "ks", "vs"):  # layer 0 sees the same input on both sides
        np.testing.assert_array_equal(st["layers"][0][key].numpy(),
                                      np.asarray(sj["layers"][0][key]))


def test_int4_rings_take_t1_steps_only():
    cfg = tT.TransformerConfig(d_model=128, num_heads=2, num_layers=1, dim_feedforward=64,
                               context=30)
    gen = torch.Generator().manual_seed(0)
    params = tT.init(cfg, gen)
    st = tT.init_state(cfg, 1, kv_quant=True, kv_bits=4)
    with pytest.raises(ValueError, match="T=1"):
        tT.step(cfg, params, st, torch.zeros(1, 2, 128))


# ---------------------------------------------------------------------------
# Sessions and engines
# ---------------------------------------------------------------------------


def _int4_duplex_cfg(**over):
    """8 heads x 64 over a 256-row ring: a shape the JAX package serves with
    its head-major int4 kernel."""
    n = 4
    lm_cfg = jLM.LmConfig(
        transformer=jT.TransformerConfig(d_model=512, num_heads=8, num_layers=2,
                                         dim_feedforward=256, context=250),
        depformer=jLM.DepFormerConfig(
            transformer=jT.TransformerConfig(
                d_model=16, num_heads=2, num_layers=2, dim_feedforward=32, context=n,
                positional_embedding="none"),
            num_slices=n),
        text_in_vocab_size=41, text_out_vocab_size=40, audio_vocab_size=33,
        audio_codebooks=2 * n)
    kw = dict(lm=lm_cfg, generated_audio_codebooks=n, input_audio_codebooks=n,
              acoustic_delay=2, text_start_token=40, max_steps=64)
    kw.update(over)
    return jGEN.DuplexConfig(**kw)


def test_lm_gen_step_with_int4_rings_matches_jax(jax_kernels):
    """10 steps, 3 slots, masks from step 2, slot 1 reset at step 6: tokens,
    frames, validity and layer 0's packed rings equal."""
    jcfg = _int4_duplex_cfg()
    tcfg = port_duplex_cfg(jcfg)
    params = {"lm": jLM.init(jcfg.lm, jax.random.PRNGKey(0))}
    pt = to_port(params)
    b = 3
    sj = jGEN.init_state(jcfg, b, cache_dtype=jnp.float32, kv_quant=True, kv_bits=4)
    st = tGEN.init_state(tcfg, b, cache_dtype=torch.float32, kv_quant=True, kv_bits=4)
    assert st["lm"]["t"]["layers"][0]["k"].dtype == torch.uint8
    assert np.asarray(sj["lm"]["t"]["layers"][0]["k"]).dtype == np.uint8
    rng = np.random.default_rng(5)
    for i in range(10):
        user = rng.integers(0, 32, (b, 4)).astype(np.int32)
        mask = rng.uniform(size=b) < 0.75 if i >= 2 else np.ones(b, bool)
        reset = np.array([False, i == 6, False])
        oj, sj = jGEN.step(jcfg, params, sj, jnp.asarray(user), jax.random.PRNGKey(100 + i),
                           mask=jnp.asarray(mask), reset=jnp.asarray(reset))
        ot, st = tGEN.step(tcfg, pt, st, torch.from_numpy(user), tS.prng_key(100 + i),
                           mask=torch.from_numpy(mask), reset=torch.from_numpy(reset))
        for key in ("text_token", "audio_tokens", "frame", "frame_valid"):
            np.testing.assert_array_equal(ot[key].numpy(), np.asarray(oj[key]),
                                          err_msg=f"step {i} {key}")
    np.testing.assert_array_equal(st["lm"]["t"]["valid"].numpy(),
                                  np.asarray(sj["lm"]["t"]["valid"]))
    for key in ("k", "v"):
        np.testing.assert_array_equal(st["lm"]["t"]["layers"][0][key].numpy(),
                                      np.asarray(sj["lm"]["t"]["layers"][0][key]))


def test_duplex_engine_with_int4_rings_matches_jax_engine(jax_kernels):
    """Sampled tokens (the default temperatures): the Gumbel noise, bit for
    bit the same on both sides, sets margins far above what the attention's
    rounding moves a logit by (a few 1e-3: the port folds the fresh row in
    after the ring's bf16 rounding, the Pallas whole-ring bodies before it)."""
    jcfg = _int4_duplex_cfg()
    mimi_cfg = small_mimi_cfg()
    key = jax.random.PRNGKey(0)
    params = {"lm": jLM.init(jcfg.lm, key),
              "mimi": jMIMI.init(mimi_cfg, jax.random.fold_in(key, 1))}
    ej = JaxDuplexEngine(jcfg, params, mimi_cfg, params["mimi"], JaxFallback(), batch_size=3,
                         kv_quant=True, kv_bits=4)
    # With kv_quant the JAX engine quantises its LM weights itself (weight-only
    # on the CPU); the port's runs the weights it is handed.
    lm_t = tT.quantize_weights(to_port(params["lm"]), w8a8=False)
    assert isinstance(lm_t["transformer"][0]["in_proj_w"], dict)
    et = tDB.BatchedDuplexEngine(port_duplex_cfg(jcfg), {"lm": lm_t},
                                 port_mimi_cfg(mimi_cfg), to_port(params["mimi"]),
                                 FallbackTokenizer(), batch_size=3, kv_quant=True, kv_bits=4,
                                 device="cpu")
    assert et.kv_bits == ej.kv_bits == 4
    ring = et.state["lm"]["t"]["layers"][0]["k"]
    assert ring.dtype == torch.uint8 and ring.shape == (3, 8, 256, 32)
    assert np.asarray(ej.state["lm"]["t"]["layers"][0]["k"]).dtype == np.uint8
    frame = mimi_cfg.frame_size
    ev_j, drv_j = _scenario(ej, frame)
    ev_t, drv_t = _scenario(et, frame)
    assert [d.steps for d in drv_t] == [d.steps for d in drv_j] == [9, 11, 9, 6]
    for sj, st in zip(ev_j, ev_t):
        kj, tj, fj = _summary(sj)
        kt, tt, ft = _summary(st)
        assert kt == kj and kt[-1] == "DuplexDoneEvent" and tt == tj
        for x, y in zip(ft, fj):
            np.testing.assert_allclose(x, y, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(et.state["audio_tokens"].numpy(),
                                  np.asarray(ej.state["audio_tokens"]))
    np.testing.assert_array_equal(et.state["text_tokens"].numpy(),
                                  np.asarray(ej.state["text_tokens"]))
    # Without kv_quant the engine keeps dense rings whatever kv_bits says.
    dense = tDB.BatchedDuplexEngine(et.cfg, et.params, et.mimi_cfg, et.mimi_params,
                                    FallbackTokenizer(), batch_size=1, kv_bits=4, device="cpu")
    assert dense.kv_bits == 8 and dense.state["lm"]["t"]["layers"][0]["k"].dtype == torch.float32


@pytest.mark.parametrize("kv_bits,dtype,row_bytes", [(4, torch.uint8, 16), (8, torch.int8, 32)])
def test_build_duplex_reads_kv_bits(kv_bits, dtype, row_bytes):
    eng = tbuilder.build_duplex(_small_duplex_module(kv_quant=True, kv_bits=kv_bits), "cpu")
    assert eng.kv_bits == kv_bits
    ring = eng.state["lm"]["t"]["layers"][0]
    assert ring["k"].dtype == dtype and ring["k"].shape == (3, 4, 128, row_bytes)
    assert ring["ks"].shape == (3, 4, 128)
    eng.warmup(1)
    events = []
    drv = eng.open_session(events.append)
    drv.push_pcm(np.random.default_rng(0).standard_normal(1920 * 5).astype(np.float32) * 0.1)
    drv.end_input()
    while eng.tick():
        pass
    eng.tick()
    assert drv.steps == 5 and isinstance(events[-1], tDB.DuplexDoneEvent)
    audio = [e for e in events if isinstance(e, tDB.DuplexAudioEvent)]
    assert len(audio) == 3 and all(np.isfinite(a.pcm).all() for a in audio)


@pytest.mark.parametrize("kv_bits", [3, 16])
def test_build_duplex_refuses_other_kv_bits(kv_bits):
    with pytest.raises(ValueError, match="kv_bits"):
        tbuilder.build_duplex(_small_duplex_module(kv_quant=True, kv_bits=kv_bits), "cpu")


def test_asr_engine_with_int4_rings_matches_the_jax_engine(jax_kernels):
    """``AsrConfig(kv_bits=4)`` handed to the engine, 8 heads x 128 over a
    256-row ring (the JAX package's 4-D int4 kernel), semantic-VAD heads,
    tokens drawn from per-slot seeded streams: events equal."""
    lm = jLM.LmConfig(
        transformer=jT.TransformerConfig(d_model=1024, num_heads=8, num_layers=2,
                                         dim_feedforward=256, context=250,
                                         max_period=100_000.0),
        text_in_vocab_size=17, text_out_vocab_size=16, audio_vocab_size=33,
        audio_codebooks=4, extra_heads=(2, 3), depformer=None)
    mimi_cfg = small_mimi_cfg()
    jcfg = jASR.AsrConfig(lm=lm, mimi=mimi_cfg, asr_delay_in_tokens=3, temperature=0.7,
                          kv_quant=True, kv_bits=4)
    key = jax.random.PRNGKey(0)
    params = {"lm": jLM.init(lm, key), "mimi": jMIMI.init(mimi_cfg, jax.random.fold_in(key, 1))}
    ej = JaxAsrEngine(jcfg, params, batch_size=3, fill_gate_frac=0.0, use_native_packer=False)
    tcfg = _fields(tASR.AsrConfig, jcfg, lm=port_lm_cfg(lm), mimi=port_mimi_cfg(mimi_cfg))
    assert tcfg.kv_bits == 4 and tcfg.kv_quant
    et = BatchedAsrEngine(tcfg, to_port(params), batch_size=3, device="cpu", fill_gate_frac=0.0)
    ring = et.state["lm"]["t"]["layers"][0]["k"]
    assert ring.dtype == torch.uint8 and ring.shape == (3, 8, 256, 64)
    assert np.asarray(ej.state["lm"]["t"]["layers"][0]["k"]).dtype == np.uint8
    frame = mimi_cfg.frame_size
    got, want = _serve(et, frame), _serve(ej, frame)
    for i in got:
        assert [e[:3] for e in got[i]] == [e[:3] for e in want[i]]
        for eg, ew in zip(got[i], want[i]):
            # VAD probabilities: within the attention's rounding (see the duplex test).
            np.testing.assert_allclose(np.asarray(eg[3]), np.asarray(ew[3]), atol=5e-3)
    markers = [m for evs in got.values() for e in evs for m in e[2]]
    assert sorted(markers) == [100, 101, 102, 103]
    np.testing.assert_array_equal(et.state["text_token"].numpy(),
                                  np.asarray(ej.state["text_token"]))
