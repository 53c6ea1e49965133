"""The rotary embedding folded into the ring commit (``ring_kernels.rope_commit``
and ``rope_qk``, the step's path for TPU kernel 3 and the rope before the int8
and packed-int4 commits) against the JAX package, at small sizes, on the CPU.

* ``rope_commit_plain`` against ``attention.apply_rope`` under ``jax.jit`` on
  q and k, followed by the Pallas ``_ring_commit`` in interpret mode: the
  rotated q and k and both rings bit for bit, at w = 0, a middle row and
  C - T, with q, k and v strided views of one QKV product as
  ``transformer._qkv`` gives them, on bf16 and f32 rings, at Dh 64 and 128
  and T 1 and 2; every row but the written ones as it was.
* ``rope_qk_plain`` against the jitted ``apply_rope``, bit for bit.
* ``transformer.step`` against the jitted JAX step through its Pallas
  kernels: at the Mimi codec transformer's shapes (h = 8, Dh = 64, T = 2) over
  a ring that wraps, and at int8 (fused route) and ``kv_bits = 4`` LM shapes;
  outputs within the bars of the existing step tests, both sides' routes
  counted: ``rope_commit`` on bf16/f32 rings and ``rope_qk`` before the
  int8/int4 commits, ``ring_commit`` never on the path.
  The CUDA kernel is held against the plain versions in
  tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.ops import attention as jattn
from dsm_tpu.ops import decode_attn as jda
from dsm_tpu.ops import ring_kernels as jrk
from dsm_tpu.ops import transformer as jT
from dsm_tpu_torch.ops import attention as tattn
from dsm_tpu_torch.ops import ring_kernels as trk
from dsm_tpu_torch.ops import transformer as tT
from tests.test_torch_ops import JitStep, as_np, to_port
from tests.test_torch_stt26 import _Counts
from tests.test_torch_tts import _fields

torch.set_num_threads(2)

_JDT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package takes its Pallas kernels (interpret mode on the CPU)."""
    monkeypatch.setenv("DSM_RING_KERNEL", "1")
    monkeypatch.setenv("DSM_DECODE_ATTN", "1")
    for var in ("DSM_FUSED_ATTN", "DSM_KERNELS", "DSM_KV_BITS"):
        monkeypatch.delenv(var, raising=False)


def _qkv_views(b, h, t, dh, dtype, seed):
    """q, k, v ``(B, H, T, Dh)`` as strided views of one QKV product ``(B, T,
    3, H, Dh)`` (``transformer._qkv``), and the same values for JAX."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy((rng.standard_normal((b, t, 3, h, dh)) * 2).astype(np.float32))
    qkv = qkv.to(dtype)
    views = tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert not any(x.is_contiguous() for x in views)
    return views, tuple(jnp.asarray(x.float().numpy()).astype(_JDT[dtype]) for x in views)


def _cos_sin(b, t, dh, pos):
    positions = np.arange(t, dtype=np.int32)[None].repeat(b, 0) + pos
    cj, sj = jax.jit(lambda p: jattn.rope_cos_sin(p, dh, 10_000.0))(jnp.asarray(positions))
    ct, st = tattn.rope_cos_sin(torch.from_numpy(positions[:1]), dh, 10_000.0)
    return (cj, sj), (ct, st)


def _same(got, want):
    """Bit for bit, as f32 words."""
    g = got.float().numpy().view(np.int32)
    w = np.asarray(want.astype(jnp.float32)).view(np.int32)
    assert g.shape == w.shape and int((g != w).sum()) == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_rope_commit_plain_matches_rope_and_ring_commit(dtype, T, Dh, where):
    b, h, c = 2, 4, 32
    w = {"first": 0, "middle": c // 2 - T, "last": c - T}[where]
    pos = 3000 + w
    (tq, tk, tv), (jq, jk, jv) = _qkv_views(b, h, T, Dh, dtype, seed=Dh + T + w)
    (cj, sj), (ct, st) = _cos_sin(b, T, Dh, pos)
    rng = np.random.default_rng(w)
    rings = [rng.standard_normal((b, h, c, Dh)).astype(np.float32) for _ in range(2)]
    jrings = [jnp.asarray(r).astype(_JDT[dtype]) for r in rings]
    trings = [torch.from_numpy(r).to(dtype) for r in rings]
    rope = jax.jit(jattn.apply_rope)
    qj, kj = rope(jq, cj, sj), rope(jk, cj, sj)
    want = jrk._ring_commit(*jrings, kj, jv, jnp.asarray([w], jnp.int32), interpret=True)
    got = [x.clone() for x in trings]
    qt, kt = trk.rope_commit_plain(tq, tk, tv, *got, ct, st, w)
    assert qt.dtype == kt.dtype == dtype and qt.is_contiguous() and kt.is_contiguous()
    _same(qt, qj)
    _same(kt, kj)
    for g, ref in zip(got, want):
        _same(g, ref)
    keep = np.ones(c, bool)
    keep[w:w + T] = False
    for g, ring in zip(got, trings):
        assert torch.equal(g[:, :, keep], ring[:, :, keep])
    # CPU tensors: the wrapper takes the plain version and launches nothing.
    before = trk.rope_commit.launches
    again = [x.clone() for x in trings]
    q2, k2 = trk.rope_commit(tq, tk, tv, *again, ct, st, torch.tensor(w, dtype=torch.int32))
    assert trk.rope_commit.launches == before
    for a, b_ in zip([q2, k2] + again, [qt, kt] + got):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("Dh", [64, 128])
def test_rope_qk_plain_matches_the_jitted_rope(dtype, Dh):
    (tq, tk, _), (jq, jk, _) = _qkv_views(3, 8, 1, Dh, dtype, seed=Dh)
    (cj, sj), (ct, st) = _cos_sin(3, 1, Dh, 99_999)
    rope = jax.jit(jattn.apply_rope)
    qt, kt = trk.rope_qk_plain(tq, tk, ct, st)
    _same(qt, rope(jq, cj, sj))
    _same(kt, rope(jk, cj, sj))
    before = trk.rope_qk.launches
    q2, k2 = trk.rope_qk(tq, tk, ct, st)
    assert trk.rope_qk.launches == before
    assert torch.equal(q2, qt) and torch.equal(k2, kt)


def test_rope_commit_raises_on_a_bad_w():
    """The position is the step's 0-d int32 tick: a host int is refused, and
    so is a tick that is not a multiple of T or is negative; tick 32 of a
    32-row ring writes rows 0 and 1."""
    (tq, tk, tv), _ = _qkv_views(2, 4, 2, 64, torch.float32, seed=0)
    _, (ct, st) = _cos_sin(2, 2, 64, 0)
    rings = [torch.zeros(2, 4, 32, 64) for _ in range(2)]
    for w in (1, 31, 32, -2):
        with pytest.raises(ValueError, match="0-d int32 tensor"):
            trk.rope_commit(tq, tk, tv, *rings, ct, st, w)
    for w in (1, 31, -2):
        with pytest.raises(ValueError, match="pos % T"):
            trk.rope_commit(tq, tk, tv, *rings, ct, st, torch.tensor(w, dtype=torch.int32))
    trk.rope_commit(tq, tk, tv, *rings, ct, st, torch.tensor(32, dtype=torch.int32))
    assert torch.equal(rings[1][:, :, :2], tv) and not rings[1][:, :, 2:].any()


def _route_counts(monkeypatch):
    return (_Counts(monkeypatch, [(jrk, "_ring_commit"), (jrk, "_ring_commit_q"),
                                  (jrk, "_scale_commit"), (jda, "_decode_attend_q4_4d"),
                                  (jda, "_decode_attend_commit_q_4d"), (jattn, "apply_rope")]),
            _Counts(monkeypatch, [(trk, "rope_commit"), (trk, "rope_qk"), (trk, "ring_commit"),
                                  (trk, "quantize_commit"), (trk, "quantize_scale_commit")]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_step_at_mimi_shapes_folds_the_rope_into_the_commit(jax_kernels, monkeypatch, dtype):
    """The codec transformer's shapes: 8 heads x 64, LayerNorm, GELU MLP,
    layer scale, T = 2 frames a step into a 32-row ring, 20 steps (it
    wraps), a mask and a reset.  Outputs and rings within the existing step
    tests' bars (1e-4 in f32, 3e-2 in bf16: the two sides' matmuls sum in
    other orders)."""
    cfg = jT.TransformerConfig(d_model=512, num_heads=8, num_layers=2, dim_feedforward=256,
                               context=30, gating=False, norm="layer_norm", layer_scale=0.5)
    jdt = _JDT[dtype]
    params = jT.init(cfg, jax.random.PRNGKey(5), dtype=jdt)
    pt = to_port({"transformer": params})["transformer"]
    b = 2
    sj = jT.init_state(cfg, b, jdt, step_t=2)
    st = tT.init_state(_fields(tT.TransformerConfig, cfg), b, dtype, step_t=2)
    assert st["layers"][0]["k"].shape == (b, 8, 32, 64)
    jcounts, tcounts = _route_counts(monkeypatch)
    jstep = JitStep(cfg)
    rng = np.random.default_rng(6)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    steps = 20
    for i in range(steps):
        x = rng.standard_normal((b, 2, 512)).astype(np.float32)
        m = rng.uniform(size=b) < 0.8
        if i == 10:
            r = np.array([True, False])
            sj = jT.reset_state(sj, jnp.asarray(r))
            st = tT.reset_state(st, torch.from_numpy(r))
        yj, sj = jstep(params, sj, jnp.asarray(x).astype(jdt), jnp.asarray(m))
        yt, st = tT.step(_fields(tT.TransformerConfig, cfg), pt, st,
                         torch.from_numpy(x).to(dtype), torch.from_numpy(m))
        np.testing.assert_allclose(as_np(yt), as_np(yj), atol=tol, rtol=tol)
    assert jcounts.nonzero() == {"_ring_commit": 2 * jstep.traces,
                                 "apply_rope": 4 * jstep.traces}
    assert tcounts.nonzero() == {"rope_commit": 2 * steps}
    np.testing.assert_array_equal(st["valid"].numpy(), np.asarray(sj["valid"]))
    for lj, lt in zip(sj["layers"], st["layers"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(as_np(lt[key]), as_np(lj[key]), atol=tol, rtol=tol)


@pytest.mark.parametrize("d,head_dim,kv_bits,jax_route,port_route", [
    (1024, 128, 8, ("_decode_attend_commit_q_4d", "_scale_commit"), "quantize_scale_commit"),
    (1024, 128, 4, ("_decode_attend_q4_4d", "_ring_commit_q"), "quantize_commit")])
def test_step_at_lm_shapes_rotates_in_one_launch(jax_kernels, monkeypatch, d, head_dim,
                                                 kv_bits, jax_route, port_route):
    """The LM's int8 (fused route) and packed-int4 rings at h = 8: ``rope_qk``
    before the quantise-and-commit, 12 steps, a mask from step 3 and a
    reset at step 7; outputs within 3e-2, layer 0's rings bit for bit."""
    cfg = jT.TransformerConfig(d_model=d, num_heads=8, num_layers=2, dim_feedforward=256,
                               context=250, head_dim=head_dim)
    params = jT.init(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    pt = to_port({"transformer": params})["transformer"]
    tcfg = _fields(tT.TransformerConfig, cfg)
    b = 2
    sj = jT.init_state(cfg, b, jnp.bfloat16, kv_quant=True, kv_bits=kv_bits)
    st = tT.init_state(tcfg, b, kv_quant=True, kv_bits=kv_bits)
    jcounts, tcounts = _route_counts(monkeypatch)
    jstep = JitStep(cfg)
    rng = np.random.default_rng(1)
    steps = 12
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
    nj = 2 * jstep.traces  # the JAX side counts its kernels per trace
    assert jcounts.nonzero() == {jax_route[0]: nj, jax_route[1]: nj, "apply_rope": 2 * nj}
    assert tcounts.nonzero() == {"rope_qk": 2 * steps, port_route: 2 * steps}
    for key in ("k", "v", "ks", "vs"):  # layer 0 sees the same input on both sides
        np.testing.assert_array_equal(st["layers"][0][key].numpy(),
                                      np.asarray(sj["layers"][0][key]))
