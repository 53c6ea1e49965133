"""The port's plain ops (dsm_tpu_torch.ops) against the JAX package's.

Inputs are made with numpy from a seed and fed to both.  Tolerances: f32
paths 1e-5 (the two frameworks sum in other orders); bf16 outputs one
bf16 step (1e-2 relative); integer results (quantisation, codes) exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.ops import attention as jattn
from dsm_tpu.ops import conv as jconv
from dsm_tpu.ops import mlp as jmlp
from dsm_tpu.ops import norm as jnorm
from dsm_tpu.ops import qmm as jqmm
from dsm_tpu.ops import rvq as jrvq
from dsm_tpu.ops import transformer as jT
from dsm_tpu_torch import bridge
from dsm_tpu_torch.ops import attention as tattn
from dsm_tpu_torch.ops import conv as tconv
from dsm_tpu_torch.ops import mlp as tmlp
from dsm_tpu_torch.ops import norm as tnorm
from dsm_tpu_torch.ops import qmm as tqmm
from dsm_tpu_torch.ops import rvq as trvq
from dsm_tpu_torch.ops import transformer as tT

torch.set_num_threads(2)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_port(tree):
    """JAX tree -> the port's tensors, through the bridge."""
    return bridge.from_numpy_tree(np_tree(tree))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def both(a, dtype="float32"):
    """numpy f32 array -> (jax array, torch tensor) of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    return j, bridge.to_tensor(np.asarray(j))


@pytest.mark.parametrize("kind", ["rms_norm", "layer_norm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_matches_jax(kind, dtype):
    rng = np.random.default_rng(0)
    xj, xt = both(rng.standard_normal((2, 3, 64)) * 2.0, dtype)
    params = {"alpha": rng.standard_normal(64).astype(np.float32)}
    if kind == "layer_norm":
        params["bias"] = rng.standard_normal(64).astype(np.float32)
    yj = jnorm.apply_norm(kind, jax.tree_util.tree_map(jnp.asarray, params), xj)
    yt = tnorm.apply_norm(kind, bridge.from_numpy_tree(params), xt)
    assert yt.dtype == xt.dtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(as_np(yt), as_np(yj), **tol)


@pytest.mark.parametrize("gating,ff", [(True, 128), (True, 96), (False, 96)])
def test_mlp_matches_jax(gating, ff):
    d = 32
    pj = jmlp.init(jax.random.PRNGKey(1), d, ff, gating)
    if gating:
        hidden = pj["linear_out"].shape[1]
        assert hidden == tmlp.gating_hidden(d, ff)
    x = np.random.default_rng(1).standard_normal((2, 3, d)).astype(np.float32)
    yj = jmlp.apply(pj, jnp.asarray(x))
    yt = tmlp.apply(to_port(pj), torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32_TOL)


def test_gating_hidden_stt_1b():
    assert tmlp.gating_hidden(2048, 8192) == 5632 == jmlp.gating_hidden(2048, 8192)


@pytest.mark.parametrize("pos", [0, 7, 3001])
def test_rope_matches_jax(pos):
    b, h, t, dh = 2, 3, 2, 16
    positions = np.arange(t, dtype=np.int32)[None].repeat(b, 0) + pos
    cj, sj = jattn.rope_cos_sin(jnp.asarray(positions), dh, 100_000.0)
    ct, st = tattn.rope_cos_sin(torch.from_numpy(positions), dh, 100_000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **F32_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **F32_TOL)
    x = np.random.default_rng(pos).standard_normal((b, h, t, dh)).astype(np.float32)
    yj = jattn.apply_rope(jnp.asarray(x), cj, sj)
    yt = tattn.apply_rope(torch.from_numpy(x), ct, st)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_bit_exact(dtype):
    rng = np.random.default_rng(2)
    kj, kt = both(rng.standard_normal((2, 4, 3, 64)) * 0.7, dtype)
    vj, vt = both(rng.standard_normal((2, 4, 3, 64)) * 3.0, dtype)
    # A zero row exercises the 1e-8 scale floor.
    kj = kj.at[0, 0, 0].set(0)
    kt[0, 0, 0] = 0
    outj = jattn.quantize_kv_rows(kj, vj)
    outt = tattn.quantize_kv_rows(kt, vt)
    for a, b in zip(outj, outt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _ring_inputs(b, h, c, dh, t, pos, quant, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, t, dh)) * 0.5
    k_new = rng.standard_normal((b, h, t, dh)) * 0.5
    v_new = rng.standard_normal((b, h, t, dh)) * 0.5
    if quant:
        kc = rng.integers(-127, 128, (b, h, c, dh)).astype(np.int8)
        vc = rng.integers(-127, 128, (b, h, c, dh)).astype(np.int8)
    else:
        kc = rng.standard_normal((b, h, c, dh))
        vc = rng.standard_normal((b, h, c, dh))
    ks = rng.uniform(0.001, 0.02, (b, h, c)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (b, h, c)).astype(np.float32)
    valid = rng.uniform(size=(b, c)) < 0.8
    pairs = {}
    for name, a in dict(q=q, k_new=k_new, v_new=v_new).items():
        pairs[name] = both(a, dtype)
    for name, a in dict(kc=kc, vc=vc).items():
        pairs[name] = both(a, "int8" if quant else dtype)
    for name, a in dict(ks=ks, vs=vs).items():
        pairs[name] = both(a)
    pairs["valid"] = (jnp.asarray(valid), torch.from_numpy(valid))
    return pairs


@pytest.mark.parametrize("t,pos", [(1, 0), (1, 40), (1, 1000), (2, 0), (2, 254), (2, 1000)])
@pytest.mark.parametrize("quant", [False, True])
def test_attend_global_split_matches_jax(t, pos, quant):
    b, h, c, dh, window = 2, 4, 64, 32, 50
    dtype = "bfloat16" if quant else "float32"
    p = _ring_inputs(b, h, c, dh, t, pos, quant, dtype, seed=pos + t)
    jplan = jattn.global_ring_plan(jnp.int32(pos), c, t)
    tplan = tattn.global_ring_plan(pos, c, t)
    np.testing.assert_array_equal(tplan["k_pos"].numpy(), np.asarray(jplan["k_pos"]))
    assert tplan["w"] == [int(x) for x in jplan["w"]]
    args_j = {k: v[0] for k, v in p.items()}
    args_t = {k: v[1] for k, v in p.items()}
    if quant:
        names = ("q", "kc", "vc", "ks", "vs", "k_new", "v_new")
        yj = jattn.attend_global_split_q(*(args_j[n] for n in names), jplan,
                                         args_j["valid"], window=window)
        yt = tattn.attend_global_split_q(*(args_t[n] for n in names), tplan,
                                         args_t["valid"], window=window)
    else:
        names = ("q", "kc", "vc", "k_new", "v_new")
        yj = jattn.attend_global_split(*(args_j[n] for n in names), jplan,
                                       args_j["valid"], window=window)
        yt = tattn.attend_global_split(*(args_t[n] for n in names), tplan,
                                       args_t["valid"], window=window)
    tol = BF16_TOL if quant else F32_TOL
    np.testing.assert_allclose(as_np(yt), as_np(yj), **tol)


def test_ring_write_and_valid_bitmap_match_jax():
    b, h, c, dh, t = 2, 3, 32, 8, 2
    rng = np.random.default_rng(5)
    kc = rng.standard_normal((b, h, c, dh)).astype(np.float32)
    kn = rng.standard_normal((b, h, t, dh)).astype(np.float32)
    valid = rng.uniform(size=(b, c)) < 0.5
    mask = np.array([True, False])
    for pos in (0, 30, 62):
        jplan = jattn.global_ring_plan(jnp.int32(pos), c, t)
        jk, _ = jattn.ring_write_global(jnp.asarray(kc), jnp.asarray(kc),
                                        jnp.asarray(kn), jnp.asarray(kn), jplan)
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(kc.copy())
        tattn.ring_write_global(tk, tv, torch.from_numpy(kn), torch.from_numpy(kn),
                                pos % c)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        jv = jattn.update_valid_bitmap(jnp.asarray(valid), jplan, jnp.asarray(mask))
        tplan = tattn.global_ring_plan(pos, c, t)
        tvld = tattn.update_valid_bitmap(torch.from_numpy(valid), tplan["w"],
                                         torch.from_numpy(mask))
        np.testing.assert_array_equal(tvld.numpy(), np.asarray(jv))


@pytest.mark.parametrize("m", [1, 5, 16, 17, 40])
def test_mm_w8a8_matches_jax(m):
    """M <= 16 takes the zero-row padding; results bit-exact."""
    rng = np.random.default_rng(m)
    x = (rng.standard_normal((m, 64)) * 2.0).astype(np.float32)
    wq = rng.integers(-127, 128, (48, 64)).astype(np.int8)
    s = rng.uniform(0.001, 0.05, 48).astype(np.float32)
    yj = jqmm.mm_w8a8(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s))
    yt = tqmm.mm_w8a8(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(s))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_mm_w8a8_rejects_unaligned_k():
    with pytest.raises(ValueError):
        tqmm.mm_w8a8(torch.zeros(20, 12), torch.zeros(16, 12, dtype=torch.int8),
                     torch.ones(16))


def test_quantize_weights_bit_exact():
    """Per-layer leaves of 49152 elements are quantised because the stacked
    JAX leaf (2 layers) passes the 65536 threshold; small leaves stay."""
    cfg = jT.TransformerConfig(d_model=128, num_heads=4, num_layers=2,
                               dim_feedforward=256, context=16)
    pj = {"transformer": jT.init(cfg, jax.random.PRNGKey(2)),
          "text_emb": jax.random.normal(jax.random.PRNGKey(3), (600, 128))}
    qj = np_tree(jT.quantize_weights(pj))
    qt = tT.quantize_weights(to_port(pj))
    want = bridge.from_numpy_tree(qj)
    assert isinstance(qt["transformer"][0]["in_proj_w"], dict)
    assert not isinstance(qt["text_emb"], dict)
    flat_t = jax.tree_util.tree_leaves(qt)
    flat_w = jax.tree_util.tree_leaves(want)
    assert len(flat_t) == len(flat_w)
    for a, b in zip(flat_t, flat_w):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


CONV_CASES = [
    jconv.ConvConfig(3, 5, 7),                                   # init conv
    jconv.ConvConfig(4, 2, 3, dilation=2),                       # residual
    jconv.ConvConfig(4, 8, 8, stride=4),                         # downsample
    jconv.ConvConfig(4, 4, 4, stride=2, bias=False, pad_mode="replicate"),
    jconv.ConvConfig(4, 6, 1),                                   # no carry
]


@pytest.mark.parametrize("cfg", CONV_CASES, ids=lambda c: f"k{c.k}s{c.stride}{c.pad_mode[0]}")
def test_conv_step_matches_jax(cfg):
    tcfg = tconv.ConvConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    pj = jconv.init(cfg, jax.random.PRNGKey(4))
    pt = to_port(pj)
    b = 3
    sj = jconv.init_state(cfg, b)
    st = tconv.init_state(tcfg, b)
    rng = np.random.default_rng(6)
    masks = [None, np.array([True, False, True]), None, np.array([False, True, True])]
    for i, m in enumerate(masks):
        x = rng.standard_normal((b, cfg.in_c, 2 * cfg.stride)).astype(np.float32)
        mj = None if m is None else jnp.asarray(m)
        mt = None if m is None else torch.from_numpy(m)
        if i == 2:  # a per-slot reset mid-stream
            r = np.array([False, True, False])
            sj = jconv.reset_state(sj, jnp.asarray(r))
            st = tconv.reset_state(st, torch.from_numpy(r))
        yj, sj = jconv.step(cfg, pj, sj, jnp.asarray(x), mj)
        yt, st = tconv.step(tcfg, pt, st, torch.from_numpy(x), mt)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32_TOL)
        np.testing.assert_allclose(st["buf"].numpy(), np.asarray(sj["buf"]), **F32_TOL)


def test_split_encode_codes_equal():
    jcfg = jrvq.SplitRvqConfig(dim=16, input_dim=32, output_dim=32, n_q=4, bins=64)
    tcfg = trvq.SplitRvqConfig(dim=16, input_dim=32, output_dim=32, n_q=4, bins=64)
    pj = jrvq.split_init(jcfg, jax.random.PRNGKey(5))
    xs = np.random.default_rng(7).standard_normal((3, 32, 2)).astype(np.float32)
    cj = jrvq.split_encode(jcfg, pj, jnp.asarray(xs))
    ct = trvq.split_encode(tcfg, to_port(pj), torch.from_numpy(xs))
    assert ct.dtype == torch.int32 and ct.shape == (3, 4, 2)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
