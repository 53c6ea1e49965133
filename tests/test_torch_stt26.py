"""The port's stt-2.6b slice against the JAX package, on the CPU at small
sizes: the weight-only int8 matmul, the profile that travels with the
weights, the explicit fused-attention setting at head-major ring shapes
(Dh = 64), the sinusoidal embedding, the presets, batch sizing, the builders'
options and a small engine without semantic-VAD heads.

Bars: ``qmm_plain`` sums the same exact products as the Pallas kernel (run
in interpret mode) in another order and rounds once, so it agrees within one
bf16 step; in f32 the kernel's formula and XLA's dequant formula coincide up
to summation order (1e-5); W8A8 is exact; a bf16 step through the kernels'
plain versions against the Pallas kernels: 3e-2, the bar of
tests/test_decode_attn.py; f32 engines: tokens and words equal.
"""

import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.models import lm as jLM
from dsm_tpu.models import mimi as jMIMI
from dsm_tpu.ops import decode_attn as jda
from dsm_tpu.ops import qmm as jqmm
from dsm_tpu.ops import ring_kernels as jrk
from dsm_tpu.ops import transformer as jT
from dsm_tpu.server import autoconfig as jAUTO
from dsm_tpu.server import config as jCFG
from dsm_tpu.server.batched_asr import BatchedAsrEngine as JaxEngine
from dsm_tpu.sessions import asr as jASR
from dsm_tpu_torch import bridge
from dsm_tpu_torch.models import lm as tLM
from dsm_tpu_torch.ops import decode_attn as tda
from dsm_tpu_torch.ops import qmm as tqmm
from dsm_tpu_torch.ops import ring_kernels as trk
from dsm_tpu_torch.ops import transformer as tT
from dsm_tpu_torch.server import autoconfig as tAUTO
from dsm_tpu_torch.server import builder as tbuilder
from dsm_tpu_torch.server import config as tCFG
from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine
from dsm_tpu_torch.sessions import asr as tASR
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_ops import JitStep, as_np, to_port
from tests.test_torch_tts import _fields, port_lm_cfg, port_mimi_cfg, port_tcfg

torch.set_num_threads(2)

TOML = "configs/config-stt-en.toml"


def _qmm_case(m, i, o, seed, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, m, i)).astype(np.float32) * 0.5
    wq = rng.integers(-127, 128, (o, i)).astype(np.int8)
    s = rng.uniform(0.001, 0.02, o).astype(np.float32)
    return x, wq, s


def _bf16(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _assert_within_one_bf16_step(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= step), float(np.max(np.abs(got - want) / step))


@pytest.fixture
def jax_profile(monkeypatch):
    """The JAX package's process-wide profile, free of the environment and
    put back afterwards."""
    for var in ("DSM_W8A8", "DSM_W8A8_SITES", "DSM_QMM", "DSM_FUSED_ATTN", "DSM_KERNELS"):
        monkeypatch.delenv(var, raising=False)
    yield jqmm
    jqmm.set_w8a8_default(False)
    jqmm.set_w8a8_sites(None)


# ---------------------------------------------------------------------------
# (a) qmm_plain against the Pallas kernel and the XLA formula
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,i,o,lead", [
    (8, 256, 512, ()), (16, 128, 384, ()), (8, 1408, 256, ()), (2, 256, 384, (4,))])
def test_qmm_plain_matches_the_pallas_kernel(m, i, o, lead):
    x, wq, s = _qmm_case(m, i, o, seed=m + i, lead=lead)
    xj = _bf16(x)
    assert jqmm.supported(xj, jnp.asarray(wq))
    want = jqmm.qmm(xj, jnp.asarray(wq), jnp.asarray(s), interpret=True)
    xt = bridge.to_tensor(np.asarray(xj))
    assert tqmm.supported(xt, torch.from_numpy(wq))
    got = tqmm.qmm(xt, torch.from_numpy(wq), torch.from_numpy(s))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _assert_within_one_bf16_step(as_np(got), as_np(want))
    # Against XLA's dequant formula (the product rounded to bf16, a bf16
    # scale): the bars of tests/test_qmm.py, and never less accurate.
    ref = (xj @ jnp.asarray(wq).astype(jnp.bfloat16).T) * jnp.asarray(s).astype(jnp.bfloat16)
    np.testing.assert_allclose(as_np(got), as_np(ref), atol=1e-1, rtol=2e-2)
    exact = (np.asarray(xj, np.float32) @ wq.astype(np.float32).T) * s
    assert np.abs(as_np(got) - exact).mean() <= np.abs(as_np(ref) - exact).mean() * 1.01


@pytest.mark.parametrize("m,i,o", [(3, 48, 250), (1, 200, 4000), (24, 272, 72), (5, 7, 9)])
def test_qmm_plain_at_shapes_the_tpu_kernel_refuses(m, i, o):
    """Tails in every dimension: against the formula in numpy."""
    x, wq, s = _qmm_case(m, i, o, seed=o)
    xj = _bf16(x)
    assert not jqmm.supported(xj, jnp.asarray(wq))
    exact = (np.asarray(xj, np.float32).astype(np.float64) @ wq.astype(np.float64).T) * s
    got = tqmm.qmm(bridge.to_tensor(np.asarray(xj)), torch.from_numpy(wq), torch.from_numpy(s))
    _assert_within_one_bf16_step(as_np(got), exact)
    got32 = tqmm.qmm(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(s))
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), (x.astype(np.float64) @ wq.T.astype(np.float64))
                               * s, atol=1e-5, rtol=1e-5)


def test_qmm_refuses_what_is_not_an_int8_matrix_of_the_same_width():
    x = torch.zeros(4, 32)
    with pytest.raises(ValueError):
        tqmm.qmm(x, torch.zeros(8, 32), torch.ones(8))             # a dense weight
    with pytest.raises(ValueError):
        tqmm.qmm(x, torch.zeros(8, 16, dtype=torch.int8), torch.ones(8))   # other width
    with pytest.raises(ValueError):
        tqmm.qmm(x, torch.zeros(2, 8, 32, dtype=torch.int8), torch.ones(8))  # a stack


# Clusters of 1, 2, ..., 8 blocks of the qmm kernel that an NVIDIA H100 80GB
# HBM3 holds at once (cudaOccupancyMaxActiveClusters at one block an SM, as
# ``qmm.resident_clusters`` read it on that card): a cluster's blocks share a
# GPC, and the GPCs' SM counts leave SMs over.
RESIDENT_H100 = (132, 66, 39, 30, 22, 17, 15, 15)


@pytest.mark.parametrize("m,o,i,want", [
    (64, 6144, 2048, 2), (64, 2048, 2048, 6), (64, 11264, 2048, 1), (64, 2048, 5632, 6),
    (64, 4000, 2048, 3), (1, 2048, 2048, 6), (24, 2048, 2048, 6), (200, 2048, 4096, 2),
    (1, 1024, 128, 1), (33, 72, 272, 3)])
def test_qmm_tiling_covers_k_and_fills_the_card(m, o, i, want):
    """The tiling the kernel launches (the H100's cluster residency): a
    cluster of at most 8 blocks whose K ranges cover the chunks of K with
    none empty, and at the five stt-2.6b serving shapes (M = 64) a grid of
    one wave of the clusters the card holds at once."""
    tiling = tqmm.qmm_tiling(m, o, i, RESIDENT_H100)
    assert tiling.ksplit == want
    rows = 8 if m <= 8 else 16 if m <= 16 else 32 if m <= 32 else 64
    assert tiling.grid == (-(-o // tqmm.TILE_O), tiling.ksplit, -(-m // rows))
    n_chunks = -(-i // 128)
    ranges = [((r * n_chunks) // tiling.ksplit, ((r + 1) * n_chunks) // tiling.ksplit)
              for r in range(tiling.ksplit)]  # the kernel's split of the chunks
    assert ranges[0][0] == 0 and ranges[-1][1] == n_chunks
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert 1 <= tiling.ksplit <= 8
    if m == 64 and (o, i) in ((6144, 2048), (2048, 2048), (11264, 2048), (2048, 5632),
                              (4000, 2048)):
        clusters = tiling.grid[0] * tiling.grid[2]
        assert clusters <= RESIDENT_H100[tiling.ksplit - 1]  # one wave
        assert clusters * tiling.ksplit >= 88  # two thirds of the card or more


def test_qmm_tiling_follows_the_cards_cluster_residency():
    """A card that holds more clusters of 8 gets the split a wave of them
    allows: the tiling reads the residency it is given."""
    roomy = tuple(132 // k for k in range(1, 9))
    assert tqmm.qmm_tiling(64, 2048, 2048, roomy).ksplit == 8
    assert tqmm.qmm_tiling(64, 2048, 2048, RESIDENT_H100).ksplit == 6


# ---------------------------------------------------------------------------
# (b) mm: the profile travels with the weights
# ---------------------------------------------------------------------------


def _quantized_leaf(o, i, seed):
    w = np.random.default_rng(seed).standard_normal((o, i)).astype(np.float32) * 0.05
    qj = jT.quantize_weights({"w": jnp.asarray(w)}, min_size=1)["w"]
    return qj, to_port({"w": qj})["w"]


@pytest.mark.parametrize("default,sites", [
    (True, None), (False, None), (True, ["in_proj", "mlp_out"]), (True, []),
    (False, ["in_proj"])])
def test_mm_follows_the_profile_as_jax_follows_its_globals(jax_profile, default, sites):
    qj, qt = _quantized_leaf(48, 64, seed=1)
    x = np.random.default_rng(2).standard_normal((5, 64)).astype(np.float32)
    jax_profile.set_w8a8_default(default)
    jax_profile.set_w8a8_sites(sites)
    w8a8 = default if (sites is None or not default) else sites
    wt = tT.quantize_weights({"w": qt}, w8a8=w8a8)["w"]
    assert wt["q"] is qt["q"] and ("w8a8" in wt) == (w8a8 is not True)
    for site in ("in_proj", "mlp_in", "mlp_out", "text_linear", None):
        assert tT.w8a8_at(wt, site) == jax_profile.w8a8_enabled(site)
        # A fresh function a site: the profile is read while tracing.
        yj = np.asarray(jax.jit(lambda x, w, site=site: jT.mm(x, w, site=site))(
            jnp.asarray(x), qj))
        yt = tT.mm(torch.from_numpy(x), wt, site=site).numpy()
        if tT.w8a8_at(wt, site):
            np.testing.assert_array_equal(yt, yj)
        else:  # f32: the kernel's formula and XLA's coincide up to summation order
            np.testing.assert_allclose(yt, yj, atol=1e-5, rtol=1e-5)


def test_two_trees_of_different_profiles_live_at_once(jax_profile):
    """What the JAX package's globals cannot do: one process, one weight,
    a W8A8 tree and a weight-only tree, used in turns."""
    _, qt = _quantized_leaf(48, 64, seed=3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((5, 64)).astype(np.float32))
    a8 = tT.quantize_weights({"w": qt})["w"]
    a16 = tT.quantize_weights({"w": qt}, w8a8=False)["w"]
    assert set(a8) == {"q", "s"} and a16["w8a8"] is False
    y8, y16 = tT.mm(x, a8, site="mlp_in"), tT.mm(x, a16, site="mlp_in")
    assert torch.equal(y8, tqmm.mm_w8a8(x, qt["q"], qt["s"]))
    assert torch.equal(y16, tqmm.qmm_plain(x, qt["q"], qt["s"]))
    assert torch.equal(tT.mm(x, a8, site="mlp_in"), y8) and not torch.equal(y8, y16)
    assert torch.equal(tT.mm_dequant(x, a8), tT.mm_dequant(x, a16))
    # A stacked DepFormer weight: the slice keeps the stack's profile.
    stack = tT.quantize_weights({"w": torch.randn(3, 16, 32)}, min_size=1, w8a8=["dep_out"])
    sl = tLM._slice_w(stack["w"], 1)
    assert sl["w8a8"] == frozenset({"dep_out"}) and sl["q"].shape == (16, 32)


def test_mm_weight_only_matches_the_pallas_route(jax_profile, monkeypatch):
    """bf16, ``DSM_QMM=1``: JAX takes ``_qmm`` (interpret mode) where
    ``supported`` holds; the port takes ``qmm``'s plain version."""
    monkeypatch.setenv("DSM_QMM", "1")
    qj, qt = _quantized_leaf(384, 256, seed=5)
    wt = tT.quantize_weights({"w": qt}, w8a8=False)["w"]
    x = _bf16(np.random.default_rng(6).standard_normal((8, 1, 256)).astype(np.float32))
    calls = []
    monkeypatch.setattr(jqmm, "_qmm", lambda *a, _f=jqmm._qmm, **kw: calls.append(1) or _f(*a, **kw))
    yj = jT.mm(x, qj, site="mlp_in")
    assert calls == [1]
    yt = tT.mm(bridge.to_tensor(np.asarray(x)), wt, site="mlp_in")
    _assert_within_one_bf16_step(as_np(yt), as_np(yj))


# ---------------------------------------------------------------------------
# (c) transformer.step at head-major ring shapes, three fused settings
# ---------------------------------------------------------------------------


class _Counts:
    """Counts calls of module-level functions, on either side."""

    def __init__(self, monkeypatch, targets):
        self.calls = {name: 0 for _, name in targets}
        for mod, name in targets:
            monkeypatch.setattr(mod, name, self._counted(getattr(mod, name), name))

    def _counted(self, fn, name):
        def wrapped(*a, **kw):
            self.calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    def nonzero(self):
        return {k: v for k, v in self.calls.items() if v}


@pytest.mark.parametrize("fused_attn,env,jax_route,port_route", [
    (None, None, "_decode_attend_q", ("quantize_commit", "decode_attend")),
    (True, "1", "_decode_attend_commit_q", ("quantize_scale_commit", "decode_attend_commit")),
    (False, "0", "_decode_attend_q", ("quantize_commit", "decode_attend"))])
def test_step_at_head_major_shapes_matches_the_pallas_kernels(
        jax_profile, monkeypatch, fused_attn, env, jax_route, port_route):
    """h = 8, Dh = 64, ring 256, B = 8, weight-only int8 weights: the JAX
    step through its Pallas kernels (ring commit, decode attention, qmm; all
    in interpret mode) against the port's step through the plain versions,
    both counted."""
    monkeypatch.setenv("DSM_RING_KERNEL", "1")
    monkeypatch.setenv("DSM_DECODE_ATTN", "1")
    monkeypatch.setenv("DSM_QMM", "1")
    if env is not None:
        monkeypatch.setenv("DSM_FUSED_ATTN", env)
    b, d, layers = 8, 512, 2
    cfg = jT.TransformerConfig(d_model=d, num_heads=8, num_layers=layers,
                               dim_feedforward=4 * d, context=250)
    params = jT.quantize_weights(jT.init(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16),
                                 min_size=1)
    assert all(isinstance(params[k], dict) for k in ("in_proj_w", "out_proj_w"))
    pt = tT.quantize_weights(to_port({"transformer": params})["transformer"], w8a8=False)
    tcfg = _fields(tT.TransformerConfig, cfg, fused_attn=fused_attn)
    sj = jT.init_state(cfg, b, jnp.bfloat16, kv_quant=True)
    st = tT.init_state(tcfg, b, kv_quant=True)
    assert st["layers"][0]["k"].shape == (b, 8, 256, 64)
    jcounts = _Counts(monkeypatch, [(jda, "_decode_attend_q"), (jda, "_decode_attend_commit_q"),
                                    (jda, "_decode_attend_q_4d"), (jda, "_decode_attend_q_flash"),
                                    (jda, "_decode_attend_commit_q_4d"), (jqmm, "_qmm"),
                                    (jrk, "_ring_commit_q"), (jrk, "_scale_commit")])
    tcounts = _Counts(monkeypatch, [(trk, "scale_commit"), (tda, "decode_attend_commit"),
                                    (trk, "ring_commit_q"), (tda, "decode_attend"),
                                    (trk, "quantize_commit"), (trk, "quantize_scale_commit"),
                                    (tqmm, "qmm_plain"), (tqmm, "mm_w8a8")])
    rng = np.random.default_rng(1)
    masks = [None, np.arange(b) % 3 != 1, None]
    jstep = JitStep(cfg)
    for m in masks:
        x = (rng.standard_normal((b, 1, d)) * 0.3).astype(np.float32)
        yj, sj = jstep(params, sj, _bf16(x), None if m is None else jnp.asarray(m))
        yt, st = tT.step(tcfg, pt, st, torch.from_numpy(x).to(torch.bfloat16),
                         None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(as_np(yt), as_np(yj), atol=3e-2, rtol=3e-2)
    n, nj = layers * len(masks), layers * jstep.traces  # the JAX side counts per trace
    jax_commit = "_scale_commit" if fused_attn else "_ring_commit_q"
    assert jcounts.nonzero() == {jax_route: nj, jax_commit: nj, "_qmm": 4 * nj}
    assert tcounts.nonzero() == {port_route[0]: n, port_route[1]: n, "qmm_plain": 4 * n}
    np.testing.assert_array_equal(st["valid"].numpy(), np.asarray(sj["valid"]))
    # The scales of layer 0's fresh rows come from matmuls summed in another
    # order: equal to a bf16 step of the rows they were taken from.
    np.testing.assert_allclose(st["layers"][0]["ks"].numpy(), np.asarray(sj["layers"][0]["ks"]),
                               rtol=2e-2, atol=1e-6)


def test_the_three_fused_settings_write_the_same_rings():
    cfg = {f: tT.TransformerConfig(d_model=512, num_heads=8, num_layers=2, dim_feedforward=512,
                                   context=250, fused_attn=f) for f in (None, True, False)}
    gen = torch.Generator().manual_seed(0)
    params = tT.quantize_weights(tT.init(cfg[None], gen, dtype=torch.bfloat16), min_size=1,
                                 w8a8=False)
    state = {f: tT.init_state(c, 3, kv_quant=True) for f, c in cfg.items()}
    ys = {}
    for _ in range(4):
        x = (torch.randn(3, 1, 512, generator=gen) * 0.3).bfloat16()
        for f, c in cfg.items():
            ys[f], state[f] = tT.step(c, params, state[f], x)
    assert torch.equal(ys[None], ys[False])
    np.testing.assert_allclose(as_np(ys[True]), as_np(ys[False]), atol=2e-2, rtol=2e-2)
    for key in ("k", "v", "ks", "vs"):  # layer 0 sees the same input in all three
        assert torch.equal(state[True]["layers"][0][key], state[False]["layers"][0][key])
        assert torch.equal(state[None]["layers"][1][key], state[False]["layers"][1][key])


@pytest.mark.parametrize("h,dh,c,rule,forced", [
    (32, 64, 384, False, True),    # stt-2.6b: mono, head-major
    (16, 128, 768, True, True),    # stt-1b: mono and 4-D
    (20, 128, 3072, False, False),  # s2s-2b: neither, whatever the setting
    (8, 64, 256, False, True)])
def test_fused_commit_supported_honours_the_setting(h, dh, c, rule, forced):
    q = torch.zeros(2, h, 1, dh, dtype=torch.bfloat16)
    ring = torch.zeros(1, h, c, dh, dtype=torch.int8).expand(2, h, c, dh)
    plan = {"w": [3], "q_pos": [3]}
    assert tda.fused_commit_supported(q, ring, plan) == rule
    assert tda.fused_commit_supported(q, ring, plan, None) == rule
    assert tda.fused_commit_supported(q, ring, plan, True) == forced
    assert not tda.fused_commit_supported(q, ring, plan, False)
    assert not tda.fused_commit_supported(q, ring.float(), plan, True)  # not an int8 ring


# ---------------------------------------------------------------------------
# (d) the sinusoidal embedding, (e) the presets
# ---------------------------------------------------------------------------


def test_sin_positional_embedding_matches_jax():
    cfg = jT.TransformerConfig(d_model=64, num_heads=4, num_layers=2, dim_feedforward=128,
                               context=24, positional_embedding="sin")
    tcfg = port_tcfg(cfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 64)).astype(np.float32)
    pos = rng.integers(0, 200, (3, 2)).astype(np.int32)
    want = jT._pos_embed_sin(cfg, jnp.asarray(x), jnp.asarray(pos))
    got = tT._pos_embed_sin(tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)
    # Through the step, over a ring that wraps (32 rows, 40 steps).
    params = jT.init(cfg, jax.random.PRNGKey(1))
    pt = to_port({"transformer": params})["transformer"]
    sj, st = jT.init_state(cfg, 2, jnp.float32), tT.init_state(tcfg, 2, torch.float32)
    jstep = JitStep(cfg)
    for i in range(40):
        xs = rng.standard_normal((2, 1, 64)).astype(np.float32)
        yj, sj = jstep(params, sj, jnp.asarray(xs))
        yt, st = tT.step(tcfg, pt, st, torch.from_numpy(xs))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="positional embedding"):
        tT.init(tT.TransformerConfig(64, 4, 1, 128, 8, positional_embedding="alibi"),
                torch.Generator())


@pytest.mark.parametrize("name", ["stt_2_6b_en", "asr_300m_202501", "asr_v0_1_1b",
                                  "stt_1b_en_fr"])
def test_presets_match_jax_field_for_field(name):
    j, t = getattr(jLM, name)(), getattr(tLM, name)()
    assert t == port_lm_cfg(j)
    for f in tT.TransformerConfig.__dataclass_fields__:
        if hasattr(j.transformer, f):
            assert getattr(t.transformer, f) == getattr(j.transformer, f), f
    for f in tLM.LmConfig.__dataclass_fields__:
        if f not in ("transformer", "depformer"):
            assert getattr(t, f) == getattr(j, f), f
    assert t.depformer is None and t.transformer.fused_attn is None


def test_serving_toml_is_the_stt_2_6b_preset():
    t = tCFG.Config.load(TOML).modules["asr"]
    j = jCFG.Config.load(TOML).modules["asr"]
    assert t.lm == tLM.stt_2_6b_en() == port_lm_cfg(j.lm)
    assert t.lm.extra_heads is None and t.lm.transformer.hd == 64
    assert (t.asr_delay_in_tokens, t.batch_size, t.raw["w8a8"]) == (32, 64, False)
    assert tT.capacity(t.lm.transformer, 1, True) == 384
    q = torch.zeros(64, 32, 1, 64, dtype=torch.bfloat16)
    ring = torch.zeros(1, 32, 384, 64, dtype=torch.int8).expand(64, 32, 384, 64)
    plan = {"w": [5], "q_pos": [5]}
    assert not tda.fused_commit_supported(q, ring, plan) and tda.supported(q, ring, plan)
    assert tda.pick_split(64 * 32, 384) == 1


# ---------------------------------------------------------------------------
# (g) batch sizing, (h) the builders' options
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["stt_2_6b_en", "stt_1b_en_fr"])
@pytest.mark.parametrize("total_gb,requested", [(80, 64), (16, 64), (16, 400), (4, 64), (80, 1)])
def test_auto_batch_size_matches_jax(monkeypatch, name, total_gb, requested):
    for var in ("DSM_HBM_RESERVED_MB", "DSM_PER_SLOT_MB"):
        monkeypatch.delenv(var, raising=False)  # the JAX side reads both
    j, t = getattr(jLM, name)(), getattr(tLM, name)()
    total = total_gb * 2**30
    monkeypatch.setattr(jAUTO, "device_memory_bytes", lambda: total)
    assert tAUTO.per_slot_bytes(t) == jAUTO.per_slot_bytes(j)
    assert tAUTO.model_bytes(t) == jAUTO.model_bytes(j)
    assert tAUTO.auto_batch_size(requested, t, total) == jAUTO.auto_batch_size(requested, j)
    monkeypatch.setenv("DSM_HBM_RESERVED_MB", "4096")
    assert (tAUTO.auto_batch_size(requested, t, total, reserved_mb=4096)
            == jAUTO.auto_batch_size(requested, j))


def test_auto_batch_size_without_a_card_keeps_the_request():
    assert tAUTO.device_memory_bytes("cpu") is None
    assert tAUTO.auto_batch_size(64, tLM.stt_2_6b_en(), None) == 64
    assert tAUTO.auto_batch_size(64, tLM.stt_2_6b_en(), 2**30) == 1  # weights alone exceed it


def _small_stt26_module(**over):
    """configs/config-stt-en.toml (w8a8 = false as shipped) at two layers and
    narrow widths: 2 heads x 64, no semantic-VAD heads, a 3-token delay."""
    with open(TOML, "rb") as f:
        raw = tomllib.load(f)
    mod = raw["modules"]["asr"]
    assert mod["w8a8"] is False
    mod.update(batch_size=3, asr_delay_in_tokens=3)
    mod.update(over)
    mod["model"].update(audio_codebooks=4, audio_vocab_size=33, text_in_vocab_size=17,
                        text_out_vocab_size=16)
    mod["model"]["transformer"].update(d_model=128, num_heads=2, num_layers=2,
                                       dim_feedforward=512, context=40)
    return tCFG.Config.from_dict(raw).modules["asr"], jCFG.Config.from_dict(raw).modules["asr"]


@pytest.mark.parametrize("key,value,profile", [
    (None, None, False), ("w8a8", True, True), ("w8a8_sites", ["in_proj", "mlp_in"], False),
    ("w8a8_sites", "in_proj, out_proj", False)])
def test_quantize_lm_writes_the_tomls_profile(key, value, profile):
    """``w8a8`` and ``w8a8_sites`` of the TOML become the profile that the
    int8 weights carry (what ``build_batched_asr`` does on a CUDA device)."""
    mod, _ = _small_stt26_module(**({key: value} if key else {}))
    gen = torch.Generator().manual_seed(0)
    lm = tLM.init(mod.lm, gen)
    q = tbuilder._quantize_lm(mod, lm, tbuilder._w8a8_sites(mod))
    leaf = q["transformer"][0]["in_proj_w"]
    assert leaf["q"].dtype == torch.int8 and leaf.get("w8a8", True) is profile
    assert not isinstance(q["text_emb"], dict)
    both = dict(mod.raw, w8a8=True, w8a8_sites=value if key == "w8a8_sites" else "mlp_out")
    mod.raw.update(both)
    leaf = tbuilder._quantize_lm(mod, lm, tbuilder._w8a8_sites(mod))["transformer"][0]["mlp"]
    want = frozenset(["in_proj", "mlp_in"] if isinstance(value, list) else
                     ["in_proj", "out_proj"] if key == "w8a8_sites" else ["mlp_out"])
    assert leaf["linear_in"]["w8a8"] == want
    assert tT.w8a8_at(leaf["linear_in"], "mlp_in") == ("mlp_in" in want)
    mod.raw["weight_quant"] = False
    assert tbuilder._quantize_lm(mod, lm) is lm


@pytest.mark.parametrize("over", [{}, {"w8a8_sites": ["in_proj"]}, {"w8a8": True}])
def test_builder_accepts_the_weight_only_profile(over):
    mod, _ = _small_stt26_module(**over)
    eng = tbuilder.build_batched_asr(mod, "cpu")
    assert eng.batch_size == 3 and eng.cfg.asr_delay_in_tokens == 3
    assert eng.cfg.lm.extra_heads is None and eng.cfg.lm.transformer.hd == 64
    assert not eng.cfg.kv_quant  # the CPU profile: f32, no quantisation
    meshed, _ = _small_stt26_module(mesh={"dp": 2}, batch_size=4)  # served since the mesh
    eng = tbuilder.build_batched_asr(meshed, "cpu")
    assert eng.mesh.shape == {"dp": 2, "tp": 1} and eng.state is None
    assert [sh.batch_size for sh, in eng.shards] == [2, 2]
    n = torch.cuda.device_count()  # on CUDA more shards than cards raise
    over, _ = _small_stt26_module(mesh={"dp": n + 2}, batch_size=n + 2)
    with pytest.raises(ValueError, match="devices, have"):
        tbuilder.build_mesh_from_config(over, "cuda")
    i16, _ = _small_stt26_module(pcm_wire="int16", pipeline_depth=2)
    eng = tbuilder.build_batched_asr(i16, "cpu")  # both ported: the JAX builder's keys
    assert eng._pcm_wire_int16 and eng.pipeline_depth == 2


@pytest.mark.parametrize("wire", ["f32", "FLOAT32", ""])
def test_builder_serves_the_f32_pcm_wire(wire):
    """``pcm_wire = "f32"`` / ``"float32"`` (any case) or empty name the wire the
    engine serves; the JAX builder maps them to its default too."""
    mod, _ = _small_stt26_module(pcm_wire=wire)
    eng = tbuilder.build_batched_asr(mod, "cpu")
    assert eng.batch_size == 3 and not eng.cfg.kv_quant


@pytest.mark.parametrize("wire,err", [("int16", None), ("Int16", None), ("bogus", ValueError)])
def test_builder_refuses_other_pcm_wires(wire, err):
    """``int16`` in any case builds the engine with the int16 upload wire, as
    the JAX builder does; any other name is refused, where the JAX builder
    would fall back to f32 without a word."""
    mod, _ = _small_stt26_module(pcm_wire=wire)
    if err is not None:
        with pytest.raises(err, match="pcm_wire"):
            tbuilder.build_batched_asr(mod, "cpu")
        return
    eng = tbuilder.build_batched_asr(mod, "cpu")
    assert eng._pcm_wire_int16 and eng.pipeline_depth == 1


# ---------------------------------------------------------------------------
# (f) a small stt-2.6b-shaped engine against the JAX engine
# ---------------------------------------------------------------------------


def _pcm(seed, frames, frame):
    return np.random.default_rng(seed).standard_normal(frame * frames).astype(np.float32) * 0.1


def _serve(eng, frame):
    """Three streams with markers, one of them in a reused slot."""
    log = {i: [] for i in range(4)}
    eng.warmup()
    chans = {}
    for i in range(3):
        chans[i] = eng.open_channel(log[i].append, seed=10 + i)
        chans[i].push_pcm(_pcm(i, 6 + 2 * i, frame))
        eng.add_marker(chans[i], 100 + i)
        chans[i].push_pcm(np.zeros(frame * 4, np.float32))
    assert eng.open_channel(lambda e: None) is None
    for _ in range(11):
        eng.tick()
    eng.flush()
    eng.close_channel(chans[0])
    chans[3] = eng.open_channel(log[3].append, seed=20)
    assert chans[3].slot == chans[0].slot
    chans[3].push_pcm(_pcm(9, 7, frame))
    eng.add_marker(chans[3], 103)
    chans[3].push_pcm(np.zeros(frame * 4, np.float32))
    for _ in range(16):
        eng.tick()
    eng.flush()
    return {i: [(e.step_idx, [(type(w).__name__, getattr(w, "tokens", None),
                               getattr(w, "start_time", None), getattr(w, "stop_time", None))
                              for w in e.words], list(e.markers), e.prs)
                for e in evs] for i, evs in log.items()}


def test_small_stt26_engine_matches_the_jax_engine(jax_profile):
    """Weight-only int8 weights (``w8a8 = false`` in the TOML), no extra
    heads, f32, tokens drawn from per-slot seeded streams: the port's engine
    on bridged weights gives the JAX engine's events word for word, marker
    for marker, token for token."""
    mod, jmod = _small_stt26_module(temperature=0.7)  # sampled, so that words appear
    assert mod.lm == port_lm_cfg(jmod.lm) and mod.lm.extra_heads is None
    jax_profile.set_w8a8_default(bool(jmod.raw["w8a8"]))
    mimi_cfg = small_mimi_cfg()
    jcfg = jASR.AsrConfig(lm=jmod.lm, mimi=mimi_cfg,
                          asr_delay_in_tokens=jmod.asr_delay_in_tokens,
                          temperature=jmod.temperature)
    key = jax.random.PRNGKey(0)
    lm_q = jT.quantize_weights(jLM.init(jmod.lm, key), min_size=1)
    assert isinstance(lm_q["text_linear"], dict)
    params = {"lm": lm_q, "mimi": jMIMI.init(mimi_cfg, jax.random.fold_in(key, 1))}
    ej = JaxEngine(jcfg, params, batch_size=3, fill_gate_frac=0.0, use_native_packer=False)
    tcfg = _fields(tASR.AsrConfig, jcfg, lm=mod.lm, mimi=port_mimi_cfg(mimi_cfg))
    lm_t = tT.quantize_weights(to_port(lm_q), w8a8=mod.raw["w8a8"])
    assert lm_t["transformer"][0]["in_proj_w"]["w8a8"] is False
    et = BatchedAsrEngine(tcfg, {"lm": lm_t, "mimi": to_port(params["mimi"])}, batch_size=3,
                          device="cpu", fill_gate_frac=0.0)
    frame = mimi_cfg.frame_size
    got, want = _serve(et, frame), _serve(ej, frame)
    assert got == want
    markers = [m for evs in got.values() for e in evs for m in e[2]]
    assert sorted(markers) == [100, 101, 102, 103]
    assert any(e[1] for evs in got.values() for e in evs), "no word came out"
    assert all(e[3] is None for evs in got.values() for e in evs)  # no VAD heads
    np.testing.assert_array_equal(et.state["text_token"].numpy(),
                                  np.asarray(ej.state["text_token"]))
    np.testing.assert_array_equal(et.state["next_codebooks"].numpy(),
                                  np.asarray(ej.state["next_codebooks"]))
