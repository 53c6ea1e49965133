"""The plain versions of the port's three kernels against the JAX
package's Pallas kernels (interpret mode on the CPU).  The CUDA kernels
are held against these plain versions in tests/test_torch_cuda.py.

Rings and scale rings must match bit for bit; attention outputs within
atol = rtol = 2e-2, the bar of tests/test_decode_attn.py (the kernels sum
in other orders and round the probabilities to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.ops import attention as jattn
from dsm_tpu.ops import decode_attn as jda
from dsm_tpu.ops import ring_kernels as jrk
from dsm_tpu_torch import bridge
from dsm_tpu_torch.ops import attention as tattn
from dsm_tpu_torch.ops import decode_attn as tda
from dsm_tpu_torch.ops import ring_kernels as trk

torch.set_num_threads(2)

ATTN_TOL = dict(atol=2e-2, rtol=2e-2)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def tick(pos):
    """A position as the wrappers take it: the step's 0-d int32 tensor."""
    return torch.tensor(pos, dtype=torch.int32)


def pair(a, dtype):
    j = jnp.asarray(a).astype(dtype)
    return j, bridge.to_tensor(np.asarray(j))


# ---------------------------------------------------------------------------
# ring_commit
# ---------------------------------------------------------------------------


def _commit_inputs(b, h, c, t, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, c, dh)), rng.standard_normal((b, h, c, dh)),
            rng.standard_normal((b, h, t, dh)), rng.standard_normal((b, h, t, dh)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("w", [0, 40, 254])
def test_ring_commit_plain_matches_pallas(dtype, w):
    b, h, c, t, dh = 2, 8, 256, 2, 64  # the Mimi ring at B=2
    kc, vc, kn, vn = (pair(a, dtype) for a in _commit_inputs(b, h, c, t, dh, dtype, w))
    kj, vj = jrk.ring_commit(kc[0], vc[0], kn[0], vn[0], w, interpret=True)
    trk.ring_commit(kc[1], vc[1], kn[1], vn[1], tick(w))
    np.testing.assert_array_equal(as_np(kc[1]), as_np(kj))
    np.testing.assert_array_equal(as_np(vc[1]), as_np(vj))


@pytest.mark.parametrize("w", [1, 255, 256])
def test_ring_commit_rejects_misaligned_rows(w):
    """A host int is refused (the wrappers take the step's device tick); a
    tick that is not a multiple of T is refused; 256 is a later tick whose
    rows wrap to row 0."""
    z = torch.zeros(1, 1, 256, 8)
    rows = torch.ones(1, 1, 2, 8)
    with pytest.raises(ValueError):
        trk.ring_commit(z, z.clone(), rows, rows, w)
    if w % 2:
        with pytest.raises(ValueError):
            trk.ring_commit(z, z.clone(), rows, rows, tick(w))
    else:
        trk.ring_commit(z, z.clone(), rows, rows, tick(w))
        assert z[:, :, :2].eq(1).all() and not z[:, :, 2:].any()


# ---------------------------------------------------------------------------
# scale_commit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", [0, 5, 767])
def test_scale_commit_plain_matches_pallas(w):
    b, h, c = 2, 16, 768
    rng = np.random.default_rng(w)
    ks, vs = pair(rng.uniform(size=(b, h, c)), "float32"), pair(rng.uniform(size=(b, h, c)), "float32")
    ksn, vsn = pair(rng.uniform(size=(b, h, 1)), "float32"), pair(rng.uniform(size=(b, h, 1)), "float32")
    kj, vj = jrk.scale_commit(ks[0], vs[0], ksn[0], vsn[0], w, interpret=True)
    trk.scale_commit(ks[1], vs[1], ksn[1], vsn[1], tick(w))
    np.testing.assert_array_equal(ks[1].numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vs[1].numpy(), np.asarray(vj))


# ---------------------------------------------------------------------------
# decode_attend_commit
# ---------------------------------------------------------------------------


def _attn_inputs(b, h, c, dh, valid_frac, seed):
    """numpy inputs as tests/test_decode_attn.py builds them."""
    rng = np.random.default_rng(seed)
    return dict(
        q=rng.standard_normal((b, h, 1, dh)) * 0.5,
        k_new=rng.standard_normal((b, h, 1, dh)) * 0.5,
        v_new=rng.standard_normal((b, h, 1, dh)) * 0.5,
        kc=rng.integers(-127, 128, (b, h, c, dh)),
        vc=rng.integers(-127, 128, (b, h, c, dh)),
        ks=rng.uniform(0.001, 0.02, (b, h, c)),
        vs=rng.uniform(0.001, 0.02, (b, h, c)),
        valid=rng.uniform(size=(b, c)) < valid_frac,
    )


def _to_pairs(inp):
    dt = dict(q="bfloat16", k_new="bfloat16", v_new="bfloat16", kc="int8",
              vc="int8", ks="float32", vs="float32", valid="bool")
    return {k: pair(v, dt[k]) for k, v in inp.items()}


GRID = [
    (2, 8, 256, 128, 0, 250, 1.0),      # first step after reset
    (2, 8, 256, 128, 40, 250, 1.0),     # partial fill
    (2, 8, 256, 128, 255, 250, 1.0),    # last pre-wrap write
    (2, 8, 256, 128, 1000, 250, 0.6),   # wrap + validity holes
    (1, 16, 768, 128, 3000, 750, 0.9),  # stt-1b serving shape
]


@pytest.mark.parametrize("B,H,C,Dh,pos,window,valid_frac", GRID)
def test_decode_attend_commit_plain_matches_pallas(B, H, C, Dh, pos, window, valid_frac):
    p = _to_pairs(_attn_inputs(B, H, C, Dh, valid_frac, seed=pos + B))
    j = {k: v[0] for k, v in p.items()}
    t = {k: v[1] for k, v in p.items()}
    kqj, vqj, ksnj, vsnj = jax.jit(jattn.quantize_kv_rows)(j["k_new"], j["v_new"])
    kqt, vqt, ksnt, vsnt = tattn.quantize_kv_rows(t["k_new"], t["v_new"])
    jplan = jattn.global_ring_plan(jnp.int32(pos), C, 1)
    tplan = tattn.global_ring_plan(pos, C, 1)

    ksj, vsj = jrk.scale_commit(j["ks"], j["vs"], ksnj, vsnj, jplan["w"][0], interpret=True)
    trk.scale_commit(t["ks"], t["vs"], ksnt, vsnt, tplan["pos"])
    np.testing.assert_array_equal(t["ks"].numpy(), np.asarray(ksj))
    np.testing.assert_array_equal(t["vs"].numpy(), np.asarray(vsj))

    yj, kj, vj = jda.decode_attend_commit(
        j["q"], j["kc"], j["vc"], ksj, vsj, kqj, vqj, j["k_new"], j["v_new"],
        jplan, j["valid"], window=window, interpret=True)
    yt, kt, vt = tda.decode_attend_commit(
        t["q"], t["kc"], t["vc"], t["ks"], t["vs"], kqt, vqt, t["k_new"],
        t["v_new"], tplan, t["valid"], window=window)
    assert kt is t["kc"] and vt is t["vc"]  # committed in place
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert yt.shape == (B, H, 1, Dh) and yt.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(yt), as_np(yj), **ATTN_TOL)


def test_decode_attend_commit_first_step_is_fresh_row():
    """At pos 0 with an empty bitmap only the fresh row attends."""
    B, H, C, Dh = 2, 8, 256, 128
    t = {k: v[1] for k, v in _to_pairs(_attn_inputs(B, H, C, Dh, 1.0, 3)).items()}
    kq, vq, _, _ = tattn.quantize_kv_rows(t["k_new"], t["v_new"])
    y, _, _ = tda.decode_attend_commit(
        t["q"], t["kc"], t["vc"], t["ks"], t["vs"], kq, vq, t["k_new"],
        t["v_new"], tattn.global_ring_plan(0, C, 1), torch.zeros(B, C, dtype=torch.bool),
        window=250)
    np.testing.assert_array_equal(as_np(y), as_np(t["v_new"]))


# ---------------------------------------------------------------------------
# The split ring pipeline: ring_commit_q, then decode_attend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,C,Dh,w", [(2, 20, 256, 128, 0), (2, 20, 256, 128, 133),
                                        (2, 20, 256, 128, 255), (1, 32, 384, 64, 100)])
def test_ring_commit_q_plain_matches_pallas(B, H, C, Dh, w):
    """All four rings bit for bit against ``_ring_commit_q`` (interpret)."""
    rng = np.random.default_rng(w + C)
    kc, vc = (pair(rng.integers(-127, 128, (B, H, C, Dh)), "int8") for _ in range(2))
    kn, vn = (pair(rng.integers(-127, 128, (B, H, 1, Dh)), "int8") for _ in range(2))
    ks, vs = (pair(rng.uniform(size=(B, H, C)), "float32") for _ in range(2))
    ksn, vsn = (pair(rng.uniform(size=(B, H, 1)), "float32") for _ in range(2))
    assert jrk.supported(kc[0], kn[0], True)
    want = jrk.ring_commit(kc[0], vc[0], kn[0], vn[0], w, ks[0], vs[0], ksn[0], vsn[0],
                           interpret=True)
    trk.ring_commit(kc[1], vc[1], kn[1], vn[1], tick(w), ks[1], vs[1], ksn[1], vsn[1])
    for got, ref in zip((kc[1], vc[1], ks[1], vs[1]), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert trk.ring_commit_q.launches == 0  # CPU tensors: the plain version


def test_ring_commit_q_keeps_the_semantic_conditions_only():
    """Any B (the JAX kernel's batch block refuses 24), no tiling terms; the
    tick past the ring's end writes row ``tick % C``; a host int is refused."""
    kc = torch.zeros(24, 3, 40, 12, dtype=torch.int8)
    ks = torch.zeros(24, 3, 40)
    kn = torch.ones(24, 3, 1, 12, dtype=torch.int8)
    trk.ring_commit(kc, kc.clone(), kn, kn, tick(39), ks, ks.clone(), ks[:, :, :1] + 2,
                    ks[:, :, :1] + 2)
    assert kc[:, :, 39].eq(1).all() and not kc[:, :, :39].any() and ks[:, :, 39].eq(2).all()
    trk.ring_commit(kc, kc.clone(), kn + 1, kn, tick(40), ks, ks.clone(), ks[:, :, :1] + 3,
                    ks[:, :, :1])
    assert kc[:, :, 0].eq(2).all() and ks[:, :, 0].eq(3).all() and kc[:, :, 39].eq(1).all()
    with pytest.raises(ValueError):
        trk.ring_commit(kc, kc.clone(), kn, kn, 40, ks, ks.clone(), ks[:, :, :1],
                        ks[:, :, :1])
    big = jnp.zeros((24, 20, 256, 128), jnp.int8)
    assert not jrk.supported(big, big[:, :, :1], True)  # b % 16: Mosaic tiling


SPLIT_GRID = [
    (2, 20, 256, 128, 40, 250, 1.0),      # h % 8 != 0, one chunk on the TPU
    (2, 20, 1024, 128, 5000, 900, 0.9),   # h % 8 != 0, several chunks, deep wrap
    (1, 20, 3072, 128, 3100, 3000, 0.9),  # s2s-2b serving shape
    (1, 32, 4096, 64, 4200, 4096, 0.9),   # tts_v0_1 shape
]


@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("B,H,C,Dh,pos,window,valid_frac", SPLIT_GRID)
def test_decode_attend_plain_matches_pallas_flash_and_xla(B, H, C, Dh, pos, window,
                                                          valid_frac, n_split):
    """``decode_attend_plain`` (the kernel's order of operations, with and
    without its split) within 2e-2 of ``_decode_attend_q_flash`` in interpret
    mode and of both packages' ``attend_global_split_q``: the bar of
    tests/test_decode_attn.py (other summation orders, probabilities rounded
    to bf16 relative to each span's own maximum)."""
    p = _to_pairs(_attn_inputs(B, H, C, Dh, valid_frac, seed=pos + B + H))
    j = {k: v[0] for k, v in p.items()}
    t = {k: v[1] for k, v in p.items()}
    jplan = jattn.global_ring_plan(jnp.int32(pos), C, 1)
    tplan = tattn.global_ring_plan(pos, C, 1)
    assert jda.supported(j["q"], j["kc"], jplan) and not jda._mono_ok(H, C, Dh, False)
    assert tda.supported(t["q"], t["kc"], tplan)
    assert not tda.fused_commit_supported(t["q"], t["kc"], tplan)

    y_xla = jattn.attend_global_split_q(j["q"], j["kc"], j["vc"], j["ks"], j["vs"],
                                        j["k_new"], j["v_new"], jplan, j["valid"],
                                        window=window)
    y_port_xla = tattn.attend_global_split_q(t["q"], t["kc"], t["vc"], t["ks"], t["vs"],
                                             t["k_new"], t["v_new"], tplan, t["valid"],
                                             window=window)
    kq, vq, ksn, vsn = jax.jit(jattn.quantize_kv_rows)(j["k_new"], j["v_new"])
    kc2, vc2, ks2, vs2 = jrk.ring_commit(j["kc"], j["vc"], kq, vq, jplan["w"][0], j["ks"],
                                         j["vs"], ksn, vsn, interpret=True)
    y_flash = jda.decode_attend(j["q"], kc2, vc2, ks2, vs2, j["k_new"], j["v_new"], jplan,
                                j["valid"], window=window, interpret=True)

    kqt, vqt, ksnt, vsnt = tattn.quantize_kv_rows(t["k_new"], t["v_new"])
    trk.ring_commit(t["kc"], t["vc"], kqt, vqt, tplan["pos"], t["ks"], t["vs"], ksnt, vsnt)
    np.testing.assert_array_equal(t["kc"].numpy(), np.asarray(kc2))
    np.testing.assert_array_equal(t["vs"].numpy(), np.asarray(vs2))
    y = tda.decode_attend(t["q"], t["kc"], t["vc"], t["ks"], t["vs"], t["k_new"],
                          t["v_new"], tplan, t["valid"], window=window, n_split=n_split)
    assert y.shape == (B, H, 1, Dh) and y.dtype == torch.bfloat16
    for ref in (y_flash, y_xla, y_port_xla):
        np.testing.assert_allclose(as_np(y), as_np(ref), **ATTN_TOL)


@pytest.mark.parametrize("n_split", [1, 4])
def test_decode_attend_first_step_ignores_garbage_ring(n_split):
    """At pos 0 with an empty bitmap no span has an attended row: the output
    is the fresh row, as for ``_decode_attend_q_flash``."""
    B, H, C, Dh = 2, 20, 1024, 128
    p = _to_pairs(_attn_inputs(B, H, C, Dh, 1.0, 11))
    j = {k: v[0] for k, v in p.items()}
    t = {k: v[1] for k, v in p.items()}
    none_j, none_t = jnp.zeros((B, C), bool), torch.zeros(B, C, dtype=torch.bool)
    jplan = jattn.global_ring_plan(jnp.int32(0), C, 1)
    kq, vq, ksn, vsn = jax.jit(jattn.quantize_kv_rows)(j["k_new"], j["v_new"])
    kc2, vc2, ks2, vs2 = jrk.ring_commit(j["kc"], j["vc"], kq, vq, jplan["w"][0], j["ks"],
                                         j["vs"], ksn, vsn, interpret=True)
    yj = jda.decode_attend(j["q"], kc2, vc2, ks2, vs2, j["k_new"], j["v_new"], jplan,
                           none_j, window=1000, interpret=True)
    y = tda.decode_attend(t["q"], bridge.to_tensor(np.asarray(kc2)),
                          bridge.to_tensor(np.asarray(vc2)), bridge.to_tensor(np.asarray(ks2)),
                          bridge.to_tensor(np.asarray(vs2)), t["k_new"], t["v_new"],
                          tattn.global_ring_plan(0, C, 1), none_t, window=1000,
                          n_split=n_split)
    np.testing.assert_array_equal(as_np(y), as_np(t["v_new"]))
    np.testing.assert_allclose(as_np(y), as_np(yj), **ATTN_TOL)


@pytest.mark.parametrize("pos", [0, 7, 300, 1000])
def test_decode_attend_masks_the_committed_row(pos):
    """The split pipeline attends after the commit, so ring row w holds this
    step's row; a huge value there must not move the output, which equals
    the fused pipeline's over the pre-commit ring."""
    B, H, C, Dh, window = 2, 20, 256, 128, 250
    t = {k: v[1] for k, v in _to_pairs(_attn_inputs(B, H, C, Dh, 0.8, pos)).items()}
    plan = tattn.global_ring_plan(pos, C, 1)
    w = plan["w"][0]
    kq, vq, ksn, vsn = tattn.quantize_kv_rows(t["k_new"], t["v_new"])
    pre = {k: t[k].clone() for k in ("kc", "vc", "ks", "vs")}
    trk.scale_commit(pre["ks"], pre["vs"], ksn, vsn, w)
    y_fused, _, _ = tda.decode_attend_commit(
        t["q"], pre["kc"], pre["vc"], pre["ks"], pre["vs"], kq, vq, t["k_new"], t["v_new"],
        plan, t["valid"], window=window)
    t["kc"][:, :, w] = 127
    t["vc"][:, :, w] = 127
    t["ks"][:, :, w] = 1e4
    t["vs"][:, :, w] = 1e4
    valid = t["valid"].clone()
    valid[:, w] = True
    for n_split in (1, 2, 5):
        y = tda.decode_attend(t["q"], t["kc"], t["vc"], t["ks"], t["vs"], t["k_new"],
                              t["v_new"], plan, valid, window=window, n_split=n_split)
        np.testing.assert_allclose(as_np(y), as_np(y_fused), **ATTN_TOL)


@pytest.mark.parametrize("H,C,Dh", [(16, 768, 128), (16, 1024, 128), (8, 256, 128),
                                    (20, 3072, 128), (16, 3072, 128), (32, 384, 64),
                                    (32, 4096, 64), (4, 640, 128), (24, 256, 128)])
def test_shape_rule_matches_jax(H, C, Dh, monkeypatch):
    """Fused iff the JAX package's shape terms hold (``_mono_ok`` and
    ``_legacy_4d``); the port's ``supported`` has no tiling term."""
    monkeypatch.delenv("DSM_FUSED_ATTN", raising=False)
    q = jnp.zeros((2, H, 1, Dh), jnp.bfloat16)
    kc = jnp.zeros((2, H, C, Dh), jnp.int8)
    jplan = jattn.global_ring_plan(jnp.int32(5), C, 1)
    tq, tk = torch.zeros(2, H, 1, Dh, dtype=torch.bfloat16), torch.zeros(2, H, C, Dh,
                                                                        dtype=torch.int8)
    tplan = tattn.global_ring_plan(5, C, 1)
    assert tda._mono_ok(H, C, Dh) == jda._mono_ok(H, C, Dh, False)
    assert tda.fused_commit_supported(tq, tk, tplan) == jda.fused_commit_supported(q, kc, jplan)
    assert tda.supported(tq, tk, tplan)
    assert not tda.fused_commit_supported(tq.float()[:, :, :0], tk, tplan)  # T = 0 rows
    # A uint8 ring is a packed-int4 ring: Dh/2 bytes a row, as in the JAX package.
    assert not tda.supported(tq, tk.to(torch.uint8), tplan)
    assert not jda.supported(q, kc.astype(jnp.uint8), jplan)
    assert tda.supported(tq, tk[..., :Dh // 2].to(torch.uint8), tplan)
    assert not tda.fused_commit_supported(tq, tk[..., :Dh // 2].to(torch.uint8), tplan, True)


def test_pick_split_fills_the_card_and_keeps_spans():
    assert tda.pick_split(24 * 20, 3072) == 3   # s2s-2b serving: 1,440 blocks
    assert tda.pick_split(64 * 16, 768) == 2
    assert tda.pick_split(2 * 32, 4096) == 16
    assert tda.pick_split(4096, 3072) == 1
    assert tda.pick_split(1, 128) == 1
