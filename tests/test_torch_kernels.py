"""The plain versions of the port's three kernels against the JAX
package's Pallas kernels (interpret mode on the CPU).  The CUDA kernels
are held against these plain versions in tests/test_torch_cuda.py.

Rings and scale rings must match bit for bit; attention outputs within
atol = rtol = 2e-2, the bar of tests/test_decode_attn.py (the kernels sum
in other orders and round the probabilities to bf16).
"""

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
    trk.ring_commit(kc[1], vc[1], kn[1], vn[1], w)
    np.testing.assert_array_equal(as_np(kc[1]), as_np(kj))
    np.testing.assert_array_equal(as_np(vc[1]), as_np(vj))


@pytest.mark.parametrize("w", [1, 255, 256])
def test_ring_commit_rejects_misaligned_rows(w):
    z = torch.zeros(1, 1, 256, 8)
    with pytest.raises(ValueError):
        trk.ring_commit(z, z.clone(), torch.zeros(1, 1, 2, 8), torch.zeros(1, 1, 2, 8), w)


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
    trk.scale_commit(ks[1], vs[1], ksn[1], vsn[1], w)
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
    kqj, vqj, ksnj, vsnj = jattn.quantize_kv_rows(j["k_new"], j["v_new"])
    kqt, vqt, ksnt, vsnt = tattn.quantize_kv_rows(t["k_new"], t["v_new"])
    jplan = jattn.global_ring_plan(jnp.int32(pos), C, 1)
    tplan = tattn.global_ring_plan(pos, C, 1)

    ksj, vsj = jrk.scale_commit(j["ks"], j["vs"], ksnj, vsnj, jplan["w"][0], interpret=True)
    trk.scale_commit(t["ks"], t["vs"], ksnt, vsnt, tplan["w"][0])
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
