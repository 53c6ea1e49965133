"""The span order of the fused pipeline's attention + commit
(``decode_attn.decode_attend_commit_plain`` with ``n_split``) against
``decode_attend_plain`` and the JAX package's Pallas kernel in interpret mode.

On the card the kernel reduces the ring in ``n_split`` spans and folds them
(``csrc/decode_attn.cu``); its plain version at that split is
``decode_attend_plain`` over the committed ring, which must hold exactly,
with the rings bit for bit the Pallas kernel's and the output within atol =
rtol = 2e-2 of it (the bar of tests/test_decode_attn.py).  ``n_split`` None
is the CPU route's whole-ring order, unchanged.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.ops import attention as jattn
from dsm_tpu.ops import decode_attn as jda
from dsm_tpu.ops import ring_kernels as jrk
from dsm_tpu_torch import bridge
from dsm_tpu_torch.ops import _build
from dsm_tpu_torch.ops import attention as tattn
from dsm_tpu_torch.ops import decode_attn as tda
from dsm_tpu_torch.ops import ring_kernels as trk
from dsm_tpu_torch.tools import fused_commit_variants as FV

torch.set_num_threads(2)

ATTN_TOL = dict(atol=2e-2, rtol=2e-2)

GRID = [  # B, H, C, Dh, pos, window, valid share (tests/test_torch_kernels.py's)
    (2, 8, 256, 128, 0, 250, 1.0),      # first step after reset
    (2, 8, 256, 128, 40, 250, 1.0),     # partial fill: every attended row in span 0
    (2, 8, 256, 128, 255, 250, 1.0),    # last pre-wrap write
    (2, 8, 256, 128, 1000, 250, 0.6),   # wrap + validity holes
    (1, 16, 768, 128, 3000, 750, 0.9),  # stt-1b serving shape
]


def _inputs(b, h, c, dh, valid_frac, seed):
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


_DTYPES = dict(q="bfloat16", k_new="bfloat16", v_new="bfloat16", kc="int8", vc="int8",
               ks="float32", vs="float32", valid="bool")


def _port(case):
    """The port's operands of a GRID case, scale rings committed: a dict of
    torch tensors, ``rows`` (q, kq, vq, k_new, v_new as (B, H, Dh)) and w."""
    b, h, c, dh, pos, _, frac = case
    t = {k: bridge.to_tensor(np.asarray(jnp.asarray(v).astype(_DTYPES[k])))
         for k, v in _inputs(b, h, c, dh, frac, seed=pos + b).items()}
    kq, vq, ksn, vsn = tattn.quantize_kv_rows(t["k_new"], t["v_new"])
    w = tattn.global_ring_plan(pos, c, 1)["w"][0]
    trk.scale_commit(t["ks"], t["vs"], ksn, vsn, w)
    t["rows"] = [x[:, :, 0].contiguous() for x in (t["q"], kq, vq, t["k_new"], t["v_new"])]
    t["w"] = w
    return t


@functools.lru_cache(maxsize=None)
def _pallas(case):
    """The Pallas kernel (interpret mode) on a GRID case -> (y, k ring, v ring)
    as numpy."""
    b, h, c, dh, pos, window, frac = case
    j = {k: jnp.asarray(v).astype(_DTYPES[k])
         for k, v in _inputs(b, h, c, dh, frac, seed=pos + b).items()}
    kq, vq, ksn, vsn = jax.jit(jattn.quantize_kv_rows)(j["k_new"], j["v_new"])
    plan = jattn.global_ring_plan(jnp.int32(pos), c, 1)
    ks, vs = jrk.scale_commit(j["ks"], j["vs"], ksn, vsn, plan["w"][0], interpret=True)
    y, k_ring, v_ring = jda.decode_attend_commit(
        j["q"], j["kc"], j["vc"], ks, vs, kq, vq, j["k_new"], j["v_new"], plan, j["valid"],
        window=window, interpret=True)
    return (np.asarray(y[:, :, 0].astype(jnp.float32)), np.asarray(k_ring),
            np.asarray(v_ring))


@pytest.mark.parametrize("n_split", [1, 2, 3])
@pytest.mark.parametrize("case", GRID, ids=str)
def test_span_order_is_decode_attend_plain_then_the_commit(case, n_split):
    """At ``n_split`` spans the fused pipeline's plain version is
    ``decode_attend_plain`` over the committed ring, exactly; its rings are
    the Pallas kernel's bit for bit and its output is within the bar of it."""
    pos, window = case[4], case[5]
    t = _port(case)
    y = tda.decode_attend_commit_plain(t["rows"][0], t["kc"], t["vc"], t["ks"], t["vs"],
                                       *t["rows"][1:], t["valid"], pos, t["w"], window,
                                       n_split)
    y_j, k_j, v_j = _pallas(case)
    np.testing.assert_array_equal(t["kc"].numpy(), k_j)
    np.testing.assert_array_equal(t["vc"].numpy(), v_j)
    want = tda.decode_attend_plain(t["rows"][0], t["kc"], t["vc"], t["ks"], t["vs"],
                                   t["rows"][3], t["rows"][4], t["valid"], pos, t["w"],
                                   window, n_split)
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)
    np.testing.assert_allclose(y.float().numpy(), y_j, **ATTN_TOL)


def _whole_ring(q, k_cache, v_cache, k_scale, v_scale, kq_new, vq_new, k_new, v_new,
                valid, pos, w, window):
    """The whole-ring order as the CPU route has computed it since the port
    began: one softmax, masked rows at -1e9, the probabilities rounded to
    bf16 before the V dot, then the commit."""
    c, dh = k_cache.shape[2], k_cache.shape[3]
    scale = 1.0 / dh ** 0.5
    j = torch.arange(c)
    k_pos = pos - torch.remainder(w - j, c)
    ok = ((k_pos >= 0) & (pos - k_pos < window) & (j != w))[None, :] & valid
    scores = torch.einsum("bhd,bhcd->bhc", q.float(), k_cache.float()) * (k_scale * scale)
    scores = torch.where(ok[:, None, :], scores, -1e9)
    s_new = (q.float() * k_new.float()).sum(-1) * scale
    m = torch.maximum(scores.amax(-1), s_new)
    e_c, e_n = torch.exp(scores - m[..., None]), torch.exp(s_new - m)
    denom = e_c.sum(-1) + e_n
    p_c = (e_c * v_scale).to(torch.bfloat16).float()
    out = torch.einsum("bhc,bhcd->bhd", p_c, v_cache.float()) + e_n[..., None] * v_new.float()
    k_cache[:, :, w] = kq_new
    v_cache[:, :, w] = vq_new
    return (out / denom[..., None]).to(q.dtype)


@pytest.mark.parametrize("case", GRID, ids=str)
def test_no_split_keeps_the_whole_ring_order(case):
    """``n_split`` None, the default and the wrapper's CPU route, is the
    whole-ring order bit for bit, rings included."""
    pos, window = case[4], case[5]
    t, ref = _port(case), _port(case)
    y = tda.decode_attend_commit_plain(t["rows"][0], t["kc"], t["vc"], t["ks"], t["vs"],
                                       *t["rows"][1:], t["valid"], pos, t["w"], window)
    want = _whole_ring(ref["rows"][0], ref["kc"], ref["vc"], ref["ks"], ref["vs"],
                       *ref["rows"][1:], ref["valid"], pos, ref["w"], window)
    assert torch.equal(y, want)
    assert torch.equal(t["kc"], ref["kc"]) and torch.equal(t["vc"], ref["vc"])
    via = _port(case)
    q4, kq4, vq4, kn4, vn4 = (x[:, :, None] for x in via["rows"])
    y4, _, _ = tda.decode_attend_commit(q4, via["kc"], via["vc"], via["ks"], via["vs"], kq4,
                                        vq4, kn4, vn4, tattn.global_ring_plan(pos, case[2], 1),
                                        via["valid"], window=window)
    assert torch.equal(y4[:, :, 0], want) and torch.equal(via["kc"], ref["kc"])


@pytest.mark.parametrize("n_split", [1, 2, 3])
def test_first_step_is_the_fresh_row_at_every_split(n_split):
    """At pos 0 with an empty bitmap only the fresh row attends, whatever
    the ring holds, in every span."""
    case = (2, 8, 256, 128, 0, 250, 1.0)
    t = _port(case)
    y = tda.decode_attend_commit_plain(t["rows"][0], t["kc"], t["vc"], t["ks"], t["vs"],
                                       *t["rows"][1:], torch.zeros(2, 256, dtype=torch.bool),
                                       0, 0, 250, n_split)
    assert torch.equal(y, t["rows"][4])
    assert torch.equal(t["kc"][:, :, 0], t["rows"][1])


@pytest.mark.parametrize("name", list(FV.VARIANTS))
def test_variant_tool_edits_still_apply_to_the_kernel_source(name):
    """Each design variant of ``tools/fused_commit_variants.py`` replaces
    text that occurs once in ``csrc/decode_attn.cu``; only the shipped one
    is the source as it is."""
    src = (_build.CSRC / "decode_attn.cu").read_text()
    assert (FV.variant_source(name) == src) == (name == "shipped")


def test_variant_tool_measures_nothing_without_a_card():
    with pytest.raises(ValueError, match="unknown variant"):
        FV.main(["--variants", "shipped,stages=5"])
    if not torch.cuda.is_available():
        assert FV.main(["--variants", "shipped"]) == 2
