"""The port's decode-attention tuning kernel and tool against the JAX
package's tuning tool, on the CPU.

``attn_tune_plain`` (the order of the CUDA kernel in
``dsm_tpu_torch/csrc/attn_tune.cu``) against
``tools/attn_kernel_tune.build_4d(..., interpret=True)`` for ``bb`` 1 and 2
and the three numeric variants: atol = rtol = 2e-2 on bf16 outputs (the two
sum in other orders; where ``x / scale`` of a quantised q or p lands on a
rounding boundary one int8 step differs).  Against ``attend_global_split_q``
(the reference of both tools): 0.01 for the bf16 variants, 0.02 for ``i8s``,
0.03 for ``i8sp`` at ``(4, 8, 256, 128)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.ops import attention as jattn
from dsm_tpu_torch.ops import attention as tattn
from dsm_tpu_torch.ops import attn_tune as tAT
from dsm_tpu_torch.ops import decode_attn as tda
from dsm_tpu_torch.tools import attn_kernel_tune as tTOOL
from tests.test_torch_ops import as_np
from tools import attn_kernel_tune as jTOOL

torch.set_num_threads(2)

VARIANTS = [("bb1", dict(bb=1)), ("bb2", dict(bb=2)), ("bb2_i8s", dict(bb=2, i8s=True)),
            ("bb2_i8sp", dict(bb=2, i8s=True, i8p=True)), ("bb1_i8p", dict(bb=1, i8p=True))]


def _inputs(b, h, c, dh, seed, valid_frac=0.9):
    rng = np.random.default_rng(seed)
    rows = {k: (rng.standard_normal((b, h, dh)) * 0.5).astype(np.float32)
            for k in ("q", "k_new", "v_new")}
    ring = [jnp.asarray(rng.standard_normal((b, h, c, dh)).astype(np.float32)).astype(
        jnp.bfloat16) for _ in range(2)]
    kq, vq, ks, vs = jattn.quantize_kv_rows(*ring)
    valid = rng.uniform(size=(b, c)) < valid_frac
    return rows, (np.asarray(kq), np.asarray(vq), np.asarray(ks), np.asarray(vs)), valid


def _port_args(rows, ring, valid):
    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in rows.items()}
    kq, vq, ks, vs = (torch.from_numpy(np.array(x)) for x in ring)
    return (bf["q"], kq, vq, ks, vs, bf["k_new"], bf["v_new"], torch.from_numpy(valid))


@pytest.mark.parametrize("pos", [5, 300])
@pytest.mark.parametrize("name,kw", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_attn_tune_plain_matches_the_pallas_variants(name, kw, pos):
    b, h, c, dh, window = 4, 8, 256, 128, 250
    rows, ring, valid = _inputs(b, h, c, dh, seed=pos)
    jb = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in rows.items()}
    kern = jTOOL.build_4d(kw["bb"], window, i8s=kw.get("i8s", False), i8p=kw.get("i8p", False),
                          interpret=True)
    want = kern(jb["q"], *map(jnp.asarray, ring), jb["k_new"], jb["v_new"],
                jnp.asarray(valid).astype(jnp.int8)[:, None, :], jnp.asarray([pos], jnp.int32))
    args = _port_args(rows, ring, valid)
    before = tAT.attn_tune.launches
    got = tAT.attn_tune(*args, pos, window, **kw)
    assert tAT.attn_tune.launches == before  # CPU tensors: the plain version
    assert got.shape == (b, h, dh) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(got), as_np(want), atol=2e-2, rtol=2e-2)
    # Both tools hold their variants against the split attention of the XLA path.
    plan = tattn.global_ring_plan(pos, c, 1)
    ref = tattn.attend_global_split_q(args[0][:, :, None], *args[1:5], args[5][:, :, None],
                                      args[6][:, :, None], plan, args[7], window)[:, :, 0]
    bar = 0.03 if kw.get("i8p") else 0.02 if kw.get("i8s") else 0.01
    assert float((got.float() - ref.float()).abs().max()) <= bar
    if not (kw.get("i8s") or kw.get("i8p")):  # bb changes no number; base is decode_attend
        assert torch.equal(got, tAT.attn_tune(*args, pos, window, bb=1))
        split = tda.decode_attend(args[0][:, :, None], *args[1:5], args[5][:, :, None],
                                  args[6][:, :, None], plan, args[7], window=window, n_split=1)
        np.testing.assert_allclose(as_np(got), as_np(split[:, :, 0]), atol=2e-2, rtol=2e-2)


def test_attn_tune_first_step_is_the_fresh_row_and_masks_row_w():
    rows, ring, valid = _inputs(2, 4, 256, 64, seed=1, valid_frac=1.0)
    args = _port_args(rows, ring, valid)
    for kw in (dict(), dict(i8s=True, i8p=True)):
        first = tAT.attn_tune(*args, 0, 250, **kw)  # nothing committed before tick 0
        np.testing.assert_allclose(as_np(first), as_np(args[6]), atol=1e-2)
    poisoned = [x.clone() for x in args]
    poisoned[1][:, :, 7] = 127
    poisoned[2][:, :, 7] = 127
    poisoned[3][:, :, 7] = 50.0
    assert torch.equal(tAT.attn_tune(*poisoned, 7 + 256, 250), tAT.attn_tune(*args, 7 + 256, 250))
    with pytest.raises(ValueError, match="bb"):
        tAT.attn_tune(*args, 300, 250, bb=4)


@pytest.mark.parametrize("name,want", [
    ("base", {}), ("bb1", dict(bb=1, i8s=False, i8p=False)),
    ("bb8", dict(bb=8, i8s=False, i8p=False)), ("bb4_i8s", dict(bb=4, i8s=True, i8p=False)),
    ("bb4_i8sp", dict(bb=4, i8s=True, i8p=True))])
def test_parse_variant_reads_the_jax_tools_names(name, want):
    assert tTOOL.parse_variant(name) == want


@pytest.mark.parametrize("name", ["bb", "bb0", "b4", "bb4_i8x", "fast"])
def test_parse_variant_refuses_unknown_names(name):
    with pytest.raises(ValueError, match="variant"):
        tTOOL.parse_variant(name)
    with pytest.raises(ValueError, match="variant"):
        tTOOL.main(["--variants", f"base,{name}"])


def test_tool_measures_nothing_without_a_card(capsys):
    """No CPU mode: a time from this machine's CPU is no device time."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool measures")
    assert tTOOL.main(["--batch", "8"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_tool_inputs_are_the_stt_1b_rings_and_every_variant_is_near_the_reference():
    x = tTOOL.make_inputs(8, torch.device("cpu"))
    assert (x["cap"], x["pos"], x["cfg"].context) == (768, 773, 750)
    assert x["k"].shape == (8, 16, 768, 128) and x["k"].dtype == torch.int8
    assert x["ks"].shape == (8, 16, 768) and x["q"].shape == (8, 16, 1, 128)
    ref = tTOOL.reference(x)
    for name in tTOOL.DEFAULT_VARIANTS.split(","):
        out = tTOOL.variant_fn(name, x)().float()
        assert out.shape == ref.shape == (8, 16, 128)
        bar = 0.03 if "i8sp" in name else 0.02 if "i8s" in name else 0.01
        assert float((out - ref).abs().max()) <= bar, name
    with pytest.raises(ValueError, match="multiple of 8"):
        tTOOL.make_inputs(12, torch.device("cpu"))
