"""The int8 ``decode_attend`` on the CPU: the split its wrapper picks on the
card (``decode_attn.pick_split_card`` from the kernel's tile rows and the
card's SMs) and on the CPU (``pick_split``, unchanged); the plain version at
the card's splits against the JAX package's Pallas kernels in interpret mode
(``_decode_attend_q_flash``, ``_decode_attend_q_4d`` and ``_decode_attend_q``);
and the design-variants tool of its kernel
(``dsm_tpu_torch.tools.int8_attend_variants``): every variant's edit still
applies to ``csrc/decode_attn.cu`` exactly once, and the tool measures
nothing without a card.  The kernel itself and the tool's timings are the
card's (tests/test_torch_cuda.py, the tool's own run)."""

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
from dsm_tpu_torch.ops import attention as A
from dsm_tpu_torch.ops import decode_attn as DA
from dsm_tpu_torch.ops import ring_kernels as RK
from dsm_tpu_torch.tools import int8_attend_variants as IV

torch.set_num_threads(2)

# The H100 as the card's library reports it: the int8 kernel's larger tiles
# (the ones a split ring's items get) hold 128 rows at Dh = 128 and 256 at
# Dh = 64; 132 SMs; three items an SM for int8 rings.
TILE_ROWS = {128: 128, 64: 256}
H100_SMS = 132
ITEMS_PER_SM = 3

# (B*H, C, Dh, the pick on the H100): the serving rings (stt-2.6b,
# tts_202501, stt-1b, s2s-2b, Moshi 7B), the two tp shards the mesh phases
# run, then the serving rings at batches an operator may set lower and rings
# of a few heads as the tests and small models have them.
PICK_CASES = [(64 * 32, 384, 64, 1), (64 * 32, 512, 64, 1), (64 * 16, 768, 128, 1),
              (24 * 20, 3072, 128, 1), (24 * 32, 3072, 128, 1),
              (12 * 10, 3072, 128, 4), (32 * 4, 768, 128, 3),
              (1 * 32, 384, 64, 1), (8 * 16, 768, 128, 3), (1 * 16, 768, 128, 6),
              (4 * 20, 3072, 128, 5), (1 * 20, 3072, 128, 12), (2 * 32, 4096, 64, 6),
              (1, 12, 64, 1), (2, 256, 128, 2), (3, 1000, 64, 2), (8, 640, 64, 2)]


@pytest.mark.parametrize("bh,c,dh,want", PICK_CASES)
def test_card_pick_covers_the_ring_in_spans_of_four_rows(bh, c, dh, want):
    tile_rows = TILE_ROWS[dh]
    n = DA.pick_split_card(bh, c, tile_rows, H100_SMS, ITEMS_PER_SM)
    assert n == want
    span = DA.span_rows(c, n)
    rows = [min(c, s0 + span) - s0 for s0 in range(0, n * span, span)]
    assert n >= 1 and span % 4 == 0
    assert sum(max(0, r) for r in rows) == c  # the spans cover the ring, once
    assert all(r > 0 for r in rows[:-1])  # no span is empty but the trailing one
    if n > 1:  # split only where the items leave SMs short, into spans of a tile at least
        assert bh * (n - 1) < ITEMS_PER_SM * H100_SMS and span >= tile_rows
        if c % tile_rows == 0 and (c // tile_rows) % n == 0:  # of whole tiles
            assert span % tile_rows == 0


def test_card_pick_follows_the_cards_sms():
    """Fewer SMs, fewer spans; items enough for three an SM: one span; the
    int8 rings take three items an SM where the packed ones take two."""
    assert DA.pick_split_card(12 * 10, 3072, 128, 66, ITEMS_PER_SM) == 2
    assert DA.pick_split_card(12 * 10, 3072, 128, 10, ITEMS_PER_SM) == 1
    assert DA.pick_split_card(3 * H100_SMS, 3072, 128, H100_SMS, ITEMS_PER_SM) == 1
    assert DA.pick_split_card(3 * H100_SMS - 1, 3072, 128, H100_SMS, ITEMS_PER_SM) == 2
    assert DA._ITEMS_PER_SM == {True: 2, False: ITEMS_PER_SM}
    assert DA.pick_split_card(12 * 10, 3072, 128, H100_SMS) == 3  # packed rings' two


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


def _pairs(inp):
    dt = dict(q="bfloat16", k_new="bfloat16", v_new="bfloat16", kc="int8", vc="int8",
              ks="float32", vs="float32", valid="bool")
    out = {}
    for k, a in inp.items():
        j = jnp.asarray(a).astype(dt[k])
        out[k] = (j, bridge.to_tensor(np.asarray(j)))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def test_decode_attend_keeps_pick_split_on_the_cpu():
    """Without an ``n_split`` an int8 ring on the CPU is reduced in
    ``pick_split``'s spans, as every CPU comparison with the JAX package
    was made, whatever the card would pick."""
    b, h, c, dh, pos, window = 2, 20, 1024, 128, 5000, 900
    t = {k: v[1] for k, v in _pairs(_attn_inputs(b, h, c, dh, 0.8, 4)).items()}
    plan = A.global_ring_plan(pos, c, 1)
    cpu_split = DA.pick_split(b * h, c)
    assert DA.card_split(b * h, c, dh, False, t["kc"].device) == cpu_split == 4
    assert DA.pick_split_card(b * h, c, TILE_ROWS[dh], H100_SMS, ITEMS_PER_SM) != cpu_split
    got = DA.decode_attend(t["q"], t["kc"], t["vc"], t["ks"], t["vs"], t["k_new"], t["v_new"],
                           plan, t["valid"], window=window)
    rows = [x[:, :, 0].contiguous() for x in (t["q"], t["k_new"], t["v_new"])]
    want = DA.decode_attend_plain(rows[0], t["kc"], t["vc"], t["ks"], t["vs"], rows[1],
                                  rows[2], t["valid"], pos, pos % c, window, cpu_split)
    assert torch.equal(got[:, :, 0], want)
    assert DA.decode_attend.launches == 0


# (B, H, C, Dh, window, the JAX kernel decode_attend routes the shape to):
# h = 20 takes the flash kernel, h = 8 at Dh = 128 the 4-D one, h = 8 at
# Dh = 64 the head-major one.
ROUTES = [(1, 20, 1024, 128, 1000, "_decode_attend_q_flash"),
          (2, 8, 512, 128, 500, "_decode_attend_q_4d"),
          (1, 8, 1024, 64, 1000, "_decode_attend_q")]


@pytest.mark.parametrize("where", ["near-empty", "mid", "wrapped"])
@pytest.mark.parametrize("B,H,C,Dh,window,route", ROUTES)
def test_plain_at_the_card_split_matches_pallas(B, H, C, Dh, window, route, where):
    """``decode_attend_plain`` at the card's split (several spans at these
    few heads) within 2e-2 of the JAX package's ``decode_attend`` in
    interpret mode, which sends the shape to ``route``: the bar of
    tests/test_decode_attn.py (other summation orders, probabilities
    rounded to bf16 relative to each span's own maximum)."""
    pos, frac = {"near-empty": (3, 1.0), "mid": (C // 2 + 5, 0.8),
                 "wrapped": (3 * C + 77, 0.7)}[where]
    n_split = DA.pick_split_card(B * H, C, TILE_ROWS[Dh], H100_SMS, ITEMS_PER_SM)
    assert n_split > 1
    takes = ("_decode_attend_q_4d" if jda._legacy_4d(H, Dh) and jda._mono_ok(H, C, Dh, False)
             else "_decode_attend_q" if jda._mono_ok(H, C, Dh, False)
             else "_decode_attend_q_flash")
    assert takes == route
    p = _pairs(_attn_inputs(B, H, C, Dh, frac, seed=pos + H))
    j = {k: v[0] for k, v in p.items()}
    t = {k: v[1] for k, v in p.items()}
    jplan = jattn.global_ring_plan(jnp.int32(pos), C, 1)
    kq, vq, ksn, vsn = jax.jit(jattn.quantize_kv_rows)(j["k_new"], j["v_new"])
    kc2, vc2, ks2, vs2 = jrk.ring_commit(j["kc"], j["vc"], kq, vq, jplan["w"][0], j["ks"],
                                         j["vs"], ksn, vsn, interpret=True)
    want = jda.decode_attend(j["q"], kc2, vc2, ks2, vs2, j["k_new"], j["v_new"], jplan,
                             j["valid"], window=window, interpret=True)

    tplan = A.global_ring_plan(pos, C, 1)
    RK.quantize_commit(t["k_new"], t["v_new"], t["kc"], t["vc"], t["ks"], t["vs"],
                       tplan["pos"])
    np.testing.assert_array_equal(t["kc"].numpy(), np.asarray(kc2))
    rows = [x[:, :, 0].contiguous() for x in (t["q"], t["k_new"], t["v_new"])]
    y = DA.decode_attend_plain(rows[0], t["kc"], t["vc"], t["ks"], t["vs"], rows[1], rows[2],
                               t["valid"], pos, pos % C, window, n_split)
    np.testing.assert_allclose(_np(y), _np(want[:, :, 0]), atol=2e-2, rtol=2e-2)
    # The wrapper on CPU tensors at the same split is that plain version.
    got = DA.decode_attend(t["q"], t["kc"], t["vc"], t["ks"], t["vs"], t["k_new"], t["v_new"],
                           tplan, t["valid"], window=window, n_split=n_split)
    assert torch.equal(got[:, :, 0], y)


@pytest.mark.parametrize("name", list(IV.VARIANTS))
def test_variant_tool_edits_still_apply_to_the_kernel_source(name):
    """Each design variant replaces text that occurs once in
    ``csrc/decode_attn.cu``; only the shipped one is the source as it is."""
    src = (_build.CSRC / "decode_attn.cu").read_text()
    assert (IV.variant_source(name) == src) == (name == "shipped")
    assert "decode_attend_q8_kernel" in IV.variant_source(name)
    assert "," not in name  # --variants takes a comma-separated list


def test_variant_tool_measures_nothing_without_a_card():
    with pytest.raises(ValueError, match="unknown variant"):
        IV.main(["--variants", "shipped,stages=5"])
    if not torch.cuda.is_available():
        assert IV.main(["--variants", "shipped,copies-alone"]) == 2
        assert IV.main(["--variants", "shipped", "--parent", "."]) == 2


@pytest.mark.parametrize("label,b,h,c,dh,pos,window,share", IV.SHAPES)
def test_variant_tool_shapes_and_bound(label, b, h, c, dh, pos, window, share):
    """Every shape is a ring the kernel takes (Dh 64 or 128, C a multiple of
    4), its splits start with the card's pick and leave no span empty but the
    last, and its byte bound counts each attended row's K, V and scales."""
    assert dh in (64, 128) and c % 4 == 0 and 0 < share <= 1
    pick = DA.pick_split_card(b * h, c, TILE_ROWS[dh], H100_SMS, ITEMS_PER_SM)
    got = IV.QV.splits(pick, c)
    assert got[0] == pick and len(set(got)) == len(got)
    for n in got:
        assert DA.span_rows(c, n) * (n - 1) < c
    valid = torch.ones(b, c, dtype=torch.bool)
    attended = min(pos, window - 1, c - 1)
    want = (attended * b * h * (2 * dh + 8) + b * c + 8 * b * h * dh) / IV.MEM_BYTES_PER_S * 1e3
    assert IV.bound_ms(b, h, c, dh, pos, window, valid) == pytest.approx(want, rel=1e-12)


def test_captured_paths_tool_measures_nothing_without_a_card(tmp_path):
    """``tools/captured_paths.py`` takes checkout roots that hold a
    ``chip_smoke.py`` and measures nothing without a card."""
    from dsm_tpu_torch.tools import captured_paths as CP

    with pytest.raises(ValueError, match="no chip_smoke.py"):
        CP.main(["--roots", str(tmp_path)])
    if not torch.cuda.is_available():
        assert CP.main(["--roots", ".,."]) == 2
