"""The packed-int4 ``decode_attend`` on the CPU: the split its wrapper picks
for packed rings (``decode_attn.pick_split_card``, from the kernel's tile
rows and the card's SMs), and the design-variants tool of its kernel
(``dsm_tpu_torch.tools.q4_attend_variants``): every variant's edit still
applies to ``csrc/decode_attn.cu`` exactly once, and the tool measures
nothing without a card.  The kernel itself and the tool's timings are the
card's (tests/test_torch_cuda.py, the tool's own run)."""

import pytest
import torch

from dsm_tpu_torch.ops import _build
from dsm_tpu_torch.ops import attention as A
from dsm_tpu_torch.ops import decode_attn as DA
from dsm_tpu_torch.tools import q4_attend_variants as QV

# The H100 as the variants tool prints it: a tile holds 128 rows at Dh = 128
# and 384 at Dh = 64; 132 SMs.
TILE_ROWS = {128: 128, 64: 384}
H100_SMS = 132

# (B*H, C, Dh, the pick on the H100): the three serving rings (stt-1b,
# stt-2.6b, s2s-2b), the same rings at batches of 1 to 8 (the picks the tool
# timed there), then rings of a few heads as the tests and small models have
# them.
PICK_CASES = [(64 * 16, 768, 128, 1), (64 * 32, 384, 64, 1), (24 * 20, 3072, 128, 1),
              (8 * 16, 768, 128, 3), (1 * 16, 768, 128, 6), (1 * 32, 384, 64, 1),
              (4 * 20, 3072, 128, 4), (1 * 20, 3072, 128, 12),
              (2 * 32, 4096, 64, 4), (2 * 16, 4096, 128, 8), (1, 12, 64, 1),
              (2, 256, 128, 2), (3, 1000, 64, 2), (1, 4096, 128, 32), (8, 640, 64, 1)]


@pytest.mark.parametrize("bh,c,dh,want", PICK_CASES)
def test_packed_pick_covers_the_ring_in_spans_of_four_rows(bh, c, dh, want):
    tile_rows = TILE_ROWS[dh]
    n = DA.pick_split_card(bh, c, tile_rows, H100_SMS)
    assert n == want
    span = DA.span_rows(c, n)
    rows = [min(c, s0 + span) - s0 for s0 in range(0, n * span, span)]
    assert n >= 1 and span % 4 == 0
    assert sum(max(0, r) for r in rows) == c  # the spans cover the ring, once
    assert all(r > 0 for r in rows[:-1])  # no span is empty but the trailing one
    if n > 1:  # split only where the items leave SMs short, into spans of a tile at least
        assert bh * (n - 1) < 2 * H100_SMS and span >= tile_rows
        if c % tile_rows == 0:  # of whole tiles
            assert span % tile_rows == 0


def test_packed_pick_follows_the_cards_sms():
    """Fewer SMs, fewer spans (7 for two items an SM, 6 of four whole tiles
    each); items enough for two an SM: one span."""
    assert DA.pick_split_card(20, 3072, 128, 66) == 6
    assert DA.pick_split_card(20, 3072, 128, 10) == 1
    assert DA.pick_split_card(2 * H100_SMS, 3072, 128, H100_SMS) == 1
    assert DA.pick_split(64 * 16, 768) == 2  # the int8 pick as it was


def test_decode_attend_takes_one_span_for_packed_rings_on_the_cpu():
    """Without an ``n_split`` a packed ring on the CPU is reduced in one span
    (the kernel's order at every serving shape), whatever the int8 pick."""
    g = torch.Generator().manual_seed(3)
    b, h, c, dh, pos, window = 2, 4, 4096, 64, 5000, 4000
    q, k_new, v_new = ((torch.randn(b, h, 1, dh, generator=g) * 0.5).bfloat16()
                       for _ in range(3))
    kc, vc = (torch.randint(0, 256, (b, h, c, dh // 2), generator=g, dtype=torch.uint8)
              for _ in range(2))
    ks, vs = (torch.rand(b, h, c, generator=g) * 0.05 + 0.01 for _ in range(2))
    valid = torch.rand(b, c, generator=g) < 0.8
    plan = A.global_ring_plan(pos, c, 1)
    assert DA.card_split(b * h, c, dh, True, kc.device) == 1 != DA.pick_split(b * h, c)
    got = DA.decode_attend(q, kc, vc, ks, vs, k_new, v_new, plan, valid, window=window)
    rows = [x[:, :, 0].contiguous() for x in (q, k_new, v_new)]  # as the wrapper passes them
    want = DA.decode_attend_plain(rows[0], kc, vc, ks, vs, rows[1], rows[2], valid, pos,
                                  pos % c, window, 1)
    assert torch.equal(got[:, :, 0], want)


@pytest.mark.parametrize("name", list(QV.VARIANTS))
def test_variant_tool_edits_still_apply_to_the_kernel_source(name):
    """Each design variant replaces text that occurs once in
    ``csrc/decode_attn.cu``; only the shipped one is the source as it is."""
    src = (_build.CSRC / "decode_attn.cu").read_text()
    assert (QV.variant_source(name) == src) == (name == "shipped")
    assert "decode_attend_q4_kernel" in QV.variant_source(name)


def test_variant_tool_measures_nothing_without_a_card():
    with pytest.raises(ValueError, match="unknown variant"):
        QV.main(["--variants", "shipped,stages=5"])
    if not torch.cuda.is_available():
        assert QV.main(["--variants", "shipped,no-mma"]) == 2
        assert QV.main(["--variants", "shipped", "--parent", "."]) == 2


@pytest.mark.parametrize("label,b,h,c,dh,pos,window,share", QV.SHAPES)
def test_variant_tool_splits_start_with_the_pick_and_leave_no_span_empty(
        label, b, h, c, dh, pos, window, share):
    pick = DA.pick_split_card(b * h, c, TILE_ROWS[dh], H100_SMS)
    got = QV.splits(pick, c)
    assert got[0] == pick
    assert len(set(got)) == len(got)
    for n in got:
        assert DA.span_rows(c, n) * (n - 1) < c
