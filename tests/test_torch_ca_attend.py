"""The voice cross-attention ``ca_decode_attend`` on the CPU: the cluster
size its wrapper picks (``decode_attn.pick_ca_cluster``, from B*H, the real
rows and the card's SMs) and the span plan each cluster rank reduces, the
shared memory a span claims, the shapes the kernel's launcher refuses before
any launch, and the design-variants tool of its kernel
(``dsm_tpu_torch.tools.ca_attend_variants``): every variant's edit still
applies to ``csrc/ca_attn.cu`` exactly once, its arguments, and that it
measures nothing without a card.  The kernel itself and the tool's timings
are the card's (tests/test_torch_cuda.py, the tool's own run)."""

import pytest
import torch

from dsm_tpu_torch.ops import decode_attn as DA
from dsm_tpu_torch.tools import ca_attend_variants as CV

H100_SMS = 132

# (B*H, real rows, Dh, the pick on the H100): tts-1.6b and tts_202501 at their
# serving batch, a tp = 2 shard of the TTS mesh, batches of 8 and 1 of each.
PICK_CASES = [(64 * 16, 625, 128, 1), (64 * 32, 625, 64, 1), (32 * 8, 625, 128, 2),
              (8 * 16, 625, 128, 3), (8 * 32, 625, 64, 2), (1 * 16, 625, 128, 8),
              (1 * 32, 625, 64, 8)]


@pytest.mark.parametrize("bh,s_len,dh,want", PICK_CASES)
def test_pick_at_the_tts_shapes(bh, s_len, dh, want):
    assert DA.pick_ca_cluster(bh, s_len, dh, H100_SMS) == want


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("s_len", [1, 3, 64, 200, 619, 625, 640, 4096, 30000, 100000])
@pytest.mark.parametrize("bh", [8, 16, 64, 256, 1024, 4096])
def test_spans_cover_the_real_rows_once_and_fit_shared_memory(bh, s_len, dh):
    n = DA.pick_ca_cluster(bh, s_len, dh, H100_SMS)
    assert 1 <= n <= 8
    span = DA.span_rows(s_len, n)  # cluster rank r reduces rows [r span, (r + 1) span)
    spans = [(min(s_len, r * span), min(s_len, (r + 1) * span)) for r in range(n)]
    covered = [j for start, stop in spans for j in range(start, stop)]
    assert covered == list(range(s_len))  # every real row once, in rank order
    assert span % 4 == 0 and all(start % 4 == 0 for start, _ in spans)
    assert all(stop > start for start, stop in spans[:-1])  # no span but the last empty
    assert DA.ca_smem_bytes(span, dh, n) <= DA._MAX_SMEM_OPT_IN
    if n > 1 and DA.ca_smem_bytes(DA.span_rows(s_len, 1), dh) <= DA._MAX_SMEM_OPT_IN:
        # split only where the clusters leave SMs short, into spans of a tile at least
        assert bh * (n - 1) < DA._CA_BLOCKS_PER_SM * H100_SMS
        assert span >= DA._CA_MIN_ROWS


def test_pick_follows_the_cards_sms():
    assert DA.pick_ca_cluster(256, 625, 128, 66) == 1
    assert DA.pick_ca_cluster(256, 625, 128, 264) == 3
    assert DA.pick_ca_cluster(16, 625, 128, 8) == 1


def test_more_rows_than_one_block_holds_split_even_at_a_large_batch():
    rows = (DA._MAX_SMEM_OPT_IN - DA.ca_smem_bytes(0, 128)) // 48 * 4  # spans of 4 rows
    assert DA.pick_ca_cluster(4096, rows, 128, H100_SMS) == 1
    assert DA.pick_ca_cluster(4096, rows + 4, 128, H100_SMS) == 2


def _meta(b, h, s, dh, q_dtype=torch.bfloat16):
    m = torch.device("meta")
    q = torch.empty(b, h, 1, dh, dtype=q_dtype, device=m)
    k = torch.empty(b, h, s, dh, dtype=torch.int8, device=m)
    sc = torch.empty(b, h, s, device=m)
    return q, k, k, sc, sc


@pytest.mark.parametrize("make,s_len,match", [
    (lambda: _meta(2, 8, 128, 96), 100, "Dh 64 or 128"),
    (lambda: _meta(2, 8, 128, 64, torch.float32), 100, "q is"),
    (lambda: _meta(2, 8, 128, 64), 129, "outside source"),
    (lambda: _meta(2, 8, 128, 128), 0, "outside source"),
])
def test_the_launcher_refuses_before_any_launch(make, s_len, match):
    before = DA.ca_decode_attend.launches
    with pytest.raises(ValueError, match=match):
        DA.ca_decode_attend(*make(), s_len)
    assert DA.ca_decode_attend.launches == before


@pytest.mark.parametrize("name", sorted(CV.VARIANTS))
def test_every_variant_edit_applies_to_the_source(name):
    src = CV.variant_source(name)
    shipped = CV.variant_source("shipped")
    assert (src == shipped) == (name == "shipped")
    assert "dsm_ca_decode_attend" in src


def test_an_unknown_variant_or_a_stale_edit_raises(monkeypatch):
    with pytest.raises(ValueError):
        CV.variant_source("no-such-variant")
    monkeypatch.setitem(CV.VARIANTS, "stale", (False, [("text not in the source", "x")]))
    with pytest.raises(ValueError):
        CV.variant_source("stale")


def test_cluster_sizes_start_with_the_pick_and_leave_no_span_empty():
    assert CV.parse_clusters("1,2,8") == [1, 2, 8]
    for bad in ("", "0", "9", "1,12"):
        with pytest.raises(ValueError):
            CV.parse_clusters(bad)
    assert CV.clusters(8, CV.CLUSTERS, 625) == [8, 1, 2, 3, 4, 6]
    assert CV.clusters(1, CV.CLUSTERS, 9) == [1, 2, 3]  # 4 spans of 4 rows leave the 4th empty
    for _, b, h, _, s_len, dh in CV.SHAPES:
        assert DA.pick_ca_cluster(b * h, s_len, dh, H100_SMS) in CV.CLUSTERS


def test_the_bound_counts_each_real_row_and_its_scales_once():
    # 64 x 16 (b, h) of 625 rows: 2 x 128 int8 and 2 f32 scales a row, q and out in bf16
    want = (64 * 16 * 625 * (2 * 128 + 8) + 2 * 64 * 16 * 128 * 2) / 3.35e12 * 1e3
    assert CV.bound_ms(64, 16, 625, 128) == pytest.approx(want)


def test_the_tool_measures_nothing_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    assert CV.main(["--variants", "shipped,no-convert"]) == 2
    assert CV.main(["--clusters", "1,8", "--parent", "."]) == 2
    with pytest.raises(ValueError):
        CV.main(["--variants", "shipped,no-such-variant"])
    with pytest.raises(ValueError):
        CV.main(["--clusters", "16"])
