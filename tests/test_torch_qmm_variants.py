"""The qmm variants tool (``dsm_tpu_torch.tools.qmm_variants``) on the CPU:
every variant's edit still applies to ``csrc/qmm.cu`` exactly once, the
tilings it times, the cold timing's weight copies, and its exit code without
a card.  The timings themselves are the card's (the tool's own run)."""

from pathlib import Path

import pytest
import torch

from dsm_tpu_torch.ops import qmm as QM
from dsm_tpu_torch.tools import qmm_variants as QV


@pytest.mark.parametrize("name", sorted(QV.VARIANTS))
def test_every_variant_edit_applies_to_the_source(name):
    src = QV.variant_source(name)
    shipped = QV.variant_source("shipped")
    assert (src == shipped) == (name == "shipped")
    assert "dsm_qmm" in src


def test_an_unknown_variant_or_a_stale_edit_raises(monkeypatch):
    with pytest.raises(ValueError):
        QV.variant_source("no-such-variant")
    monkeypatch.setitem(QV.VARIANTS, "stale", (False, [("text not in the source", "x")]))
    with pytest.raises(ValueError):
        QV.variant_source("stale")


@pytest.mark.parametrize("m,o,i", QV.SHAPES)
def test_splits_start_with_the_picked_one_and_leave_none_empty(m, o, i):
    resident = tuple(132 // k for k in range(1, 9))
    got = QV.splits(m, o, i, resident)
    assert got[0] == QM.qmm_tiling(m, o, i, resident).ksplit
    n_chunks = -(-i // 128)
    assert sorted(got) == [k for k in QV.SPLITS if k <= n_chunks]


def test_weight_copies_exceed_twice_the_l2():
    wq = torch.zeros(300, 1024, dtype=torch.int8)
    copies = QV.weight_copies(wq, min_bytes=3 * 300 * 1024 + 1)
    assert len(copies) == 4
    assert len({c.data_ptr() for c in copies}) == 4
    assert QV.COLD_BYTES > 2 * 50 * 2**20
    assert len(QV.weight_copies(torch.zeros(2048, 2048, dtype=torch.int8))) == 32


def test_the_tool_measures_nothing_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    assert QV.main(["--variants", "shipped,no-mma"]) == 2
    assert QV.main(["--step"]) == 2
    assert QV.main(["--host", "--parent", "."]) == 2
    with pytest.raises(ValueError):
        QV.main(["--variants", "shipped,no-such-variant"])


def test_load_qmm_imports_a_checkouts_qmm_beside_this_one():
    """The host timing's parent: a checkout's ``ops.qmm`` as a package of its
    own (here this checkout's), its plain version the same function."""
    root = Path(__file__).resolve().parents[1]
    other = QV.load_qmm(root, alias="dsm_tpu_torch_test_copy")
    assert other is not QM and other.__name__ == "dsm_tpu_torch_test_copy.ops.qmm"
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 64, generator=g).bfloat16()
    wq = torch.randint(-127, 128, (16, 64), generator=g, dtype=torch.int8)
    s = torch.rand(16, generator=g) / 100
    assert torch.equal(other.qmm(x, wq, s), QM.qmm(x, wq, s))
