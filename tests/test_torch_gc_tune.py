"""The host GC freeze after warm-up (``dsm_tpu_torch/utils/gc_tune.py``), as
the JAX engines run it: each of the three batched engines freezes the heap
and raises the thresholds at the end of ``warmup()``; built with
``gc_tune=False`` it leaves the GC as it was.  Engines at small sizes on the
CPU."""

import gc

import pytest

from dsm_tpu_torch.server import builder as tbuilder
from dsm_tpu_torch.server import config as tCFG
from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine
from dsm_tpu_torch.server.duplex_batched import BatchedDuplexEngine
from dsm_tpu_torch.server.tts_batched import BatchedTtsEngine
from dsm_tpu_torch.utils import gc_tune
from tests.test_torch_tts_single import _small_module, _small_v0_1


@pytest.fixture
def fresh_gc():
    gc.unfreeze()
    thresholds = gc.get_threshold()
    gc.set_threshold(700, 10, 10)
    yield
    gc.unfreeze()
    gc.set_threshold(*thresholds)


def _engine(kind, monkeypatch, gc_on):
    monkeypatch.setattr(tbuilder.MIMI, "v0_1", _small_v0_1(True))
    raw, name = _small_module(kind, 2)
    mod = tCFG.Config.from_dict(raw).modules[name]
    build = {"asr": tbuilder.build_batched_asr, "tts": tbuilder.build_tts,
             "duplex": tbuilder.build_duplex}[kind]
    eng = build(mod, "cpu")
    if gc_on:
        return eng
    if kind == "asr":
        return BatchedAsrEngine(eng.cfg, eng.params, batch_size=2, device="cpu",
                                gc_tune=False)
    if kind == "tts":
        return BatchedTtsEngine(eng.cfg, eng.params, eng.mimi_cfg, eng.mimi_params,
                                eng.tokenizer, batch_size=2, device="cpu", gc_tune=False)
    return BatchedDuplexEngine(eng.cfg, eng.params, eng.mimi_cfg, eng.mimi_params,
                               eng.tokenizer, batch_size=2, device="cpu", gc_tune=False)


@pytest.mark.parametrize("gc_on", [True, False])
@pytest.mark.parametrize("kind", ["asr", "tts", "duplex"])
def test_engine_freezes_the_gc_after_warmup(kind, gc_on, monkeypatch, fresh_gc):
    eng = _engine(kind, monkeypatch, gc_on)
    assert eng.gc_tune is gc_on
    assert gc.get_freeze_count() == 0
    eng.warmup()
    if gc_on:
        assert gc.get_freeze_count() > 0
        assert gc.get_threshold() == (50_000, 50, 50)
    else:
        assert gc.get_freeze_count() == 0
        assert gc.get_threshold() == (700, 10, 10)


def test_freeze_after_warmup(fresh_gc):
    assert gc_tune.freeze_after_warmup(False) is False
    assert gc.get_freeze_count() == 0
    keep = [object() for _ in range(10)]
    assert gc_tune.freeze_after_warmup() is True
    assert gc.get_freeze_count() >= len(keep)
    gc.set_threshold(60_000, 5, 70)
    gc_tune.freeze_after_warmup()  # keeps larger thresholds, raises smaller ones
    assert gc.get_threshold() == (60_000, 50, 70)
