"""The port's native frame packer (``dsm_tpu_torch/server/native.py``,
``csrc/packer.cpp``) against the JAX package's, and the ASR engine on it.

Bars: the round trip and the wraparound of ``tests/test_native_tools.py``; the
same packed frames, masks and counts as the JAX ``FramePacker`` for the same
pushes, bit for bit; the build lands under ``build/`` and leaves
``native/libdsm_packer.so`` as it was (its hash before and after); the ASR
engine on the packer gives the deque path's events bit for bit at
``pipeline_depth`` 0-2 on both pcm wires, and with pushes larger than the
slot's ring (the overflow); ``use_native_packer`` None / True / False keep the
JAX engine's meaning.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from dsm_tpu.server import native as jnative
from dsm_tpu_torch.server import batched_asr as tBA
from dsm_tpu_torch.server import native as tnative
from tests import test_torch_asr_pipeline as AP
from tests.test_torch_ops import to_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def test_roundtrip():
    p = tnative.FramePacker(batch=3, frame=8, capacity_frames=4)
    # Slot 0: exactly one frame; slot 1: 1.5 frames; slot 2: starved.
    p.push(0, np.arange(8, dtype=np.float32))
    p.push(1, np.arange(12, dtype=np.float32) + 100)
    active = np.array([True, True, True])
    out, mask, n = p.pack(active)
    assert n == 2 and mask.tolist() == [True, True, False]
    np.testing.assert_array_equal(out[0], np.arange(8))
    np.testing.assert_array_equal(out[1], np.arange(8) + 100)
    np.testing.assert_array_equal(out[2], np.zeros(8))
    assert p.available(1) == 4
    out, mask, n = p.pack(active)
    assert n == 0
    p.push(1, np.arange(4, dtype=np.float32) + 200)
    out, mask, n = p.pack(active)
    assert n == 1 and mask.tolist() == [False, True, False]
    np.testing.assert_array_equal(out[1][:4], np.arange(4) + 108)
    np.testing.assert_array_equal(out[1][4:], np.arange(4) + 200)
    p.push(2, np.ones(20, np.float32))
    p.reset_slot(2)
    assert p.available(2) == 0


def test_wraparound():
    p = tnative.FramePacker(batch=1, frame=8, capacity_frames=2)  # a ring of 16
    active = np.array([True])
    for it in range(5):
        p.push(0, np.full(8, it, np.float32))
        out, mask, n = p.pack(active)
        assert n == 1
        np.testing.assert_array_equal(out[0], np.full(8, it))
    assert p.push(0, np.zeros(100, np.float32)) == 16  # truncated, not corrupted


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_same_frames_as_the_jax_packer(seed):
    """Random pushes (ragged, some past the ring), resets and packs with
    random active slots: every return value equal to the JAX packer's."""
    rng = np.random.default_rng(seed)
    b, frame, cap = 4, 48, 3
    pj, pt = jnative.FramePacker(b, frame, cap), tnative.FramePacker(b, frame, cap)
    for _ in range(200):
        op = rng.integers(0, 10)
        slot = int(rng.integers(0, b))
        if op < 5:
            pcm = rng.standard_normal(int(rng.integers(1, 3 * frame))).astype(np.float32)
            assert pt.push(slot, pcm) == pj.push(slot, pcm)
        elif op == 5:
            pt.reset_slot(slot)
            pj.reset_slot(slot)
        else:
            active = rng.random(b) < 0.7
            ot, mt, nt = pt.pack(active)
            oj, mj, nj = pj.pack(active)
            assert nt == nj and mt.tolist() == mj.tolist()
            np.testing.assert_array_equal(ot.view(np.int32), oj.view(np.int32))
        for s in range(b):
            assert pt.available(s) == pj.available(s)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_build_keys_the_port_copy_and_leaves_the_committed_library(tmp_path, monkeypatch):
    committed = os.path.join(ROOT, "native", "libdsm_packer.so")
    before, listing = _sha(committed), sorted(os.listdir(os.path.join(ROOT, "native")))
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path)
    lib = tnative.build()
    assert lib.parent.parent == tmp_path and lib.name == "libdsm_packer.so" and lib.exists()
    assert tnative.build() == lib  # built once for this source
    assert tnative.lib_path() == lib and len(lib.parent.name) == 16
    assert _sha(committed) == before
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == listing
    assert tnative.SOURCE.parent.name == "csrc"
    # The port's copy is the JAX package's source, code for code.
    with open(os.path.join(ROOT, "native", "packer.cpp")) as f:
        theirs = f.read()
    ours = tnative.SOURCE.read_text()
    assert theirs[theirs.index("#include <atomic>"):] == ours[ours.index("#include <atomic>"):]


def _port_engine(depth, wire, packer):
    jcfg, tcfg, params = AP._small_asr()
    return jcfg.mimi.frame_size, tBA.BatchedAsrEngine(
        tcfg, to_port(params), batch_size=3, device="cpu", fill_gate_frac=0.0,
        pipeline_depth=depth, pcm_wire_int16=wire == "int16", use_native_packer=packer)


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("wire", ["f32", "int16"])
def test_engine_on_the_packer_gives_the_deque_paths_events(depth, wire):
    frame, on = _port_engine(depth, wire, True)
    _, off = _port_engine(depth, wire, False)
    assert on.packer is not None and off.packer is None
    (got, got_prs), (want, want_prs) = AP._serve(on, frame), AP._serve(off, frame)
    assert got == want
    assert sum(len(evs) for evs in got.values()) > 100
    for i in want_prs:
        np.testing.assert_array_equal(got_prs[i].view(np.int32), want_prs[i].view(np.int32))


def test_pushes_past_the_ring_overflow_and_lose_nothing():
    """A whole stream pushed at once (far more than the 64-frame ring) keeps
    every sample: the frames and events of the deque path."""
    frame, on = _port_engine(1, "f32", None)
    _, off = _port_engine(1, "f32", False)
    assert on.packer is not None
    logs = []
    for eng in (on, off):
        eng.warmup()
        events = []
        ch = eng.open_channel(events.append, seed=3)
        pcm = np.random.default_rng(0).standard_normal(frame * 150).astype(np.float32) * 0.3
        ch.push_pcm(pcm[:frame * 100 + 5])
        ch.push_pcm(pcm[frame * 100 + 5:])
        eng.add_marker(ch, 7)
        ch.push_pcm(np.zeros(frame * 4, np.float32))
        assert ch.buffered_samples() == frame * 154
        while ch.buffered_samples() >= frame:
            eng.tick()
        eng.stop()
        logs.append([(e.step_idx, [(type(w).__name__, getattr(w, "tokens", None))
                                   for w in e.words], e.markers, e.prs.tobytes())
                     for e in events])
    assert logs[0] == logs[1] and len(logs[0]) == 154
    assert [m for e in logs[0] for m in e[2]] == [7]


def test_use_native_packer_keeps_the_jax_meaning(monkeypatch):
    monkeypatch.setattr(tBA, "FramePacker", lambda *a: (_ for _ in ()).throw(
        RuntimeError("native packer unavailable")))
    _, eng = _port_engine(1, "f32", None)
    assert eng.packer is None  # None: the deque path where it does not build
    with pytest.raises(RuntimeError, match="unavailable"):
        _port_engine(1, "f32", True)
