"""The joins of the captured tp step (``dsm_tpu_torch/parallel/mesh.py``) on
the CPU: :class:`DeviceJoin`, driven through ``ShardRunner`` on CPU tensors,
is bit for bit :class:`TpGroup`'s host sum in shard order (bf16 and f32, tp
2 and 4, more shard threads than cores, its slots static across steps);
``pick_cuda_graph``'s rules on a CUDA device that is never touched; which
thread records a replica's graph; and how a meshed engine routes its calls
once its tp step is captured (tp shard 0 of each replica, on the calling
thread).  The capture itself needs the card: ``tests/test_torch_cuda.py``
and ``chip_smoke.py``'s ``[mesh-*]`` phases.
"""

import logging
import sys
import threading

import numpy as np
import pytest
import torch

from dsm_tpu_torch.parallel import mesh as tM

torch.set_num_threads(1)

CUDA = torch.device("cuda", 0)  # named, never touched


def _partials(dp, tp, dtype, seed, joins):
    """Partials whose sum rounds by its order: large and small magnitudes of
    both signs, ``joins`` a shard."""
    g = np.random.default_rng(seed)
    scale = np.array([1e4, 1.0, 3e-3, 7.0])
    return [[[torch.from_numpy(g.standard_normal(6) * scale[(t + j) % 4]).to(dtype)
              for j in range(joins)] for t in range(tp)] for d in range(dp)]


def _joined(device_join, mesh, parts, steps=2):
    """Every shard's sums of its partials, join after join, ``steps`` times
    through one runner (the slots and barriers come round again)."""
    runner = tM.ShardRunner(mesh, parts, device_join=device_join)
    try:
        for _ in range(steps):
            out = runner.run(lambda d, t, ps: [tM.all_reduce(p) for p in ps])
    finally:
        runner.close()
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tp", [2, 4])
def test_device_join_is_the_host_sum_in_shard_order(dtype, tp):
    mesh = tM.make_mesh(dp=2, tp=tp, devices=["cpu"] * 8)
    parts = _partials(2, tp, dtype, seed=tp, joins=7)
    got = _joined(True, mesh, parts)
    want = _joined(False, mesh, parts)
    for d in range(2):
        for j in range(7):
            order = parts[d][0][j]
            for t in range(1, tp):
                order = order + parts[d][t][j]
            for t in range(tp):
                assert got[d][t][j].dtype == dtype
                assert torch.equal(got[d][t][j], want[d][t][j])
                assert torch.equal(got[d][t][j], order)
    if tp == 4:  # the partials round by their order: another order differs somewhere
        rev = [[sum(reversed([parts[d][t][j] for t in range(tp)])) for j in range(7)]
               for d in range(2)]
        assert any(not torch.equal(rev[d][j], want[d][0][j]) for d in range(2) for j in range(7))


def test_device_join_holds_with_more_threads_than_cores_switching_often():
    """12 tp shards (more threads than cores) through 40 joins with the
    interpreter switching threads every microsecond: every shard gets each
    join's sum of that join's partials, bit for bit the host join's."""
    mesh = tM.make_mesh(dp=1, tp=12, devices=["cpu"] * 12)
    parts = _partials(1, 12, torch.bfloat16, seed=5, joins=40)
    out = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for device_join in (True, False):
            th = threading.Thread(target=lambda dj=device_join: out.__setitem__(
                dj, _joined(dj, mesh, parts, steps=1)))
            th.start()
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    for t in range(12):
        for j in range(40):
            assert torch.equal(out[True][0][t][j], out[False][0][t][j])


def test_device_join_slots_are_static_across_steps():
    """A step's joins copy into the same slot tensors every step (the
    buffers a captured graph reads), two sets in turn, one a dp replica."""
    mesh = tM.make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    parts = _partials(2, 2, torch.float32, seed=3, joins=3)
    runner = tM.ShardRunner(mesh, parts, device_join=True)
    try:
        runner.run(lambda d, t, ps: [tM.all_reduce(p) for p in ps])
        join = runner._group
        ptrs = {k: [s.data_ptr() for s in v] for k, v in join._slots.items()}
        runner.run(lambda d, t, ps: [tM.all_reduce(p) for p in ps])
    finally:
        runner.close()
    assert {k: [s.data_ptr() for s in v] for k, v in join._slots.items()} == ptrs
    assert sorted((k[0], k[1]) for k in ptrs) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_a_failing_shard_breaks_the_device_join_and_the_runner_recovers():
    mesh = tM.make_mesh(dp=1, tp=2, devices=["cpu"] * 2)
    runner = tM.ShardRunner(mesh, [[torch.ones(3), torch.ones(3)]], device_join=True)

    def fail(d, t, p):
        if t == 1:
            raise KeyError("shard 1")
        return tM.all_reduce(p)

    try:
        with pytest.raises(KeyError, match="shard 1"):
            runner.run(fail)
        out = runner.run(lambda d, t, p: tM.all_reduce(p))
    finally:
        runner.close()
    assert all(torch.equal(o, torch.full((3,), 2.0)) for o in out[0])


@pytest.mark.parametrize("cuda_graph,devices,want", [
    (None, ["cuda:0"] * 4, True),             # dp x tp on one card: captured
    (True, ["cuda:0"] * 4, True),             # asked for: no longer raises
    (None, ["cuda:0", "cuda:0", "cuda:1", "cuda:1"], True),  # each replica on its card
    (None, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"], False),  # a replica across cards
    (True, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"], "tp=2 replica across cards"),
    (False, ["cuda:0"] * 4, False),
])
def test_pick_cuda_graph_under_tp(cuda_graph, devices, want, caplog):
    mesh = tM.make_mesh(dp=2, tp=2, devices=devices)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            tM.pick_cuda_graph(cuda_graph, CUDA, mesh, "asr")
        return
    with caplog.at_level(logging.INFO, logger="dsm.torch.mesh"):
        assert tM.pick_cuda_graph(cuda_graph, CUDA, mesh, "asr") is want
    said = "spans cards within a replica and runs the eager step" in caplog.text
    assert said == (cuda_graph is None and not want)


@pytest.mark.parametrize("cuda_graph,want", [(None, False), (False, False),
                                             (True, "no CUDA graph on cpu")])
@pytest.mark.parametrize("tp", [1, 2])
def test_pick_cuda_graph_on_the_cpu_is_unchanged(cuda_graph, want, tp):
    mesh = tM.make_mesh(dp=2, tp=tp, devices=["cpu"] * 4)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            tM.pick_cuda_graph(cuda_graph, torch.device("cpu"), mesh, "tts")
    else:
        assert tM.pick_cuda_graph(cuda_graph, torch.device("cpu"), mesh, "tts") is want


def test_only_a_device_join_thread_records_a_replicas_graph():
    """``capture_group`` (what ``server/cuda_graph.capture`` asks) is the
    join and the shard's rank on a device-join runner's threads, None on
    the calling thread and on a host-join runner's threads."""
    assert tM.capture_group() is None
    mesh = tM.make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    for device_join in (True, False):
        runner = tM.ShardRunner(mesh, [[0, 1], [2, 3]], device_join=device_join)
        try:
            seen = runner.run(lambda d, t, sh: (tM.capture_group(), sh))
        finally:
            runner.close()
        for d in range(2):
            for t in range(2):
                group, sh = seen[d][t]
                assert sh == 2 * d + t
                assert (group == (runner._group, t)) if device_join else group is None


class _Shard:
    def __init__(self, d, t, calls):
        self.d, self.t, self.calls = d, t, calls
        self._graph = object()

    def _dispatch(self, rows):
        self.calls.append((self.d, self.t, threading.current_thread().name, rows.tolist()))
        return (self.d, self.t)


class _Engine(tM.ShardedEngine):
    """The mesh half of an engine with stand-in shards."""

    def __init__(self, mesh, cuda_graph):
        self.mesh, self.cuda_graph, self.batch_size = mesh, cuda_graph, 4
        self._shard_b = 4 // mesh.dp
        self.calls = []
        self.shards = [[_Shard(d, t, self.calls) for t in range(mesh.tp)]
                       for d in range(mesh.dp)]
        self._runner = tM.ShardRunner(mesh, self.shards,
                                      device_join=cuda_graph and mesh.tp > 1)


@pytest.mark.parametrize("cuda_graph", [True, False])
def test_a_captured_tp_engine_launches_each_replica_from_tp_shard_0(cuda_graph):
    """Captured, a dispatch calls tp shard 0 of each replica alone, on the
    calling thread, with the replica's rows; eager, every shard on its tp
    thread.  Work that replays a graph (``_on_graph_shards``) likewise."""
    eng = _Engine(tM.make_mesh(dp=2, tp=2, devices=["cpu"] * 4), cuda_graph)
    try:
        out = eng._on_shards("_dispatch", np.arange(4))
        assert out == [(0, 0), (1, 0)]
        me = threading.current_thread().name
        if cuda_graph:
            assert eng.calls == [(0, 0, me, [0, 1]), (1, 0, me, [2, 3])]
        else:
            assert sorted((d, t, rows) for d, t, _, rows in eng.calls) == [
                (0, 0, [0, 1]), (0, 1, [0, 1]), (1, 0, [2, 3]), (1, 1, [2, 3])]
            assert all(name == f"mesh-tp-{t}" for _, t, name, _ in eng.calls)
        seen = eng._on_graph_shards(lambda d, t, sh: (d, t))
        assert seen == ([(0, 0), (1, 0)] if cuda_graph else [[(0, 0), (0, 1)], [(1, 0), (1, 1)]])
    finally:
        eng._runner.close()
