"""Device mesh for multi-device serving (counterpart of ``dsm_tpu/parallel/mesh.py``).

A mesh is a ``dp x tp`` grid of ``torch.device``s:

  * ``dp`` splits the continuous batch: shard ``d`` owns slots ``[d*B/dp,
    (d+1)*B/dp)`` and holds the whole params on its device;
  * ``tp`` splits the MAIN LM transformer over attention heads and MLP
    hidden (Megatron): the fused projections are row-split, the output
    projections column-split, and the three row-parallel partial sums
    (after ``out_proj``, after ``ca_out``, after the MLP) are summed across
    the tp shards (``ops/transformer.py``, ``TransformerConfig.tp_shard``).
    The DepFormer, the codec, the embeddings, the heads and the sampling run
    replicated on every tp shard, which therefore draw the same tokens.

One controller serves the mesh, as the JAX package's ``shard_map`` does: one
process and one engine object, whose tick stages, runs and fetches every
shard.  The engines (``server/batched_asr.py``, ``server/tts_batched.py``,
``server/duplex_batched.py``) take :class:`ShardedEngine`'s shard lifecycle:
one engine of their own class a shard, at the shard's batch, config and
params, run through :class:`ShardRunner`: dp shards one after another on the calling thread (a
shard's step is asynchronous on its card; there are no collectives), the tp
shards of a dp replica in lock-step, one host thread each, meeting at the
joins in :class:`TpGroup`'s all-reduce.  On the card a replica's tp shards
are one captured CUDA graph (where they share the card): the threads run
only to warm up and capture, the joins are :class:`DeviceJoin`'s sums on the
device, and every later step is one graph launch a replica.

The rules are the JAX package's: :func:`permute_tp_params` (``_TP_INTERLEAVE``),
:func:`tp_shard_params` (``_tp_param_spec``), :func:`state_shard`
(``_dp_tp_state_spec`` and ``_dp_spec``) and :func:`tp_local_transformer_cfg`.
The port's transformers keep a list of per-layer dicts where the JAX package
stacks layers on a leading axis, so a leaf's projection dims are its first
two here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import queue
import threading
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

log = logging.getLogger("dsm.torch.mesh")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[d][t]``: the device of dp shard ``d``, tp shard ``t``."""

    devices: tuple

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return len(self.devices[0])

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}


def make_mesh(dp: Optional[int] = None, tp: int = 1, devices=None) -> Mesh:
    """A ``dp x tp`` mesh of the leading ``dp * tp`` of ``devices`` (the
    CUDA devices ``cuda:0 .. cuda:n-1`` by default).  More shards than
    devices raise; a mesh smaller than the list is valid (two modules of one
    TOML may each take part of the machine).  A list may repeat a device:
    every shard is then a separate engine on the one device."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp < 1 or tp < 1:
        raise ValueError(f"dp and tp must be at least 1, got dp={dp} tp={tp}")
    if dp * tp > n:
        raise ValueError(f"dp*tp = {dp}*{tp} > {n} devices")
    return Mesh(tuple(tuple(devices[d * tp:(d + 1) * tp]) for d in range(dp)))


# ---------------------------------------------------------------------------
# The tp split of the params
# ---------------------------------------------------------------------------

# Fused-projection row blocks that a contiguous tp split would cross: in_proj
# rows are [q|k|v], ca_kv rows [k|v], gated MLP rows [a|b].
_TP_INTERLEAVE = {"in_proj_w": 3, "in_proj_b": 3, "ca_kv_w": 2, "linear_in": 2}
_TP_ROW_SHARD = ("in_proj_w", "in_proj_b", "ca_q_w", "ca_kv_w", "linear_in", "linear1")
_TP_COL_SHARD = ("out_proj_w", "ca_out_w", "linear_out", "linear2")


def _lm_transformer_path(parts) -> bool:
    """True for leaves of the MAIN LM transformer (``params["lm"]
    ["transformer"]``); the codec's and the DepFormer's stay replicated."""
    return "lm" in parts and "transformer" in parts and "depformer" not in parts


def _base_name(parts) -> str:
    """A leaf's weight name: ``.../<name>/q`` and ``.../<name>/s`` are the
    int8 halves of ``<name>``."""
    name = parts[-1]
    return parts[-2] if name in ("q", "s") and len(parts) >= 2 else name


def _map_with_path(fn, tree, path=()):
    """``fn(parts, leaf)`` on every tensor leaf; other leaves (an int8
    weight's ``w8a8`` profile, ints) are kept."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    return tree


def permute_tp_params(params, tp: int):
    """Interleave the fused projection rows of the main LM transformer so
    that a contiguous tp split gives each shard ``[q|k|v]``, ``[k|v]`` and
    ``[a|b]`` blocks in the standard layout.  An int8 weight's ``q`` rows and
    their scales ``s`` move together (the quantisation is per output row),
    so permuting before or after ``quantize_weights`` is the same."""

    def perm(parts, leaf):
        if not _lm_transformer_path(parts):
            return leaf
        groups = _TP_INTERLEAVE.get(_base_name(parts))
        if groups is None:
            return leaf
        o = leaf.shape[0]
        if o % (groups * tp):
            raise ValueError(f"{'/'.join(parts)}: fused dim {o} not divisible by "
                             f"{groups}*tp={groups * tp}")
        rest = tuple(leaf.shape[1:])
        w = leaf.reshape((groups, tp, o // (groups * tp)) + rest).transpose(0, 1)
        return w.reshape((o,) + rest).contiguous()

    return _map_with_path(perm, params)


def tp_shard_params(params, tp: int, t: int):
    """Tp shard ``t`` of (permuted) params: rows of the row-parallel leaves
    (``in_proj_w/b``, ``ca_q_w``, ``ca_kv_w``, ``linear_in``, ``linear1``),
    columns of the column-parallel ones (``out_proj_w``, ``ca_out_w``,
    ``linear_out``, ``linear2``; an int8 weight's ``s`` stays whole), every
    other leaf whole.  Row blocks are views, column blocks copies."""

    def take(parts, leaf):
        if not _lm_transformer_path(parts):
            return leaf
        base = _base_name(parts)
        if base in _TP_ROW_SHARD:
            n = leaf.shape[0] // tp
            return leaf[t * n:(t + 1) * n]
        if base in _TP_COL_SHARD and parts[-1] != "s" and leaf.dim() == 2:
            n = leaf.shape[1] // tp
            return leaf[:, t * n:(t + 1) * n].contiguous()
        return leaf

    return _map_with_path(take, params)


def tp_local_transformer_cfg(tcfg, tp: int):
    """The per-shard view of a transformer config: heads split over tp,
    ``head_dim`` pinned (it must not be re-derived from the reduced head
    count), the joins summed over ``tp``."""
    if tcfg.num_heads % tp:
        raise ValueError(f"num_heads {tcfg.num_heads} not divisible by {tp}")
    return dataclasses.replace(tcfg, num_heads=tcfg.num_heads // tp, head_dim=tcfg.hd,
                               tp_shard=True)


def tp_split(mesh: Mesh, cfg, params):
    """An engine's config (whose ``lm.transformer`` is the main LM's) and
    params -> the config its shards run and the params of each tp shard: under
    tp the tp-local config and the slices of the permuted params, else the
    config and the whole params."""
    if mesh.tp == 1:
        return cfg, [params]
    permuted = permute_tp_params(params, mesh.tp)
    local = dataclasses.replace(cfg, lm=dataclasses.replace(
        cfg.lm, transformer=tp_local_transformer_cfg(cfg.lm.transformer, mesh.tp)))
    return local, [tp_shard_params(permuted, mesh.tp, t) for t in range(mesh.tp)]


def params_to(tree, device):
    """``tree`` with every tensor on ``device`` (tensors there already are
    kept, not copied)."""
    return _map_with_path(lambda _, leaf: leaf.to(device), tree)


# ---------------------------------------------------------------------------
# The split of a session state
# ---------------------------------------------------------------------------


def _is_key(leaf: torch.Tensor) -> bool:
    """A generator key, ``(2,)`` or ``(4,)`` int64 words: replicated."""
    return leaf.dtype == torch.int64 and leaf.dim() == 1 and leaf.shape[0] in (2, 4)


def state_shard(state, dp: int, tp: int, d: int, t: int, batch: int, heads: int):
    """Shard ``(d, t)`` of a session state of ``batch`` slots: the main LM's
    K/V rings and scale rings (``.../lm/.../layers/<i>/{k,v,ks,vs}``,
    ``(batch, heads, ...)``) split over (dp, tp), every other batch-leading
    leaf over dp; the 0-d tick and the generator keys replicated."""
    b = batch // dp

    def take(parts, leaf):
        if _is_key(leaf) or leaf.dim() == 0 or leaf.shape[0] != batch:
            return leaf
        rows = leaf[d * b:(d + 1) * b]
        if ("lm" in parts and "layers" in parts and parts[-1] in ("k", "v", "ks", "vs")
                and leaf.dim() >= 3 and leaf.shape[1] == heads):
            h = heads // tp
            return rows[:, t * h:(t + 1) * h]
        return rows

    return _map_with_path(take, state)


def _tp_across_devices(mesh: Optional[Mesh]) -> bool:
    """True where a dp replica's tp shards sit on more than one device."""
    return mesh is not None and mesh.tp > 1 and any(len(set(row)) > 1 for row in mesh.devices)


def pick_cuda_graph(cuda_graph: Optional[bool], device: torch.device,
                    mesh: Optional[Mesh], what: str) -> bool:
    """An engine's ``cuda_graph``: None takes the captured step on CUDA, under
    tp too (a replica's tp shards in one graph, :class:`DeviceJoin`), except
    where a replica's tp shards sit on different cards: one capture records
    one card's work (its private memory pool is that card's), so that mesh
    runs the eager step, said in the log.  True raises there and on the CPU."""
    on_card = device.type == "cuda"
    across = _tp_across_devices(mesh)
    if cuda_graph is None:
        if on_card and across:
            log.info("%s engine: the tp=%d mesh spans cards within a replica and runs the "
                     "eager step (one CUDA graph records one card)", what, mesh.tp)
        return on_card and not across
    if cuda_graph and not on_card:
        raise ValueError(f"cuda_graph: no CUDA graph on {device}")
    if cuda_graph and across:
        row = next(r for r in mesh.devices if len(set(r)) > 1)
        raise ValueError(f"cuda_graph: no CUDA graph for a tp={mesh.tp} replica across cards "
                         f"{[str(d) for d in row]}: one capture records one card, so that "
                         "mesh runs the eager step")
    return bool(cuda_graph)


def check_divisible(mesh: Mesh, batch: int, heads: int) -> None:
    """The engines' checks of a mesh against a batch and the LM's heads."""
    if batch % mesh.dp:
        raise ValueError(f"batch {batch} not divisible by dp={mesh.dp}")
    if mesh.tp > 1 and heads % mesh.tp:
        raise ValueError(f"num_heads {heads} not divisible by tp={mesh.tp}")


# ---------------------------------------------------------------------------
# The tp joins and the runner
# ---------------------------------------------------------------------------

_local = threading.local()


class TpGroup:
    """The tp shards of a dp replica: :meth:`all_reduce` sums their
    partials in shard order and gives each shard the sum on its own device,
    so that every shard rounds alike, on the CPU and the card.  Two sets of
    slots in turn: a shard writes the set of its next join only after every
    shard has passed this join's barrier, so one barrier a join suffices."""

    def __init__(self, n: int):
        self.n = n
        self.reset()

    def reset(self) -> None:
        self._barrier = threading.Barrier(self.n)
        self._parts = [[None] * self.n, [None] * self.n]
        self._calls = [0] * self.n

    def all_reduce(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        parts = self._parts[self._calls[rank] % 2]
        self._calls[rank] += 1
        parts[rank] = x
        self._barrier.wait()
        acc = parts[0].to(x.device)
        for p in parts[1:]:
            acc = acc + p.to(x.device)
        return acc

    def abort(self) -> None:
        self._barrier.abort()


class _PeerGraph:
    """What a tp shard other than 0 holds of its replica's graph: tp shard
    0's graph launches every tp shard's work, so this one launches nothing."""

    def replay(self) -> None:
        pass


class DeviceJoin(TpGroup):
    """The joins of a captured tp step: the sum of :class:`TpGroup`, in the
    same shard order and dtype, kept on the device so that a CUDA graph
    records it.  Each shard copies its partial into a static slot (held here
    for the engine's life, outside any graph's memory pool) and records an
    event on its stream; the host threads meet at the barrier only to know
    that every event is recorded; each shard's stream then waits on its
    peers' events and sums the slots ``s0 + s1 + ...``.  In a captured graph
    the events are edges between the shards' streams and no host thread
    takes part.  Two sets of slots and events in turn, as in
    :class:`TpGroup`.  On CPU tensors there is no event: the slots and the
    barrier alone.

    :meth:`capture` records the body of every tp shard of a replica as one
    graph: each shard on its own stream (the one it warmed up on), forked
    from tp shard 0's capture stream and joined back into it before the
    capture ends."""

    def __init__(self, n: int):
        self._slots, self._events, self._streams = {}, {}, {}
        self._shared: dict = {}
        super().__init__(n)

    def all_reduce(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        parity = self._calls[rank] % 2
        self._calls[rank] += 1
        key = (_local.replica, parity, tuple(x.shape), x.dtype, x.device)
        slots = self._slots.setdefault(key, [None] * self.n)
        if slots[rank] is None:
            slots[rank] = torch.empty_like(x)
        slots[rank].copy_(x)
        events = None
        if x.is_cuda:
            events = self._events.setdefault(key, [None] * self.n)
            if events[rank] is None:
                events[rank] = torch.cuda.Event()
            events[rank].record()
        self._barrier.wait()
        if events is not None:
            stream = torch.cuda.current_stream(x.device)
            for t, ev in enumerate(events):
                if t != rank:
                    stream.wait_event(ev)
        acc = slots[0].to(x.device)
        for s in slots[1:]:
            acc = acc + s.to(x.device)
        return acc

    def capture(self, rank: int, body: Callable[[], object], warm_steps: int, device,
                inputs=None):
        """Collective of a replica's tp shards, each on its own thread, in
        the same order: ``body`` run ``warm_steps`` times (at least once) on
        the shard's stream, then captured there into tp shard 0's graph ->
        ``(graph, outputs)``: tp shard 0 gets the graph, the others a
        :class:`_PeerGraph`.  ``inputs``: the shard's ``StagedInputs``; the
        other shards' bodies first copy tp shard 0's buffers into theirs, on
        the card, so that a dispatch stages tp shard 0's alone.  A capture
        that fails raises on every shard."""
        device = torch.device(device)
        key = (_local.replica, rank)
        if key not in self._streams:  # warm-up and capture on one stream a shard
            self._streams[key] = torch.cuda.Stream(device)
        stream = self._streams[key]
        stream.wait_stream(torch.cuda.current_stream(device))
        if rank == 0:  # the events made (recorded once) before the capture
            self._shared = {"inputs": inputs, "fork": torch.cuda.Event(),
                            "done": [torch.cuda.Event() for _ in range(self.n)]}
            for ev in [self._shared["fork"]] + self._shared["done"]:
                ev.record(stream)
        self._barrier.wait()
        shared = self._shared
        src = shared["inputs"]

        def run():
            if rank and inputs is not None:
                for name, buf in inputs.buffers.items():
                    buf.copy_(src.buffers[name])
            return body()

        with torch.cuda.stream(stream), torch.inference_mode():
            for _ in range(max(1, warm_steps)):
                run()
        self._barrier.wait()
        graph = failed = None
        if rank == 0:
            torch.cuda.synchronize(device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                graph.capture_begin()
                shared["fork"].record(stream)
        try:
            self._barrier.wait()
            if rank:
                stream.wait_event(shared["fork"])
            with torch.cuda.stream(stream), torch.inference_mode():
                out = run()
                shared["done"][rank].record(stream)
            self._barrier.wait()
        except BaseException as e:
            failed = e
            raise
        finally:
            if rank == 0:  # the capture ends whatever happened
                try:
                    with torch.cuda.stream(stream):
                        for ev in shared["done"][1:]:
                            stream.wait_event(ev)
                        graph.capture_end()
                except Exception:
                    if failed is None:
                        raise
        self._barrier.wait()
        torch.cuda.current_stream(device).wait_stream(stream)
        if rank == 0:
            torch.cuda.synchronize(device)
        return (graph if rank == 0 else _PeerGraph()), out


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the tp shards of the dp replica that the
    calling thread steps (the port's ``jax.lax.psum`` over ``"tp"``).
    Raises outside a shard's thread."""
    group = getattr(_local, "group", None)
    if group is None:
        raise RuntimeError("all_reduce outside a tp shard of a mesh step")
    return group.all_reduce(_local.rank, x)


def capture_group():
    """``(join, rank)`` where the calling thread is a tp shard of a captured
    mesh (its joins a :class:`DeviceJoin`), else None: what
    ``server/cuda_graph.capture`` asks to record a replica's graph."""
    group = getattr(_local, "group", None)
    return (group, _local.rank) if isinstance(group, DeviceJoin) else None


def _device_ctx(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class ShardRunner:
    """Runs a function on every shard of a mesh: ``fn(d, t, shard)`` with
    the shard's device current.  :meth:`run` takes the dp replicas one after
    another, each on the calling thread when tp is 1, else its tp shards at
    once on ``tp`` host threads (thread ``t`` runs tp shard ``t`` of every
    replica), joined by a :class:`TpGroup`, or with ``device_join`` by a
    :class:`DeviceJoin` (the joins of a step to capture).  :meth:`each` runs
    every shard on the calling thread (work with no join: voice writes,
    script ops); :meth:`leads` runs tp shard 0 of every replica there (the
    launch of a replica's captured graph)."""

    def __init__(self, mesh: Mesh, shards: Sequence[Sequence[object]],
                 device_join: bool = False):
        self.mesh = mesh
        self.shards = shards
        self._group = (DeviceJoin if device_join else TpGroup)(mesh.tp)
        self._queues: Optional[list] = None

    def each(self, fn: Callable) -> list:
        out = []
        for d, row in enumerate(self.shards):
            out.append([])
            for t, shard in enumerate(row):
                with _device_ctx(self.mesh.devices[d][t]):
                    out[-1].append(fn(d, t, shard))
        return out

    def leads(self, fn: Callable) -> list:
        out = []
        for d, row in enumerate(self.shards):
            with _device_ctx(self.mesh.devices[d][0]):
                out.append(fn(d, 0, row[0]))
        return out

    def run(self, fn: Callable) -> list:
        if self.mesh.tp == 1:
            return self.each(fn)
        if self._queues is None:
            self._start()
        out = []
        for d, row in enumerate(self.shards):  # one dp replica at a time
            futures = []
            for t, shard in enumerate(row):
                fut: Future = Future()
                self._queues[t].put((fn, d, t, shard, fut))
                futures.append(fut)
            errors = [e for e in (f.exception() for f in futures) if e is not None]
            if errors:
                self._group.reset()
                # The failing shard's error, not the broken barrier of its peers.
                raise next((e for e in errors
                            if not isinstance(e, threading.BrokenBarrierError)), errors[0])
            out.append([f.result() for f in futures])
        return out

    def _start(self) -> None:
        self._queues = []
        for t in range(self.mesh.tp):
            q: queue.Queue = queue.Queue()
            self._queues.append(q)
            threading.Thread(target=self._worker, args=(q, t), daemon=True,
                             name=f"mesh-tp-{t}").start()

    def _worker(self, q: queue.Queue, t: int) -> None:
        _local.group, _local.rank = self._group, t
        while True:
            job = q.get()
            if job is None:
                return
            fn, d, t, shard, fut = job
            _local.replica = d
            try:
                with _device_ctx(self.mesh.devices[d][t]), torch.inference_mode():
                    fut.set_result(fn(d, t, shard))
            except BaseException as e:  # the replica's other shards must not wait for ever
                self._group.abort()
                fut.set_exception(e)
                if not isinstance(e, Exception):
                    raise

    def close(self) -> None:
        """End the shard threads (a later :meth:`run` starts them anew)."""
        if self._queues is not None:
            for q in self._queues:
                q.put(None)
            self._queues = None


# ---------------------------------------------------------------------------
# The shards' packed outputs
# ---------------------------------------------------------------------------


def merge_packed(arrays: Sequence[np.ndarray], batch: int, widths) -> np.ndarray:
    """The dp shards' packed int32 arrays -> the unmeshed engine's layout.
    Each shard's last axis is segments of ``batch * w`` words for ``w`` in
    ``widths`` (one ``None``: the rest); the result is each segment of every
    shard in turn."""
    total = arrays[0].shape[-1] // batch
    known = sum(w for w in widths if w is not None)
    widths = [total - known if w is None else w for w in widths]
    out, off = [], 0
    for w in widths:
        out.extend(a[..., off * batch:(off + w) * batch] for a in arrays)
        off += w
    return np.concatenate(out, axis=-1)


class MeshHandle:
    """A dispatch of every dp shard: the shards' handles (of tp shard 0) and
    how their packed arrays merge.  ``server/cuda_graph.fetch`` takes it as
    it takes one engine's handle."""

    def __init__(self, handles: list, batch: int, widths):
        self.handles = handles
        self.batch = batch
        self.widths = widths

    def merge(self, arrays: List[np.ndarray]) -> np.ndarray:
        return merge_packed(arrays, self.batch, self.widths)


# ---------------------------------------------------------------------------
# The shards of a batched engine
# ---------------------------------------------------------------------------


class ShardedEngine:
    """The mesh half of the batched engines: :meth:`_place` on one device or
    a mesh, and on a mesh one engine of the same class a shard at ``B/dp``
    slots (:meth:`_build_shards`), stepped through a :class:`ShardRunner`.
    An engine keeps only its own routing: which host arrays, rows and ops
    go to which shard, and how its packed outputs merge.

    Captured under tp, each shard's ``_capture`` runs on its tp thread and
    ``server/cuda_graph.capture`` records the replica's tp shards into one
    graph (:meth:`DeviceJoin.capture`), held by tp shard 0; a dispatch then
    stages tp shard 0's inputs and replays that graph from the calling
    thread, one launch a replica, with no host thread or barrier."""

    mesh: Optional[Mesh] = None
    _graph = None

    def _place(self, mesh: Optional[Mesh], device, cuda_graph: Optional[bool],
               what: str) -> None:
        """``device``, or the first shard's under a mesh; the captured step
        by :func:`pick_cuda_graph`."""
        self.mesh = mesh
        self.device = torch.device(device if mesh is None else mesh.devices[0][0])
        self.cuda_graph = pick_cuda_graph(cuda_graph, self.device, mesh, what)

    def _build_shards(self, what: str, make: Callable) -> None:
        """``self.shards[d][t]``: ``make(cfg, params, device, b, d)``, the
        engine of dp shard ``d`` at ``b = B/dp`` slots on ``device`` with the
        shard's config and params: the whole params under dp; under tp the
        tp-local config and tp shard ``t``'s slice of the permuted params."""
        mesh = self.mesh
        check_divisible(mesh, self.batch_size, self.cfg.lm.transformer.num_heads)
        cfg, tp_params = tp_split(mesh, self.cfg, self.params)
        b = self._shard_b = self.batch_size // mesh.dp
        self.shards = [[make(cfg, params_to(tp_params[t], dev), dev, b, d)
                        for t, dev in enumerate(row)] for d, row in enumerate(mesh.devices)]
        self._runner = ShardRunner(mesh, self.shards,
                                   device_join=self.cuda_graph and mesh.tp > 1)
        log.info("%s engine B=%d on a dp=%d x tp=%d mesh: %d slots a shard, %s step", what,
                 self.batch_size, mesh.dp, mesh.tp, b,
                 "captured" if self.cuda_graph else "eager")

    def _shard_slots(self, d: int) -> slice:
        """The slots of dp shard ``d``."""
        return slice(d * self._shard_b, (d + 1) * self._shard_b)

    def _on_shards(self, method: str, *arrays) -> list:
        """``shard.<method>`` with its dp shard's rows of the host ``arrays``
        -> each dp shard's result (its tp shard 0's).  Captured: on tp shard 0
        of each replica, on the calling thread (its graph launches every tp
        shard's work); eager: on every shard (the tp shards of a replica in
        lock-step on their threads)."""

        def call(d, t, sh):
            return getattr(sh, method)(*(a[self._shard_slots(d)] for a in arrays))

        if self.cuda_graph:
            return self._runner.leads(call)
        return [row[0] for row in self._runner.run(call)]

    def _on_graph_shards(self, fn: Callable) -> list:
        """``fn(d, t, shard)`` on every shard on the calling thread, or, once
        a tp step is captured, on tp shard 0 of each replica alone: work that
        replays a shard's graph (the script ops), which under tp is the
        replica's."""
        if self.cuda_graph and self.mesh.tp > 1 and self._captured():
            return self._runner.leads(fn)
        return self._runner.each(fn)

    def _captured(self) -> bool:
        if self.mesh is None:
            return self._graph is not None
        return all(sh._graph is not None for row in self.shards for sh in row)

    def _warm_all(self, steps: int) -> None:
        """The engine's ``_warm`` (the capture, or eager steps), on every
        shard under a mesh.  A captured tp mesh's shard threads end once its
        replicas are captured: replays launch from the calling thread."""
        if self.mesh is None:
            self._warm(steps)
            return
        def warm(d, t, sh):
            # Outside the shard thread's inference mode: the buffers a capture
            # makes are refilled in place from the calling thread later.
            with torch.inference_mode(False):
                sh._warm(steps)

        self._runner.run(warm)
        if self.cuda_graph and self.mesh.tp > 1:
            self._runner.close()

    def _close_shards(self) -> None:
        """End the shards' threads (nothing without a mesh)."""
        if self.mesh is not None:
            self._runner.close()
