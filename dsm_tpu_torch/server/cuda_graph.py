"""What the engines share to serve a step as one captured CUDA graph.

A captured graph replays its launches on the same buffers for ever: its
inputs are static device buffers that each tick refills from host arrays
(:class:`StagedInputs`), :func:`capture` records the step once, after
warm-up runs on the stream it captures on, and a replay's packed output goes
back to the host into one of a few pinned buffers behind an event
(:class:`PinnedOutputs`, read with :func:`fetch`), so that the engines can
dispatch ahead.  ``server/batched_asr.py``, ``server/tts_batched.py`` and
``server/duplex_batched.py`` use them, on one device or on each dp replica
of a mesh (``parallel/mesh.py``), whose tp shards make one graph.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..parallel import mesh as M


class StagedInputs:
    """A graph's static input buffers on the card (``buffers``), filled from
    host arrays through pinned host staging: two staging sets in turn, each
    written only once its previous copy to the device has run (its event)."""

    def __init__(self, buffers: Dict[str, torch.Tensor]):
        self.buffers = buffers
        self._staging = [{k: torch.empty(v.shape, dtype=v.dtype).pin_memory()
                          for k, v in buffers.items()} for _ in range(2)]
        self._staged = [torch.cuda.Event(), torch.cuda.Event()]
        self._next = 0

    def stage(self, arrays: Dict[str, np.ndarray]) -> None:
        """Copy one host array into each buffer of the same name, on the
        current stream."""
        if arrays.keys() != self.buffers.keys():
            raise ValueError(f"staged {sorted(arrays)}, the graph reads {sorted(self.buffers)}")
        i = self._next
        self._next ^= 1
        host = self._staging[i]
        self._staged[i].synchronize()
        for name, arr in arrays.items():
            host[name].numpy()[...] = arr
        for name, buf in self.buffers.items():
            buf.copy_(host[name], non_blocking=True)
        self._staged[i].record()


class PinnedOutputs:
    """``n`` pinned host buffers for a graph's int32 output, used in turn:
    :meth:`copy` queues the device-to-host copy of a replay's output into the
    next one behind an event.  A buffer comes round again ``n`` copies later,
    so the caller reads each before ``n`` more dispatches."""

    def __init__(self, shape, n: int):
        self.buffers = [torch.empty(shape, dtype=torch.int32).pin_memory() for _ in range(n)]
        self.done = [torch.cuda.Event() for _ in range(n)]
        self._next = 0

    def copy(self, out: torch.Tensor):
        """Queue ``out``'s copy on the current stream -> ``(buffer, event)``,
        for :func:`fetch`."""
        i = self._next
        self._next = (i + 1) % len(self.buffers)
        self.buffers[i].copy_(out, non_blocking=True)
        self.done[i].record()
        return self.buffers[i], self.done[i]


def fetch(handle) -> np.ndarray:
    """A dispatch's packed array on the host, from ``(buffer, event)`` of
    :meth:`PinnedOutputs.copy` (the wait on that copy's event alone) or
    ``(device tensor, None)`` of an eager dispatch (its device-to-host copy),
    or a mesh's ``parallel.mesh.MeshHandle``: every shard's, merged."""
    if hasattr(handle, "merge"):
        return handle.merge([fetch(h) for h in handle.handles])
    packed, done = handle
    if done is not None:
        done.synchronize()
        return packed.numpy()
    return packed.cpu().numpy()


def capture(body: Callable[[], object], warm_steps: int, device,
            inputs: Optional[StagedInputs] = None):
    """Run ``body`` ``warm_steps`` times (at least once) on a side stream,
    then capture it there -> ``(graph, outputs)``, the outputs static
    tensors that every replay overwrites.  The warm-up builds what the step
    makes lazily (kernels, device constants, the cuBLAS workspace of that
    stream) before the capture; a capture that fails raises.  On a tp
    shard's thread of a captured mesh every tp shard of the replica calls
    this at once, and the body of each goes into one graph
    (``parallel.mesh.DeviceJoin.capture``; ``inputs``: the buffers the body
    reads, tp shard 0's staged for all)."""
    join = M.capture_group()
    if join is not None:
        group, rank = join
        return group.capture(rank, body, warm_steps, device, inputs)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.inference_mode():
        for _ in range(max(1, warm_steps)):
            body()
        with torch.cuda.graph(graph, stream=stream):
            out = body()
    torch.cuda.current_stream(device).wait_stream(stream)
    torch.cuda.synchronize(device)
    return graph, out
