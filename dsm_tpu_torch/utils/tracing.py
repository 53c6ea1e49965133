"""Profiling and tracing (counterpart of ``dsm_tpu/utils/tracing.py``).

:func:`device_trace` records the enclosed block with ``torch.profiler`` (the
host's operators and, where a card is present, its kernels through CUPTI)
and writes a Chrome trace that Perfetto opens; :func:`span` names a block in
that trace and always feeds the latency recorder of its name
(``utils/bench.py``), traced or not; :func:`annotate_fn` is its decorator
form.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

from .bench import recorder


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block -> ``log_dir/trace.json`` (Chrome trace
    format; open it in Perfetto).  Yields the trace's path."""
    import torch

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def span(name: str):
    """A named span: a ``record_function`` range in a trace, and its wall
    time recorded into ``recorder(name)``."""
    import torch

    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        recorder(name).record(time.perf_counter() - t0)


def annotate_fn(name: Optional[str] = None):
    """Decorator form of :func:`span` (the label defaults to the function's
    qualified name)."""

    def deco(fn):
        label = name or fn.__qualname__

        def wrapped(*args, **kwargs):
            with span(label):
                return fn(*args, **kwargs)

        return wrapped

    return deco
