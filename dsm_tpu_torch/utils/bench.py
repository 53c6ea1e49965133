"""Latency recording (counterpart of ``dsm_tpu/utils/bench.py``; the
stages of moshi-server's bench.rs).

``LatencyRecorder`` keeps count, min and max and a reservoir sample for
p50/p95/p99; :func:`scoped_timer` times a block into a named recorder;
:func:`device_timed` times a call on the card honestly: it synchronizes the
device after the call, as bench.rs's ``with_cuda_sync`` does.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np


class LatencyRecorder:
    RESERVOIR = 4096

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._samples: list = []
        self._rng = random.Random(0xC0FFEE)

    def record(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total += seconds
            self.min = min(self.min, seconds)
            self.max = max(self.max, seconds)
            if len(self._samples) < self.RESERVOIR:
                self._samples.append(seconds)
            else:
                j = self._rng.randrange(self.count)
                if j < self.RESERVOIR:
                    self._samples[j] = seconds

    def percentile(self, p: float) -> float:
        with self._lock:
            if not self._samples:
                return 0.0
            return float(np.percentile(self._samples, p))

    def summary(self) -> Dict[str, float]:
        with self._lock:
            n = self.count
            mean = self.total / n if n else 0.0
        return {
            "name": self.name,
            "count": n,
            "mean_ms": mean * 1e3,
            "min_ms": (self.min if self.min != float("inf") else 0.0) * 1e3,
            "max_ms": self.max * 1e3,
            "p50_ms": self.percentile(50) * 1e3,
            "p95_ms": self.percentile(95) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
        }

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.total = 0.0
            self.min = float("inf")
            self.max = 0.0
            self._samples.clear()


_REGISTRY: Dict[str, LatencyRecorder] = {}
_REG_LOCK = threading.Lock()

# Stage names mirroring bench.rs:234-280.
STAGES = (
    "inference", "mimi_encode", "mimi_decode", "transformer",
    "attention", "kv_cache", "pipeline", "depformer", "sampling",
)


def recorder(name: str) -> LatencyRecorder:
    with _REG_LOCK:
        if name not in _REGISTRY:
            _REGISTRY[name] = LatencyRecorder(name)
        return _REGISTRY[name]


def all_summaries() -> list:
    with _REG_LOCK:
        recs = list(_REGISTRY.values())
    return [r.summary() for r in recs if r.count]


@contextmanager
def scoped_timer(name: str):
    rec = recorder(name)
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        rec.record(time.perf_counter() - t0)


def device_timed(fn, *args, name: Optional[str] = None, **kwargs):
    """``fn(*args, **kwargs)`` timed to the end of its device work: the call,
    then ``torch.cuda.synchronize()`` where a card is present -> ``(out,
    seconds)``; the time goes to ``recorder(name)`` when ``name`` is given."""
    import torch

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if name:
        recorder(name).record(dt)
    return out, dt
