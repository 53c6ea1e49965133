"""Prometheus metrics of the port (counterpart of ``dsm_tpu/server/metrics.py``;
reference: moshi-server/src/metrics.rs).

The family names, types, help strings, label names and histogram buckets are
the JAX module's (``REFERENCE_FAMILIES`` is its list).  The port writes the
Prometheus text exposition (format 0.0.4) itself, with a small thread-safe
``Counter`` / ``Gauge`` / ``Histogram`` that take ``.labels()``, so that it
runs where ``prometheus_client`` is absent: this module imports only the
standard library, and every engine may import it.  As the Python client
does, a counter named ``x`` or ``x_total`` is the family ``x`` rendered as
``x_total``, and a histogram renders ``_bucket{le=...}`` (with ``+Inf``),
``_count`` and ``_sum``; the client's ``_created`` samples are not written.

The device-memory gauges (``system_*_vram_bytes``, ``memory_*_vram_bytes``)
read the CUDA device through ``torch.cuda`` (:func:`update_device_memory`,
torch imported there).
"""

from __future__ import annotations

import math
import os
import threading
from typing import Dict, List, NamedTuple, Tuple

# The complete reference family list (moshi-server/src/metrics.rs), as the
# exposition names them.
REFERENCE_FAMILIES = (
    # asr (metrics.rs:15-40)
    "asr_connect",
    "asr_model_step_duration",
    "asr_connection_num_steps",
    "asr_open_channels",
    # per-WS stream counters, MOSHI_STREAM_METRICS-gated (:59-92)
    "asr_ws_in_bytes_total",
    "asr_ws_in_messages_total",
    "asr_ws_out_bytes_total",
    "asr_ws_out_messages_total",
    "lm_ws_in_bytes_total",
    "lm_ws_in_messages_total",
    "lm_ws_out_bytes_total",
    "lm_ws_out_messages_total",
    "tts_ws_in_bytes_total",
    "tts_ws_in_messages_total",
    "tts_ws_out_bytes_total",
    "tts_ws_out_messages_total",
    # warmup (:100-115)
    "warmup_duration_seconds",
    "warmup_success_total",
    "warmup_failure_total",
    "warmup_skipped_total",
    # system (:125-132)
    "system_free_vram_bytes",
    "system_used_vram_bytes",
    "system_total_vram_bytes",
    "system_gpu_utilization_percent",
    # errors (:144-166)
    "ws_close_total",
    "connection_error_total",
    "auth_error_total",
    # lm (:193-232)
    "lm_step_duration_seconds",
    "lm_tokens_per_second",
    "lm_batch_utilization",
    "lm_queue_depth",
    "lm_steps_total",
    "lm_active_connections",
    # mimi (:248-288)
    "mimi_encode_duration_seconds",
    "mimi_decode_duration_seconds",
    "mimi_frames_encoded_total",
    "mimi_frames_decoded_total",
    "mimi_batch_encode_duration_seconds",
    "mimi_batch_decode_duration_seconds",
    # tts (:310-348)
    "tts_synthesis_duration_seconds",
    "tts_audio_duration_seconds_total",
    "tts_realtime_factor",
    "tts_active_requests",
    "tts_requests_total",
    "tts_vocoder_duration_seconds",
    # memory (:369-397)
    "memory_tensor_allocations_total",
    "memory_peak_vram_bytes",
    "memory_current_vram_bytes",
    "memory_gpu_bytes_allocated_total",
    "memory_gpu_bytes_deallocated_total",
    # pipeline (:418-458)
    "pipeline_stalls_total",
    "pipeline_overlap_efficiency",
    "pipeline_preprocess_duration_seconds",
    "pipeline_postprocess_duration_seconds",
    "pipeline_batch_duration_seconds",
    "pipeline_channel_queue_depth",
)


def format_float(x: float) -> str:
    """A sample value or bucket bound as the Python client writes it (Go's
    form): ``+Inf``, ``NaN``, ``repr`` otherwise, with an exponent once a
    positive value has more than six digits before its point."""
    x = float(x)
    if math.isinf(x):
        return "+Inf" if x > 0 else "-Inf"
    if math.isnan(x):
        return "NaN"
    s = repr(x)
    dot = s.find(".")
    if x > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


class Sample(NamedTuple):
    name: str
    labels: Dict[str, str]
    value: float


class Family(NamedTuple):
    """One collected family: ``name`` without a counter's ``_total``."""

    name: str
    type: str
    documentation: str
    samples: List[Sample]


class Registry:
    """The families in registration order; names are unique."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, "_Metric"] = {}

    def register(self, metric: "_Metric") -> None:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"metric {metric.name} registered twice")
            self._metrics[metric.name] = metric

    def collect(self) -> List[Family]:
        with self._lock:
            metrics = list(self._metrics.values())
        return [Family(m.name, m.type, m.documentation, m.samples()) for m in metrics]


REGISTRY = Registry()


class _Value:
    """One float under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)

    def get(self) -> float:
        with self._lock:
            return self._v


class _CounterChild(_Value):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("a counter only goes up")
        super().inc(amount)

    def set(self, value: float) -> None:
        raise AttributeError("a counter is not set")


class _GaugeChild(_Value):
    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _HistogramChild:
    def __init__(self, bounds: Tuple[float, ...]):
        self._lock = threading.Lock()
        self._bounds = bounds
        self._counts = [0.0] * len(bounds)  # per bucket, not cumulative
        self._sum = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            for i, b in enumerate(self._bounds):
                if value <= b:
                    self._counts[i] += 1.0
                    break

    def snapshot(self) -> Tuple[List[float], float]:
        """(cumulative counts of every bound, +Inf last; sum)."""
        with self._lock:
            counts, total = list(self._counts), self._sum
        out, acc = [], 0.0
        for c in counts:
            acc += c
            out.append(acc)
        return out, total


class _Metric:
    type = ""

    def __init__(self, name: str, documentation: str, labelnames=()):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()
        REGISTRY.register(self)

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values, **by_name):
        """The child of these label values (by position or by name), made on
        first use."""
        if by_name:
            if values or set(by_name) != set(self.labelnames):
                raise ValueError(f"{self.name}: labels {sorted(by_name)}, "
                                 f"want {list(self.labelnames)}")
            values = tuple(by_name[n] for n in self.labelnames)
        if not self.labelnames or len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: {len(values)} label values for "
                             f"{list(self.labelnames)}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
        return child

    def _only(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {list(self.labelnames)}: use .labels()")
        return self._children[()]

    def _items(self):
        with self._lock:
            return list(self._children.items())

    def samples(self) -> List[Sample]:
        raise NotImplementedError


class Counter(_Metric):
    type = "counter"

    def __init__(self, name: str, documentation: str, labelnames=()):
        if name.endswith("_total"):
            name = name[:-len("_total")]
        super().__init__(name, documentation, labelnames)

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def get(self) -> float:
        return self._only().get()

    def samples(self) -> List[Sample]:
        return [Sample(self.name + "_total", dict(zip(self.labelnames, key)), child.get())
                for key, child in self._items()]


class Gauge(_Metric):
    type = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def get(self) -> float:
        return self._only().get()

    def samples(self) -> List[Sample]:
        return [Sample(self.name, dict(zip(self.labelnames, key)), child.get())
                for key, child in self._items()]


class Histogram(_Metric):
    type = "histogram"

    def __init__(self, name: str, documentation: str, labelnames=(), buckets=()):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds or bounds[-1] != math.inf:
            bounds += (math.inf,)
        self.buckets = bounds
        super().__init__(name, documentation, labelnames)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._only().observe(value)

    def samples(self) -> List[Sample]:
        out = []
        for key, child in self._items():
            labels = dict(zip(self.labelnames, key))
            counts, total = child.snapshot()
            for b, c in zip(self.buckets, counts):
                out.append(Sample(self.name + "_bucket", {**labels, "le": format_float(b)}, c))
            out.append(Sample(self.name + "_count", labels, counts[-1]))
            out.append(Sample(self.name + "_sum", labels, total))
        return out


def _h(name, doc, buckets, labels=()):
    return Histogram(name, doc, labels, buckets=buckets)


# -- ASR (metrics.rs:15-40) --------------------------------------------------
# `asr_connect` is a bare-named counter in the reference; a Gauge carries the
# exact name, as in the JAX module.
ASR_CONNECT = Gauge("asr_connect", "ASR websocket connections")
ASR_MODEL_STEP_DURATION = _h(
    "asr_model_step_duration", "Batched ASR model step duration (s)",
    (20e-3, 30e-3, 40e-3, 50e-3, 60e-3, 70e-3, 80e-3))
ASR_STEPS_PER_CONNECTION = _h(
    "asr_connection_num_steps", "Model steps per connection",
    (2.0, 25.0, 125.0, 250.0, 500.0, 750.0, 1125.0, 1500.0, 2250.0, 3000.0, 4500.0))
ASR_OPEN_CHANNELS = Gauge("asr_open_channels", "Active ASR channels")

# -- LM (metrics.rs:193-232) -------------------------------------------------
LM_STEP_DURATION = _h(
    "lm_step_duration_seconds", "LM step duration (s)",
    (0.005, 0.010, 0.020, 0.030, 0.040, 0.050, 0.075, 0.100, 0.150, 0.200))
LM_TOKENS_PER_SECOND = Gauge("lm_tokens_per_second", "Real-time LM token throughput")
LM_BATCH_UTILIZATION = _h(
    "lm_batch_utilization", "Fraction of batch slots active",
    (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0))
LM_QUEUE_DEPTH = Gauge("lm_queue_depth", "Pending work items")
LM_STEPS_TOTAL = Counter("lm_steps_total", "Total LM inference steps completed")
LM_ACTIVE_CONNECTIONS = Gauge("lm_active_connections", "Active LM connections")

# -- Codec (metrics.rs:248-288) ----------------------------------------------
_MIMI_STEP_BUCKETS = (0.001, 0.002, 0.005, 0.010, 0.020, 0.030, 0.050, 0.075, 0.100)
_MIMI_BATCH_BUCKETS = (0.005, 0.010, 0.020, 0.030, 0.050, 0.075, 0.100, 0.150)
MIMI_ENCODE_DURATION = _h("mimi_encode_duration_seconds", "Mimi encode step duration (s)",
                          _MIMI_STEP_BUCKETS)
MIMI_DECODE_DURATION = _h("mimi_decode_duration_seconds", "Mimi decode step duration (s)",
                          _MIMI_STEP_BUCKETS)
MIMI_FRAMES_ENCODED = Counter("mimi_frames_encoded_total", "Total audio frames encoded")
MIMI_FRAMES_DECODED = Counter("mimi_frames_decoded_total", "Total audio frames decoded")
MIMI_BATCH_ENCODE_DURATION = _h("mimi_batch_encode_duration_seconds",
                                "Batched Mimi encode duration (s)", _MIMI_BATCH_BUCKETS)
MIMI_BATCH_DECODE_DURATION = _h("mimi_batch_decode_duration_seconds",
                                "Batched Mimi decode duration (s)", _MIMI_BATCH_BUCKETS)

# -- TTS (metrics.rs:310-348) ------------------------------------------------
TTS_SYNTHESIS_DURATION = _h(
    "tts_synthesis_duration_seconds", "TTS synthesis wall time (s)",
    (0.05, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 5.0))
TTS_AUDIO_DURATION = Counter("tts_audio_duration_seconds_total",
                             "Total audio seconds synthesised")
TTS_RTF = Gauge("tts_realtime_factor", "TTS real-time factor")
TTS_ACTIVE_REQUESTS = Gauge("tts_active_requests", "In-flight TTS requests")
TTS_REQUESTS_TOTAL = Counter("tts_requests_total", "Total TTS synthesis requests completed")
TTS_VOCODER_DURATION = _h(
    "tts_vocoder_duration_seconds", "Vocoder (Mimi decode) duration (s)",
    (0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0))

# -- Warmup (metrics.rs:100-115; main.rs:1082-1146 counters) -----------------
WARMUP_DURATION = _h("warmup_duration_seconds", "Module warmup duration (s)",
                     (0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0))
WARMUP_SUCCESS = Counter("warmup_success_total", "Module warmups ok")
WARMUP_FAILURE = Counter("warmup_failure_total", "Module warmups failed")
WARMUP_SKIPPED = Counter("warmup_skipped_total", "Module warmups skipped")

# -- Errors (metrics.rs:144-166) ---------------------------------------------
WS_CLOSE_ERRORS = Counter("ws_close", "WS closes by code", ["code", "reason"])
CONNECTION_ERRORS = Counter("connection_error", "Connection level errors",
                            ["error_type", "module"])
AUTH_ERRORS = Counter("auth_error", "Auth failures by type", ["error_type"])

# -- System / device memory (metrics.rs:125-132, the NVML VRAM gauges) -------
DEVICE_MEM_FREE = Gauge("system_free_vram_bytes", "Accelerator memory free")
DEVICE_MEM_USED = Gauge("system_used_vram_bytes", "Accelerator memory in use")
DEVICE_MEM_TOTAL = Gauge("system_total_vram_bytes", "Accelerator memory total")
DEVICE_UTILIZATION = Gauge("system_gpu_utilization_percent", "Accelerator duty-cycle estimate")

# -- Memory (metrics.rs:369-397) ---------------------------------------------
MEMORY_TENSOR_ALLOCATIONS = Counter("memory_tensor_allocations", "Total tensor allocations")
MEMORY_PEAK_VRAM = Gauge("memory_peak_vram_bytes", "Peak accelerator memory")
MEMORY_CURRENT_VRAM = Gauge("memory_current_vram_bytes", "Current accelerator memory")
MEMORY_BYTES_ALLOCATED = Counter("memory_gpu_bytes_allocated", "Cumulative bytes allocated")
MEMORY_BYTES_DEALLOCATED = Counter("memory_gpu_bytes_deallocated", "Cumulative bytes freed")

# -- Pipeline (metrics.rs:418-458) -------------------------------------------
PIPELINE_STALLS = Counter("pipeline_stalls", "Total pipeline stall events")
PIPELINE_OVERLAP_EFFICIENCY = _h(
    "pipeline_overlap_efficiency", "Mimi/LM overlap efficiency ratio",
    (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0))
PIPELINE_PREPROCESS_DURATION = _h(
    "pipeline_preprocess_duration_seconds", "Pre-processing stage duration (s)",
    (0.001, 0.002, 0.005, 0.010, 0.020, 0.030, 0.050))
PIPELINE_POSTPROCESS_DURATION = _h(
    "pipeline_postprocess_duration_seconds", "Post-processing stage duration (s)",
    (0.001, 0.002, 0.005, 0.010, 0.020, 0.030, 0.050))
PIPELINE_BATCH_DURATION = _h(
    "pipeline_batch_duration_seconds", "Full pipeline batch duration (s)",
    (0.010, 0.020, 0.030, 0.040, 0.050, 0.060, 0.080, 0.100, 0.150))
PIPELINE_CHANNEL_QUEUE_DEPTH = Gauge("pipeline_channel_queue_depth",
                                     "Inter-stage channel queue depth")


def record_ws_close(code, reason: str = "") -> None:
    """metrics.rs record_ws_close: labels (code, reason category)."""
    from . import protocol as proto

    try:
        reason = reason or proto.CloseCode(int(code)).name.lower()
    except (ValueError, AttributeError):
        reason = reason or "unknown"
    WS_CLOSE_ERRORS.labels(code=str(int(code)), reason=reason).inc()


def record_connection_error(error_type: str, module: str) -> None:
    """metrics.rs record_connection_error: error_type in (capacity, timeout,
    protocol, internal)."""
    CONNECTION_ERRORS.labels(error_type=error_type, module=module).inc()


def record_auth_error(error_type: str) -> None:
    AUTH_ERRORS.labels(error_type=error_type).inc()


def stream_metrics_enabled() -> bool:
    """Per-WS byte counters are opt-in, as in the reference server
    (``MOSHI_STREAM_METRICS``, metrics.rs:42-95)."""
    return os.environ.get("MOSHI_STREAM_METRICS", "") not in ("", "0", "false")


def _stream_counters(module: str) -> Dict[str, Counter]:
    return {
        "in_bytes": Counter(f"{module}_ws_in_bytes", f"Total {module} websocket bytes in"),
        "in_messages": Counter(f"{module}_ws_in_messages",
                               f"Total {module} websocket messages in"),
        "out_bytes": Counter(f"{module}_ws_out_bytes", f"Total {module} websocket bytes out"),
        "out_messages": Counter(f"{module}_ws_out_messages",
                                f"Total {module} websocket messages out"),
    }


# asr_ws_in_bytes_total, ... (metrics.rs:59-92).
_STREAM = {m: _stream_counters(m) for m in ("asr", "lm", "tts")}


def stream_in(module: str, nbytes: int) -> None:
    c = _STREAM.get(module)
    if c is not None:
        c["in_messages"].inc()
        c["in_bytes"].inc(nbytes)


def stream_out(module: str, nbytes: int) -> None:
    c = _STREAM.get(module)
    if c is not None:
        c["out_messages"].inc()
        c["out_bytes"].inc(nbytes)


def collect() -> List[Family]:
    return REGISTRY.collect()


def render() -> bytes:
    """The text exposition (format 0.0.4) of every family."""
    lines = []
    for fam in REGISTRY.collect():
        name = fam.name + "_total" if fam.type == "counter" else fam.name
        doc = fam.documentation.replace("\\", r"\\").replace("\n", r"\n")
        lines.append(f"# HELP {name} {doc}")
        lines.append(f"# TYPE {name} {fam.type}")
        for s in fam.samples:
            labels = ",".join(f'{k}="{_escape_label(v)}"' for k, v in s.labels.items())
            lines.append(f"{s.name}{{{labels}}} {format_float(s.value)}" if labels
                         else f"{s.name} {format_float(s.value)}")
    return ("\n".join(lines) + "\n").encode()


def rendered_families() -> set:
    """Family names as the exposition writes them (a counter's with
    ``_total``)."""
    return {f.name + "_total" if f.type == "counter" else f.name for f in REGISTRY.collect()}


def update_device_memory(device) -> None:
    """The VRAM gauges for a CUDA ``device`` (the reference's background NVML
    read, main.rs:1311-1326): free and total from ``torch.cuda.mem_get_info``,
    used their difference; the allocator's current and peak bytes
    (``allocated_bytes.all.current`` / ``.peak``) into the memory gauges, the
    peak never lowered.  Another device leaves every gauge as it is."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return
    free, total = torch.cuda.mem_get_info(device)
    DEVICE_MEM_FREE.set(free)
    DEVICE_MEM_TOTAL.set(total)
    DEVICE_MEM_USED.set(total - free)
    stats = torch.cuda.memory_stats(device)
    cur = stats.get("allocated_bytes.all.current")
    peak = stats.get("allocated_bytes.all.peak")
    if cur is not None:
        MEMORY_CURRENT_VRAM.set(cur)
    if peak is not None:
        MEMORY_PEAK_VRAM.set(max(peak, MEMORY_PEAK_VRAM.get()))
