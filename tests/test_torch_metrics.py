"""The port's prometheus metrics (``dsm_tpu_torch/server/metrics.py``) against
the JAX module's registry.

Bars: the same family set (``REFERENCE_FAMILIES`` and the rendered names);
each family's type, help string, label names and histogram buckets equal to
the JAX registry's; the same calls move both registries' samples by the same
amounts (deltas: both registries live for the whole process; the Python
client's ``_created`` samples are skipped); the module imports with
``prometheus_client``, ``aiohttp``, ``numpy`` and ``torch`` blocked; small
ASR, TTS (single tick and fused), duplex and single-session TTS engines,
tick-driven on the CPU, move the step, frame, warm-up and session counters by
the JAX engines' amounts on the same traffic, and the decoded-frame counter
by the audio frames their sessions receive.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from dsm_tpu.server import metrics as J
from dsm_tpu_torch.server import metrics as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def _jax_samples():
    out = {}
    for m in J.REGISTRY.collect():
        for s in m.samples:
            if not s.name.endswith("_created"):
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def _port_samples():
    return {(s.name, tuple(sorted(s.labels.items()))): s.value
            for f in P.collect() for s in f.samples}


def _deltas(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def test_family_set_equals_the_jax_registry():
    assert P.REFERENCE_FAMILIES == J.REFERENCE_FAMILIES
    assert P.rendered_families() == J.rendered_families()
    assert set(P.REFERENCE_FAMILIES) <= P.rendered_families()
    assert len(P.collect()) == len(list(J.REGISTRY.collect())) == 56


def test_each_family_matches_the_jax_registry():
    """Type, help, label names and buckets (``le`` as the client writes it)."""
    jax_fams = {m.name: m for m in J.REGISTRY.collect()}
    jax_labels = {c._name: tuple(c._labelnames) for c in J.REGISTRY._collector_to_names}
    for fam in P.collect():
        jm = jax_fams[fam.name]
        assert (fam.type, fam.documentation) == (jm.type, jm.documentation), fam.name
        metric = P.REGISTRY._metrics[fam.name]
        assert metric.labelnames == jax_labels[fam.name], fam.name
        if fam.type == "histogram" and not metric.labelnames:
            want = [s.labels["le"] for s in jm.samples if s.name.endswith("_bucket")]
            got = [s.labels["le"] for s in fam.samples if s.name.endswith("_bucket")]
            assert got == want and want[-1] == "+Inf", fam.name


def _calls(m):
    """One sequence of calls on either module (every value exact in f32 and
    f64, so that the deltas are exact on both sides)."""
    m.record_ws_close(4000)
    m.record_ws_close(1000, "going")
    m.record_ws_close(4999)  # no such close code: reason "unknown"
    m.record_connection_error("internal", "asr")
    m.record_connection_error("capacity", "tts")
    m.record_auth_error("invalid_token")
    m.stream_in("asr", 96)
    m.stream_out("lm", 1921)
    m.stream_out("tts", 8)
    m.stream_in("nobody", 5)
    m.LM_STEPS_TOTAL.inc()
    m.LM_STEPS_TOTAL.inc(4)
    m.MIMI_FRAMES_DECODED.inc(7)
    m.TTS_AUDIO_DURATION.inc(0.25)
    m.WARMUP_SUCCESS.inc()
    for v in (0.0, 0.02, 0.0234375, 0.08, 0.5, 1e9):  # on, between and past the bounds
        m.ASR_MODEL_STEP_DURATION.observe(v)
        m.LM_BATCH_UTILIZATION.observe(v)
    m.ASR_STEPS_PER_CONNECTION.observe(2.0)
    m.LM_QUEUE_DEPTH.set(3)
    m.LM_QUEUE_DEPTH.inc(2)
    m.LM_ACTIVE_CONNECTIONS.inc()
    m.LM_ACTIVE_CONNECTIONS.dec()
    m.ASR_CONNECT.inc()


def _same_calls_check():
    """The next test's body, run where no engine has moved either registry."""
    assert P.stream_metrics_enabled() and J.stream_metrics_enabled()
    jb, pb = _jax_samples(), _port_samples()
    _calls(J)
    _calls(P)
    dj, dp = _deltas(jb, _jax_samples()), _deltas(pb, _port_samples())
    assert dp == dj
    assert dp[("ws_close_total", (("code", "4999"), ("reason", "unknown")))] == 1.0
    assert dp[("asr_model_step_duration_bucket", (("le", "0.02"),))] == 2.0  # 0.0 and 0.02
    assert dp[("lm_batch_utilization_bucket", (("le", "+Inf"),))] == 6.0


def test_the_same_calls_move_both_registries_alike():
    """In a fresh interpreter: engines that other test files drive in a shared
    process move one registry's gauges and duration sums and not the other's,
    and a float sum's delta rounds by what the sum held before."""
    code = textwrap.dedent("""
        import os
        os.environ["MOSHI_STREAM_METRICS"] = "1"
        from tests.test_torch_metrics import J, P, _same_calls_check
        _same_calls_check()
        os.environ["MOSHI_STREAM_METRICS"] = "0"
        assert not P.stream_metrics_enabled() and not J.stream_metrics_enabled()
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=False)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_render_is_the_text_exposition():
    text = P.render().decode()
    assert text.endswith("\n")
    helps = [ln.split()[2] for ln in text.splitlines() if ln.startswith("# HELP ")]
    types = {ln.split()[2]: ln.split()[3] for ln in text.splitlines() if ln.startswith("# TYPE ")}
    assert set(helps) == set(types) == P.rendered_families()
    assert types["lm_steps_total"] == "counter" and types["lm_batch_utilization"] == "histogram"
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        float(value)  # every value parses
    assert 'lm_batch_utilization_bucket{le="+Inf"}' in text
    assert P.format_float(1e7) == "1e+07" and P.format_float(0.02) == "0.02"
    assert P.format_float(2.0) == "2.0" and P.format_float(float("inf")) == "+Inf"
    with pytest.raises(ValueError):
        P.WS_CLOSE_ERRORS.inc()  # a labelled family needs its labels
    with pytest.raises(ValueError):
        P.LM_STEPS_TOTAL.inc(-1)


def test_metrics_import_with_only_the_standard_library():
    code = textwrap.dedent("""
        import sys
        for name in ("prometheus_client", "aiohttp", "msgpack", "numpy", "torch", "jax"):
            sys.modules[name] = None
        from dsm_tpu_torch.server import metrics
        metrics.LM_STEPS_TOTAL.inc()
        metrics.record_ws_close(4000)
        assert b"lm_steps_total 1.0" in metrics.render()
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=False)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_device_memory_leaves_the_gauges_on_the_cpu():
    before = _port_samples()
    P.update_device_memory("cpu")
    P.update_device_memory(torch.device("cpu"))
    assert _port_samples() == before


# -- the engines' counters against the JAX engines' ---------------------------

ENGINE_SAMPLES = ("lm_steps_total", "mimi_frames_encoded_total", "mimi_frames_decoded_total",
                  "warmup_success_total", "warmup_failure_total", "pipeline_stalls_total",
                  "asr_open_channels", "asr_connection_num_steps_count",
                  "asr_model_step_duration_count", "lm_batch_utilization_count",
                  "lm_step_duration_seconds_count", "tts_requests_total",
                  "tts_synthesis_duration_seconds_count", "tts_audio_duration_seconds_total")


def _engine_deltas(run):
    """Run ``run(side)`` for "jax" then "port" -> each side's deltas of
    ENGINE_SAMPLES and what ``run`` returned."""
    out = {}
    for side, samples in (("jax", _jax_samples), ("port", _port_samples)):
        before = samples()
        got = run(side)
        d = _deltas(before, samples())
        out[side] = ({k[0]: v for k, v in d.items() if k[0] in ENGINE_SAMPLES}, got)
    return out


def _audio_frames(events):
    return sum(type(e).__name__ in ("AudioEvent", "DuplexAudioEvent") for evs in events
               for e in evs)


def test_asr_engine_counters_match_the_jax_engine():
    from tests import test_torch_asr_pipeline as AP

    # Both gauges from no open channel, as in a fresh server: ASR engines that
    # other test files drive in a shared process leave channels open on one side.
    J.ASR_OPEN_CHANNELS.set(0)
    P.ASR_OPEN_CHANNELS.set(0)
    frame, ej, et = AP._engines(1, "f32")
    out = _engine_deltas(lambda side: AP._serve(ej if side == "jax" else et, frame))
    (dj, _), (dp, _) = out["jax"], out["port"]
    assert dp == dj
    assert dp["lm_steps_total"] == et.step_count > 0
    assert dp["mimi_frames_encoded_total"] > dp["lm_steps_total"]  # several slots a step
    assert dp["warmup_success_total"] == 1.0 and dp["asr_connection_num_steps_count"] == 1.0
    assert P.ASR_OPEN_CHANNELS.get() == et.used_slots() == 3


@pytest.mark.parametrize("fuse", [1, 4])
def test_tts_engine_counters_match_the_jax_engine(fuse):
    from tests import test_torch_tts_serving as TS

    kw = {"fuse_ticks": 4, "pipeline_depth": 2} if fuse > 1 else {}
    jcfg, params, ej, et = TS._engines(**kw)
    voices = [TS._voice(jcfg, params, 2), None, None]
    open_kw = [dict(seed=7, text_temperature=0.8, audio_temperature=0.9),
               dict(seed=8), dict(seed=9)]

    def run(side):
        if side == "jax":
            return TS._drive(ej, voices, lambda v: v, open_kw)
        return TS._drive(et, voices, lambda v: None if v is None else
                         tuple(torch.from_numpy(np.asarray(x)) for x in v), open_kw)

    out = _engine_deltas(run)
    (dj, ev_j), (dp, ev_t) = out["jax"], out["port"]
    assert dp == dj
    assert dp["lm_steps_total"] == et.step_count > 0
    assert dp["mimi_frames_decoded_total"] == _audio_frames(ev_t) == _audio_frames(ev_j) > 0


def test_duplex_engine_counters_match_the_jax_engine():
    from tests import test_torch_duplex_serving as DS

    ej, et, frame = DS._engines()
    out = _engine_deltas(lambda side: DS._scenario(ej if side == "jax" else et, frame)[0])
    (dj, ev_j), (dp, ev_t) = out["jax"], out["port"]
    assert dp == dj
    assert dp["lm_steps_total"] == et.step_count > 0 and dp["warmup_success_total"] == 1.0
    assert dp["mimi_frames_decoded_total"] == _audio_frames(ev_t) == _audio_frames(ev_j) > 0


def test_single_session_tts_counters_match_the_jax_session():
    from tests import test_torch_tts_single as TSS

    jcfg, params, ej, et = TSS._engines()
    text = "fab ked gic"
    out = _engine_deltas(lambda side: (ej.synthesize(text, seed=3) if side == "jax"
                                       else et.synthesize(text, seed=3))[0])
    (dj, pj), (dp, pt) = out["jax"], out["port"]
    seconds = {k: v.pop("tts_audio_duration_seconds_total") for k, v in (("jax", dj), ("port", dp))}
    assert dp == dj and dp["tts_requests_total"] == 1.0
    assert dp["tts_synthesis_duration_seconds_count"] == 1.0
    assert len(pt) == len(pj) > 0
    assert seconds["port"] == pytest.approx(len(pt) / 24_000.0, rel=1e-9)
    assert seconds["jax"] == pytest.approx(len(pj) / 24_000.0, rel=1e-9)
