"""The port's ``bench_perf.py`` and the engines' observers against the JAX
package.

* ``_late_tick_attribution`` equal to the JAX function's on seeded rows:
  late on the phases' sum, late on ``late_key``, none late, no rows;
* the ASR engine's ``step_observer`` and ``phase_observer``: the paired
  small engines of ``tests/test_torch_asr_pipeline.py`` at depth 1 and 2,
  the same frames pushed: as many calls as the JAX engine's, the same
  utilizations, the JAX keys; the TTS engine's ``tick_observer`` on the
  single and the fused path: the JAX arity at every tick, and on the fused
  path the same counts of voice writes and script ops a dispatch; the
  duplex engine's: the JAX arity and active slots at every tick;
* ``bench_server_sustained`` and ``bench_tts_sustained`` on injected small
  engines of two slots (about 1.5 s each), beside the JAX functions on the
  JAX engines: the JAX keys (no ``rtt_probe``: the JAX tunnel prober is not
  ported), every marker or Done, the events file's rows in order with the
  JAX rows' keys; ``bench_duplex_sustained`` on a small port engine;
* the component benches at small shapes on ``device="cpu"`` beside the JAX
  functions at the same small shapes (their models patched small for the
  test): the same keys, ``realtime_streams`` = batch x ``rtf`` as rounded;
* ``cli bench --device cpu`` prints one JSON line.

No bound here is on wall-clock time: the CPU's times say nothing of the card.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu import bench_perf as jBP
from dsm_tpu.server.batched_asr import BatchedAsrEngine as JaxAsrEngine
from dsm_tpu_torch import bench_perf as tBP
from dsm_tpu_torch.server import batched_asr as tBA
from tests.test_torch_asr_pipeline import _engines as asr_engines
from tests.test_torch_asr_pipeline import _serve as asr_serve
from tests.test_torch_asr_pipeline import _small_asr
from tests.test_torch_ops import to_port
from tests.test_torch_tts_fused import _open_kw, _to_port_voice
from tests.test_torch_tts_serving import _drive, _voice
from tests.test_torch_tts_serving import _engines as tts_engines

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PH = ("gather_ms", "dispatch_ms", "fetch_ms", "post_ms")


def _rows(seed, n, spread):
    """``n`` seeded rows of the four phases (ms), a step time and a tick
    time; ``spread`` scales the phases (large: some rows over 80 ms)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        r = {"t": float(i) * 0.08, **{k: float(rng.gamma(2.0, spread)) for k in PH}}
        r["step_ms"] = r["gather_ms"] + r["fetch_ms"] + float(rng.uniform(0, 30))
        rows.append(r)
    return rows


@pytest.mark.parametrize("case,late_key,spread", [
    ("late on the phases' sum", None, 12.0),
    ("late on late_key", "step_ms", 12.0),
    ("none late", None, 1.0),
    ("none late on late_key", "step_ms", 1.0),
    ("no rows", None, 0.0),
])
def test_late_tick_attribution_equals_the_jax_function(case, late_key, spread):
    rows = _rows(sum(map(ord, case)), 0 if case == "no rows" else 200, spread)
    got = tBP._late_tick_attribution(rows, PH, budget_ms=80.0, late_key=late_key)
    want = jBP._late_tick_attribution(rows, PH, budget_ms=80.0, late_key=late_key)
    assert got == want
    if case.startswith("late"):
        assert got["n_late"] > 0 and len(got["worst"]) == min(10, got["n_late"])
    elif case.startswith("none"):
        assert got["n_late"] == 0


# ---------------------------------------------------------------------------
# The engines' observers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2])
def test_asr_observers_fire_as_the_jax_engines(depth):
    """The same streams through both engines: one ``step_observer`` call and
    one ``phase_observer`` call a drained step, as many as the JAX engine
    makes, with its utilizations and its keys."""
    frame, ej, et = asr_engines(depth, "f32")
    seen = {}
    for name, eng in (("jax", ej), ("port", et)):
        steps, phases = [], []
        eng.step_observer = lambda dt, u, steps=steps: steps.append((dt, u))
        eng.phase_observer = phases.append
        asr_serve(eng, frame)
        seen[name] = steps, phases
    (sj, pj), (st, pt) = seen["jax"], seen["port"]
    assert len(st) == len(sj) == len(pt) == len(pj) > 40
    assert [u for _, u in st] == [u for _, u in sj]
    assert 0.0 < min(u for _, u in st) and max(u for _, u in st) <= 1.0
    keys = {"t0", "queue_ms", "fetch_ms", "post_ms", "util"}
    assert all(set(p) == set(q) == keys for p, q in zip(pt, pj))
    assert [p["util"] for p in pt] == [u for _, u in st]
    assert all(dt >= 0 and min(p["queue_ms"], p["fetch_ms"], p["post_ms"]) >= 0
               for (dt, _), p in zip(st, pt))
    assert all(a["t0"] <= b["t0"] for a, b in zip(pt, pt[1:]))


@pytest.mark.parametrize("fuse,depth", [(1, 1), (2, 2), (4, 1)])
def test_tts_tick_observer_has_the_jax_arity(fuse, depth):
    """Three sessions on two slots (one with no voice, two with one): the
    port's ``tick_observer`` is called at every tick the JAX engine's is,
    with the four phase durations on the single path and the four and the
    gather's six details on the fused path, whose counts of voice writes and
    script ops each dispatch are the JAX engine's."""
    kw = {} if fuse == 1 else dict(fuse_ticks=fuse, pipeline_depth=depth)
    jcfg, params, ej, et = tts_engines(**kw)
    voices = [_voice(jcfg, params, 2), None, _voice(jcfg, params, 3)]
    calls = {}
    for name, eng, to_voice in (("jax", ej, lambda v: v), ("port", et, _to_port_voice)):
        seen = []
        eng.tick_observer = lambda *p, seen=seen: seen.append(p)
        _drive(eng, voices, to_voice, _open_kw(False))
        calls[name] = seen
    j, t = calls["jax"], calls["port"]
    arity = 4 if fuse == 1 else 10
    assert len(t) == len(j) > 3
    assert [len(p) for p in t] == [len(p) for p in j] == [arity] * len(j)
    assert all(isinstance(x, float) and x >= 0 for p in t for x in p[:min(arity, 8)])
    if fuse > 1:
        assert [p[8:] for p in t] == [tuple(int(x) for x in p[8:]) for p in j]
        # a voice write a session opened (one without a voice clears its rows)
        assert sum(p[8] for p in t) == 3 and sum(p[9] for p in t) > 3


def test_duplex_tick_observer_has_the_jax_arity():
    """The duplex engines' hook, which the port had before the bench: the
    same scenario through both, ``(dt, n_active, (gather, dispatch, fetch,
    post))`` at every posted tick, the same count and the same active
    slots."""
    from tests.test_torch_duplex_serving import _engines as duplex_engines
    from tests.test_torch_duplex_serving import _scenario

    ej, et, frame = duplex_engines()
    calls = {}
    for name, eng in (("jax", ej), ("port", et)):
        seen = []
        eng.tick_observer = lambda dt, n, ph, seen=seen: seen.append((dt, n, ph))
        _scenario(eng, frame)
        calls[name] = seen
    j, t = calls["jax"], calls["port"]
    assert len(t) == len(j) > 10
    assert [n for _, n, _ in t] == [n for _, n, _ in j]
    assert all(dt > 0 and len(ph) == 4 and min(ph) >= 0 for dt, _, ph in t)


# ---------------------------------------------------------------------------
# The sustained benches on injected small engines
# ---------------------------------------------------------------------------


def _asr_pair(batch=2):
    jcfg, tcfg, params = _small_asr()
    ej = JaxAsrEngine(jcfg, params, batch_size=batch, use_native_packer=False,
                      pipeline_depth=2)
    et = tBA.BatchedAsrEngine(tcfg, to_port(params), batch_size=batch, device="cpu",
                              pipeline_depth=2)
    return jcfg, ej, et


def _keys(tree):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in tree.items()}


def test_server_sustained_on_a_small_engine_returns_the_jax_keys(tmp_path):
    jcfg, ej, et = _asr_pair()
    want = jBP.bench_server_sustained(2, 1.5, events_out=str(tmp_path / "j.json"),
                                      engine=ej, cfg=jcfg)
    got = tBP.bench_server_sustained(2, 1.5, events_out=str(tmp_path / "t.json"), engine=et)
    want.pop("rtt_probe", None)
    # Its keys depend on whether a step ran over 80 ms: the same function's
    # output (see the attribution test above).
    lta = [res.pop("late_step_attribution") for res in (got, want)]
    assert _keys(got) == _keys(want)
    assert "n_late" in lta[0] and "n_late" in lta[1]
    assert got["markers_completed"] == 2 and got["engine_steps"] > 0
    assert got["slot_steps_min"] > 0 and got["batch"] == got["sessions"] == 2
    assert got["delivery"]["frames"] > 0 and got["delivery"]["lag_def"] == "v2"
    rows = json.loads((tmp_path / "t.json").read_text())
    rows_j = json.loads((tmp_path / "j.json").read_text())
    assert len(rows) == got["engine_steps"]
    assert all(a["t"] <= b["t"] for a, b in zip(rows, rows[1:]))
    assert all({"t", "step_ms", "util", "queue_ms", "fetch_ms", "post_ms"} <= set(r)
               for r in rows)
    assert set().union(*rows) == set().union(*rows_j)
    assert not et.step_observer and not et.phase_observer and et.used_slots() == 0


def test_tts_sustained_on_a_small_engine_returns_the_jax_keys(tmp_path):
    _, _, ej, et = tts_engines(batch=2, fuse_ticks=2, pipeline_depth=2)
    want = jBP.bench_tts_sustained(2, 1.5, engine=ej, n_words=4, drain_s=60.0,
                                   events_out=str(tmp_path / "j.json"))
    got = tBP.bench_tts_sustained(2, 1.5, engine=et, n_words=4, drain_s=60.0,
                                  events_out=str(tmp_path / "t.json"))
    want.pop("rtt_probe", None)
    lta = [res.pop("late_tick_attribution") for res in (got, want)]
    assert _keys(got) == _keys(want)
    assert "n_late" in lta[0] and "n_late" in lta[1]
    assert got["sessions_completed"] == got["sessions_launched"] == 2
    assert want["sessions_completed"] == 2 and got["fuse_ticks"] == 2
    assert got["audio_s_total"] > 0 and got["tick_ms_p50"] > 0
    rows = json.loads((tmp_path / "t.json").read_text())
    rows_j = json.loads((tmp_path / "j.json").read_text())
    assert rows and all(a["t"] <= b["t"] for a, b in zip(rows, rows[1:]))
    assert [set(r) for r in rows] == [set(rows_j[0])] * len(rows)
    assert et.tick_observer is None and et.used_slots() == 0


def test_duplex_sustained_on_a_small_engine():
    """The JAX function builds s2s-2b itself (no ``engine=``): the port's on
    a small engine returns the JAX keys, every dialogue hears audio."""
    engine = tBP._duplex_engine(2, torch.device("cpu"), 2, None, small=True)
    got = tBP.bench_duplex_sustained(2, 1.0, engine=engine, drain_s=30.0)
    assert set(got) == {
        "batch", "seconds", "model", "frames_sent_per_session", "step_ms_p50", "step_ms_p95",
        "step_ms_p99", "audio_s_per_session_p50", "realtime_sessions_frac", "realtime_ok",
        "aggregate_duplex_streams", "tick_phase_ms_p50", "tick_phase_ms_p95",
        "late_tick_attribution", "n_events", "pipeline_depth"}
    assert got["frames_sent_per_session"] == 12 and got["pipeline_depth"] == 2
    assert got["audio_s_per_session_p50"] > 0 and len(got["tick_phase_ms_p50"]) == 4
    assert engine.tick_observer is None and engine.used_slots() == 0


# ---------------------------------------------------------------------------
# The component benches at small shapes
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_small(monkeypatch):
    """The JAX benches at the small shapes of ``__graft_entry__._asr_setup``:
    its presets patched small for the test (the JAX package is not edited);
    the TTS model the port's small one, its voice source 2048 wide as the
    JAX bench draws it."""
    import dataclasses

    import __graft_entry__ as ge
    from dsm_tpu.models import lm as jLM
    from dsm_tpu.models import mimi as jMIMI
    from tests.test_tts import small_tts_cfg

    cfg, *_ = ge._asr_setup(2, jnp.float32, jnp.float32, small=True)
    setup = jBP._setup
    tts_lm = small_tts_cfg().lm
    tts_lm = dataclasses.replace(tts_lm, transformer=dataclasses.replace(
        tts_lm.transformer, ca_dim=2048))
    monkeypatch.setattr(jBP, "_setup", lambda batch, **kw: setup(batch, small=True))
    monkeypatch.setattr(jLM, "stt_1b_en_fr", lambda: cfg.lm)
    monkeypatch.setattr(jLM, "tts_1_6b_en_fr", lambda: tts_lm, raising=False)
    monkeypatch.setattr(jMIMI, "v0_1", lambda n_q=None: cfg.mimi)


def _realtime_as_rounded(res, batch, rtf_key, streams_key):
    # realtime_streams = round(batch * rtf, 1) of the unrounded rtf
    assert abs(res[streams_key] - batch * res[rtf_key]) <= batch * 0.005 + 0.05 + 1e-9


def test_component_benches_return_the_jax_keys(jax_small):
    cpu = {"device": "cpu", "small": True}
    pairs = {
        "mimi": (jBP.bench_mimi(2, 2), tBP.bench_mimi(2, 2, **cpu)),
        "lm": (jBP.bench_lm(2, 2), tBP.bench_lm(2, 2, **cpu)),
        "e2e": (jBP.bench_e2e(2, 2), tBP.bench_e2e(2, 2, **cpu)),
        "e2e serving": (jBP.bench_e2e(2, 2, serving=True),
                        tBP.bench_e2e(2, 2, serving=True, **cpu)),
        "tts": (jBP.bench_tts(2, 2), tBP.bench_tts(2, 2, **cpu)),
        "memory": (jBP.bench_memory(), tBP.bench_memory("cpu")),
    }
    for name, (want, got) in pairs.items():
        assert set(got) == set(want), name
    e2e = pairs["e2e"][1]
    assert e2e["batch"] == 2 and e2e["e2e_step_ms"] > 0 and e2e["profile"] == "bf16"
    assert pairs["e2e serving"][1]["profile"] == "serving"
    _realtime_as_rounded(e2e, 2, "rtf", "realtime_streams")
    _realtime_as_rounded(pairs["tts"][1], 2, "rtf_per_session", "realtime_tts_streams")
    assert pairs["lm"][1]["fused_steps"] == 2 and pairs["mimi"][1]["mimi_encode_p50_ms"] > 0
    assert pairs["memory"][1] == dict.fromkeys(pairs["memory"][1])  # no statistics on the CPU


def test_sustained_bench_paces_the_asr_step_on_the_cpu(tmp_path):
    got = tBP.bench_sustained(2, 0.5, events_out=str(tmp_path / "e.json"), device="cpu",
                              small=True)
    events = json.loads((tmp_path / "e.json").read_text())
    assert got["frames"] == len(events) > 0 and got["batch"] == 2
    assert all(e["InputPcm"] <= e["Step"] <= e["StepPostSampling"] for e in events)


def test_cli_bench_on_the_cpu_prints_one_json_line():
    res = subprocess.run(
        [sys.executable, "-m", "dsm_tpu_torch.cli", "bench", "--device", "cpu", "--mimi",
         "--lm", "--e2e", "--memory", "--batch", "2", "--steps", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=False,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"mimi", "lm", "e2e", "memory"}
    assert out["e2e"]["model"] == "small" and out["memory"]["bytes_in_use"] is None
