"""The port's single-stream generator (``sessions/lm_gen_simple.py``), its
``cli gen`` and the timing and tracing utilities, against the JAX package,
on the CPU.

* ``generate`` at both Moshi layouts (``moshi_v0_1``: 8 codebooks in, 8
  slices; ``moshi_v0_1_streaming()``: 16 and 16, ``gen``'s default), cut to
  narrow widths with their codebook counts, delays and norms, bf16 rings,
  forced text with ``ZERO`` inputs: the text tokens and frames equal JAX's,
  at ``chunk`` 1 and 5.
* ``step`` with forced and absent (``ZERO``) audio inputs against the
  jitted JAX step, past the end of the token buffers: tokens, frames and
  buffers equal.
* ``cli gen --device cpu``: the JSON line, the tokens file read back, and
  ``--trace``'s Chrome trace parsed.
* ``utils/bench.py`` (the recorder's reservoir and percentiles equal the
  JAX recorder's) and ``utils/tracing.py`` (spans recorded, a trace written).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.models import lm as jLM
from dsm_tpu.sessions import lm_gen_simple as jG
from dsm_tpu.utils import bench as jB
from dsm_tpu_torch import cli as tcli
from dsm_tpu_torch.models import lm as tLM
from dsm_tpu_torch.ops import sampling as tS
from dsm_tpu_torch.sessions import lm_gen_simple as tG
from dsm_tpu_torch.utils import bench as tB
from dsm_tpu_torch.utils import tracing as tTR
from dsm_tpu_torch.utils.checkpoint import load_safetensors
from tests.test_torch_moshi import np_lm_params
from tests.test_torch_ops import to_port
from tests.test_torch_tts import _fields, port_lm_cfg

torch.set_num_threads(2)


def _cut(lm):
    t = dataclasses.replace(lm.transformer, d_model=32, num_heads=4, num_layers=2,
                            dim_feedforward=64, context=24)
    d = lm.depformer
    dt = dataclasses.replace(d.transformer, d_model=16, num_heads=2, num_layers=2,
                             dim_feedforward=32)
    return dataclasses.replace(lm, transformer=t, depformer=dataclasses.replace(d, transformer=dt),
                               text_in_vocab_size=41, text_out_vocab_size=40, audio_vocab_size=33)


def _cfgs(preset, max_steps=28, **over):
    """``cli gen``'s GenConfig of the cut preset, on both sides."""
    lm = _cut(getattr(jLM, preset)())
    n = lm.generated_codebooks
    jcfg = jG.GenConfig(lm=lm, audio_delays=tuple([0] + [2] * (n - 1)),
                        text_start_token=lm.text_start_token, max_steps=max_steps, **over)
    return jcfg, _fields(tG.GenConfig, jcfg, lm=port_lm_cfg(lm))


@pytest.mark.parametrize("preset,books", [("moshi_v0_1", 8), ("moshi_v0_1_streaming", 16)])
def test_generate_matches_jax_at_any_chunk(preset, books):
    jcfg, tcfg = _cfgs(preset)
    assert tcfg.lm == _cut(getattr(tLM, preset)())
    assert (tcfg.lm.audio_codebooks, len(tcfg.audio_delays)) == (books, books)
    params = {"lm": np_lm_params(jcfg.lm, 0)}
    pt = to_port(params)
    forced = [5, jG.ZERO, jG.FREE, 7, jG.ZERO, 3, jG.FREE, jG.FREE, 9]
    tj, fj = jG.generate(jcfg, params, 20, seed=3, forced_text=forced, chunk=20)
    assert fj.shape == (18, books) and tj[:1] == [5] and tj[3] == 7
    for chunk in (1, 5):
        tt, ft = tG.generate(tcfg, pt, 20, seed=3, forced_text=forced, chunk=chunk)
        assert tt == tj
        np.testing.assert_array_equal(ft, fj)
        assert ft.dtype == np.int32


def test_step_with_forced_and_absent_audio_past_the_buffers_end():
    """A 2-step buffer tail (max_steps 6, delay 2): 10 steps run past it."""
    jcfg, tcfg = _cfgs("moshi_v0_1", max_steps=6, text_temperature=0.0)
    params = {"lm": np_lm_params(jcfg.lm, 1)}
    pt = to_port(params)
    sj = jG.init_state(jcfg, cache_dtype=jnp.float32)
    st = tG.init_state(tcfg, cache_dtype=torch.float32)
    jstep = jax.jit(functools.partial(jG.step, jcfg))
    rng = np.random.default_rng(2)
    k = len(jcfg.audio_delays)
    for i in range(10):
        fa = np.where(rng.uniform(size=k) < 0.3, rng.integers(0, 32, k), jG.FREE)
        fa = np.where(rng.uniform(size=k) < 0.2, jG.ZERO, fa).astype(np.int32)
        ft = np.int32([jG.FREE, jG.ZERO, 11][i % 3])
        oj, sj = jstep(params, sj, jax.random.PRNGKey(50 + i), jnp.asarray(ft), jnp.asarray(fa))
        ot, st = tG.step(tcfg, pt, st, tS.prng_key(50 + i), torch.tensor(ft),
                         torch.from_numpy(fa))
        for key in ("text_token", "frame", "frame_valid"):
            np.testing.assert_array_equal(ot[key].numpy(), np.asarray(oj[key]),
                                          err_msg=f"step {i} {key}")
    for key in ("audio_tokens", "text_tokens", "prev_text", "step_idx"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(sj[key]), err_msg=key)
    assert int(st["step_idx"]) == 10 > st["audio_tokens"].shape[1]


def test_cli_gen_on_the_cpu(tmp_path, monkeypatch, capsys):
    full = tLM.moshi_v0_1_streaming
    monkeypatch.setattr(tLM, "moshi_v0_1_streaming", lambda n=16: _cut(full(n)))
    out = tmp_path / "tok.safetensors"
    rc = tcli.main(["gen", "--steps", "6", "--seed", "4", "--device", "cpu", "--out-tokens",
                    str(out), "--trace", str(tmp_path / "trace")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and set(line) == {"text_tokens", "audio_frames", "codebooks"}
    assert len(line["text_tokens"]) == 6 and line["audio_frames"] == 4 and line["codebooks"] == 16
    f = load_safetensors(str(out))
    assert f.get("text_tokens").tolist() == line["text_tokens"]
    assert tuple(f.get("audio_tokens").shape) == (4, 16)
    with open(tmp_path / "trace" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_latency_recorder_matches_jax():
    rng = np.random.default_rng(0)
    xs = rng.exponential(0.01, 6000)
    rj, rt = jB.LatencyRecorder("x"), tB.LatencyRecorder("x")
    for x in xs:
        rj.record(float(x))
        rt.record(float(x))
    assert rt.summary() == rj.summary()
    rt.reset()
    assert rt.summary()["count"] == 0 and rt.percentile(50) == 0.0


def test_scoped_timer_device_timed_and_spans(tmp_path):
    with tB.scoped_timer("test-port-scope") as rec:
        pass
    assert rec is tB.recorder("test-port-scope") and rec.count == 1
    out, dt = tB.device_timed(lambda a: a * 2, torch.ones(3), name="test-port-timed")
    assert out.tolist() == [2.0, 2.0, 2.0] and dt >= 0.0
    assert tB.recorder("test-port-timed").count == 1
    assert {"test-port-scope", "test-port-timed"} <= {s["name"] for s in tB.all_summaries()}

    @tTR.annotate_fn("test-port-fn")
    def f(x):
        return x + 1

    with tTR.device_trace(str(tmp_path)) as path:
        with tTR.span("test-port-span"):
            f(torch.zeros(2))
    assert tB.recorder("test-port-span").count == 1 and tB.recorder("test-port-fn").count == 1
    with open(path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"test-port-span", "test-port-fn"} <= names
