"""The port's ASR engine with dispatch-ahead and the int16 upload wire,
against the JAX package.

Inputs are made with numpy or the JAX init from a seed; weights are carried
over by the bridge; the JAX side runs jitted, as its engine runs it.  Bars:

* the int16 wire's dequantisation (``batched_asr.wire_in``) bit for bit the
  jitted JAX ``_wire_in`` over all 65,536 int16 values, and the host's
  quantisation (``wire_out``) equal to the JAX engine's expression;
* the packing: ``prs`` in 1e-6 fixed point, truncated toward zero as the
  JAX step's ``astype(int32)``;
* a small engine with semantic-VAD heads (4 heads x 6, as stt-1b has) at
  ``pipeline_depth`` 0, 1 and 2 on both wires against the JAX engine at the
  same settings, a reused slot, markers, past a wrap of the 64-row LM ring:
  every event equal, and every VAD probability on the JAX engine's 1e-6
  grid (the f32 value of ``k * 1e-6``, as its host unpacks it), with the
  same ``k`` but where the raw probabilities round apart (the hidden state's
  ``rsqrt``, Eigen's order of the head's dot and XLA's ``exp``, ROADMAP
  queue 3), there one step off at most;
* with the VAD head's weights zero the raw probabilities are exactly 1/6 on
  both sides, and the delivered ones bit for bit the JAX engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.models import lm as jLM
from dsm_tpu.models import mimi as jMIMI
from dsm_tpu.ops import transformer as jT
from dsm_tpu.server.batched_asr import BatchedAsrEngine as JaxEngine
from dsm_tpu.sessions import asr as jASR
from dsm_tpu_torch.server import batched_asr as tBA
from dsm_tpu_torch.sessions import asr as tASR
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_ops import to_port
from tests.test_torch_stt26 import _pcm
from tests.test_torch_tts import _fields, port_lm_cfg, port_mimi_cfg

torch.set_num_threads(2)


def test_int16_wire_dequantisation_is_the_jitted_jax_one_bit_for_bit():
    every = np.arange(-32768, 32768, dtype=np.int64).astype(np.int16)
    want = np.asarray(jax.jit(lambda p: p.astype(jnp.float32) * (1.0 / 32767.0))(every))
    got = tBA.wire_in(torch.from_numpy(every)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    pcm = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 0.7
    pcm[:4] = [1.5, -1.5, 1.0, -1.0]
    np.testing.assert_array_equal(tBA.wire_out(pcm),
                                  (np.clip(pcm, -1.0, 1.0) * 32767.0).astype(np.int16))


def test_pack_outputs_truncates_prs_as_the_jax_step():
    prs = np.array([[0.0, 1e-7, 0.9999999, 0.5], [1.0, 0.1234567, 3e-6, 0.25]], np.float32)
    out = {"text_token": torch.tensor([3, 4]), "step_idx": torch.tensor([7, 8], dtype=torch.int32),
           "prs": torch.from_numpy(prs)}
    want = (jnp.asarray(prs).astype(jnp.float32) * 1e6).astype(jnp.int32).reshape(-1)
    got = tBA.pack_outputs(out).numpy()
    np.testing.assert_array_equal(got, np.concatenate([[3, 4, 7, 8], np.asarray(want)]))
    none = tBA.pack_outputs(dict(out, prs=torch.zeros((2, 0))))
    assert none.tolist() == [3, 4, 7, 8]


def _small_asr():
    """2 LM layers (2 heads x 64 over 64 f32 rows), the small codec, 4
    semantic-VAD heads of 6 probabilities."""
    tcfg = jT.TransformerConfig(d_model=128, num_heads=2, num_layers=2,
                                dim_feedforward=256, context=40)
    lm = jLM.LmConfig(transformer=tcfg, text_in_vocab_size=17, text_out_vocab_size=16,
                      audio_vocab_size=33, audio_codebooks=4, extra_heads=(4, 6),
                      depformer=None)
    mimi_cfg = small_mimi_cfg()
    jcfg = jASR.AsrConfig(lm=lm, mimi=mimi_cfg, asr_delay_in_tokens=3, temperature=0.7)
    key = jax.random.PRNGKey(0)
    params = {"lm": jLM.init(lm, key), "mimi": jMIMI.init(mimi_cfg, jax.random.fold_in(key, 1))}
    tcfg = _fields(tASR.AsrConfig, jcfg, lm=port_lm_cfg(lm), mimi=port_mimi_cfg(mimi_cfg))
    return jcfg, tcfg, params


def _serve(eng, frame):
    """Three streams with markers; one slot then reused by a fourth; long
    enough to pass the LM ring's 64 rows -> per stream, its events and its
    VAD probabilities ``(n_events, 4)``."""
    log = {i: [] for i in range(4)}
    eng.warmup()
    chans = {}
    for i in range(3):
        chans[i] = eng.open_channel(log[i].append, seed=10 + i)
        chans[i].push_pcm(_pcm(i, 30 + 4 * i, frame) * (4.0 if i == 1 else 1.0))
        eng.add_marker(chans[i], 100 + i)
        chans[i].push_pcm(np.zeros(frame * 4, np.float32))
    for _ in range(44):
        eng.tick()
    eng.flush()
    eng.close_channel(chans[0])
    chans[3] = eng.open_channel(log[3].append, seed=20)
    chans[3].push_pcm(_pcm(9, 20, frame))
    eng.add_marker(chans[3], 103)
    chans[3].push_pcm(np.zeros(frame * 4, np.float32))
    for _ in range(26):
        eng.tick()
    eng.stop()  # tick()-driven: delivers every step in flight
    events = {i: [(e.step_idx, [(type(w).__name__, getattr(w, "tokens", None),
                                 getattr(w, "start_time", None), getattr(w, "stop_time", None))
                                for w in e.words], list(e.markers)) for e in evs]
              for i, evs in log.items()}
    prs = {i: np.stack([e.prs for e in evs]) for i, evs in log.items()}
    return events, prs


def _engines(depth, wire, zero_vad=False):
    jcfg, tcfg, params = _small_asr()
    if zero_vad:
        params["lm"]["extra_heads"] = jnp.zeros_like(params["lm"]["extra_heads"])
    i16 = wire == "int16"
    ej = JaxEngine(jcfg, params, batch_size=3, fill_gate_frac=0.0, use_native_packer=False,
                   pipeline_depth=depth, pcm_wire_int16=i16)
    et = tBA.BatchedAsrEngine(tcfg, to_port(params), batch_size=3, device="cpu",
                              fill_gate_frac=0.0, pipeline_depth=depth, pcm_wire_int16=i16)
    assert et.pipeline_depth == depth and et._pcm_wire_int16 == i16
    return jcfg.mimi.frame_size, ej, et


def _grid(prs):
    """VAD probabilities -> their 1e-6 steps ``k``, checked to be the f32
    values ``float32(k) * float32(1e-6)`` that the JAX engine unpacks."""
    k = np.rint(prs.astype(np.float64) * 1e6).astype(np.int64)
    assert prs.dtype == np.float32
    np.testing.assert_array_equal(k.astype(np.float32) * np.float32(1e-6), prs)
    return k


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("wire", ["f32", "int16"])
def test_engine_matches_the_jax_engine_at_each_depth_and_wire(depth, wire):
    """Events, markers and words equal to the JAX engine's at the same
    depth and wire (the int16 wire's loud stream clips); the VAD
    probabilities on its grid, the same step but where the raw values round
    apart."""
    frame, ej, et = _engines(depth, wire)
    (got, got_prs), (want, want_prs) = _serve(et, frame), _serve(ej, frame)
    assert got == want
    assert sorted(m for evs in got.values() for e in evs for m in e[2]) == [100, 101, 102, 103]
    assert any(e[1] for evs in got.values() for e in evs), "no word came out"
    k_t = np.concatenate([_grid(got_prs[i]) for i in got_prs])
    k_j = np.concatenate([_grid(want_prs[i]) for i in want_prs])
    assert k_t.shape == k_j.shape and k_t.shape[1] == 4
    assert np.abs(k_t - k_j).max() <= 1 and (k_t == k_j).mean() > 0.9
    assert int(et.state["lm"]["t"]["pos"]) > 64
    assert not et._pending and et._inflight == 0


@pytest.mark.parametrize("depth", [0, 2])
def test_uniform_vad_heads_give_the_jax_engines_prs_bit_for_bit(depth):
    """Zero VAD weights: the raw probabilities are exactly 1/6 on both
    sides, so the delivered ones are the JAX engine's bit for bit (the f32
    of 166666e-6, not 1/6: what the JAX engine's fixed point delivers)."""
    frame, ej, et = _engines(depth, "int16", zero_vad=True)
    (got, got_prs), (want, want_prs) = _serve(et, frame), _serve(ej, frame)
    assert got == want
    for i in want_prs:
        assert got_prs[i].dtype == want_prs[i].dtype == np.float32
        np.testing.assert_array_equal(got_prs[i].view(np.int32), want_prs[i].view(np.int32))
    assert float(want_prs[0][0, 0]) == float(np.float32(166666) * np.float32(1e-6))


# The serving TOMLs as shipped, cut only where the CPU forces it: each cut
# named here, every other key (the [model] widths included) the TOML's.
SERVING_CUTS = {
    "configs/config-stt-tpu-serving.toml": ("asr", {"batch_size": (192, 2)},
                                            {"num_layers": (16, 1)}),
    "configs/config-tts-tpu-serving.toml": ("tts", {"batch_size": (64, 2)},
                                            {"num_layers": (16, 1)}),
}
# And the TTS DepFormer's depth: its 32 slices x 4 layers at d=1024 are some
# 1.7 B f32 weights on the CPU.
DEPFORMER_CUTS = {"num_layers": (4, 1)}


@pytest.mark.parametrize("path", sorted(SERVING_CUTS))
def test_builder_builds_the_serving_tomls_as_shipped(path):
    """Both serving presets build on the CPU with their own options
    (``pipeline_depth``, ``pcm_wire = "int16"``, ``fuse_ticks``, ``ca_int8``)
    at the TOML's widths; only ``batch_size``, the LM's ``num_layers`` and
    the DepFormer's (SERVING_CUTS, DEPFORMER_CUTS) are cut, nothing is
    refused."""
    import tomllib

    from dsm_tpu_torch.server import builder as tbuilder
    from dsm_tpu_torch.server import config as tCFG

    name, mod_cuts, lm_cuts = SERVING_CUTS[path]
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    mod = raw["modules"][name]
    for key, (shipped, cut) in mod_cuts.items():
        assert mod[key] == shipped
        mod[key] = cut
    for key, (shipped, cut) in lm_cuts.items():
        assert mod["model"]["transformer"][key] == shipped
        mod["model"]["transformer"][key] = cut
    if name == "tts":
        for key, (shipped, cut) in DEPFORMER_CUTS.items():
            assert mod["model"]["depformer"]["transformer"][key] == shipped
            mod["model"]["depformer"]["transformer"][key] = cut
    m = tCFG.Config.from_dict(raw).modules[name]
    assert m.lm.transformer.d_model == 2048 and m.lm.transformer.num_heads == 16
    if name == "asr":
        eng = tbuilder.build_batched_asr(m, "cpu")
        assert eng.pipeline_depth == 2 and eng._pcm_wire_int16
        assert eng.cfg.lm.extra_heads == (4, 6) and eng.cfg.asr_delay_in_tokens == 6
    else:
        eng = tbuilder.build_batched_tts(m, "cpu")
        assert (eng.fuse, eng.pipeline_depth, eng.script_cap) == (4, 2, 1024)
        assert eng.ca_quant and eng._pcm_wire_i16 and eng._frames.shape[0] == 4
        assert eng.cfg.lm.depformer.num_slices == 32
    assert eng.batch_size == 2 and not eng.cuda_graph
