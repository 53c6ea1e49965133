"""The fixed-buffer duplex tick that ``BatchedDuplexEngine`` captures as one
CUDA graph on the card, and its dispatch-ahead, on the CPU.

* ``sessions.lm_gen.step_in_place`` equals ``sessions.lm_gen.step`` bit for bit
  over 40 ticks at small widths (2 LM layers, a DepFormer of 3 slices x 2
  layers, B = 4), from a tick 20 rows before the end of the LM ring so that
  it wraps, with partial masks, slot resets, an ASR-delay slot and sampling,
  on f32, int8 and packed-int4 rings; the state keeps its buffers
  (``data_ptr``) from tick to tick.
* ``models.mimi.encode_step_in_place`` and the in-place codec resets equal
  ``encode_step`` and ``reset_encode_state`` / ``reset_decode_state`` bit
  for bit past a wrap of the encoder's 32-row ring (2 rows a step).
* The engine's tick body as the graph captures it (``_device_tick(x,
  in_place=True)``, the key split inside) equals the eager tick bit for bit
  over 40 ticks past a wrap of every ring, on f32, int8 and packed-int4 LM
  rings: the packed arrays, the key and the states, the buffers kept.
* A CPU engine has no graph, and ``cuda_graph=True`` there raises.
* The port's engine at ``pipeline_depth = 2`` gives the JAX engine's events
  at ``pipeline_depth = 2`` (text equal, frames within atol 1e-4, the bar of
  ``tests/test_torch_duplex_serving.py``: the codec sums in other orders) and
  its own events at depth 1 with every frame bit for bit; Done arrives after
  a dialogue's last audio and text, and ``stop()`` delivers the ticks still
  in flight, as ``tests/test_duplex_batched.py::
  test_pipelined_engine_matches_unpipelined`` holds the JAX engine.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dsm_tpu.models import lm as jLM
from dsm_tpu.models import mimi as jMIMI
from dsm_tpu.server.duplex_batched import BatchedDuplexEngine as JaxEngine
from dsm_tpu.utils.tokenizer import FallbackTokenizer as JaxFallback
from dsm_tpu_torch.models import lm as tLM
from dsm_tpu_torch.models import mimi as tMIMI
from dsm_tpu_torch.ops import sampling as tS
from dsm_tpu_torch.server import duplex_batched as tDB
from dsm_tpu_torch.sessions import lm_gen as tGEN
from dsm_tpu_torch.utils.tokenizer import FallbackTokenizer
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_duplex import port_duplex_cfg, small_duplex_cfg
from tests.test_torch_duplex_serving import _pcm, _summary
from tests.test_torch_ops import to_port
from tests.test_torch_tts import port_mimi_cfg
from tests.test_torch_tts_graph import _clone, _same, _tensors

torch.set_num_threads(2)

LM_CONTEXT = 16  # the LM's context: a 32-row f32 ring, 128 rows when quantised


@pytest.mark.parametrize("rings", ["f32", "int8", "int4"])
def test_step_in_place_equals_step_over_a_wrap(rings):
    cfg = port_duplex_cfg(small_duplex_cfg(max_steps=64, repetition_penalty=(4, 1.3),
                                           pad_mult=0.5))
    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(
        cfg.lm, transformer=dataclasses.replace(cfg.lm.transformer, context=LM_CONTEXT)))
    b = 4
    params = {"lm": tLM.init(cfg.lm, torch.Generator().manual_seed(0))}
    kv_quant = rings != "f32"
    state = tGEN.init_state(cfg, b, torch.float32, kv_quant=kv_quant,
                            kv_bits=4 if rings == "int4" else 8)
    cap = state["lm"]["t"]["valid"].shape[1]
    state["lm"]["t"]["pos"].fill_(cap - 20)  # 20 ticks before the ring's end
    ref = _clone(state)
    ptrs = [x.data_ptr() for x in _tensors(state)]
    rng = np.random.default_rng(3)
    asr_delay = torch.tensor([0, 6, 0, 0], dtype=torch.int32)
    for i in range(40):
        user = torch.from_numpy(rng.integers(0, 8, (b, 3)).astype(np.int32))
        mask = torch.from_numpy(rng.uniform(size=b) < 0.8)
        reset = torch.tensor([i == 0, i in (0, 17), i == 0, i in (0, 25)])
        key = tS.prng_key(100 + i)
        kw = dict(asr_delay=asr_delay, mask=mask, reset=reset)
        got = tGEN.step_in_place(cfg, params, state, user, key, **kw)
        want, ref = tGEN.step(cfg, params, ref, user, key, **kw)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        assert [x.data_ptr() for x in _tensors(state)] == ptrs
    assert _same(state, ref)
    assert int(state["lm"]["t"]["pos"]) == cap + 20
    assert int(state["step_idx"].max()) > cfg.acoustic_delay
    if kv_quant:
        assert state["lm"]["t"]["layers"][0]["k"].dtype == (torch.uint8 if rings == "int4"
                                                             else torch.int8)


def test_mimi_encode_and_resets_in_place_equal_the_functional_forms():
    cfg = port_mimi_cfg(small_mimi_cfg())
    b = 3
    params = tMIMI.init(cfg, torch.Generator().manual_seed(2))
    enc, dec = tMIMI.init_encode_state(cfg, b), tMIMI.init_decode_state(cfg, b)
    enc_ref, dec_ref = _clone(enc), _clone(dec)
    ptrs = [x.data_ptr() for x in _tensors(enc) + _tensors(dec)]
    rng = np.random.default_rng(4)
    for i in range(20):
        pcm = torch.from_numpy((rng.standard_normal((b, 1, cfg.frame_size)) * 0.1)
                               .astype(np.float32))
        mask = torch.from_numpy(rng.uniform(size=b) < 0.7)
        reset = torch.tensor([i == 5, i in (5, 13), False])
        got = tMIMI.encode_step_in_place(cfg, params, enc, pcm, mask)
        want, enc_ref = tMIMI.encode_step(cfg, params, enc_ref, pcm, mask)
        assert torch.equal(got, want)
        codes = torch.from_numpy(rng.integers(0, cfg.bins, size=(b, cfg.n_q, 1))
                                 .astype(np.int32))
        tMIMI.decode_step_in_place(cfg, params, dec, codes, mask)
        _, dec_ref = tMIMI.decode_step(cfg, params, dec_ref, codes, mask)
        tMIMI.reset_encode_state_in_place(enc, reset)
        tMIMI.reset_decode_state_in_place(dec, reset)
        enc_ref = tMIMI.reset_encode_state(enc_ref, reset)
        dec_ref = tMIMI.reset_decode_state(dec_ref, reset)
        assert _same(enc, enc_ref) and _same(dec, dec_ref), i
        if i == 5:  # the reset slots' carries are cleared, the others' are not
            buf = enc["enc"]["init"]["buf"]
            assert not buf[0].any() and not buf[1].any() and buf[2].any()
        assert [x.data_ptr() for x in _tensors(enc) + _tensors(dec)] == ptrs
    enc_t = enc["enc_t"]
    assert int(enc_t["pos"]) == 40 > enc_t["valid"].shape[1]


def _engine_args():
    jcfg = small_duplex_cfg(n=4, audio_vocab=33, max_steps=64)
    mimi_cfg = small_mimi_cfg()  # n_q = 4, 48 samples a frame
    key = jax.random.PRNGKey(0)
    params = {"lm": jLM.init(jcfg.lm, key),
              "mimi": jMIMI.init(mimi_cfg, jax.random.fold_in(key, 1))}
    return jcfg, mimi_cfg, params


def _port_engine(jcfg, mimi_cfg, params, **kw):
    return tDB.BatchedDuplexEngine(port_duplex_cfg(jcfg), {"lm": to_port(params["lm"])},
                                   port_mimi_cfg(mimi_cfg), to_port(params["mimi"]),
                                   FallbackTokenizer(), batch_size=2, device="cpu", **kw)


def test_cpu_engine_has_no_graph():
    jcfg, mimi_cfg, params = _engine_args()
    eng = _port_engine(jcfg, mimi_cfg, params)
    assert eng.cuda_graph is False and eng._graph is None and eng.pipeline_depth == 1
    assert _port_engine(jcfg, mimi_cfg, params, pipeline_depth=0).pipeline_depth == 1
    with pytest.raises(ValueError, match="no CUDA graph"):
        _port_engine(jcfg, mimi_cfg, params, cuda_graph=True)


@pytest.mark.parametrize("kv_bits", [None, 8, 4], ids=["f32", "int8", "int4"])
def test_in_place_tick_equals_the_eager_tick(kv_bits):
    """The engine's tick body as the graph captures it (``_device_tick(x,
    in_place=True)``: the key split and every state written back into its
    own buffers) beside the eager tick on clones, over 40 ticks from 20
    before the end of the LM ring and the codec's rings, with resets,
    partial masks and a text-only slot: the packed arrays, the key and every
    state bit for bit, the buffers kept."""
    import copy

    jcfg, mimi_cfg, params = _engine_args()
    kw = {} if kv_bits is None else {"kv_quant": True, "kv_bits": kv_bits}
    eng = _port_engine(jcfg, mimi_cfg, params, **kw)
    eng.warmup()
    rings = [eng.state["lm"]["t"], eng.enc_state["enc_t"], eng.dec_state["dec_t"]]
    with torch.inference_mode():  # the eager warm-up made them inference tensors
        for t, rows in zip(rings, (1, 2, 2)):
            t["pos"].fill_(3 * t["valid"].shape[1] - 20 * rows)
    ref = copy.copy(eng)
    ref.rng = eng.rng.clone()
    ref.state, ref.enc_state, ref.dec_state = (_clone(eng.state), _clone(eng.enc_state),
                                               _clone(eng.dec_state))

    def trees(e):
        return [e.rng] + _tensors(e.state) + _tensors(e.enc_state) + _tensors(e.dec_state)

    ptrs = [x.data_ptr() for x in trees(eng)]
    rng = np.random.default_rng(9)
    b, frame = eng.batch_size, mimi_cfg.frame_size
    delay = torch.tensor([0, 4], dtype=torch.int32)
    for i in range(40):
        x = {"pcm": torch.from_numpy((rng.standard_normal((b, 1, frame)) * 0.1)
                                     .astype(np.float32)),
             "mask": torch.from_numpy(rng.uniform(size=b) < 0.85),
             "reset": torch.tensor([i in (0, 21), i in (0, 9)]), "asr_delay": delay}
        with torch.inference_mode():
            got = eng._device_tick(x, in_place=True)
            want = ref._device_tick(x, in_place=False)
        assert torch.equal(got, want), i
        assert [x.data_ptr() for x in trees(eng)] == ptrs
    assert _same(trees(eng), trees(ref))
    assert all(int(t["pos"]) > 3 * t["valid"].shape[1] for t in rings)
    assert int(got[2 * b:3 * b].sum()) == 1  # slot 0 decodes, the text-only slot 1 not


def _serve(eng, frame):
    """Two dialogues, one text-only, then a third in the first one's slot;
    a fixed number of ticks, then ``stop()``.  Returns the events, the
    number of events ``stop()`` delivered, and the observer's calls."""
    events = [[] for _ in range(3)]
    seen = []
    eng.tick_observer = lambda dt, n, phases: seen.append((dt, n))
    eng.warmup()
    a = eng.open_session(events[0].append)
    a.push_pcm(_pcm(1, 6, frame))
    a.end_input()
    eng.tick()
    b = eng.open_session(events[1].append, asr_delay_in_tokens=3)
    b.push_pcm(_pcm(2, 9, frame))
    b.end_input()
    for _ in range(9):
        eng.tick()
    assert a.finished
    eng.close_session(a)
    c = eng.open_session(events[2].append)
    assert c.slot == a.slot
    c.push_pcm(_pcm(3, 5, frame))
    c.end_input()
    for _ in range(5):  # c's last frame dispatched: at depth 2 still in flight
        eng.tick()
    before = sum(len(e) for e in events)
    eng.stop()
    drained = sum(len(e) for e in events) - before
    for _ in range(3):  # the Done of c, now that nothing is in flight
        eng.tick()
    return events, drained, seen


def test_pipelined_engine_matches_the_jax_engine_and_itself_unpipelined():
    jcfg, mimi_cfg, params = _engine_args()
    frame = mimi_cfg.frame_size
    jax_eng = JaxEngine(jcfg, params, mimi_cfg, params["mimi"], JaxFallback(), batch_size=2,
                        pipeline_depth=2)
    ev_j, drained_j, _ = _serve(jax_eng, frame)
    ev_1, drained_1, seen_1 = _serve(_port_engine(jcfg, mimi_cfg, params), frame)
    eng2 = _port_engine(jcfg, mimi_cfg, params, pipeline_depth=2)
    ev_2, drained_2, seen_2 = _serve(eng2, frame)
    assert drained_1 == 0 and drained_2 == drained_j > 0  # stop() delivered the last tick
    assert not eng2._inflight and eng2.step_count == len(seen_2)
    assert all(dt > 0 and n >= 1 for dt, n in seen_1 + seen_2)
    for sj, s1, s2 in zip(ev_j, ev_1, ev_2):
        kj, tj, fj = _summary(sj)
        k1, t1, f1 = _summary(s1)
        k2, t2, f2 = _summary(s2)
        assert k2 == k1 == kj and k2[-1] == "DuplexDoneEvent" and k2.count("DuplexDoneEvent") == 1
        assert t2 == t1 == tj
        for x, y, z in zip(f2, f1, fj):
            assert x.shape == (frame,) and np.array_equal(x, y)
            np.testing.assert_allclose(x, z, atol=1e-4, rtol=0)
    # Audio from the acoustic delay on; the text-only dialogue gets none.
    assert [len(_summary(s)[2]) for s in ev_2] == [6 - 2, 0, 5 - 2]
