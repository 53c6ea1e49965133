"""The port's fused multi-tick TTS path against the JAX package.

Inputs are made with numpy or the JAX init from a seed; weights are carried
over by the bridge; the JAX side runs jitted, as its engines run it.  Bars:

* the device script machine (``sessions/tts_script.py``) against the JAX
  machine, transition for transition (every field of the machine, the mode,
  token and step mask of every frame, equal), and against the port's host
  ``TtsSlot``, which the fused engine keeps as its mirror: random scripts,
  starvation then feed, a ring that wraps;
* ``apply_ops`` on a table of ops: equal to the ops applied one by one, by
  the JAX sequential forms and by the port's, from a random machine, with
  the same-slot orders deact-then-init, init-words-eos and word chunks that
  wrap the ring;
* the port's fused engine (``fuse_ticks`` 2 and 4, ``pipeline_depth`` 1 and
  2, guidance, the int8 voice store, a reused slot, an oversized word)
  against the JAX fused engine at the same settings: words and Done equal,
  audio within atol 1e-4, the bar of ``tests/test_torch_tts_serving.py``
  (Mimi decode sums in other orders);
* the port's fused engine against its own single-tick engine: every event
  equal, audio bit for bit (no compiler re-associates the port's sums).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.sessions import tts_script as jSCRIPT
from dsm_tpu_torch.server import tts_batched as tTB
from dsm_tpu_torch.sessions import tts as tTTS
from dsm_tpu_torch.sessions import tts_script as tSCRIPT
from dsm_tpu_torch.utils.tokenizer import FallbackTokenizer
from tests.test_torch_tts_serving import _drive, _engines, _summary, _voice, port_tts_cfg
from tests.test_tts import small_tts_cfg

torch.set_num_threads(2)

J_CONSTRAINT = jax.jit(jSCRIPT.constraint, static_argnums=0)
J_ADVANCE = jax.jit(jSCRIPT.advance, static_argnums=0)


def _same_machine(mj, mt, where=""):
    assert mj.keys() == mt.keys()
    for key in mj:
        np.testing.assert_array_equal(np.asarray(mj[key]), mt[key].numpy(),
                                      err_msg=f"{key} {where}")


def _upload(words, eos, slot=0):
    """Host ops that upload ``words`` (chunked, empty words as one op) and
    the end of input, as the engine makes them."""
    ops, up = [], 0
    for wid, w in enumerate(words):
        for off in range(0, max(len(w), 1), tSCRIPT.WORD_CHUNK):
            chunk = w[off:off + tSCRIPT.WORD_CHUNK]
            toks = np.zeros(tSCRIPT.WORD_CHUNK, np.int32)
            toks[:len(chunk)] = chunk
            ops.append((tSCRIPT.OP_WORD, slot, toks, len(chunk), wid, up + off))
        up += len(w)
    if eos:
        ops.append((tSCRIPT.OP_EOS, slot, None, 0, 0, 0))
    return ops


def _apply_j(m, ops):
    """The JAX sequential forms, one op after the other."""
    for kind, slot, toks, count, wid, start in ops:
        if kind == tSCRIPT.OP_INIT:
            m = jSCRIPT.reset_row(m, slot)
        elif kind == tSCRIPT.OP_DEACT:
            m = jSCRIPT.deactivate_row(m, slot)
        elif kind == tSCRIPT.OP_EOS:
            m = jSCRIPT.set_eos_row(m, slot)
        elif kind == tSCRIPT.OP_WORD:
            m = jSCRIPT.write_word_chunk(m, slot, jnp.asarray(toks), count, wid, start)
    return m


def _apply_t_seq(m, ops):
    """The port's sequential forms, one op after the other."""
    for kind, slot, toks, count, wid, start in ops:
        if kind == tSCRIPT.OP_INIT:
            m = tSCRIPT.reset_row(m, slot)
        elif kind == tSCRIPT.OP_DEACT:
            m = tSCRIPT.deactivate_row(m, slot)
        elif kind == tSCRIPT.OP_EOS:
            m = tSCRIPT.set_eos_row(m, slot)
        elif kind == tSCRIPT.OP_WORD:
            m = tSCRIPT.write_word_chunk(m, slot, toks, count, wid, start)
    return m


class _Pair:
    """One slot's machine on both sides, stepped together."""

    def __init__(self, cfg, cap, ops):
        self.cfg = cfg
        self.cc_j = jSCRIPT.ScriptConsts.from_cfg(cfg)
        self.cc_t = tSCRIPT.ScriptConsts.from_cfg(port_tts_cfg(cfg))
        self.mj = jSCRIPT.init(1, cap)
        self.mt = tSCRIPT.init(1, cap)
        self.apply([(tSCRIPT.OP_INIT, 0, None, 0, 0, 0)] + ops)

    def apply(self, ops):
        self.mj = _apply_j(self.mj, ops)
        tSCRIPT.apply_ops(self.mt, torch.from_numpy(tSCRIPT.op_table(ops)))
        _same_machine(self.mj, self.mt, "after the upload")

    def constraint(self):
        mode_j, tok_j, mask_j, self.mj = J_CONSTRAINT(self.cc_j, self.mj)
        mode, tok, mask = tSCRIPT.constraint_in_place(self.cc_t, self.mt)
        for a, b in ((mode_j, mode), (tok_j, tok), (mask_j, mask)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        _same_machine(self.mj, self.mt, "after constraint")
        return int(mode[0]), int(tok[0]), bool(mask[0])

    def advance(self, token):
        self.mj, patch_j = J_ADVANCE(self.cc_j, self.mj, jnp.asarray([token], jnp.int32),
                                     jnp.asarray([True]))
        patch = tSCRIPT.advance_in_place(self.cc_t, self.mt,
                                         torch.tensor([token], dtype=torch.int32),
                                         torch.tensor([True]))
        np.testing.assert_array_equal(np.asarray(patch_j), patch.numpy())
        _same_machine(self.mj, self.mt, "after advance")
        return bool(patch[0])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("eos", [True, False])
def test_machine_matches_jax_and_the_host_slot(seed, eos):
    """Random script, random pad / end-of-word choices: both machines equal
    at every transition, and the host ``TtsSlot`` (the fused engine's
    mirror) picks the same constraint and ends on the same frame."""
    cfg = small_tts_cfg(max_steps=96)
    tcfg = port_tts_cfg(cfg)
    rng = np.random.default_rng(seed)
    words = [list(map(int, rng.integers(30, 60, size=int(rng.integers(0, 5)))))
             for _ in range(int(rng.integers(1, 6)))]
    host = tTB.TtsSlot(0, lambda ev: None)
    host.feed_words(words)
    if eos:
        host.end_input()
    pair = _Pair(cfg, 64, _upload(words, eos))
    for step in range(200):
        want = host.next_constraint(tcfg)
        mode, tok, stepped = pair.constraint()
        if want is None:
            assert not stepped, f"the machine still steps at frame {step}"
            return
        assert stepped and mode == want[0], f"frame {step}"
        if mode == tTTS.ALLOW_TEXT:
            assert tok == want[1]
            sampled = tok
        elif mode == tTTS.ALLOW_PAD:
            sampled = cfg.text_pad_token
        else:
            sampled = cfg.text_eop_token if rng.random() < 0.4 else cfg.text_pad_token
        patch = host.on_text_token(tcfg, sampled, FallbackTokenizer())
        assert pair.advance(sampled) == (patch == "overwrite_pad")
    assert not eos, "the session never ended"


def test_machine_starvation_then_feed():
    """No end of input and every word consumed: pad-or-end-of-word for as
    long as it lasts; a word uploaded later is forced after the next
    end-of-word."""
    cfg = small_tts_cfg(max_steps=96)
    eop = cfg.text_eop_token
    pair = _Pair(cfg, 64, _upload([[41, 42]], eos=False))
    assert pair.constraint()[0] == tTTS.ALLOW_PAD_OR_EPAD
    pair.advance(eop)
    for tok in (41, 42):
        assert pair.constraint()[:2] == (tTTS.ALLOW_TEXT, tok)
        pair.advance(tok)
    for _ in range(4):  # starved, through end-of-words
        assert pair.constraint() == (tTTS.ALLOW_PAD_OR_EPAD, 0, True)
        pair.advance(eop)
    toks = np.zeros(tSCRIPT.WORD_CHUNK, np.int32)
    toks[0] = 55
    pair.apply([(tSCRIPT.OP_WORD, 0, toks, 1, 1, 2)])
    assert pair.constraint()[0] == tTTS.ALLOW_PAD_OR_EPAD
    pair.advance(eop)
    assert pair.constraint()[:2] == (tTTS.ALLOW_TEXT, 55)


def test_machine_ring_wraparound():
    """30 tokens through a 16-token ring, each word uploaded once the last
    was consumed: every forced token is the uploaded one."""
    cfg = small_tts_cfg(max_steps=96)
    pair = _Pair(cfg, 16, [])
    start = 0
    for wid in range(10):
        w = [100 + 3 * wid, 101 + 3 * wid, 102 + 3 * wid]
        toks = np.zeros(tSCRIPT.WORD_CHUNK, np.int32)
        toks[:3] = w
        pair.apply([(tSCRIPT.OP_WORD, 0, toks, 3, wid, start)])
        start += 3
        assert pair.constraint()[0] == tTTS.ALLOW_PAD_OR_EPAD
        pair.advance(cfg.text_eop_token)
        for t in w:
            assert pair.constraint()[:2] == (tTTS.ALLOW_TEXT, t)
            pair.advance(t)


def _random_machine(rng, batch, cap):
    """A machine in a state that serving could reach, field by field."""
    m = tSCRIPT.init(batch, cap)
    for key, hi in (("toks", 100), ("ptr", 40), ("widx", 9), ("n_toks", 60),
                    ("n_words", 10), ("past_last", 8)):
        m[key] = torch.from_numpy(rng.integers(0, hi, m[key].shape).astype(np.int32))
    m["word_of"] = torch.from_numpy(rng.integers(-1, 9, m["word_of"].shape).astype(np.int32))
    for key in ("eos", "drained", "active"):
        m[key] = torch.from_numpy(rng.uniform(size=batch) < 0.5)
    return m


def _random_ops(rng, batch, n):
    ops, up = [], {s: [int(rng.integers(0, 40)), int(rng.integers(0, 8))] for s in range(batch)}
    for _ in range(n):
        kind, slot = int(rng.integers(0, 5)), int(rng.integers(0, batch))
        if kind == tSCRIPT.OP_INIT:
            up[slot] = [0, 0]
        if kind != tSCRIPT.OP_WORD:
            ops.append((kind, slot, None, 0, 0, 0))
            continue
        count = int(rng.integers(0, tSCRIPT.WORD_CHUNK + 1))
        toks = np.zeros(tSCRIPT.WORD_CHUNK, np.int32)
        toks[:count] = rng.integers(1, 100, count)
        ops.append((kind, slot, toks, count, up[slot][1], up[slot][0]))
        up[slot][0] += count
        up[slot][1] += 1
    return ops


ORDERS = {
    "deact-init": [(tSCRIPT.OP_DEACT, 1, None, 0, 0, 0), (tSCRIPT.OP_INIT, 1, None, 0, 0, 0)],
    "init-words-eos": ([(tSCRIPT.OP_INIT, 2, None, 0, 0, 0)]
                       + _upload([[5, 6, 7], [], list(range(10, 30))], eos=True, slot=2)),
    "init-deact": [(tSCRIPT.OP_INIT, 0, None, 0, 0, 0), (tSCRIPT.OP_DEACT, 0, None, 0, 0, 0)],
    # 24 + 20 tokens from position 20 of a 32-token ring: both wrap.
    "wrapping-chunks": [(tSCRIPT.OP_WORD, 3, np.arange(1, 17, dtype=np.int32), 16, 4, 20),
                        (tSCRIPT.OP_WORD, 3, np.arange(40, 56, dtype=np.int32), 8, 4, 36),
                        (tSCRIPT.OP_WORD, 3, np.arange(60, 76, dtype=np.int32), 16, 5, 44),
                        (tSCRIPT.OP_WORD, 3, np.arange(80, 96, dtype=np.int32), 4, 5, 60)],
}


@pytest.mark.parametrize("case", [0, 1, 2, 3, 4, 5, *ORDERS])
def test_apply_ops_equals_the_ops_one_by_one(case):
    """A table of ops against the same ops applied one at a time (JAX's
    sequential forms, the port's), from a random machine; OP_NOP rows and
    a chunk longer than one table's rows included."""
    rng = np.random.default_rng(hash(case) % 1000 if isinstance(case, str) else case)
    batch, cap = 4, 32
    m0 = _random_machine(rng, batch, cap)
    if isinstance(case, str):
        ops = ORDERS[case]
    else:
        ops = _random_ops(rng, batch, int(rng.integers(1, 40)))
    ops = ops + [(tSCRIPT.OP_NOP, 0, None, 0, 0, 0)] * 3
    want_j = _apply_j({k: jnp.asarray(v.numpy()) for k, v in m0.items()}, ops)
    want_t = _apply_t_seq({k: v.clone() for k, v in m0.items()}, ops)
    got = {k: v.clone() for k, v in m0.items()}
    tSCRIPT.apply_ops(got, torch.from_numpy(tSCRIPT.op_table(ops)))
    _same_machine(want_j, got)
    _same_machine(want_j, want_t)


def _open_kw(cfg):
    kw = [dict(seed=7, text_temperature=0.8, audio_temperature=0.9),
          dict(seed=8, audio_temperature=1.0),
          dict(seed=9, text_temperature=0.0, audio_temperature=0.7)]
    if cfg:
        for k, a in zip(kw, (2.0, None, 1.5)):
            k["cfg_alpha"] = a
    return kw


def _to_port_voice(v):
    return None if v is None else tuple(torch.from_numpy(np.array(x)) for x in v)


@pytest.mark.parametrize("fuse,depth,variant", [
    (2, 1, "plain"), (4, 2, "plain"), (4, 1, "cfg"), (2, 2, "ca_int8"), (4, 2, "cfg_ca_int8")])
def test_fused_engine_matches_the_jax_fused_engine(fuse, depth, variant):
    """Three sessions on two slots, the third in the slot of the first to
    finish: the port's fused engine gives the JAX fused engine's words and
    Done, audio within 1e-4."""
    kw = dict(fuse_ticks=fuse, pipeline_depth=depth, ca_quant="ca_int8" in variant,
              cfg_enabled=variant.startswith("cfg"))
    jcfg, params, ej, et = _engines(**kw)
    voices = [_voice(jcfg, params, 2), None, _voice(jcfg, params, 3)]
    open_kw = _open_kw(kw["cfg_enabled"])
    ev_j = _drive(ej, voices, lambda v: v, open_kw)
    ev_t = _drive(et, voices, _to_port_voice, open_kw)
    for sj, st in zip(ev_j, ev_t):
        wj, fj, dj = _summary(sj)
        wt, ft, dt = _summary(st)
        assert dj == dt == 1 and type(st[-1]).__name__ == "DoneEvent"
        assert wt == wj and len(wt) >= 2
        assert len(ft) == len(fj) >= 1
        for a, b in zip(ft, fj):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    assert et.fuse == fuse and et.pipeline_depth == depth and not et._inflight_f


def test_fused_engine_truncates_an_oversized_word_as_jax_does():
    """A word longer than ``script_cap`` is cut to it, not held for ever:
    the same single word and Done as the JAX engine."""
    jcfg, params, ej, et = _engines(batch=1, fuse_ticks=2)
    out = []
    for eng in (ej, et):
        eng.script_cap = 16
        events = []
        drv = eng.open_session(events.append, seed=2)
        drv.feed_words([[4 + i % 20 for i in range(24)]])
        drv.end_input()
        for _ in range(200):
            if not eng.tick():
                break
        assert drv.finished
        out.append(_summary(events))
    (wj, fj, dj), (wt, ft, dt) = out
    assert wt == wj and len(wt) == 1 and dj == dt == 1 and len(ft) == len(fj)
    for a, b in zip(ft, fj):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def _schedule(eng, voices, fuse):
    """Slot 0: a short session, then (closed at frame 48) a session in the
    reused slot; slot 1: a long session that keeps every frame busy until
    then, so both engines step the same frames.  Returns each session's
    events and the frames run."""
    events = [[] for _ in range(3)]
    texts = ["abc fed", "gab c ef hak kij abc fed gab c ef hak kij abc", "hak kij"]
    kw = _open_kw(eng.cfg_enabled)

    def open_(i, slot_voice):
        drv = eng.open_session(events[i].append, voice_ca=slot_voice, **kw[i])
        words, _ = eng.encode_words(texts[i], inserted_bos=False)
        drv.feed_words(words[:2])  # the rest a few frames later
        return drv, words[2:]

    live = {0: open_(0, voices[0]), 1: open_(1, voices[1])}
    frames = 0
    while frames < 400:
        if frames == 8 or frames == 56:
            for drv, rest in live.values():
                if rest:
                    drv.feed_words(rest)
                    rest.clear()
                drv.end_input()
        if frames == 48:
            assert live[0][0].finished, "the first session outlasted frame 48"
            eng.close_session(live[0][0])
            live[2] = open_(2, voices[2])
        if not eng.tick():
            break
        frames += fuse
    eng.stop()  # tick()-driven: delivers what is in flight
    assert all(drv.finished for drv, _ in live.values())
    return events, frames


@pytest.mark.parametrize("variant", ["plain", "cfg_ca_int8_i16"])
def test_fused_engine_equals_the_single_tick_engine(variant):
    """The same sessions, frame for frame: the fused engine (K = 4, depth 2)
    and the single-tick engine deliver the same words, audio bit for bit,
    Done last."""
    kw = dict(cfg_enabled="cfg" in variant, ca_quant="ca_int8" in variant,
              pcm_wire_int16="i16" in variant)
    jcfg, params, _, single = _engines(**kw)
    _, _, _, fused = _engines(fuse_ticks=4, pipeline_depth=2, **kw)
    voices = [_to_port_voice(_voice(jcfg, params, 2)), None,
              _to_port_voice(_voice(jcfg, params, 3))]
    ev_s, n_s = _schedule(single, voices, 1)
    ev_f, n_f = _schedule(fused, voices, 4)
    assert n_s > 64  # past the LM ring's 64 rows
    for a, b in zip(ev_s, ev_f):
        assert [type(e).__name__ for e in a] == [type(e).__name__ for e in b]
        assert type(a[-1]).__name__ == "DoneEvent"
        for x, y in zip(a, b):
            if isinstance(x, tTB.AudioEvent):
                assert x.pcm.dtype == y.pcm.dtype and np.array_equal(x.pcm, y.pcm)
            elif not isinstance(x, tTB.DoneEvent):
                assert x == y
        assert sum(isinstance(e, tTB.WordEvent) for e in a) >= 2


def test_pipeline_depth_without_fusing_warns(caplog):
    """As in the JAX engine: ``pipeline_depth > 1`` with ``fuse_ticks = 1``
    has no effect, and says so."""
    with caplog.at_level(logging.WARNING, logger="dsm.torch.tts"):
        _, _, _, et = _engines(pipeline_depth=2)
    assert et.fuse == 1 and et.pipeline_depth == 2
    assert "no effect" in caplog.text
