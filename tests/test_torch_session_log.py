"""The port's session logs (``dsm_tpu_torch/utils/session_log.py``) against
the JAX package's.

Bars: files written by the port are read back by the JAX ``load_session``
with equal arrays (dtype, shape, values) and sidecar, and the other way
round; the same file names; flushes every ``flush_every_steps`` steps; and
the port's ASR engine with a ``session_logger`` logs, for every channel,
the text tokens and audio codes that the JAX engine logs on the same
traffic (both on the deque path), the text tokens being those the words
were built from.
"""

import json
import os

import numpy as np
import torch

from dsm_tpu.server.batched_asr import BatchedAsrEngine as JaxEngine
from dsm_tpu.utils import session_log as J
from dsm_tpu_torch.server import batched_asr as tBA
from dsm_tpu_torch.sessions import asr as tASR
from dsm_tpu_torch.utils import session_log as P
from tests import test_torch_asr_pipeline as AP
from tests.test_torch_ops import to_port

torch.set_num_threads(2)


def _fill(logger, rng, sid, steps, k=4):
    logger.open_session(sid, meta={"model": "small", "seed": 3})
    for i in range(steps):
        logger.log_step(sid, int(rng.integers(0, 2 ** 31 - 1)),
                        rng.integers(-5, 2048, size=k).astype(np.int32))
    logger.log_word(sid, "hello", 0.08, 0.4)
    logger.log_word(sid, "wörld", 0.48, None)
    return logger.close_session(sid)


def _same(a, b):
    (ta, aa, ma), (tb, ab, mb) = a, b
    for x, y in ((ta, tb), (aa, ab)):
        assert x.dtype == y.dtype == np.int32 and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert ma == mb


def test_port_files_read_by_jax_and_jax_files_read_by_the_port(tmp_path):
    for side, writer in (("port", P.SessionLogger), ("jax", J.SessionLogger)):
        logger = writer(str(tmp_path / side), instance_name="inst")
        path = _fill(logger, np.random.default_rng(0), "asr-7", 37)
        assert os.path.basename(path) == "inst-asr-7.safetensors"
        assert os.path.exists(path.replace(".safetensors", ".json"))
    port_path = str(tmp_path / "port" / "inst-asr-7.safetensors")
    jax_path = str(tmp_path / "jax" / "inst-asr-7.safetensors")
    want = J.load_session(jax_path)
    assert want[0].shape == (37,) and want[1].shape == (37, 4)
    assert want[2]["transcript"][1] == {"text": "wörld", "start_s": 0.48, "stop_s": None}
    for got in (J.load_session(port_path), P.load_session(port_path), P.load_session(jax_path)):
        _same(got, want)
    with open(port_path.replace(".safetensors", ".json")) as f, \
            open(jax_path.replace(".safetensors", ".json")) as g:
        assert json.load(f) == json.load(g)


def test_periodic_flush_and_empty_sessions(tmp_path):
    logger = P.SessionLogger(str(tmp_path), flush_every_steps=5)
    logger.open_session("s")
    assert logger.flush("s") is None and logger.flush("unknown") is None
    for i in range(7):
        logger.log_step("s", i, np.arange(2, dtype=np.int32) + i)
    text, audio, meta = J.load_session(str(tmp_path / "dsm-tpu-s.safetensors"))
    assert text.tolist() == [0, 1, 2, 3, 4]  # the flush at 5 steps
    logger.close_session("s")
    text, audio, _ = P.load_session(str(tmp_path / "dsm-tpu-s.safetensors"))
    assert text.tolist() == list(range(7)) and audio[:, 1].tolist() == list(range(1, 8))
    logger.log_step("s", 1, [0])  # closed: ignored
    assert logger.close_session("s") is None


def test_engine_logs_what_the_jax_engine_logs(tmp_path):
    jcfg, tcfg, params = AP._small_asr()
    frame = jcfg.mimi.frame_size
    lj = J.SessionLogger(str(tmp_path / "jax"), flush_every_steps=16)
    lt = P.SessionLogger(str(tmp_path / "port"), flush_every_steps=16)
    ej = JaxEngine(jcfg, params, batch_size=3, fill_gate_frac=0.0, use_native_packer=False,
                   session_logger=lj)
    et = tBA.BatchedAsrEngine(tcfg, to_port(params), batch_size=3, device="cpu",
                              fill_gate_frac=0.0, use_native_packer=False, session_logger=lt)
    for eng in (ej, et):
        events = AP._serve(eng, frame)[0]  # the port's, last
        for ch in list(eng.slots):
            if ch is not None:
                eng.close_channel(ch)

    def sessions(side):  # in the order the channels opened (their ids)
        names = os.listdir(tmp_path / side)
        assert len(names) == 8  # four sessions, two files each
        return sorted((f for f in names if f.endswith(".safetensors")),
                      key=lambda f: int(f.split("-")[-1].split(".")[0]))

    word_tokens = []
    for fj, ft in zip(sessions("jax"), sessions("port")):
        got = P.load_session(str(tmp_path / "port" / ft))
        want = J.load_session(str(tmp_path / "jax" / fj))
        _same(got, want)
        assert got[1].shape[1] == tcfg.mimi.n_q and got[0].size > 20
        # The logged text tokens rebuild the delivered words.
        ws = tASR.WordState(tcfg, 1)
        words = [e.tokens for step, tok in enumerate(got[0], start=1)
                 for e in ws.process([tok], [step], [True]) if hasattr(e, "tokens")]
        word_tokens.append(words)
    delivered = [[w[1] for e in evs for w in e[1] if w[0] == "WordEvent"]
                 for evs in events.values()]
    assert sorted(map(str, word_tokens)) == sorted(map(str, delivered))
    assert any(word_tokens)
