"""The fixed-buffer TTS tick that ``BatchedTtsEngine`` captures as one CUDA
graph on the card, on the CPU.

* ``sessions.tts.step_in_place`` equals ``sessions.tts.step`` bit for bit over
  40 ticks at small widths (2 LM layers over a 16-row ring, a DepFormer of 4
  slices x 2 layers, B = 4, guidance off and on), past a wrap of the LM ring,
  with slot resets, partial masks, the three constraint modes and per-slot
  seeds, temperatures and guidance; the state keeps its buffers
  (``data_ptr``) from tick to tick.
* ``overwrite_last_text_token_in_place`` equals ``overwrite_last_text_token``.
* ``models.mimi.decode_step_in_place`` equals ``decode_step`` bit for bit past
  a wrap of the decoder's 32-row ring (2 rows a step), with partial masks.
* A CPU engine has no graph, and ``cuda_graph=True`` there raises.
* A small CPU ``BatchedTtsEngine`` whose LM and codec rings wrap while it
  serves gives the JAX engine's events: words and their timestamps equal,
  frames within atol 1e-4 (``test_engine_matches_jax_engine``'s bar: the Mimi
  decode sums in other orders).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dsm_tpu.models import lm as jLM
from dsm_tpu.models import mimi as jMIMI
from dsm_tpu.server.tts_batched import BatchedTtsEngine as JaxEngine
from dsm_tpu.utils import tokenizer as jTOK
from dsm_tpu_torch.models import lm as tLM
from dsm_tpu_torch.models import mimi as tMIMI
from dsm_tpu_torch.ops import transformer as tT
from dsm_tpu_torch.server import tts_batched as tTB
from dsm_tpu_torch.sessions import tts as tTTS
from dsm_tpu_torch.utils import tokenizer as tTOK
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_ops import to_port
from tests.test_torch_tts import port_mimi_cfg
from tests.test_torch_tts_serving import (_drive, _summary, _voice, port_tts_cfg,
                                          spm_bytes)
from tests.test_tts import small_tts_cfg

torch.set_num_threads(2)

LM_CONTEXT = 16  # the LM ring: 16 rows, so that 40 ticks wrap it


def _small_cfg():
    """The JAX package's small TTS config with a 16-row LM ring."""
    j = small_tts_cfg(max_steps=96)
    lm = dataclasses.replace(j.lm, transformer=dataclasses.replace(j.lm.transformer,
                                                                   context=LM_CONTEXT))
    return dataclasses.replace(j, lm=lm)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    return [x for v in tree for x in _tensors(v)]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _same(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(_tensors(a), _tensors(b), strict=True))


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "cfg"])
def test_step_in_place_equals_step_over_a_wrap(guided):
    cfg = port_tts_cfg(_small_cfg())
    b = 4
    rows = 2 * b if guided else b
    gen = torch.Generator().manual_seed(0)
    params = {"lm": tLM.init(cfg.lm, gen)}
    tcfg = cfg.lm.transformer
    ca = tT.precompute_ca_kv(tcfg, params["lm"]["transformer"],
                             torch.randn(rows, 6, tcfg.ca_dim, generator=gen))
    state = tTTS.init_state(cfg, rows, torch.float32)
    ref = _clone(state)
    ptrs = [x.data_ptr() for x in _tensors(state)]
    rng = np.random.default_rng(3)

    def per_row(a):
        a = torch.from_numpy(a)
        return torch.cat([a, a]) if guided else a

    seeds = per_row(np.array([11, 12, 13, 14], np.int64))
    temps = {"text": per_row(np.array([0.6, 0.0, 0.9, 0.7], np.float32)),
             "audio": per_row(np.array([0.8, 1.0, 0.0, 0.7], np.float32))}
    alpha = torch.tensor([2.0, 1.0, 1.5, 3.0]) if guided else None
    for i in range(40):
        modes = per_row(rng.integers(0, 3, size=b).astype(np.int32))
        toks = per_row(rng.integers(4, 30, size=b).astype(np.int32))
        mask = per_row(rng.uniform(size=b) < 0.8)
        reset = per_row(np.array([i == 0, i == 17, i in (0, 25), i == 0]))
        kw = dict(ca_kv=ca, mask=mask, reset=reset, temps=temps, seeds=seeds,
                  cfg_alpha=alpha)
        got = tTTS.step_in_place(cfg, params, state, modes, toks, **kw)
        want, ref = tTTS.step(cfg, params, ref, modes, toks, **kw)
        for key in want:
            assert torch.equal(got[key], want[key]), (i, key)
        assert [x.data_ptr() for x in _tensors(state)] == ptrs
    assert _same(state, ref)
    assert int(state["lm"]["t"]["pos"]) == 40 > state["lm"]["t"]["valid"].shape[1]
    assert int(state["step_idx"].max()) > cfg.text_audio_delay_in_tokens + cfg.acoustic_delay


def test_overwrite_in_place_equals_the_functional_form():
    cfg = port_tts_cfg(_small_cfg())
    state = tTTS.init_state(cfg, 4, torch.float32)
    g = torch.Generator().manual_seed(1)
    state["text_tokens"].copy_(torch.randint(0, 30, state["text_tokens"].shape, generator=g))
    state["prev_text"].copy_(torch.randint(0, 30, (4,), generator=g))
    state["step_idx"].copy_(torch.tensor([0, 5, 9, 3], dtype=torch.int32))
    ptrs = [x.data_ptr() for x in _tensors(state)]
    for slots in (None, torch.tensor([False, True, True, False])):
        want = tTTS.overwrite_last_text_token(_clone(state), cfg.text_pad_token, slots)
        tTTS.overwrite_last_text_token_in_place(state, cfg.text_pad_token, slots)
        assert _same(state, want)
        assert [x.data_ptr() for x in _tensors(state)] == ptrs
    assert int(state["text_tokens"][2, 8]) == cfg.text_pad_token


def test_mimi_decode_in_place_equals_decode_step_over_a_wrap():
    cfg = port_mimi_cfg(small_mimi_cfg())
    b = 3
    params = tMIMI.init(cfg, torch.Generator().manual_seed(2))
    state = tMIMI.init_decode_state(cfg, b)
    ref = _clone(state)
    ptrs = [x.data_ptr() for x in _tensors(state)]
    rng = np.random.default_rng(4)
    for _ in range(20):
        codes = torch.from_numpy(rng.integers(0, cfg.bins, size=(b, cfg.n_q, 1))
                                 .astype(np.int32))
        mask = torch.from_numpy(rng.uniform(size=b) < 0.7)
        got = tMIMI.decode_step_in_place(cfg, params, state, codes, mask)
        want, ref = tMIMI.decode_step(cfg, params, ref, codes, mask)
        assert torch.equal(got, want)
        assert [x.data_ptr() for x in _tensors(state)] == ptrs
    assert _same(state, ref)
    dec_t = state["dec_t"]
    assert int(dec_t["pos"]) == 40 > dec_t["valid"].shape[1]


def _engines():
    jcfg = _small_cfg()
    mimi_cfg = small_mimi_cfg()
    params = {"lm": jLM.init(jcfg.lm, jax.random.PRNGKey(0))}
    mimi_params = jMIMI.init(mimi_cfg, jax.random.PRNGKey(1))
    ej = JaxEngine(jcfg, params, mimi_cfg, mimi_params,
                   jTOK.SentencePieceModel.from_bytes(spm_bytes()), batch_size=2, ca_len=6)
    et = tTB.BatchedTtsEngine(port_tts_cfg(jcfg), to_port(params), port_mimi_cfg(mimi_cfg),
                              to_port(mimi_params),
                              tTOK.SentencePieceModel.from_bytes(spm_bytes()),
                              batch_size=2, ca_len=6, device="cpu")
    return jcfg, params, ej, et


def test_cpu_engine_has_no_graph():
    cfg = port_tts_cfg(_small_cfg())
    mimi_cfg = port_mimi_cfg(small_mimi_cfg())
    gen = torch.Generator().manual_seed(0)
    args = (cfg, {"lm": tLM.init(cfg.lm, gen)}, mimi_cfg, tMIMI.init(mimi_cfg, gen),
            tTOK.SentencePieceModel.from_bytes(spm_bytes()))
    et = tTB.BatchedTtsEngine(*args, batch_size=2, ca_len=6, device="cpu")
    assert et.cuda_graph is False and et._graph is None
    with pytest.raises(ValueError, match="no CUDA graph"):
        tTB.BatchedTtsEngine(*args, batch_size=2, ca_len=6, device="cpu", cuda_graph=True)


def test_cpu_engine_matches_the_jax_engine_past_a_ring_wrap():
    """Three sessions on two slots, the third reusing a slot, voices and
    seeded sampling: the port's engine on bridged weights gives the JAX
    engine's events while its LM ring (16 rows) and codec ring wrap."""
    jcfg, params, ej, et = _engines()
    voices = [_voice(jcfg, params, 2), None, _voice(jcfg, params, 3)]
    open_kw = [dict(seed=7, text_temperature=0.8, audio_temperature=0.9),
               dict(seed=8, audio_temperature=1.0),
               dict(seed=9, text_temperature=0.0, audio_temperature=0.7)]
    ev_j = _drive(ej, voices, lambda v: v, open_kw)
    ev_t = _drive(et, voices, lambda v: None if v is None else
                  tuple(torch.from_numpy(np.array(x)) for x in v), open_kw)
    for sj, st in zip(ev_j, ev_t):
        wj, fj, dj = _summary(sj)
        wt, ft, dt = _summary(st)
        assert dj == dt == 1
        assert wt == wj and len(wt) >= 2
        assert len(ft) == len(fj) >= 1
        for a, b in zip(ft, fj):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    pos = int(et.state["lm"]["t"]["pos"])
    assert pos == int(ej.state["lm"]["t"]["pos"]) > LM_CONTEXT
    dec_t = et.mimi_state["dec_t"]
    assert int(dec_t["pos"]) > dec_t["valid"].shape[1]
