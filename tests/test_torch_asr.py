"""The port's STT serving slice end to end, against the JAX package.

* The golden fixture (tests/fixtures/golden_asr_small.json, made by
  tools/gen_golden.py on the JAX package) reproduced from the JAX init's
  weights carried over by the bridge: text tokens and codes exact,
  prs_tail within atol 1e-5.
* The serving profile (int8 KV rings, int8 weights, W8A8) at small width:
  LM logits and VAD probabilities within atol 3e-2 of JAX's over 10 steps,
  the bar of the JAX package's own kernel-against-XLA step tests.  JAX
  takes its XLA attention on the CPU, which rounds the normalised
  probabilities to bf16; the port takes the plain version of its fused
  kernel, which rounds them before normalising (a 2^-8 relative step), and
  W8A8 activation rounding can tip either way on sums taken in other orders.
* The port's engine, built from configs/config-smoke.toml, serving a
  WebSocket stream and a marker through dsm_tpu.server.app.App.
"""

import asyncio
import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import torch
from aiohttp.test_utils import TestClient, TestServer

import __graft_entry__ as ge
from dsm_tpu.models import lm as jLM
from dsm_tpu.ops import transformer as jT
from dsm_tpu.server.app import App
from dsm_tpu_torch.models import lm as tLM
from dsm_tpu_torch.models import mimi as tMIMI
from dsm_tpu_torch.ops import transformer as tT
from dsm_tpu_torch.server import builder as tbuilder
from dsm_tpu_torch.server import config as tCFG
from dsm_tpu_torch.sessions import asr as tASR
from tests.test_torch_ops import to_port

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_asr_small.json")


def _fields(cls, obj, **over):
    kw = {f: getattr(obj, f) for f in cls.__dataclass_fields__ if hasattr(obj, f)}
    kw.update(over)
    return cls(**kw)


def port_lm_cfg(j):
    return _fields(tLM.LmConfig, j, transformer=_fields(tT.TransformerConfig, j.transformer))


def port_asr_cfg(j):
    m = j.mimi
    mimi = _fields(tMIMI.MimiConfig, m,
                   seanet=_fields(tMIMI.SeaNetConfig, m.seanet),
                   transformer=_fields(tT.TransformerConfig, m.transformer))
    return _fields(tASR.AsrConfig, j, lm=port_lm_cfg(j.lm), mimi=mimi)


def test_golden_asr_reproduced_from_jax_weights():
    jcfg, _fn, (params, _st, _pcm, _mask, _reset, _rng) = ge._asr_setup(
        batch=2, lm_dtype=jnp.float32, cache_dtype=jnp.float32, small=True)
    cfg = port_asr_cfg(jcfg)
    pt = to_port(params)
    state = tASR.init_state(cfg, 2, torch.float32)
    pcm = torch.from_numpy(
        np.sin(np.arange(2 * cfg.mimi.frame_size, dtype=np.float32).reshape(2, 1, -1)
               * 0.01) * 0.3)
    mask = torch.ones(2, dtype=torch.bool)
    reset = torch.zeros(2, dtype=torch.bool)
    text, codes_head = [], []
    for _ in range(20):
        out, state = tASR.step(cfg, pt, state, pcm, mask, reset)
        text.append(out["text_token"].tolist())
        codes_head.append(out["codes"][:, 0].tolist())
    prs_tail = out["prs"].reshape(-1).numpy()
    with open(FIXTURE) as f:
        want = json.load(f)
    assert text == want["text_tokens"]
    assert codes_head == want["codes_head"]
    np.testing.assert_allclose(prs_tail, want["prs_tail"], atol=1e-5, rtol=0)


def test_serving_profile_logits_match_jax(monkeypatch):
    monkeypatch.setenv("DSM_W8A8", "1")
    jcfg = jLM.LmConfig(
        transformer=jT.TransformerConfig(d_model=128, num_heads=2, num_layers=2,
                                         dim_feedforward=512, context=40),
        depformer=None, text_in_vocab_size=65, text_out_vocab_size=64,
        audio_vocab_size=33, audio_codebooks=4, extra_heads=(2, 6))
    params = jT.quantize_weights(jLM.init(jcfg, jax.random.PRNGKey(8)), min_size=2048)
    assert isinstance(params["transformer"]["in_proj_w"], dict)
    assert isinstance(params["text_linear"], dict)  # M = B = 3: padded rows
    cfg = port_lm_cfg(jcfg)
    pt = to_port(params)
    b = 3
    sj = jLM.init_state(jcfg, b, kv_quant=True)
    st = tLM.init_state(cfg, b, kv_quant=True)
    jstep = jax.jit(lambda s, t, a, m: jLM.step(jcfg, params, s, t, a, m))
    rng = np.random.default_rng(9)
    for i in range(10):
        text = rng.integers(-1, 65, b).astype(np.int32)
        audio = rng.integers(-1, 33, (b, 4)).astype(np.int32)
        m = np.array([True, i % 3 != 1, True])
        lj, hj, sj = jstep(sj, jnp.asarray(text), jnp.asarray(audio), jnp.asarray(m))
        lt, ht, st = tLM.step(cfg, pt, st, torch.from_numpy(text),
                              torch.from_numpy(audio), torch.from_numpy(m))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=3e-2, rtol=0)
        np.testing.assert_allclose(
            tLM.extra_heads_probs(cfg, pt, ht).numpy(),
            np.asarray(jLM.extra_heads_probs(jcfg, params, hj)), atol=3e-2, rtol=0)


def test_port_engine_serves_through_app():
    mod = tCFG.Config.load("configs/config-smoke.toml").modules["asr"]
    engine = tbuilder.build_batched_asr(mod, "cpu")
    # The CPU profile: f32 throughout, no quantisation.
    assert not engine.cfg.kv_quant and engine.cfg.mimi_dtype == "float32"
    assert not isinstance(engine.params["lm"]["transformer"][0]["in_proj_w"], dict)
    engine.warmup()
    engine.start()
    app = App(asr_engine=engine, instance_name="torch-port")
    frame = engine.frame_size

    async def main():
        async with TestClient(TestServer(app.web_app)) as client:
            ws = await client.ws_connect("/api/asr-streaming")
            assert msgpack.unpackb((await ws.receive()).data) == {"type": "Ready"}
            pcm = np.random.default_rng(0).standard_normal(frame * 3).astype(np.float32) * 0.1
            tail = np.zeros(frame * (engine.cfg.asr_delay_in_tokens + 1), np.float32)
            await ws.send_bytes(msgpack.packb({"type": "Audio", "pcm": pcm.tolist()}))
            await ws.send_bytes(msgpack.packb({"type": "Marker", "id": 42}))
            await ws.send_bytes(msgpack.packb({"type": "Audio", "pcm": tail.tolist()}))
            msgs = []
            async with asyncio.timeout(60):
                while True:
                    m = msgpack.unpackb((await ws.receive()).data, raw=False)
                    msgs.append(m)
                    if m["type"] == "Marker":
                        break
            steps = [m for m in msgs if m["type"] == "Step"]
            assert [s["step_idx"] for s in steps] == list(range(1, len(steps) + 1))
            assert len(steps) >= 3 + engine.cfg.asr_delay_in_tokens
            assert len(steps[0]["prs"]) == 4  # extra_heads (4, 6) in the smoke config
            assert all(np.isfinite(s["prs"]).all() for s in steps)
            assert msgs[-1] == {"type": "Marker", "id": 42}
            await ws.close()

    try:
        asyncio.run(main())
    finally:
        engine.stop()
    assert engine.step_count >= 3 + engine.cfg.asr_delay_in_tokens


def test_word_state_matches_jax():
    """The port's copy of the host word assembly emits the JAX package's
    events on the same token stream (including a slot reset)."""
    from dsm_tpu.sessions import asr as jASR
    from tests.test_asr import small_asr_cfg

    jcfg = small_asr_cfg()
    ws_j, ws_t = jASR.WordState(jcfg, 3), tASR.WordState(port_asr_cfg(jcfg), 3)
    rng = np.random.default_rng(11)
    steps = np.zeros(3, np.int32)
    kinds = set()
    for i in range(60):
        mask = rng.uniform(size=3) < 0.8
        steps = steps + mask
        toks = rng.choice([0, 3, 7, 8, 9], size=3, p=[0.2, 0.3, 0.2, 0.2, 0.1])
        if i == 30:
            ws_j.reset_slot(1)
            ws_t.reset_slot(1)
            steps[1] = 0
        ev_j = ws_j.process(toks, steps, mask)
        ev_t = ws_t.process(toks, steps, mask)
        assert [(type(e).__name__, vars(e)) for e in ev_t] == \
            [(type(e).__name__, vars(e)) for e in ev_j]
        kinds.update(type(e).__name__ for e in ev_t)
    assert kinds == {"WordEvent", "EndWordEvent"}
