"""The step's position on the device, on the CPU, against the JAX package.

``transformer.step`` carries the shared tick ``pos`` as a 0-d int32 tensor
(the JAX package's ``jnp.zeros((), jnp.int32)``); the ring plan, the validity
bitmap, the ring mask and every kernel's write row come from it on the
device, and the ASR step has a fixed-buffer form (``sessions.asr.
step_in_place``) that ``BatchedAsrEngine`` captures as one CUDA graph on the
card.  Held here:

* ``global_ring_plan``, ``update_valid_bitmap`` and ``_ring_ok`` on a tensor
  position equal the JAX functions (the ring mask: the expression
  ``attend_global_split_q`` builds) at w = 0, a middle row and C - T, also at
  positions a few wraps on: exact.
* ``transformer.step`` from a state whose tick sits a few rows before the
  ring's end (so it wraps), with partial masks and a reset, against the
  jitted JAX step through its Pallas kernels in interpret mode, on every
  route: the codec's bf16 ring at T = 2 (``rope_commit``), the LM's int8 ring
  on the fused route (``quantize_scale_commit`` + ``decode_attend_commit``)
  and on the split route (``quantize_commit`` + ``decode_attend``), and the
  packed-int4 ring.  The tick equal to JAX's and a 0-d int32 tensor after
  every step, the validity bitmap bit for bit, outputs within 3e-2 (two layers
  of bf16 matmuls, the bar of the existing step tests) and layer 0's rings:
  bf16 rings within 3e-2; int8 and packed rings within one integer step, in
  at most 0.1 % of their values, and their scales within 1e-2.  Layer 0's
  rows are not bit for bit for every input: the port's RMSNorm and its bf16
  QKV product round a few elements of some rows otherwise than the jitted
  JAX step does, which moves a quantised value by one step (ROADMAP queue 3
  item 2): the norm's sum now follows XLA:CPU's order, but XLA:CPU's
  ``rsqrt`` is the x86 approximation refined by two Newton steps, which no
  tensor operation reproduces, and its bf16 product is an f32 GEMM in
  Eigen's blocked order, which torch's product does not take.
* ``sessions.asr.step_in_place`` equals ``sessions.asr.step`` bit for bit
  over a wrap of both rings with slot resets and partial masks, and the state
  keeps its buffers (``data_ptr``) from step to step.
* A small ``BatchedAsrEngine`` on the CPU (no graph there) whose LM ring
  wraps while it serves gives the JAX engine's events, word for word and
  marker for marker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.models import lm as jLM
from dsm_tpu.models import mimi as jMIMI
from dsm_tpu.ops import attention as jattn
from dsm_tpu.ops import transformer as jT
from dsm_tpu.server.batched_asr import BatchedAsrEngine as JaxEngine
from dsm_tpu.sessions import asr as jASR
from dsm_tpu_torch.ops import attention as tattn
from dsm_tpu_torch.ops import transformer as tT
from dsm_tpu_torch.server.batched_asr import BatchedAsrEngine
from dsm_tpu_torch.sessions import asr as tASR
from tests.test_mimi import small_cfg as small_mimi_cfg
from tests.test_torch_ops import JitStep, as_np, to_port
from tests.test_torch_stt26 import _pcm
from tests.test_torch_tts import _fields, port_lm_cfg, port_mimi_cfg

torch.set_num_threads(2)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package takes its Pallas kernels (interpret mode on the CPU)."""
    monkeypatch.setenv("DSM_RING_KERNEL", "1")
    monkeypatch.setenv("DSM_DECODE_ATTN", "1")
    for var in ("DSM_FUSED_ATTN", "DSM_KERNELS", "DSM_KV_BITS"):
        monkeypatch.delenv(var, raising=False)


def tick(pos):
    return torch.tensor(pos, dtype=torch.int32)


# ---------------------------------------------------------------------------
# The ring plan, the bitmap and the ring mask on a tensor position
# ---------------------------------------------------------------------------

PLAN_CASES = [(c, t, w, wraps) for c, t in ((64, 1), (32, 2), (768, 1))
              for w in (0, c // 2, c - t) for wraps in (0, 3)]


@pytest.mark.parametrize("c,t,w,wraps", PLAN_CASES)
def test_ring_plan_on_a_tensor_position_matches_jax(c, t, w, wraps):
    pos = w + wraps * c
    jplan = jattn.global_ring_plan(jnp.int32(pos), c, t)
    tplan = tattn.global_ring_plan(tick(pos), c, t)
    for key in ("pos", "w", "q_pos", "k_pos", "new_pos"):
        got = tplan[key]
        assert isinstance(got, torch.Tensor) and got.dtype == torch.int32, key
    assert tplan["pos"].dim() == 0 and int(tplan["pos"]) == pos
    for key in ("w", "q_pos", "k_pos", "new_pos"):
        np.testing.assert_array_equal(tplan[key].numpy(), np.asarray(jplan[key]))
    # An int is made into the same tensors (the callers that hold one).
    again = tattn.global_ring_plan(pos, c, t)
    assert all(torch.equal(again[k], tplan[k]) for k in tplan)


@pytest.mark.parametrize("c,t,w,wraps", PLAN_CASES[:6])
@pytest.mark.parametrize("with_mask", [True, False])
def test_valid_bitmap_on_a_tensor_position_matches_jax(c, t, w, wraps, with_mask):
    b = 3
    pos = w + wraps * c
    rng = np.random.default_rng(pos + t)
    valid = rng.uniform(size=(b, c)) < 0.5
    mask = np.array([True, False, True]) if with_mask else None
    jplan = jattn.global_ring_plan(jnp.int32(pos), c, t)
    want = jattn.update_valid_bitmap(jnp.asarray(valid), jplan,
                                     None if mask is None else jnp.asarray(mask))
    tplan = tattn.global_ring_plan(tick(pos), c, t)
    before = torch.from_numpy(valid.copy())
    got = tattn.update_valid_bitmap(before, tplan["w"],
                                    None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(before.numpy(), valid)  # a copy: the input stays


@pytest.mark.parametrize("c,t,w,wraps", PLAN_CASES)
def test_ring_mask_on_a_tensor_position_matches_jax(c, t, w, wraps):
    """``_ring_ok`` against the mask ``dsm_tpu.ops.attention.
    attend_global_split_q`` builds from the JAX plan."""
    b, window = 2, c - 3
    pos = w + wraps * c
    valid = np.random.default_rng(pos).uniform(size=(b, c)) < 0.8
    jplan = jattn.global_ring_plan(jnp.int32(pos), c, t)
    k_pos, q_pos = jplan["k_pos"][None, :], jplan["q_pos"][None, :]
    ok = ((k_pos[:, None, :] >= 0) & (k_pos[:, None, :] <= q_pos[:, :, None])
          & (q_pos[:, :, None] - k_pos[:, None, :] < window))
    j = jnp.arange(c)
    stale = jnp.zeros((c,), bool)
    for ti in range(t):
        stale = stale | (j == jplan["w"][ti])
    want = ok & ~stale[None, None, :] & jnp.asarray(valid)[:, None, :]
    got = tattn._ring_ok(tattn.global_ring_plan(tick(pos), c, t), torch.from_numpy(valid),
                         window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# transformer.step on the device position, every route, over a wrap
# ---------------------------------------------------------------------------

STEP_ROUTES = {  # route -> (config fields, T, dtype, kv_bits, fused_attn, DSM_FUSED_ATTN)
    "codec-bf16-T2": (dict(d_model=512, num_heads=8, dim_feedforward=256, context=30,
                           gating=False, norm="layer_norm", layer_scale=0.5),
                      2, "bfloat16", None, None, None),
    "int8-fused": (dict(d_model=1024, num_heads=8, dim_feedforward=256, context=250),
                   1, "bfloat16", 8, None, None),
    "int8-split": (dict(d_model=1024, num_heads=8, dim_feedforward=256, context=250),
                   1, "bfloat16", 8, False, "0"),
    "int4": (dict(d_model=1024, num_heads=8, dim_feedforward=256, context=250),
             1, "bfloat16", 4, None, None),
}


@pytest.mark.parametrize("route", list(STEP_ROUTES))
def test_step_on_the_device_position_matches_the_jitted_jax_step(jax_kernels, monkeypatch,
                                                                 route):
    fields, t, dtype, kv_bits, fused_attn, env = STEP_ROUTES[route]
    if env is not None:
        monkeypatch.setenv("DSM_FUSED_ATTN", env)
    cfg = jT.TransformerConfig(num_layers=2, **fields)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    params = jT.init(cfg, jax.random.PRNGKey(3), dtype=jdt)
    pt = to_port({"transformer": params})["transformer"]
    tcfg = _fields(tT.TransformerConfig, cfg, fused_attn=fused_attn)
    b = 2
    quant = kv_bits is not None
    if quant:
        sj = jT.init_state(cfg, b, jdt, kv_quant=True, kv_bits=kv_bits)
        st = tT.init_state(tcfg, b, kv_quant=True, kv_bits=kv_bits)
    else:
        sj = jT.init_state(cfg, b, jdt, step_t=t)
        st = tT.init_state(tcfg, b, tdt, step_t=t)
    cap = st["valid"].shape[1]
    assert isinstance(st["pos"], torch.Tensor) and st["pos"].dtype == torch.int32
    start = cap - 3 * t  # a few rows before the ring's end: it wraps at step 3
    sj["pos"] = jnp.int32(start)
    st["pos"].fill_(start)
    jstep = JitStep(cfg)
    rng = np.random.default_rng(5)
    tol = 3e-2
    for i in range(12):
        x = (rng.standard_normal((b, t, cfg.d_model)) * 0.3).astype(np.float32)
        m = np.array([True, i % 3 != 0]) if i >= 2 else None
        if i == 7:
            reset = np.array([False, True])
            sj = jT.reset_state(sj, jnp.asarray(reset))
            st = tT.reset_state(st, torch.from_numpy(reset))
        yj, sj = jstep(params, sj, jnp.asarray(x).astype(jdt),
                       None if m is None else jnp.asarray(m))
        yt, st = tT.step(tcfg, pt, st, torch.from_numpy(x).to(tdt),
                         None if m is None else torch.from_numpy(m))
        assert isinstance(st["pos"], torch.Tensor) and st["pos"].dim() == 0
        assert st["pos"].dtype == torch.int32 and int(st["pos"]) == int(sj["pos"])
        np.testing.assert_allclose(as_np(yt), as_np(yj), atol=tol, rtol=tol)
        np.testing.assert_array_equal(st["valid"].numpy(), np.asarray(sj["valid"]))
    assert int(st["pos"]) == start + 12 * t > cap
    layer_t, layer_j = st["layers"][0], sj["layers"][0]  # the same input on both sides
    for key in ("k", "v"):
        if not quant:
            np.testing.assert_allclose(as_np(layer_t[key]), as_np(layer_j[key]), atol=tol,
                                       rtol=tol)
            continue
        got, want = layer_t[key].numpy(), np.asarray(layer_j[key])
        if kv_bits == 8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        else:  # packed nibbles: each value within one step
            for shift in (0, 4):
                diff = np.abs(((got >> shift) & 15).astype(np.int32)
                              - ((want >> shift) & 15).astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    if quant:
        for key in ("ks", "vs"):
            np.testing.assert_allclose(layer_t[key].numpy(), np.asarray(layer_j[key]),
                                       rtol=1e-2, atol=0)


# ---------------------------------------------------------------------------
# The fixed-buffer ASR step
# ---------------------------------------------------------------------------


def _small_asr(kv_quant: bool):
    """An ASR config at small widths: 2 LM layers (8 heads x 128 over a
    256-row ring with ``kv_quant``, else 2 heads x 64 over 64 f32 rows), the
    small codec (its ring wraps), semantic-VAD heads."""
    if kv_quant:
        tcfg = jT.TransformerConfig(d_model=1024, num_heads=8, num_layers=2,
                                    dim_feedforward=256, context=250)
    else:
        tcfg = jT.TransformerConfig(d_model=128, num_heads=2, num_layers=2,
                                    dim_feedforward=256, context=40)
    lm = jLM.LmConfig(transformer=tcfg, text_in_vocab_size=17, text_out_vocab_size=16,
                      audio_vocab_size=33, audio_codebooks=4, extra_heads=(2, 3),
                      depformer=None)
    mimi_cfg = small_mimi_cfg()
    jcfg = jASR.AsrConfig(lm=lm, mimi=mimi_cfg, asr_delay_in_tokens=3, temperature=0.7,
                          kv_quant=kv_quant)
    key = jax.random.PRNGKey(0)
    params = {"lm": jLM.init(lm, key), "mimi": jMIMI.init(mimi_cfg, jax.random.fold_in(key, 1))}
    tcfg = _fields(tASR.AsrConfig, jcfg, lm=port_lm_cfg(lm), mimi=port_mimi_cfg(mimi_cfg))
    return jcfg, tcfg, params


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


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "int8"])
def test_step_in_place_equals_step_over_a_wrap(kv_quant):
    """The body the engine captures: ``step`` with its state written back
    into the same buffers.  Both rings start a few rows before their end."""
    _, cfg, params = _small_asr(kv_quant)
    pt = to_port(params)
    b = 3
    state = tASR.init_state(cfg, b, torch.float32)
    for t_state, t in ((state["lm"]["t"], 1), (state["mimi_enc"]["enc_t"], 2)):
        t_state["pos"].fill_(t_state["valid"].shape[1] - 4 * t)
    ref = _clone(state)
    ptrs = [x.data_ptr() for x in _tensors(state)]
    rng = np.random.default_rng(2)
    seeds = torch.tensor([5, 6, 7])
    for i in range(10):
        pcm = torch.from_numpy((rng.standard_normal((b, 1, cfg.mimi.frame_size)) * 0.1)
                               .astype(np.float32))
        mask = torch.from_numpy(rng.uniform(size=b) < 0.8)
        reset = torch.from_numpy(np.array([i == 4, False, i in (0, 6)]))
        got = tASR.step_in_place(cfg, pt, state, pcm, mask, reset, seeds=seeds)
        want, ref = tASR.step(cfg, pt, ref, pcm, mask, reset, seeds=seeds)
        for key in want:
            assert torch.equal(got[key], want[key]), key
        assert [x.data_ptr() for x in _tensors(state)] == ptrs
    for a, r in zip(_tensors(state), _tensors(ref)):
        assert a.dtype == r.dtype and torch.equal(a, r)
    assert int(state["lm"]["t"]["pos"]) > state["lm"]["t"]["valid"].shape[1]
    enc_t = state["mimi_enc"]["enc_t"]
    assert int(enc_t["pos"]) > enc_t["valid"].shape[1]


def test_step_in_place_refuses_a_state_of_another_shape():
    _, cfg, params = _small_asr(False)
    state = tASR.init_state(cfg, 3, torch.float32)
    other = tASR.init_state(cfg, 2, torch.float32)
    pcm = torch.zeros(2, 1, cfg.mimi.frame_size)
    on = torch.ones(2, dtype=torch.bool)
    _, new = tASR.step(cfg, to_port(params), other, pcm, on, on,
                       seeds=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="does not fit"):
        tASR._copy_into(state, new)


def test_cpu_engine_has_no_graph():
    _, cfg, params = _small_asr(False)
    eng = BatchedAsrEngine(cfg, to_port(params), batch_size=2, device="cpu")
    assert eng.cuda_graph is False
    with pytest.raises(ValueError, match="no CUDA graph"):
        BatchedAsrEngine(cfg, to_port(params), batch_size=2, device="cpu", cuda_graph=True)


def _serve_past_the_wrap(eng, frame):
    """Three streams with markers, one of them then in a reused slot, long
    enough that the engine steps past a wrap of its 64-row LM ring."""
    log = {i: [] for i in range(4)}
    eng.warmup()
    chans = {}
    for i in range(3):
        chans[i] = eng.open_channel(log[i].append, seed=10 + i)
        chans[i].push_pcm(_pcm(i, 30 + 4 * i, frame))
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
    eng.flush()
    return {i: [(e.step_idx, [(type(w).__name__, getattr(w, "tokens", None),
                               getattr(w, "start_time", None), getattr(w, "stop_time", None))
                              for w in e.words], list(e.markers)) for e in evs]
            for i, evs in log.items()}


def test_cpu_engine_matches_the_jax_engine_past_a_ring_wrap():
    """f32, tokens drawn from per-slot seeded streams: the port's engine on
    bridged weights gives the JAX engine's events, its tick a tensor that
    has passed the ring's 64 rows."""
    jcfg, tcfg, params = _small_asr(False)
    ej = JaxEngine(jcfg, params, batch_size=3, fill_gate_frac=0.0, use_native_packer=False)
    et = BatchedAsrEngine(tcfg, to_port(params), batch_size=3, device="cpu", fill_gate_frac=0.0)
    frame = jcfg.mimi.frame_size
    got, want = _serve_past_the_wrap(et, frame), _serve_past_the_wrap(ej, frame)
    assert got == want
    markers = [m for evs in got.values() for e in evs for m in e[2]]
    assert sorted(markers) == [100, 101, 102, 103]
    assert any(e[1] for evs in got.values() for e in evs), "no word came out"
    pos = et.state["lm"]["t"]["pos"]
    assert isinstance(pos, torch.Tensor) and int(pos) == int(ej.state["lm"]["t"]["pos"]) > 64
    np.testing.assert_array_equal(et.state["text_token"].numpy(),
                                  np.asarray(ej.state["text_token"]))
