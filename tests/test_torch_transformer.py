"""The port's streaming transformer step against the JAX package's, with
the JAX init's weights carried over by the bridge.

* int8 KV rings (the LM's serving profile), bf16, T=1, Dh=128: the JAX
  step takes its fused Pallas kernels in interpret mode; the port its
  plain kernel versions.  Outputs within 3e-2 (the bar of
  tests/test_decode_attn.py for kernel against XLA paths); the first
  layer's rings bit for bit, deeper rings dequantised within 3e-2.
* bf16/f32 rings at T=2, as in the Mimi codec transformer, f32: 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dsm_tpu.ops import transformer as jT
from dsm_tpu_torch.ops import transformer as tT
from tests.test_torch_ops import JitStep, as_np, to_port

torch.set_num_threads(2)


def _tcfg(cfg):
    # Every field the JAX config has; the port's own (fused_attn) keep their defaults.
    return tT.TransformerConfig(**{f: getattr(cfg, f)
                                   for f in tT.TransformerConfig.__dataclass_fields__
                                   if hasattr(cfg, f)})


def test_step_int8_rings_matches_jax_fused_kernels(monkeypatch):
    monkeypatch.setenv("DSM_RING_KERNEL", "1")
    monkeypatch.setenv("DSM_DECODE_ATTN", "1")
    cfg = jT.TransformerConfig(d_model=1024, num_heads=8, num_layers=2,
                               dim_feedforward=512, context=250)
    params = jT.init(cfg, jax.random.PRNGKey(3), dtype=jnp.bfloat16)
    pt = to_port({"transformer": params})["transformer"]
    b = 2
    sj = jT.init_state(cfg, b, jnp.bfloat16, kv_quant=True)
    st = tT.init_state(_tcfg(cfg), b, kv_quant=True)
    assert st["valid"].shape == sj["valid"].shape == (b, 256)
    rng = np.random.default_rng(4)
    masks = [None, None, np.array([True, False]), None]
    jstep = JitStep(cfg)
    for i, m in enumerate(masks):
        x = (rng.standard_normal((b, 1, 1024)) * 0.3).astype(np.float32)
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        yj, sj = jstep(params, sj, xj, None if m is None else jnp.asarray(m))
        yt, st = tT.step(_tcfg(cfg), pt, st, xt, None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(as_np(yt), as_np(yj), atol=3e-2, rtol=3e-2)
    assert st["pos"] == int(sj["pos"]) == len(masks)
    np.testing.assert_array_equal(st["valid"].numpy(), np.asarray(sj["valid"]))
    # Layer 0 sees the same input on both sides: its rings match bit for
    # bit.  Deeper layers see inputs a bf16 step apart, so a K/V value may
    # quantise to a neighbouring int8: compare the dequantised rows.
    for key in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(st["layers"][0][key].numpy(),
                                      np.asarray(sj["layers"][0][key]))
    for lj, lt in zip(sj["layers"][1:], st["layers"][1:]):
        for key in ("k", "v"):
            deq_t = lt[key].numpy() * lt[key + "s"].numpy()[..., None]
            deq_j = np.asarray(lj[key], np.float32) * np.asarray(lj[key + "s"])[..., None]
            np.testing.assert_allclose(deq_t, deq_j, atol=3e-2, rtol=0)


def test_step_float_rings_t2_matches_jax():
    """The codec transformer's shape family: LayerNorm, GELU MLP, layer
    scale, 2 frames per step, ring rounded up to 32 rows."""
    cfg = jT.TransformerConfig(d_model=64, num_heads=4, num_layers=2,
                               dim_feedforward=256, context=20, gating=False,
                               norm="layer_norm", layer_scale=0.5)
    params = jT.init(cfg, jax.random.PRNGKey(5))
    pt = to_port({"transformer": params})["transformer"]
    b = 3
    sj = jT.init_state(cfg, b, jnp.float32, step_t=2)
    st = tT.init_state(_tcfg(cfg), b, torch.float32, step_t=2)
    rng = np.random.default_rng(6)
    jstep = jax.jit(lambda s, x, m: jT.step(cfg, params, s, x, m))
    for i in range(20):  # 40 rows through a 32-row ring: it wraps
        x = rng.standard_normal((b, 2, 64)).astype(np.float32)
        m = rng.uniform(size=b) < 0.8
        if i == 10:
            r = np.array([True, False, False])
            sj = jT.reset_state(sj, jnp.asarray(r))
            st = tT.reset_state(st, torch.from_numpy(r))
        yj, sj = jstep(sj, jnp.asarray(x), jnp.asarray(m))
        yt, st = tT.step(_tcfg(cfg), pt, st, torch.from_numpy(x), torch.from_numpy(m))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4, rtol=1e-4)
    for lj, lt in zip(sj["layers"], st["layers"]):
        np.testing.assert_allclose(lt["k"].numpy(), np.asarray(lj["k"]), atol=1e-4, rtol=1e-4)


def test_capacity_rounding_matches_jax():
    for ctx, t, q in [(750, 1, True), (250, 2, False), (16, 2, False), (32, 1, False)]:
        cfg = jT.TransformerConfig(d_model=16, num_heads=2, num_layers=1,
                                   dim_feedforward=32, context=ctx)
        sj = jT.init_state(cfg, 1, step_t=t, kv_quant=q)
        assert tT.capacity(_tcfg(cfg), t, q) == sj["valid"].shape[1]
