"""The quantise-and-commit wrappers (``ring_kernels.quantize_commit`` and
``quantize_scale_commit``, the step's path for TPU kernels 4 and 1) against
the JAX package, at small sizes, on the CPU.

* ``quantize_commit_plain`` against ``attention.quantize_kv_rows`` (or
  ``quantize_kv_rows_packed4`` for a uint8 ring) followed by the Pallas
  ``_ring_commit_q`` in interpret mode, and ``quantize_scale_commit_plain``
  against ``quantize_kv_rows`` followed by ``_scale_commit``: all four rings
  and the returned int8 rows bit for bit, at w = 0, a middle row and C - 1,
  with V a strided view of the QKV product as ``transformer._qkv`` gives it,
  on rows that sit on rounding ties, rows at +-amax, an all-zero row (scale
  1e-8 * fl(1/qmax)) and a row holding a NaN (its scale NaN on both sides).
  The JAX quantisation runs under ``jax.jit``, as in the JAX step.
* ``transformer.step`` over 12 steps at h = 8 for the three ``fused_attn``
  settings and ``kv_bits = 4`` against the jitted JAX step through its Pallas
  kernels: outputs within 3e-2 (two layers of bf16 matmuls between the
  attention calls), layer 0's rings bit for bit, both sides' routes counted:
  the new wrappers on the port's side and no ``scale_commit`` or
  ``ring_commit_q`` call.  The CUDA kernels are held against the plain
  versions in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.ops import attention as jattn
from dsm_tpu.ops import decode_attn as jda
from dsm_tpu.ops import ring_kernels as jrk
from dsm_tpu.ops import transformer as jT
from dsm_tpu_torch.ops import decode_attn as tda
from dsm_tpu_torch.ops import ring_kernels as trk
from dsm_tpu_torch.ops import transformer as tT
from tests.test_torch_ops import JitStep, as_np, to_port
from tests.test_torch_stt26 import _Counts
from tests.test_torch_tts import _fields

torch.set_num_threads(2)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package takes its Pallas kernels (interpret mode on the CPU)."""
    monkeypatch.setenv("DSM_RING_KERNEL", "1")
    monkeypatch.setenv("DSM_DECODE_ATTN", "1")
    for var in ("DSM_FUSED_ATTN", "DSM_KERNELS", "DSM_KV_BITS"):
        monkeypatch.delenv(var, raising=False)


def _rows(b, h, dh, qmax, seed):
    """f32 rows ``(B, H, 1, Dh)`` of spread 0-3, exact in bf16, with a row
    of ties (amax ``qmax``: scale 1, values k + 0.5), a row of +-amax, an
    all-zero row and a row holding a NaN."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b * h, dh)) * rng.uniform(0.1, 3.0, (b * h, 1))).astype(np.float32)
    x[0] = 0.0
    x[1] = np.resize(np.float32([0.5, 1.5, 2.5, -0.5, -1.5, -3.5]), dh)
    x[1, 5] = qmax
    x[2] = np.where(np.arange(dh) % 2 == 0, 1.0, -1.0) * np.abs(x[2]).max()
    x[3, dh // 3] = np.nan
    x = torch.from_numpy(x.reshape(b, h, 1, dh)).bfloat16()
    return x.float().numpy()


def _fresh(b, h, dh, qmax, seed):
    """The same K and V rows for both sides: jnp bf16 arrays, and the
    port's K contiguous with its V a strided view of a QKV product ``(B, 1,
    3, H, Dh)``."""
    k, v = _rows(b, h, dh, qmax, seed), _rows(b, h, dh, qmax, seed + 1)
    qkv = torch.zeros(b, 1, 3, h, dh, dtype=torch.bfloat16)
    qkv[:, 0, 2] = torch.from_numpy(v[:, :, 0]).bfloat16()
    tv = qkv[:, :, 2].transpose(1, 2)
    assert not tv.is_contiguous()
    return ((jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)),
            (torch.from_numpy(k).bfloat16(), tv))


def _rings(b, h, c, row_bytes, packed4, seed):
    rng = np.random.default_rng(seed)
    lo, hi, dt = (0, 256, np.uint8) if packed4 else (-127, 128, np.int8)
    rings = [rng.integers(lo, hi, (b, h, c, row_bytes)).astype(dt) for _ in range(2)]
    rings += [rng.uniform(size=(b, h, c)).astype(np.float32) for _ in range(2)]
    return rings


def _assert_same(got, want):
    """Bit for bit (``assert_array_equal`` takes a NaN as equal to a NaN)."""
    want = np.asarray(want)
    assert got.dtype == {np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
                         np.dtype(np.float32): torch.float32}[want.dtype]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("packed4", [False, True], ids=["int8", "uint8"])
@pytest.mark.parametrize("B,H,C,Dh", [(2, 4, 64, 128), (2, 8, 32, 64)])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_quantize_commit_plain_matches_quantize_and_ring_commit_q(B, H, C, Dh, packed4, where):
    w = {"first": 0, "middle": C // 2 + 1, "last": C - 1}[where]
    qmax = 7.0 if packed4 else 127.0
    (jk, jv), (tk, tv) = _fresh(B, H, Dh, qmax, seed=C + Dh)
    rings = _rings(B, H, C, Dh // 2 if packed4 else Dh, packed4, seed=w)
    if packed4:
        kq, vq, ks, vs = jax.jit(jattn.quantize_kv_rows_packed4)(jk, jv)
    else:
        kq, vq, ks, vs = jax.jit(jattn.quantize_kv_rows)(jk, jv)
    want = jrk._ring_commit_q(*map(jnp.asarray, rings), kq, vq, ks, vs,
                              jnp.asarray([w], jnp.int32), interpret=True)
    got = [torch.from_numpy(x.copy()) for x in rings]
    trk.quantize_commit_plain(tk, tv, *got, w)
    for g, ref in zip(got, want):
        _assert_same(g, ref)
    assert np.isnan(np.asarray(ks)).sum() == 1 and np.isnan(got[2][:, :, w].numpy()).sum() == 1
    # The all-zero row's scale: the floor times fl(1/qmax), as under jax.jit.
    assert float(got[2][0, 0, w]) == np.float32(1e-8) * (np.float32(1) / np.float32(qmax))
    keep = np.arange(C) != w
    for g, ring in zip(got, rings):
        np.testing.assert_array_equal(g.numpy()[:, :, keep], ring[:, :, keep])
    before = trk.quantize_commit.launches
    again = [torch.from_numpy(x.copy()) for x in rings]
    # CPU tensors: the plain version, no launch; the position a 0-d int32 tensor.
    trk.quantize_commit(tk, tv, *again, torch.tensor(w, dtype=torch.int32))
    assert trk.quantize_commit.launches == before
    for g, ref in zip(again, got):
        _assert_same(g, ref.numpy())


@pytest.mark.parametrize("B,H,C,Dh", [(2, 8, 256, 128), (2, 8, 128, 64)])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_quantize_scale_commit_plain_matches_quantize_and_scale_commit(B, H, C, Dh, where):
    w = {"first": 0, "middle": C // 2 - 3, "last": C - 1}[where]
    (jk, jv), (tk, tv) = _fresh(B, H, Dh, 127.0, seed=C + w)
    rings = _rings(B, H, C, Dh, False, seed=w)[2:]
    kq, vq, ks, vs = jax.jit(jattn.quantize_kv_rows)(jk, jv)
    want = jrk._scale_commit(*map(jnp.asarray, rings), ks, vs, jnp.asarray([w], jnp.int32),
                             interpret=True)
    got = [torch.from_numpy(x.copy()) for x in rings]
    tkq, tvq = trk.quantize_scale_commit_plain(tk, tv, *got, w)
    _assert_same(tkq, kq)
    _assert_same(tvq, vq)
    for g, ref in zip(got, want):
        _assert_same(g, ref)
    before = trk.quantize_scale_commit.launches
    again = [torch.from_numpy(x.copy()) for x in rings]
    rows = trk.quantize_scale_commit(tk, tv, *again,
                                     torch.tensor(w, dtype=torch.int32))  # CPU: the plain version
    assert trk.quantize_scale_commit.launches == before
    for g, ref in zip(list(rows) + again, [tkq, tvq] + got):
        _assert_same(g, ref.numpy())


@pytest.mark.parametrize("fused_attn,kv_bits,env,jax_route,port_route", [
    (None, 8, None, ("_decode_attend_commit_q_4d", "_scale_commit"),
     ("quantize_scale_commit", "decode_attend_commit")),
    (True, 8, "1", ("_decode_attend_commit_q_4d", "_scale_commit"),
     ("quantize_scale_commit", "decode_attend_commit")),
    (False, 8, "0", ("_decode_attend_q_4d", "_ring_commit_q"),
     ("quantize_commit", "decode_attend")),
    (None, 4, None, ("_decode_attend_q4_4d", "_ring_commit_q"),
     ("quantize_commit", "decode_attend"))])
def test_step_quantises_in_the_commit(jax_kernels, monkeypatch, fused_attn, kv_bits, env,
                                      jax_route, port_route):
    """12 steps at h = 8, Dh = 128, a mask from step 3 and slot 1 reset at
    step 7, against the JAX step through its Pallas kernels."""
    if env is not None:
        monkeypatch.setenv("DSM_FUSED_ATTN", env)
    d, heads, b = 1024, 8, 2
    cfg = jT.TransformerConfig(d_model=d, num_heads=heads, num_layers=2, dim_feedforward=256,
                               context=250)
    params = jT.init(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    pt = to_port({"transformer": params})["transformer"]
    tcfg = _fields(tT.TransformerConfig, cfg, fused_attn=fused_attn)
    sj = jT.init_state(cfg, b, jnp.bfloat16, kv_quant=True, kv_bits=kv_bits)
    st = tT.init_state(tcfg, b, kv_quant=True, kv_bits=kv_bits)
    jcounts = _Counts(monkeypatch, [(jda, "_decode_attend_q4_4d"), (jda, "_decode_attend_q_4d"),
                                    (jda, "_decode_attend_commit_q_4d"),
                                    (jrk, "_ring_commit_q"), (jrk, "_scale_commit")])
    tcounts = _Counts(monkeypatch, [(trk, "quantize_commit"), (trk, "quantize_scale_commit"),
                                    (trk, "scale_commit"), (trk, "ring_commit_q"),
                                    (trk, "ring_commit"), (tda, "decode_attend"),
                                    (tda, "decode_attend_commit")])
    rng = np.random.default_rng(1)
    steps = 12
    jstep = JitStep(cfg)
    for i in range(steps):
        x = (rng.standard_normal((b, 1, d)) * 0.3).astype(np.float32)
        m = np.array([True, i % 3 != 0]) if i >= 3 else None
        if i == 7:
            reset = np.array([False, True])
            sj = jT.reset_state(sj, jnp.asarray(reset))
            st = tT.reset_state(st, torch.from_numpy(reset))
        yj, sj = jstep(params, sj, jnp.asarray(x).astype(jnp.bfloat16),
                       None if m is None else jnp.asarray(m))
        yt, st = tT.step(tcfg, pt, st, torch.from_numpy(x).to(torch.bfloat16),
                         None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(as_np(yt), as_np(yj), atol=3e-2, rtol=3e-2)
    n, nj = 2 * steps, 2 * jstep.traces  # the JAX side counts its kernels per trace
    assert jcounts.nonzero() == {jax_route[0]: nj, jax_route[1]: nj}
    assert tcounts.nonzero() == {port_route[0]: n, port_route[1]: n}
    np.testing.assert_array_equal(st["valid"].numpy(), np.asarray(sj["valid"]))
    for key in ("k", "v", "ks", "vs"):  # layer 0 sees the same input on both sides
        np.testing.assert_array_equal(st["layers"][0][key].numpy(),
                                      np.asarray(sj["layers"][0][key]))
