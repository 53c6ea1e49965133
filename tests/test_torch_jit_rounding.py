"""The port's rounding against the JAX step as its engines run it: under
``jax.jit``, on the CPU, bit for bit.

The JAX engines and the goldens run their steps under ``jax.jit``.  There
XLA folds a division by a constant into a product with the constant's f32
reciprocal, contracts ``x1*c - x2*s`` into one fused multiply-add and folds
``rope_cos_sin``'s frequencies as a constant computed in f64.  Run op by op,
JAX divides, rounds each product and takes ``pow`` in f32.  The port follows
the jitted form on every device, so each check here calls the JAX function
under ``jax.jit`` and holds the port to it bit for bit, on rows chosen where
a reciprocal misses the quotient (a division would fail each of them, which
each test also checks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsm_tpu.ops import attention as jattn
from dsm_tpu.ops import qmm as jqmm
from dsm_tpu.ops import sampling as jS
from dsm_tpu.ops import transformer as jT
from dsm_tpu_torch.ops import attention as tattn
from dsm_tpu_torch.ops import qmm as tqmm
from dsm_tpu_torch.ops import sampling as tS
from dsm_tpu_torch.ops import transformer as tT

torch.set_num_threads(2)


def _bits(x) -> np.ndarray:
    """An array's bits as integers (a NaN's too), floats as their raw
    words, so that equal means bit for bit."""
    if isinstance(x, torch.Tensor):
        x = x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    else:
        x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_same_bits(got, want, what=""):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape, what
    differ = int((g != w).sum())
    assert differ == 0, f"{what}: {differ} of {g.size} differ"


def _misses(qmax, n, seed, bf16=False):
    """``n`` amaxes in [0.5, 4) where ``amax * fl(1/qmax)`` and ``amax /
    qmax`` differ in f32 (bf16-exact ones with ``bf16``: a few dozen,
    repeated)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 4.0, 200_000).astype(np.float32)
    if bf16:
        a = torch.from_numpy(a).bfloat16().float().numpy()
    recip = np.float32(1) / np.float32(qmax)
    a = rng.permutation(np.unique(a[a * recip != a / np.float32(qmax)]))
    assert len(a) >= 8
    return np.resize(a, n)


def _rows(qmax, shape, seed, bf16=False):
    """f32 rows of ``shape`` (last dim the row), each row's amax one of
    :func:`_misses` at a random place and sign, the other values within
    0.45 of it."""
    rng = np.random.default_rng(seed)
    n, dh = int(np.prod(shape[:-1])), shape[-1]
    amax = _misses(qmax, n, seed, bf16)
    x = rng.uniform(-0.45, 0.45, (n, dh)).astype(np.float32) * amax[:, None]
    x[np.arange(n), rng.integers(0, dh, n)] = amax * rng.choice([-1.0, 1.0], n).astype(np.float32)
    if bf16:
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x.reshape(shape)


def _both(x, bf16):
    dt = jnp.bfloat16 if bf16 else jnp.float32
    j = jnp.asarray(x).astype(dt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16 if bf16 else torch.float32)


def _divided_scales(x, qmax):
    """The per-row scales a true division would give: ``max(amax, 1e-8) / qmax``."""
    amax = np.abs(np.asarray(x, np.float32)).max(-1)
    return np.maximum(amax, np.float32(1e-8)) / np.float32(qmax)


# ---------------------------------------------------------------------------
# Divisions by a constant: a product with the f32 reciprocal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("packed4", [False, True], ids=["int8", "int4"])
def test_quantize_kv_rows_match_the_jitted_step(bf16, packed4):
    qmax = 7.0 if packed4 else 127.0
    (jk, tk), (jv, tv) = (_both(_rows(qmax, (4, 8, 2, 64), seed, bf16), bf16)
                          for seed in (1, 2))
    fj = jattn.quantize_kv_rows_packed4 if packed4 else jattn.quantize_kv_rows
    ft = tattn.quantize_kv_rows_packed4 if packed4 else tattn.quantize_kv_rows
    want = jax.jit(fj)(jk, jv)
    got = ft(tk, tv)
    for what, g, w in zip(("kq", "vq", "ks", "vs"), got, want):
        _assert_same_bits(g, w, what)
    # Every scale is one a division would miss.
    assert (_bits(got[2]) != _bits(_divided_scales(tk.float().numpy(), qmax))).all()


def test_quantize_ca_kv_matches_the_jitted_step():
    """The voice source ``(L, B, H, S, Dh)`` with S = 70 rows, padded to
    128 by both sides."""
    k, v = (_rows(127.0, (2, 2, 4, 70, 32), seed) for seed in (3, 4))
    want = jax.jit(jT.quantize_ca_kv)((jnp.asarray(k), jnp.asarray(v)))
    got = tT.quantize_ca_kv((torch.from_numpy(k), torch.from_numpy(v)))
    for key in ("k", "v", "ks", "vs"):
        _assert_same_bits(got[key], want[key], key)
    assert got["s_len"] == int(want["s_len"]) == 70
    assert (_bits(got["ks"][..., :70]) != _bits(_divided_scales(k, 127.0))).all()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_mm_w8a8_matches_the_jitted_step(bf16):
    rng = np.random.default_rng(5)
    xj, xt = _both(_rows(127.0, (48, 256), 5, bf16), bf16)
    wq = rng.integers(-127, 128, (64, 256)).astype(np.int8)
    s = (rng.uniform(size=64) * 1e-2).astype(np.float32)
    want = jax.jit(jqmm.mm_w8a8)(xj, jnp.asarray(wq), jnp.asarray(s))
    got = tqmm.mm_w8a8(xt, torch.from_numpy(wq), torch.from_numpy(s))
    _assert_same_bits(got, want)
    if bf16:
        return  # one f32 step of a scale seldom survives the output's bf16 rounding
    # Dividing the activations' scales changes the f32 output.
    xs = np.maximum(_divided_scales(xt.float().numpy(), 127.0), np.float32(1e-8))[:, None]
    xq = np.clip(np.round(xt.float().numpy() / xs), -127, 127).astype(np.int64)
    divided = (xq @ wq.T.astype(np.int64)).astype(np.float32) * xs * s[None, :]
    assert (_bits(got) != divided.view(np.int32)).any()


def _scaling_decides(temperature, n, seed):
    """Rows of logits ``(n, 4)`` whose token is decided by the rounding of
    ``logits / T`` alone: two neighbouring f32 values near 1e30 (where the
    Gumbel noise vanishes in the sum) that tie after one of ``* fl(1/T)`` and
    ``/ T`` and not after the other; the argmax takes the first of a tie."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(1e30, 2e30, 400_000).astype(np.float32)
    b = np.nextafter(a, np.float32(np.inf))
    r = np.float32(1) / np.float32(temperature)
    t = np.float32(temperature)
    pick = ((a * r) == (b * r)) != ((a / t) == (b / t))
    assert pick.sum() >= n
    a, b = a[pick][:n], b[pick][:n]
    return np.stack([a, b, np.full(n, -1e30, np.float32), np.zeros(n, np.float32)], -1)


@pytest.mark.parametrize("temperature,top_k", [(0.7, None), (1.3, None), (0.8, 3)])
def test_sample_matches_the_jitted_step(temperature, top_k):
    logits = _scaling_decides(temperature, 64, seed=int(temperature * 10))
    cfg_j, cfg_t = jS.SamplingConfig(temperature, top_k), tS.SamplingConfig(temperature, top_k)
    want = jax.jit(jS.sample, static_argnums=0)(cfg_j, jnp.asarray(logits),
                                                jax.random.PRNGKey(3))
    got = tS.sample(cfg_t, torch.from_numpy(logits), tS.prng_key(3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    divided = np.argmax(logits / np.float32(temperature), -1)
    assert (got.numpy() != divided).all()


# ---------------------------------------------------------------------------
# The rotary embedding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim,max_period", [(64, 10_000.0), (128, 10_000.0),
                                                  (128, 100_000.0), (16, 10_000.0)])
def test_rope_cos_sin_matches_the_jitted_step(head_dim, max_period):
    """Positions traced (the step's ``pos`` moves), the frequencies folded."""
    positions = (np.arange(4, dtype=np.int32)[None] + np.array([[0], [7], [3001], [99_996]],
                                                                 np.int32))
    want = jax.jit(lambda p: jattn.rope_cos_sin(p, head_dim, max_period))(jnp.asarray(positions))
    got = tattn.rope_cos_sin(torch.from_numpy(positions), head_dim, max_period)
    for what, g, w in zip(("cos", "sin"), got, want):
        _assert_same_bits(g, w, what)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_apply_rope_matches_the_jitted_step(bf16):
    """The step's rows at the Mimi width, ``(64, 8, 2, 64)``, rotated at
    positions past 3000."""
    rng = np.random.default_rng(6)
    xj, xt = _both(rng.standard_normal((64, 8, 2, 64)).astype(np.float32), bf16)
    positions = np.array([[3001, 3002]], np.int32)
    cj, sj = jax.jit(lambda p: jattn.rope_cos_sin(p, 64, 10_000.0))(jnp.asarray(positions))
    ct, st = tattn.rope_cos_sin(torch.from_numpy(positions), 64, 10_000.0)
    want = jax.jit(jattn.apply_rope)(xj, cj, sj)
    got = tattn.apply_rope(xt, ct, st)
    assert got.dtype == xt.dtype and got.is_contiguous()
    _assert_same_bits(got, want)


def test_apply_rope_plain_form_is_the_fused_one_over_2_20_pairs():
    """The f64 form of :func:`attention.apply_rope` against XLA's fused
    multiply-adds on 2**20 random f32 pairs and angles: 0 differences.  The
    products rounded one by one differ in about a quarter of them."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 1, 1024, 2048)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (1, 1024, 1024))
    c, s = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    want = np.asarray(jax.jit(jattn.apply_rope)(jnp.asarray(x), jnp.asarray(c), jnp.asarray(s)))
    got = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(s))
    _assert_same_bits(got, want)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rounded = x1 * c[:, None] - x2 * s[:, None]
    assert (rounded.view(np.int32) != want[..., 0::2].view(np.int32)).mean() > 0.1


def _wide_rows(d, n, seed):
    """``n`` bf16 rows of width ``d`` with a large dynamic range: magnitudes
    log-uniform over 2^-8 .. 2^8, random signs."""
    rng = np.random.default_rng(seed)
    mag = np.exp2(rng.uniform(-8.0, 8.0, (n, d)))
    return (mag * rng.choice([-1.0, 1.0], (n, d))).astype(np.float32)


@pytest.mark.parametrize("d", [64, 1024, 2048, 2560])
def test_rms_norm_sums_in_the_jitted_steps_order(d):
    """``mean_square`` (the statistic of ``rms_norm``) bit for bit the jitted
    JAX one (XLA:CPU sums in windows of 32, zero-padded at both ends, then
    multiplies by the f32 reciprocal of the width; ``torch.mean`` differs in
    most rows), and the output bit for bit in every row whose ``rsqrt``
    agrees.  XLA:CPU's
    ``rsqrt`` is the x86 approximation refined by two Newton steps, which
    ``torch.rsqrt`` does not reproduce (ROADMAP queue 3): a row where the two
    differ may differ in an element."""
    from dsm_tpu.ops import norm as jN
    from dsm_tpu_torch.ops import norm as tN

    x = _wide_rows(d, 256, seed=d)
    alpha = np.random.default_rng(1).uniform(0.5, 2.0, d).astype(np.float32)
    xj, aj = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(alpha).astype(jnp.bfloat16)
    xt, at = torch.from_numpy(x).bfloat16(), torch.from_numpy(alpha).bfloat16()
    var_j = jax.jit(lambda v: jnp.mean(v.astype(jnp.float32) ** 2, axis=-1))(xj)
    xf = xt.float()
    var_t = tN.mean_square(xf)[:, 0]
    _assert_same_bits(var_t, var_j, "mean square")
    assert (_bits(torch.mean(xf * xf, -1)) != _bits(var_j)).mean() > 0.3  # the order matters
    want = jax.jit(jN.rms_norm)({"alpha": aj}, xj)
    got = tN.rms_norm({"alpha": at}, xt)
    r_j = jax.jit(lambda v: jax.lax.rsqrt(v + 1e-8))(var_j)
    same_scale = _bits(torch.rsqrt(var_t + 1e-8)) == _bits(r_j)
    assert same_scale.mean() > 0.5
    _assert_same_bits(got[torch.from_numpy(same_scale)], np.asarray(want)[same_scale], "rows")


def _blocked_fma_dot(x: torch.Tensor, w: torch.Tensor, kc: int) -> torch.Tensor:
    """``x (M, K) @ w (K, N)`` in f32 as a GEMM of Eigen's form sums: each
    block of ``kc`` columns of K an in-order chain of fused multiply-adds from
    0 (one rounding a step: the f64 product of two bf16 values is exact), the
    blocks' sums added in order."""
    out = torch.zeros(x.shape[0], w.shape[1])
    for s in range(0, x.shape[1], kc):
        acc = torch.zeros_like(out)
        for k in range(s, min(s + kc, x.shape[1])):
            acc = (x[:, k:k + 1].double() * w[k:k + 1].double() + acc.double()).float()
        out = out + acc
    return out


@pytest.mark.parametrize("m,k,n", [(16, 1024, 3072), (64, 2048, 2048)])
def test_the_jitted_bf16_dot_is_an_f32_gemm_rounded_once(m, k, n):
    """The finding behind ROADMAP queue 3 item 2, held: XLA:CPU's jitted bf16
    product is the f32 product of the upcast operands rounded once to bf16,
    and that f32 product is summed as Eigen's GEMM sums it (in-order
    fused multiply-add chains over blocks of K, the blocks added in order;
    the block follows Eigen's cache-size rule, so the test finds it among
    256-1024).  Torch's bf16 product takes another order and misses some
    elements; the port keeps it (a K-step loop a product would be the fix).
    ``pytest -s`` prints the counts."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32)).astype(jnp.bfloat16)
    w = jnp.asarray((rng.standard_normal((k, n)) * 0.02).astype(np.float32)).astype(jnp.bfloat16)
    bf16 = jax.jit(lambda a, b: a @ b)(x, w)
    f32 = jax.jit(lambda a, b: jnp.dot(a.astype(jnp.float32), b.astype(jnp.float32)))(x, w)
    _assert_same_bits(torch.from_numpy(np.asarray(f32)).bfloat16(), bf16, "rounded once")
    xt = torch.from_numpy(np.array(x.astype(jnp.float32)))
    wt = torch.from_numpy(np.array(w.astype(jnp.float32)))
    differ = {kc: int((_bits(_blocked_fma_dot(xt, wt, kc)) != _bits(f32)).sum())
              for kc in (256, 512, 1024)}
    torch_bf16 = int((_bits(xt.bfloat16() @ wt.bfloat16()) != _bits(bf16)).sum())
    print(f"\n({m},{k})x({k},{n}): f32 elements off the blocked order by block {differ}; "
          f"torch's bf16 product off the jitted one in {torch_bf16} of {m * n}")
    assert min(differ.values()) == 0
    assert torch_bf16 > 0
