"""Token sampling (counterpart of ``dsm_tpu/ops/sampling.py``).

Greedy decoding is ``argmax`` (the first maximum, as ``jnp.argmax``).
Sampling at temperature > 0 is a Gumbel-argmax whose noise is a copy of
``jax.random``'s default generator, threefry-2x32 in its partitionable
form (``jax_threefry_partitionable``, the JAX 0.9 default), so that the
same seeds give the same tokens on both sides:

  * a key is two uint32 words ``(..., 2)``; ``prng_key(seed)`` is
    ``[seed >> 32, seed & 0xFFFFFFFF]`` (0 and the seed for a 32-bit seed);
  * ``fold_in(key, d)`` hashes the counter pair ``(0, d)``;
  * ``split(key, n)`` hashes the counter pairs ``(0, i)``, ``i < n``;
  * 32 random bits at flat index ``i`` of a shape are ``y0 ^ y1`` of the
    hash of ``(i >> 32, i & 0xFFFFFFFF)``;
  * a uniform float in [1, 2) takes the top 23 bits as its mantissa;
    Gumbel noise is ``-log(-log(max(tiny, u - 1 + tiny)))``.

Keys are explicit int64 tensors holding uint32 values; there is no global
generator.  uint32 arithmetic runs in int64 with a 32-bit mask, since
torch has no unsigned 32-bit arithmetic on every device.  The bits and the
Gumbel draws equal ``jax.random``'s on the CPU bit for bit
(tests/test_torch_tts.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .attention import mul_recip

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(torch.finfo(torch.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0
    top_k: Optional[int] = None


# ---------------------------------------------------------------------------
# threefry-2x32, as jax._src.prng
# ---------------------------------------------------------------------------


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 hash (20 rounds) of the counter pairs ``(x0, x1)``
    under the key words ``(k0, k1)``; all int64 holding uint32, broadcast
    against each other.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for one seed or a tensor of seeds:
    ``(..., 2)`` int64 words."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device)
    return torch.stack([(s >> 32) & _M32, s & _M32], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch of keys ``(..., 2)``; ``data`` is
    an int or a tensor broadcast against the batch."""
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64) & _M32
    else:  # a fill on the keys' device: no copy from the host (the tick is captured)
        d = torch.full((), int(data) & _M32, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of one key ``(2,)`` -> ``(num, 2)``."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, shape, row0: int = 0) -> torch.Tensor:
    """32 random bits per element of ``shape`` for each key of ``keys
    (..., 2)``: ``(..., *shape)`` int64 holding uint32, each key's draw
    being ``jax.random.bits(key, shape)``.  ``row0``: the draw is rows
    ``row0 ..`` of a draw with more rows (the leading dim of ``shape``): a
    dp shard's rows of the batch's draw, the bits of the partitionable form
    depending on the flat index alone."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    i = torch.arange(n, dtype=torch.int64, device=keys.device).reshape(shape)
    if row0:
        i = i + row0 * (n // shape[0])
    lead = keys.shape[:-1]
    k0 = keys[..., 0].reshape(*lead, *([1] * len(shape)))
    k1 = keys[..., 1].reshape(*lead, *([1] * len(shape)))
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & _M32)
    return y0 ^ y1


# XLA's f32 log on the CPU: the Cephes polynomial of Eigen's plog, as the
# CPU backend compiles it, with LLVM's fused multiply-adds where a product
# feeds a single add.
_LOG_P = [float.fromhex(h) for h in (
    "0x1.2043760000000p-4", "-0x1.d7a3700000000p-4", "-0x1.fcba9e0000000p-4",
    "0x1.23d37e0000000p-3", "0x1.999d580000000p-3", "-0x1.fffff80000000p-3",
    "0x1.de4a340000000p-4", "-0x1.555ca00000000p-3", "0x1.5555540000000p-2")]
_LOG_Q1 = float.fromhex("-0x1.bd01060000000p-13")
_LOG_Q2 = float.fromhex("0x1.6300000000000p-1")
_SQRTHF = float.fromhex("0x1.6a09e60000000p-1")


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32 (the f64 product of two f32 values
    is exact)."""
    return (a.double() * b + c).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of an f32 tensor with the bits of XLA's CPU ``log``
    (for normal inputs: XLA also flushes subnormal inputs to zero).

    ``torch.log`` rounds differently from XLA's polynomial in about one
    value in seven, which flips Gumbel-argmax draws.  Every step here is an
    IEEE f32 operation or a single-rounding multiply-add, so the result is
    the same on the CPU and the card."""
    xc = torch.clamp(x, min=_TINY)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    e = e - small.float()
    x1 = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    z = x1 * x1
    x3 = z * x1
    p = _LOG_P
    a = _fma(_fma(x1, p[0], p[1]), x1, p[6])
    b = _fma(_fma(x1, p[2], p[3]), x1, p[7])
    c = _fma(_fma(x1, p[4], p[5]), x1, p[8])
    y = _fma(_fma(_fma(a, x3, b), x3, c), x3, e * _LOG_Q1)
    out = _fma(e, _LOG_Q2, (x1 - z * 0.5) + y)
    out = torch.where(x == float("inf"), x, out)
    out = torch.where(x == 0, float("-inf"), out)
    return torch.where((x < 0) | torch.isnan(x), float("nan"), out)


def gumbel(keys: torch.Tensor, shape, row0: int = 0) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode "low") for each key
    of ``keys (..., 2)`` -> ``(..., *shape)`` f32; ``row0`` as
    :func:`random_bits`'s."""
    bits = random_bits(keys, shape, row0)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)  # < 2^31: no overflow
    u = mant.view(torch.float32) - 1.0
    u = torch.clamp(u + _TINY, min=_TINY)
    return -xla_log(-xla_log(u))


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------


def _top_k_mask(logits: torch.Tensor, top_k: Optional[int]) -> torch.Tensor:
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    return logits


def sample(cfg: SamplingConfig, logits: torch.Tensor,
           key: Optional[torch.Tensor] = None, row0: int = 0) -> torch.Tensor:
    """Token ids ``(...,) int32`` from ``logits (..., V)``: greedy at
    temperature <= 0, else Gumbel-argmax of ``logits / T`` over the top-k
    with one key ``(2,)`` for the whole array (``row0``: its rows ``row0 ..``
    of a larger batch's draw, :func:`random_bits`)."""
    if cfg.temperature > 0.0 and key is None:
        raise ValueError("sampling at temperature > 0 needs a key")
    noise = gumbel(key, logits.shape, row0) if cfg.temperature > 0.0 else None
    return sample_with_noise(cfg, logits, noise)


def sample_with_noise(cfg: SamplingConfig, logits: torch.Tensor,
                      noise: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`sample` with its Gumbel draws made ahead by the caller:
    ``noise`` is ``gumbel(key, logits.shape)`` (unused, and may be None, at
    temperature <= 0)."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = _top_k_mask(mul_recip(logits.float(), cfg.temperature), cfg.top_k)
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


def slot_keys(seeds: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Per-slot keys ``fold_in(PRNGKey(seed), step)`` -> ``(B, 2)``."""
    return fold_in(prng_key(seeds.to(torch.int64) & _M32), steps.to(torch.int64))


def fold_keys(keys: torch.Tensor, idx) -> torch.Tensor:
    """Fold a draw index into a batch of keys ``(B, 2) -> (B, 2)``."""
    return fold_in(keys, idx)


def _mix(logits, noise, temperature):
    t = temperature.float().reshape(*temperature.shape, 1)
    stoch = torch.argmax(logits + noise * torch.clamp(t, min=1e-6), dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temperature > 0, stoch, greedy).to(torch.int32)


def sample_per_slot(logits: torch.Tensor, keys: torch.Tensor,
                    temperature: torch.Tensor, top_k: Optional[int] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``logits (B, V)`` with one key per row ``(B, 2)`` and a per-row
    temperature ``(B,)`` (<= 0 rows decode greedily).  ``noise``: the rows'
    Gumbel draws, if the caller made them ahead (``gumbel(keys, (V,))``)."""
    logits = _top_k_mask(logits.float(), top_k)
    if noise is None:
        noise = gumbel(keys, logits.shape[-1:])
    return _mix(logits, noise, temperature)


def sample_dynamic(logits: torch.Tensor, key: torch.Tensor,
                   temperature, top_k: Optional[int] = None, row0: int = 0) -> torch.Tensor:
    """Per-row temperature, one key ``(2,)`` for the whole array (``row0``
    as :func:`sample`'s)."""
    logits = _top_k_mask(logits.float(), top_k)
    t = torch.broadcast_to(torch.as_tensor(temperature, dtype=torch.float32,
                                           device=logits.device),
                           logits.shape[:-1])
    return _mix(logits, gumbel(key, logits.shape, row0), t)
