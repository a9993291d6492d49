"""Threefry-2x32 counter-based random numbers: torch twins of what the JAX
package's ``lm.sample_token`` takes from ``jax.random`` (the ``threefry2x32``
implementation with ``jax_threefry_partitionable`` on, JAX's default).

A key is a pair of 32-bit words, held as the last axis of an int64 tensor
(..., 2) whose entries lie in [0, 2^32): CUDA has few uint32 operations, so
every word is an int64 masked to 32 bits after each addition and shift. No
generator state exists anywhere: a draw is a pure function of the key
tensors, so the same ops run eagerly on the CPU and inside a captured CUDA
graph, and the bits equal ``jax.random``'s for the same key.

  key = prng_key(seed)                       # jax.random.PRNGKey(seed)
  key = fold_in(key, data)                   # jax.random.fold_in
  bits = random_bits(key, n)                 # jax.random.bits(key, (n,))
  u = uniform(key, n, minval=FLOAT32_TINY)   # jax.random.uniform
  g = gumbel(key, n)                         # jax.random.gumbel, mode "low"
  i = categorical(key, logits)               # jax.random.categorical
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA            # Threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000          # the bits of float32 1.0
FLOAT32_TINY = 1.1754943508222875e-38   # finfo(float32).tiny


# XLA's float32 log on the CPU: the Cephes polynomial, with the
# multiply-adds it fuses (a * b + c rounded once)
_LOG_P = tuple(float(np.float32(p)) for p in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = 0.693359375
_SQRT_HALF = float(np.float32(0.707106781186547524))


def _rotl(x, d: int):
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block function (20 rounds) on broadcastable int64
    tensors of 32-bit words: key (k1, k2), counter (x1, x2). Returns the
    two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & MASK
    x1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device="cpu"):
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the words (0, seed
    mod 2^32), as a (2,) int64 tensor (made by fills, not copied from the
    host, so it can be made inside a graph capture)."""
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"prng_key: seed {seed} is not a 32-bit integer")
    word = torch.full((), seed & MASK, dtype=torch.int64, device=device)
    return torch.stack([torch.zeros_like(word), word])


def fold_in(key, data):
    """``jax.random.fold_in``: the new key is the block function of
    ``key`` at the counter (0, data mod 2^32). key: (..., 2); data: an int
    or an integer tensor broadcastable to key's batch shape."""
    if not torch.is_tensor(data):
        data = torch.full((), data, dtype=torch.int64, device=key.device)
    data = data.to(torch.int64) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key, n: int):
    """``jax.random.bits(key, (n,))``, partitionable: word i is the XOR of
    the block function's two outputs at the counter (0, i). key: (..., 2)
    -> (..., n) int64 in [0, 2^32)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(i), i)
    return b1 ^ b2


def uniform(key, n: int, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in [1, 2), less 1, scaled into
    [minval, maxval) in float32 and kept at or above ``minval``."""
    bits = (random_bits(key, n) >> 9) | _ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    return torch.clamp_min(floats * float(span) + float(lo), float(lo))


def _fma(a, b, c):
    """a * b + c in float64, rounded to float32: the product of two float32
    values is exact in float64, so only the sum rounds before the final
    rounding (twice-rounded results differ from one fused rounding in about
    one case in 2^29)."""
    def f64(v):
        return v.double() if torch.is_tensor(v) else v
    return (f64(a) * f64(b) + f64(c)).float()


def xla_log(x):
    """The natural log of positive float32 ``x`` as XLA computes it on the
    CPU (the Cephes polynomial on the mantissa in [sqrt(1/2), sqrt(2)),
    its multiply-adds fused), which is not the correctly rounded log
    ``torch.log`` gives in most cases: ``jax.random.gumbel``'s bits on the
    CPU, on either device here."""
    p, q1 = _LOG_P, _LOG_Q1
    bits = torch.clamp_min(x, FLOAT32_TINY).view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    t = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.float()
    x2 = t * t
    x3 = x2 * t
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(_fma(y, x3, y1), x3, y2), x3, e * q1)
    return ((t - 0.5 * x2) + y) + e * _LOG_Q2


def gumbel(key, n: int):
    """``jax.random.gumbel(key, (n,), float32)`` in mode "low":
    ``-log(-log(u))`` with u uniform in [tiny, 1), through ``xla_log``."""
    return -xla_log(-xla_log(uniform(key, n, minval=FLOAT32_TINY)))


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` over the last axis: the
    Gumbel-max draw ``argmax(gumbel + logits)``. key: (..., 2); logits:
    (..., V) float32 -> (...,) int64."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
