"""A numpy copy of JAX's default PRNG, so a seed draws the same noise as
lvd_tpu does.

lvd_tpu draws its initial latents with
``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)``
(lvd_tpu/pipeline.py:353-357). In JAX 0.9 that is the threefry2x32 generator
with ``jax_threefry_partitionable=True``:

* ``PRNGKey(seed)`` is the key ``(seed >> 32, seed & 0xFFFFFFFF)``;
* the 32-bit random bits of element ``i`` (row-major) are ``b1 ^ b2`` where
  ``(b1, b2) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
* ``uniform(lo, hi)`` puts the top 23 bits into the mantissa of a float in
  [1, 2), subtracts 1, scales to [lo, hi) and clamps at lo;
* ``normal`` is ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``, with
  XLA's float32 erfinv (Giles' polynomial).

Everything runs in numpy on the host; the caller moves the result to the
device.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds on uint32 arrays (JAX's
    ``threefry2x32_p``). Returns the two output words."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [x1 + ks[0], x2 + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` as a pair of uint32."""
    seed = int(seed)
    return np.uint32((seed >> 32) & 0xFFFFFFFF), np.uint32(seed & 0xFFFFFFFF)


def random_bits(key, shape) -> np.ndarray:
    """32-bit random bits of ``shape`` (partitionable threefry)."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(32 - 23)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv: Giles' single-precision polynomial."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = np.where(lt, np.float32(a), np.float32(b)) + p * w
    out = (p * x).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, out)


def normal(seed: int, shape) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(prng_key(seed), tuple(shape), lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)
