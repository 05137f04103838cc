"""A copy of JAX's default PRNG, so a seed or a key draws what lvd_tpu draws.

lvd_tpu draws its initial latents with
``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)``
(lvd_tpu/pipeline.py:353-357) and its random weights from keys it splits and
folds (models/{unet3d,clip,vae,gligen}.py). In JAX 0.9 that is the
threefry2x32 generator with ``jax_threefry_partitionable=True``:

* ``PRNGKey(seed)`` is the key ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``split(key, n)[i]`` and ``fold_in(key, i)`` are both the pair
  ``threefry2x32(key, (0, i))``;
* the 32-bit random bits of element ``i`` (row-major) are ``b1 ^ b2`` where
  ``(b1, b2) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
* ``uniform(lo, hi)`` puts the top 23 bits into the mantissa of a float in
  [1, 2), subtracts 1, scales to [lo, hi) and clamps at lo;
* ``randint`` draws two words from the halves of ``split(key)`` and folds
  them into the span with JAX's modular multiplier;
* ``normal`` is ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``, with
  XLA's float32 erfinv (Giles' polynomial);
* in bfloat16 and float16, ``uniform`` keeps only the mantissa's bits of the
  low 8 (bfloat16) or 16 (float16) random bits, every operation rounds to
  the type, and erfinv runs in float32. A half-precision normal therefore
  takes one of 128 (bfloat16) or 1024 (float16) values, one for each
  mantissa.

Keys and random bits are bit-exact; a float32 normal is within an ulp or two
of JAX's, since the erfinv's log1p is the device's, not XLA's. A
half-precision normal is read from its table of values, made once on the
CPU, so it is JAX's bit for bit on every device. One threefry
serves both: on Python ints for keys (a key is a pair of ints), and on int64
tensors masked to 32 bits for the bits of a draw, which run on the device
they are asked for.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds (JAX's ``threefry2x32_p``) on 32-bit
    values held in Python ints or int64 tensors. Returns the two words.
    Augmented assignments rebind ints and update tensors in place."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x0 &= _M32
            high = x1 << r  # x1 = rotl(x1, r) ^ x0
            x1 >>= 32 - r
            x1 |= high
            x1 &= _M32
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x0 &= _M32
        x1 += ks[(i + 2) % 3] + i + 1
        x1 &= _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``."""
    seed = int(seed)
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def split(key: Key, num: int = 2):
    """``jax.random.split(key, num)`` as a list of keys."""
    return [fold_in(key, i) for i in range(num)]


def random_bits_at(key: Key, index: torch.Tensor) -> torch.Tensor:
    """The 32-bit random bits of the elements at the row-major ``index``
    (int64) of any draw from ``key``, as int64 values in [0, 2**32) on
    ``index``'s device."""
    b1, b2 = threefry2x32(key[0], key[1], index >> 32, index & _M32)
    return b1 ^ b2


# Elements a pass on the CPU: the passes of a draw then stay in its caches.
_CPU_CHUNK = 1 << 16


def _draw(key: Key, shape, device, of_bits, dtype) -> torch.Tensor:
    """``of_bits`` of the random bits of ``shape``: on the CPU a chunk at a
    time, elsewhere in one pass."""
    n = math.prod(shape)
    device = torch.device(device)
    step = _CPU_CHUNK if device.type == "cpu" else max(n, 1)
    out = torch.empty(n, dtype=dtype, device=device)
    for start in range(0, n, step):
        idx = torch.arange(start, min(n, start + step), dtype=torch.int64, device=device)
        out[start:start + step] = of_bits(random_bits_at(key, idx))
    return out.reshape(tuple(shape))


def random_bits(key: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` on ``device``, as int64."""
    return _draw(key, shape, device, lambda bits: bits, torch.int64)


def randint(key: Key, shape, minval: int, maxval: int, device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) on
    ``device``, as int64: JAX's algorithm (jax/_src/random.py ``_randint``).
    Two words of random bits from the two halves of ``split(key)``, the
    bounds clamped to int32, ``span = maxval - minval`` (1 where maxval <=
    minval), the multiplier ``(2**16 % span)**2 % span`` and the offset
    ``((hi % span) * mult + lo % span) % span``, both in wrapping uint32
    arithmetic."""
    i32 = np.iinfo(np.int32)
    clamp = lambda v: min(max(int(v), int(i32.min)), int(i32.max))
    out_of_range = int(maxval) > int(i32.max)
    lo_v, hi_v = clamp(minval), clamp(maxval)
    span = (hi_v - lo_v) & _M32
    if hi_v <= lo_v:
        span = 1
    elif out_of_range:
        span = (span + 1) & _M32
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape, device), random_bits(k2, shape, device)
    if span == 0:  # the full 2**32 range: XLA's x % 0 is x, and the offset lo
        offset = lower
    else:
        mult = (((2 ** 16 % span) ** 2) & _M32) % span
        offset = (((higher % span) * mult) & _M32) + lower % span
        offset = (offset & _M32) % span
    return ((offset + lo_v + 2 ** 31) & _M32) - 2 ** 31


def uniform_from_bits(bits: torch.Tensor, minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 of the given bits."""
    one = 0x3F800000  # the bits of 1.0f
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(floats * float(hi - lo) + float(lo), float(lo))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv: Giles' single-precision polynomial."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    p = torch.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, f32(a), f32(b)) + p * w
    out = p * x
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max, out)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal`` in float32 of the given bits."""
    return _SQRT2 * erfinv_f32(uniform_from_bits(bits, _NORMAL_LO, 1.0))


# Half types: (mantissa bits, the bits of 1.0, the random bits uniform takes).
_HALF = {torch.bfloat16: (7, 0x3F80, 8), torch.float16: (10, 0x3C00, 16)}


@functools.lru_cache(maxsize=None)
def _half_normals(dtype) -> torch.Tensor:
    """``jax.random.normal`` in ``dtype`` of each mantissa its uniform can
    draw, on the CPU."""
    nmant, one, _ = _HALF[dtype]
    floats = (torch.arange(2 ** nmant, dtype=torch.int32) | one).to(torch.int16).view(dtype) - 1
    lo = torch.tensor(-1.0 + 2.0 ** -(nmant + 1), dtype=dtype)  # nextafter(-1, 0)
    u = torch.clamp_min(floats * (torch.tensor(1.0, dtype=dtype) - lo) + lo, lo)
    return torch.tensor(math.sqrt(2), dtype=dtype) * erfinv_f32(u.float()).to(dtype)


def normal_key(key: Key, shape, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` on ``device``; ``dtype`` is
    float32, bfloat16 or float16."""
    if dtype == torch.float32:
        return _draw(key, shape, device, normal_from_bits, dtype)
    nmant, _, rng_bits = _HALF[dtype]
    table = _half_normals(dtype).to(device)
    return _draw(key, shape, device,
                 lambda bits: table[(bits & (2 ** rng_bits - 1)) >> (rng_bits - nmant)], dtype)


def normal(seed: int, shape) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)`` on the
    host."""
    return normal_key(prng_key(seed), tuple(shape)).numpy()
