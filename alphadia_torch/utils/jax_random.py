"""JAX's random stream, drawn without JAX: the numbers that ``jax.random``
(threefry2x32, ``jax_threefry_partitionable=True``) and flax's module RNG
derivation give, so that a network the port initialises and trains sees the
draws a flax fit sees.

- ``threefry2x32``: Threefry-2x32 with 20 rounds, as JAX's
  ``threefry2x32_p`` computes it;
- ``prng_key(seed)`` = ``jax.random.PRNGKey(seed)`` (``[seed >> 32, seed &
  0xffffffff]``); ``split(key, n)[j]`` = threefry of the counter pair ``(0,
  j)``; ``fold_in(key, d)`` = threefry of ``(0, d)``;
- ``random_bits(key, shape)``: the row-major flat index ``i`` of each
  element is the counter pair ``(i >> 32, i & 0xffffffff)``, the bits are
  the two output words xor'ed;
- ``uniform``: ``bits >> 9 | 0x3F800000`` read as float32, minus 1, scaled
  to ``[minval, maxval)`` and clipped below at ``minval``;
- ``normal``: ``sqrt(2) * erfinv(u)`` for ``u`` uniform on [nextafter(-1,
  0), 1) (flax's embedding init);
- ``truncated_normal``: ``sqrt(2) * erfinv(u)`` for ``u`` uniform on
  ``[erf(lower / sqrt 2), erf(upper / sqrt 2))``, clipped to the open
  interval. ``erfinv`` is XLA's float32 polynomial (Giles), with its
  multiply-adds fused as XLA's CPU code fuses them; XLA's ``log1p`` inside
  it is its own, so ~1% of draws differ from JAX's by an ulp or two
  (``tests/test_torch_classifier.py`` holds the bound);
- flax: a child scope appends its name to the parent's suffix,
  ``make_rng(collection)`` appends the scope's per-collection counter
  (1, 2, ...), and the suffix is folded in once as the first four bytes of
  the SHA-1 of its parts (a string as UTF-8, an int as its minimal big-endian
  bytes).

The host functions work on uint32 numpy arrays; ``uniform_torch`` draws
blocks of uniforms on a torch device from keys that lie there, in int64
arithmetic masked to 32 bits (no uint32 shifts needed).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# erf(-+2 / sqrt 2) as XLA evaluates it in float32: the bounds of the
# uniform that ``truncated_normal(-2, 2)`` (lecun_normal) draws
_ERF_2_SQRT2 = np.float32(0.95449972)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of counters ``(x0, x1)`` under key ``(k0, k1)``. Works
    on uint32 numpy arrays and on int64 torch tensors holding 32-bit values
    (every sum and left shift is masked back to 32 bits)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _u32(v) -> np.ndarray:
    return np.asarray(v, dtype=np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as uint32[2]."""
    seed = int(seed)
    return _u32([(seed >> 32) & M32, seed & M32])


def _hash(key, hi, lo) -> np.ndarray:
    key = _u32(key)
    with np.errstate(over="ignore"):
        return threefry2x32(key[0], key[1], _u32(hi), _u32(lo))


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` as uint32[num, 2]."""
    b0, b1 = _hash(key, np.zeros(num), np.arange(num))
    return np.stack([b0, b1], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` (``data`` taken as uint32)."""
    b0, b1 = _hash(key, 0, int(data) & M32)
    return _u32([b0, b1])


def random_bits(key, shape) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (uint32)."""
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    b0, b1 = _hash(key, idx >> np.uint64(32), idx & np.uint64(M32))
    return (b0 ^ b1).reshape(shape)


def _bits_to_unit(bits):
    """float32 in [0, 1) from uint32 bits, as ``jax.random.uniform``."""
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the product of two float32
    values is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _fma32(_bits_to_unit(random_bits(key, shape)), hi - lo, lo))


def bernoulli(key, p, shape) -> np.ndarray:
    return uniform(key, shape) < np.float32(p)


# XLA's ErfInv32 coefficients, for w = -log1p(-x^2) below and above 5
_ERFINV_LOW = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HIGH = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` (see the module docstring)."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-_fma32(x, x, 0.0))
    low = w < np.float32(5)
    w = np.where(low, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    coef = [np.where(low, np.float32(a), np.float32(b)) for a, b in zip(_ERFINV_LOW, _ERFINV_HIGH)]
    p = coef[0]
    for c in coef[1:]:
        p = _fma32(p, w, c)
    return p * x


def truncated_normal(key, shape) -> np.ndarray:
    """``jax.random.truncated_normal(key, -2, 2, shape)`` (float32), the
    draw behind ``lecun_normal``."""
    u = uniform(key, shape, -_ERF_2_SQRT2, _ERF_2_SQRT2)
    out = np.float32(np.sqrt(2)) * erfinv32(u)
    lo = np.nextafter(np.float32(-2), np.float32(np.inf))
    return np.clip(out, lo, -lo)


def lecun_normal(key, shape) -> np.ndarray:
    """flax's default Dense and Conv kernel init for a kernel [..., fan_in,
    fan_out]: the fan-in is ``shape[-2]`` times the receptive field (the
    product of the leading axes, a convolution's width)."""
    # as ``variance_scaling`` computes it: a float32 variance, its float32
    # root, over the truncated normal's standard deviation in float32
    fan_in = shape[-2] * math.prod(shape[:-2])
    stddev = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(0.87962566103423978)
    return truncated_normal(key, shape) * stddev


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` (float32): ``sqrt(2) * erfinv(u)``
    for ``u`` uniform on [nextafter(-1, 0), 1)."""
    u = uniform(key, shape, np.nextafter(np.float32(-1), np.float32(0)), 1.0)
    return np.float32(np.sqrt(2)) * erfinv32(u)


def embed_normal(key, shape) -> np.ndarray:
    """flax's ``default_embed_init`` for a table [num_embeddings, features]:
    ``variance_scaling(1.0, "fan_in", "normal", out_axis=0)``, whose fan-in
    is the feature count."""
    return normal(key, shape) * np.sqrt(np.float32(1.0 / shape[-1]))


def split_chain(key, n: int) -> np.ndarray:
    """The ``sub`` keys of ``key, sub = split(key)`` taken ``n`` times in a
    row, uint32[n, 2] (in Python ints: each split waits for the last)."""
    k0, k1 = (int(v) for v in _u32(key))
    out = np.empty((n, 2), np.uint32)
    for t in range(n):
        a0, a1 = threefry2x32(k0, k1, 0, 0)
        out[t] = threefry2x32(k0, k1, 0, 1)
        k0, k1 = a0, a1
    return out


def flax_suffix_hash(*suffix) -> int:
    """The uint32 that flax's ``LazyRng.as_jax_rng`` folds in for a suffix:
    the first four bytes of the SHA-1 of its parts."""
    m = hashlib.sha1()
    for x in suffix:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, byteorder="big"))
    return int.from_bytes(m.digest()[:4], byteorder="big")


def flax_rng(keys, *suffix) -> np.ndarray:
    """``make_rng`` under ``keys`` (uint32[..., 2]) for the suffix (child
    scope names from the root, then the call's count in its scope)."""
    keys = _u32(keys)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(keys[..., 0], keys[..., 1], np.uint32(0), np.uint32(flax_suffix_hash(*suffix)))
    return np.stack([b0, b1], axis=-1)


def uniform_torch(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` for each key of ``keys`` (int64
    [..., 2] holding uint32 values, on any device): float32
    [..., *shape] on the keys' device."""
    n = math.prod(shape)
    lead = keys.shape[:-1]
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    k0 = keys[..., 0].reshape(*lead, 1)
    k1 = keys[..., 1].reshape(*lead, 1)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(idx), idx)
    bits = (b0 ^ b1) >> 9 | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(*lead, *shape)
