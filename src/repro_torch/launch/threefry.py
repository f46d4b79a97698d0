"""The JAX package's default random-key arithmetic in numpy, so that the
port's launcher draws the same synthetic prompts from the same seed
without importing JAX.

Threefry-2x32 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011; 20 rounds) with the key derivation ``jax.random`` uses by
default (``jax_threefry_partitionable``): ``prng_key(seed)`` is the pair
(0, seed), ``fold_in`` hashes (0, data) under the key, a split or a draw
of n words hashes the counters (hi(i), lo(i)) of i = 0..n-1, and 32-bit
words are the xor of the two output halves.  ``randint`` is
``jax.random.randint``'s span arithmetic on two such draws.
tests/test_torch_launch_serve.py holds all three to ``jax.random``."""
from __future__ import annotations

from typing import Sequence

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block function of ``key`` (2 uint32 words) on the
    counter words (x0, x1), elementwise; uint32 arithmetic wraps."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed mod 2^32)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def _counters(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    y0, y1 = threefry2x32(key, *_counters(num))
    return np.stack([y0, y1], axis=1)


def random_bits32(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    y0, y1 = threefry2x32(key, *_counters(int(np.prod(shape, dtype=np.int64))))
    return (y0 ^ y1).reshape(tuple(shape))


def randint(key: np.ndarray, shape: Sequence[int], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 in
    [minval, maxval)) for int32 bounds."""
    k1, k2 = split(key)
    higher, lower = random_bits32(k1, shape), random_bits32(k2, shape)
    span = np.uint32(int(maxval) - int(minval)) if maxval > minval else np.uint32(1)
    with np.errstate(over="ignore"):
        # JAX's multiplier 2^32 mod span as uint32 arithmetic: the square
        # wraps mod 2^32 (to 0 for a span past 2^16), as its lax.mul does
        mult = np.uint32(2 ** 16) % span
        mult = (mult * mult) % span
        off = (higher % span) * mult + (lower % span)
        off = off % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)
