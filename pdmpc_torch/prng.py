"""Threefry-2x32 counter-based random numbers, bit-equal to ``jax.random``.

The reference draws its random priorities, random weights and the sampled
search's rollout policy with ``jax.random`` under its default
implementation (``threefry2x32``) in partitionable mode
(``jax_threefry_partitionable``, the default of the jax the goldens were
made with). This module computes the same bits:

- ``prng_key(seed)`` is ``jax.random.PRNGKey(seed)``: the pair
  (seed >> 32, seed & 0xFFFFFFFF); a 32-bit seed has 0 in front;
- ``fold_in(key, data)`` hashes the count pair (0, data), as
  ``threefry_2x32`` does with a count of two words split into halves;
- ``split(key, num)`` and ``random_bits(key, shape)`` hash each element's
  64-bit flat index, as (hi, lo) words (``iota_2x32_shape``):
  ``split(key, num)[i]`` is the hash's pair, and the 32-bit bits are the
  pair's two words XORed;
- ``uniform`` puts the top 23 bits into the mantissa of a float in
  [1, 2), subtracts 1, then scales to [minval, maxval) and clamps at
  minval (``jax.random.uniform``, exact);
- ``permutation`` sorts by fresh 32-bit keys, ceil(3 ln N / ln(2^32 - 1))
  rounds (one for N <= 1,625), each with ``key, subkey = split(key)``; the
  sort is stable, as ``lax.sort_key_val``'s is, so equal keys keep their
  order;
- ``gumbel`` is ``-log(-log(u))`` of a uniform on [tiny, 1) (mode "low").

Every word lives in an int64 tensor masked to 32 bits, so one code path
runs on the CPU and on the card and unsigned order is int64 order. The
integers and the uniforms are bit-equal to ``jax.random``'s; ``gumbel``
goes through torch's f32 ``log``, which sits an ulp from XLA's in some
values (its noise agrees to about 1e-6).
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
# threefry-2x32's key-schedule parity constant and rotation distances
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The 20-round threefry-2x32 hash of the count words (x1, x2) under
    the key (k1, k2); int64 tensors holding 32-bit words, broadcast
    against each other. Returns the two hashed words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed that fits in 32 bits: [2]
    int64."""
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys [..., 2], data an int or an integer
    tensor broadcast against the keys' leading dims. Returns [..., 2]."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data & MASK32)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def _counts(shape, device):
    """Flat element indices of ``shape`` as (hi, lo) 32-bit words."""
    flat = torch.arange(math.prod(shape), dtype=torch.int64,
                        device=device).reshape(shape)
    return flat >> 32, flat & MASK32


def _hash_counts(key: torch.Tensor, shape):
    """Both hash words of every flat index of ``shape`` under each key
    [..., 2]: [..., *shape] each."""
    hi, lo = _counts(tuple(shape), key.device)
    tail = (None,) * len(shape)
    k1 = key[(..., 0) + tail]
    k2 = key[(..., 1) + tail]
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: keys [..., 2] -> [..., num, 2]."""
    return torch.stack(_hash_counts(key, (num,)), dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit) of keys [..., 2]: int64
    [..., *shape] holding the unsigned words."""
    b1, b2 = _hash_counts(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` of keys
    [..., 2]: f32 [..., *shape]."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in mode "low" of keys [..., 2]:
    f32 [..., *shape]. torch's ``log`` stands in for XLA's."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))


def permutation(key: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jax.random.permutation(key, x)`` of a 1-d ``x`` under one key
    [2]."""
    n = x.shape[0]
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(MASK32))
    for _ in range(rounds):
        key, subkey = split(key)
        order = torch.sort(random_bits(subkey, (n,)), stable=True).indices
        x = x[order]
    return x
