"""The `jax.random` subset the annealer draws from, bit-exact in torch.

One seed must give the same trajectory (and the same compressed bytes)
in the port as in megalania_tpu, so the port reproduces jax.random's
threefry2x32 generator as jax 0.9.0 runs it with
`jax_threefry_partitionable=True` (its default): `PRNGKey`, `split`,
`randint` (scalar or per-element bounds) and `uniform` (float32).

Keys are int64 tensors [..., 2] holding the two uint32 words; every
uint32 operation is emulated in int64 and masked back to 32 bits.  All
functions batch over the keys' leading axes the way the reference vmaps
them.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 hash, 20 rounds (broadcasting int64 tensors)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Raw key [2] from a 32-bit integer seed: (0, seed mod 2**32)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def _hash_counts(key, shape):
    """threefry2x32(key, iota(shape)) for keys [..., 2] -> two [..., *shape]
    word tensors (the 64-bit iota's high word is 0 for any size here)."""
    count = 1
    for s in shape:
        count *= s
    lo = torch.arange(count, dtype=torch.int64,
                      device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key, num: int = 2) -> torch.Tensor:
    """[..., 2] -> [..., num, 2] subkeys."""
    b1, b2 = _hash_counts(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key, shape=()) -> torch.Tensor:
    """32 random bits per element: [..., 2] keys -> [..., *shape]."""
    b1, b2 = _hash_counts(key, tuple(shape))
    return b1 ^ b2


def randint(key, shape, minval, maxval) -> torch.Tensor:
    """int32 draws in [minval, maxval) like jax.random.randint (2x32 bits
    reduced mod span, uint32 wraparound included).  minval/maxval: ints or
    tensors broadcastable to [..., *shape]."""
    ks = split(key, 2)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    minval = torch.as_tensor(minval, dtype=torch.int64, device=key.device)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    span = (maxval - minval) & M32
    span = torch.where(maxval <= minval, 1, span)
    mult = ((1 << 16) % span) ** 2 % span
    off = ((((higher % span) * mult) & M32) + (lower % span)) & M32
    return (minval + off % span).to(torch.int32)


def uniform(key, shape=()) -> torch.Tensor:
    """float32 draws in [0, 1): 23 random mantissa bits under exponent 0,
    minus one — exact, so equal bits give equal floats."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0
