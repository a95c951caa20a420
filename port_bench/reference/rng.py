"""Counter-based random bits that equal ``jax.random``'s, bit for bit.

The JAX package draws every random number from threefry2x32 keys
(``PRNGKey``, ``split``, ``fold_in``, ``uniform``, ``randint``) with
``jax_threefry_partitionable=True``. The hist grower derives each node's key
from its global node id, which is what makes node-batch width and tree
chunking results-neutral; reproducing those bits is the only way the port's
forests can be held bitwise against the reference's. ``torch.Generator``
cannot do that, so this module re-implements the subset the main path uses.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words. All
arithmetic runs in int64 and is masked to 32 bits, because torch's uint32
support is thin. Every function broadcasts over the leading key axes, so a
batch of keys (per tree, per node) hashes in one pass.
"""

import math

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block on broadcastable int64 tensors of
    uint32 words; returns the two output words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed, device="cpu"):
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32)."""
    if not 0 <= int(seed) <= _M32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return torch.tensor([0, int(seed)], dtype=torch.int64, device=device)


def _counts(shape, device):
    """Low words of the flattened iota over ``shape`` (the high words of
    jax's 64-bit iota are 0 below 2**32 elements)."""
    n = math.prod(shape)
    if n > _M32:
        raise ValueError("at most 2**32 random words per key")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def _hash_iota(key, shape):
    """threefry over counts (0, i) for each key: two words [..., *shape]."""
    cnt = _counts(shape, key.device)
    lead = key.shape[:-1]
    pad = (1,) * len(shape)
    k0 = key[..., 0].reshape(*lead, *pad)
    k1 = key[..., 1].reshape(*lead, *pad)
    return threefry2x32(k0, k1, torch.zeros_like(cnt), cnt)


def split(key, num=2):
    """``jax.random.split``: key [..., 2] -> [..., num, 2]."""
    b0, b1 = _hash_iota(key, (num,))
    return torch.stack([b0, b1], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in``: key [..., 2] with uint32 ``data`` (int or
    tensor broadcastable against the key's leading axes) -> [..., 2]."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    b0, b1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key, shape):
    """32-bit ``jax.random.bits``: [..., *shape] int64 in [0, 2**32)."""
    b0, b1 = _hash_iota(key, tuple(shape))
    return b0 ^ b1


def uniform(key, shape):
    """f32 ``jax.random.uniform`` on [0, 1): mantissa bits under 1.0,
    minus 1."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def randint(key, shape, minval, maxval):
    """int32 ``jax.random.randint`` with scalar bounds (``maxval`` may be
    a 0-d tensor): two draws, reduced modulo the span exactly as jax does,
    including its uint32 wrap-around."""
    k1, k2 = split(key).unbind(-2)
    hi = random_bits(k1, shape)
    lo = random_bits(k2, shape)
    minval = torch.as_tensor(minval, dtype=torch.int64, device=key.device)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    span = torch.where(maxval <= minval, torch.ones_like(maxval),
                       (maxval - minval) & _M32)
    mult = (((65536 % span) ** 2) & _M32) % span
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    return (minval + off % span).to(torch.int32)
