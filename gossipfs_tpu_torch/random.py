"""Counter-based random numbers, bit for bit with ``jax.random``.

A port of JAX's threefry2x32 generator as torch integer ops, in the
partitionable mode (``jax_threefry_partitionable=True``, the JAX package's
test setting and the default from jax 0.5 on).  The round loop draws its
arc bases and churn uniforms from the same keys as the JAX package, so a
whole scan replays identically in both packages.

Keys are explicit objects: an int64 tensor ``[..., 2]`` holding the two
uint32 words of a threefry key (``jax.random.key_data`` of the same key).
Every function takes a BATCH of keys (any leading shape) and returns one
result per key, so a caller can draw a whole horizon's randomness in one
pass: ``fold_in(key, rounds)`` gives one key per round, and
``randint(keys, (n,), ...)`` one ``[n]`` draw per key.

uint32 arithmetic runs in int64 with an explicit 32-bit mask, since torch
has no uint32 arithmetic on every device.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds over broadcast int64 tensors holding
    uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + k1) & _M32
    b = (x2 + k2) & _M32
    for i in range(5):
        for r in (_ROT0 if i % 2 == 0 else _ROT1):
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def PRNGKey(seed: int, device="cuda") -> torch.Tensor:
    """Key from an integer seed (``jax.random.PRNGKey`` for 32-bit seeds)."""
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed must be an int32, got {seed}")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _counts(shape, device):
    """Flat row-major index of every element of ``shape`` as (hi, lo)
    uint32 words (jax's ``iota_2x32_shape``)."""
    numel = 1
    for s in shape:
        numel *= s
    idx = torch.arange(numel, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _M32


def _batched(keys: torch.Tensor, shape):
    """Key words broadcast against ``shape`` trailing axes."""
    pad = (None,) * len(shape)
    return keys[(..., 0) + pad], keys[(..., 1) + pad]


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` per key: ``[..., 2]`` -> ``[..., num, 2]``."""
    hi, lo = _counts((num,), keys.device)
    k1, k2 = _batched(keys, (num,))
    a, b = threefry2x32(k1, k2, hi, lo)
    return torch.stack([a, b], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` per key; ``data`` (int or int tensor)
    broadcasts against the key batch."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    a, b = threefry2x32(keys[..., 0], keys[..., 1],
                        torch.zeros_like(data), data & _M32)
    return torch.stack([a, b], dim=-1)


def bits32(keys: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape``, per key (int64 values)."""
    shape = tuple(shape)
    hi, lo = _counts(shape, keys.device)
    k1, k2 = _batched(keys, shape)
    a, b = threefry2x32(k1, k2, hi, lo)
    return a ^ b


def randint(keys: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)`` per
    key, for Python-int bounds within int32."""
    if not -2**31 <= minval < maxval < 2**31:
        raise ValueError(f"need int32 bounds with minval < maxval, got "
                         f"[{minval}, {maxval})")
    shape = tuple(shape)
    # both halves of the split in one batch of threefry ops
    higher, lower = bits32(split(keys), shape).unbind(-len(shape) - 1)
    span = (maxval - minval) & _M32
    # 2**32 % span without leaving uint32, as jax computes it (the square
    # of 2**16 % span wraps in uint32 before the second remainder)
    mult = ((((1 << 16) % span) ** 2) & _M32) % span
    off = (((higher % span) * mult) & _M32) + (lower % span)
    off = (off & _M32) % span
    return (minval + off).to(torch.int32)


def uniform(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1)) per key."""
    bits = bits32(keys, tuple(shape))
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0
