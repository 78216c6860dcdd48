"""SWAR (SIMD within a register) int8 arithmetic over packed int32 words.

The port's copy of the JAX package's ``gossipfs_tpu/ops/swar.py``, as
torch int32 ops.  A "word" is an int32 carrying 4 independent int8 lanes
(bytes, little-endian: byte 0 = the lowest subject index of the group).
Every ordered compare, select and wrap-around add below touches the 4
subjects of a word at once with carry-safe bitwise arithmetic, so no
carry or borrow crosses a byte boundary.

* An "hmask" is a word whose bytes are 0x80 (true) or 0x00 (false), the
  output of the compare primitives.  hmasks compose with ``&``/``|``;
  :func:`to_bytes` expands one to a full-byte mask (0xFF/0x00) where a
  select needs it.
* Byte arithmetic wraps mod 2^8, the semantics of the narrow int8 lanes.
  Two places overflow the int32 word itself, as they do in the JAX
  package: :func:`to_bytes` multiplies into the sign byte, and the low-7
  sums of :func:`eq`/:func:`add` can exceed 2^31.  torch's int32 ops wrap
  there exactly as XLA's do (two's complement), which
  tests/test_torch_swar.py checks over all 256 x 256 byte pairs.
* ``>>`` is arithmetic on int32, as ``jnp``'s is; every shift below is
  masked so that the sign fill never reaches a result byte.

The CUDA kernel's twin of this module is ``csrc/rr_swar.cuh`` (uint32
words, the same formulas term for term).
"""

from __future__ import annotations

import torch


def word(b: int) -> int:
    """The Python int32 value whose 4 bytes all equal ``b`` (mod 256)."""
    v = (b & 0xFF) * 0x01010101
    return v - (1 << 32) if v >= (1 << 31) else v


H = word(0x80)    # per-byte sign bits
L = word(0x01)    # per-byte ones
B7F = word(0x7F)  # per-byte low-7 mask (~H)

# single-byte select masks, index k = byte k of the word (int32-safe)
BYTE = (0x000000FF, 0x0000FF00, 0x00FF0000, -16777216)


def pack(x: torch.Tensor) -> torch.Tensor:
    """int8 ``[..., 4k]`` -> int32 words ``[..., k]`` (byte i = element
    4w + i): a view of the same memory, so writes through it land in
    ``x``.  The minor axis must be contiguous."""
    if x.dtype != torch.int8:
        raise ValueError(f"pack expects int8, got {x.dtype}")
    if x.shape[-1] % 4:
        raise ValueError(f"pack needs a minor axis % 4 == 0, got "
                         f"{tuple(x.shape)}")
    return x.view(torch.int32)


def unpack(w: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack`: int32 words ``[..., k]`` -> int8
    ``[..., 4k]`` (a view)."""
    return w.view(torch.int8)


def eq(x, y):
    """Per-byte x == y -> hmask.  (Zero-byte detect on x ^ y; the low-7
    add cannot carry across bytes: 0x7F + 0x7F < 0x100.)"""
    z = x ^ y
    return ~(((z & B7F) + B7F) | z) & H


def ne(x, y):
    """Per-byte x != y -> hmask."""
    z = x ^ y
    return (((z & B7F) + B7F) | z) & H


def ges(x, y):
    """Per-byte SIGNED x >= y -> hmask: an unsigned compare of the low 7
    bits (``(x | H) - (y & B7F)`` cannot borrow across bytes), folded with
    the sign bits."""
    t = (x | H) - (y & B7F)
    return ((~x & y) | (~(x ^ y) & t)) & H


def gts(x, y):
    """Per-byte SIGNED x > y -> hmask."""
    return ~ges(y, x) & H


def les(x, y):
    """Per-byte SIGNED x <= y -> hmask."""
    return ges(y, x)


def to_bytes(m):
    """hmask -> full-byte mask (0xFF per true byte).  The multiply by 255
    cannot carry: each byte of the 0/1 word contributes < 256."""
    return ((m >> 7) & L) * 0xFF


def sel(m, x, y):
    """Byte-wise select: x where full-byte mask ``m`` else y."""
    return y ^ ((x ^ y) & m)


def add(x, y):
    """Per-byte wrap-around add (no carries cross byte boundaries)."""
    return ((x & B7F) + (y & B7F)) ^ ((x ^ y) & H)


def sub(x, y):
    """Per-byte wrap-around subtract (no borrows cross byte boundaries)."""
    return ((x | H) - (y & B7F)) ^ ((x ^ ~y) & H)


def maxs(x, y):
    """Per-byte SIGNED max."""
    return sel(to_bytes(ges(x, y)), x, y)


def mins(x, y):
    """Per-byte SIGNED min."""
    return sel(to_bytes(les(x, y)), x, y)


def bool_mask(b: torch.Tensor) -> torch.Tensor:
    """bool tensor -> word-shaped select mask (-1/0: every byte set), for
    masks uniform across a word's 4 subjects (per-receiver row flags); it
    serves as a full-byte mask and as an hmask operand."""
    return torch.where(b, -1, 0).to(torch.int32)


def splat(b: torch.Tensor) -> torch.Tensor:
    """int ``[...]`` byte values -> int32 words ``[...]`` holding the byte
    (mod 256) in all 4 lanes: a per-row constant, built through an int8
    view so that no int32 product overflows."""
    b8 = b.to(torch.int8).unsqueeze(-1).expand(*b.shape, 4).contiguous()
    return b8.view(torch.int32).squeeze(-1)
