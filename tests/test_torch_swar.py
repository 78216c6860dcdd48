"""Exhaustive per-byte check of the port's SWAR word primitives.

Every compare, select and arithmetic primitive of
``gossipfs_tpu_torch/ops/swar.py`` over ALL 256 x 256 int8 operand pairs
(packed 4 per word), against numpy's int8 semantics (the lanes form's
ground truth) and against the JAX package's ``gossipfs_tpu.ops.swar`` on
the very same words.  Both sides' int32 words overflow in the same places
(``to_bytes``' multiply into the sign byte, the low-7 sums of ``eq`` and
``add``), so equal words show that torch wraps exactly as XLA does.
Tolerance: exact equality.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.ops import swar as jswar
from gossipfs_tpu_torch.ops import swar

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

B = np.arange(-128, 128, dtype=np.int8)
X8 = np.repeat(B, 256)            # every (x, y) byte pair, 65,536 bytes
Y8 = np.tile(B, 256)
XW = swar.pack(torch.from_numpy(X8.copy()))
YW = swar.pack(torch.from_numpy(Y8.copy()))
JXW = jswar.pack(jnp.asarray(X8).reshape(1, -1))
JYW = jswar.pack(jnp.asarray(Y8).reshape(1, -1))


def words(w) -> np.ndarray:
    return np.asarray(w).reshape(-1).astype(np.int32)


def as_bytes(w: torch.Tensor) -> np.ndarray:
    return swar.unpack(w).numpy().reshape(-1)


def hmask_bytes(h: torch.Tensor) -> np.ndarray:
    """hmask word -> per-byte bool; the non-sign bits must be clear."""
    b = as_bytes(h).view(np.uint8)
    assert not (b & 0x7F).any()
    return b != 0


def test_pack_matches_the_jax_package():
    """Byte i of word w is subject 4w + i on both sides (little-endian)."""
    np.testing.assert_array_equal(words(XW), words(JXW))
    np.testing.assert_array_equal(words(YW), words(JYW))
    rng = np.random.default_rng(0)
    x = rng.integers(-128, 128, size=(3, 5, 16), dtype=np.int8)
    w = swar.pack(torch.from_numpy(x))
    assert w.shape == (3, 5, 4) and w.dtype == torch.int32
    np.testing.assert_array_equal(swar.unpack(w).numpy(), x)
    with pytest.raises(ValueError, match="% 4"):
        swar.pack(torch.zeros((2, 6), dtype=torch.int8))
    with pytest.raises(ValueError, match="int8"):
        swar.pack(torch.zeros((2, 8), dtype=torch.int16))


@pytest.mark.parametrize("name,ref", [
    ("eq", lambda x, y: x == y), ("ne", lambda x, y: x != y),
    ("ges", lambda x, y: x >= y), ("gts", lambda x, y: x > y),
    ("les", lambda x, y: x <= y),
])
def test_compares_exhaustive(name, ref):
    got = getattr(swar, name)(XW, YW)
    np.testing.assert_array_equal(hmask_bytes(got), ref(X8, Y8),
                                  err_msg=name)
    np.testing.assert_array_equal(
        words(got), words(getattr(jswar, name)(JXW, JYW)), err_msg=name)


@pytest.mark.parametrize("name,ref", [
    ("add", lambda x, y: x + y), ("sub", lambda x, y: x - y),
    ("maxs", np.maximum), ("mins", np.minimum),
])
def test_arith_exhaustive(name, ref):
    got = getattr(swar, name)(XW, YW)
    want = ref(X8.astype(np.int16), Y8.astype(np.int16)).astype(np.int8)
    np.testing.assert_array_equal(as_bytes(got), want, err_msg=name)
    np.testing.assert_array_equal(
        words(got), words(getattr(jswar, name)(JXW, JYW)), err_msg=name)


def test_to_bytes_and_select_exhaustive():
    """``to_bytes`` overflows the word (0x01010101 * 255 = -1 as int32):
    the same words as the JAX package's, and a select through it picks
    per byte."""
    h = swar.ges(XW, YW)
    m = swar.to_bytes(h)
    np.testing.assert_array_equal(as_bytes(m), np.where(X8 >= Y8, -1, 0))
    np.testing.assert_array_equal(
        words(m), words(jswar.to_bytes(jswar.ges(JXW, JYW))))
    got = swar.sel(m, XW, YW)
    np.testing.assert_array_equal(as_bytes(got), np.where(X8 >= Y8, X8, Y8))
    np.testing.assert_array_equal(
        words(got), words(jswar.sel(jswar.to_bytes(jswar.ges(JXW, JYW)),
                                    JXW, JYW)))


def test_word_constants_match_the_jax_package():
    for b in range(-300, 300, 7):
        assert swar.word(b) == jswar.word(b)
    assert (swar.H, swar.L, swar.B7F) == (jswar.H, jswar.L, jswar.B7F)
    assert swar.BYTE == jswar.BYTE
    # the words overflow exactly where the reference's do
    assert swar.word(0x80) == -2139062144 and swar.word(0xFF) == -1


def test_bool_mask_and_splat():
    b = torch.tensor([True, False, True])
    np.testing.assert_array_equal(swar.bool_mask(b).numpy(), [-1, 0, -1])
    np.testing.assert_array_equal(
        swar.bool_mask(b).numpy(),
        np.asarray(jswar.bool_mask(jnp.asarray(b.numpy()))))
    vals = torch.arange(-128, 128)
    w = swar.splat(vals)
    assert w.dtype == torch.int32 and w.shape == vals.shape
    np.testing.assert_array_equal(
        w.numpy(), [swar.word(int(v)) for v in vals])
