"""(k, m) systematic Reed-Solomon over GF(256) as pure tensor ops.

The port of the JAX package's ``gossipfs_tpu/erasure/codec.py``: the
tables, the field scalars and every numpy function are copies; the tensor
twins (``gf_matmul``, ``encode``, ``decode``) are torch ops on the
caller's device, equal to the numpy twins bit for bit.  The JAX package
computes ``gf_matmul`` in XLA outside any Pallas kernel, so its faithful
counterpart here is plain torch (no CUDA kernel).

The field is GF(2^8) under the AES-adjacent primitive polynomial
``x^8 + x^4 + x^3 + x^2 + 1`` (0x11d) with generator 2 — the same field
every production RS deployment uses, so the exp/log tables are 256
bytes each and every field multiply is two gathers and an add.  That
makes GF matrix multiplication a *batched tensor program*: gather logs,
add, gather exps, mask zeros, XOR-reduce the shared axis — exactly a
matmul with (+, x) swapped for (xor, table-mul), which is why the
tensor path (``gf_matmul`` / ``encode``) runs on the same device as
the detector's rounds.

The code is SYSTEMATIC: generator ``G = [I | P]`` with ``P`` a k x m
Cauchy block, ``P[i][j] = inv(x_i ^ y_j)`` over the disjoint evaluation
points ``x_i = i`` and ``y_j = k + j`` (so k + m <= 256).  Every square
submatrix of a Cauchy matrix is nonsingular, hence every k x k
submatrix of ``G`` is invertible and the code is MDS: ANY k of the
k + m fragments reconstruct the payload (the classic Cauchy-RS
construction, cf. Jerasure).  Data fragments are the payload rows
verbatim — reads with zero fragment loss never touch the field at all.

Decode inverts the k x k survivor submatrix ON HOST (GF Gauss-Jordan
over a tiny k x k, ``gf_matinv``) and applies the inverse as one more
batched matmul — tensor or numpy; the two paths are pinned bit-exact
by tests/test_torch_erasure.py.

The numpy twin (``*_np``) is the CoSim byte path: the co-sim's
fragments are host ``bytes``, and shipping every 4 KiB payload through
a device round-trip would be dishonest benchmarking (BASELINE.md's
CPU-pinned boundary).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ---------------------------------------------------------------------------
# GF(256) tables — poly 0x11d, generator 2
# ---------------------------------------------------------------------------

_POLY = 0x11D


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.int32)   # doubled so log(a)+log(b) <= 508 indexes directly
    log = np.zeros(256, dtype=np.int32)   # log[0] unused — callers mask zeros
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    return exp, log


EXP, LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    """Scalar field multiply (host reference path)."""
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def gf_inv(a: int) -> int:
    """Multiplicative inverse; 0 has none."""
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(256)")
    return int(EXP[255 - LOG[a]])


def gf_div(a: int, b: int) -> int:
    """a / b in the field."""
    if b == 0:
        raise ZeroDivisionError("division by 0 in GF(256)")
    if a == 0:
        return 0
    return int(EXP[(LOG[a] - LOG[b]) % 255])


# ---------------------------------------------------------------------------
# GF matrix multiply — numpy twin and tensor path, pinned bit-exact
# ---------------------------------------------------------------------------


def gf_matmul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """uint8 [r, c] x [c, L] -> [r, L] over GF(256), host side."""
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    prod = EXP[LOG[a][:, :, None] + LOG[b][None, :, :]]
    nz = (a[:, :, None] != 0) & (b[None, :, :] != 0)
    return np.bitwise_xor.reduce(
        np.where(nz, prod, 0), axis=1
    ).astype(np.uint8)


def _tables(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The EXP and LOG tables as int64 tensors on ``device``."""
    return (torch.from_numpy(EXP).to(device=device, dtype=torch.int64),
            torch.from_numpy(LOG).to(device=device, dtype=torch.int64))


def gf_matmul(a, b: torch.Tensor) -> torch.Tensor:
    """The tensor twin of :func:`gf_matmul_np`: log gathers + add + exp
    gather + zero mask + XOR fold of the shared axis — a batched GF
    "matmul" on ``b``'s device.  ``a`` (the small coefficient matrix) may
    be numpy or a tensor; the fold walks its c columns, one [r, L] term
    each, so no [r, c, L] intermediate is held."""
    dev = b.device
    exp_t, log_t = _tables(dev)
    a = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                        else a, device=dev).to(torch.int64)
    b = b.to(torch.int64)
    la, lb = log_t[a], log_t[b]
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64,
                      device=dev)
    for j in range(a.shape[1]):
        prod = exp_t[la[:, j, None] + lb[None, j, :]]
        nz = (a[:, j, None] != 0) & (b[None, j, :] != 0)
        out ^= torch.where(nz, prod, 0)
    return out.to(torch.uint8)


# ---------------------------------------------------------------------------
# The systematic generator and its survivor inverses
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def parity_matrix(k: int, m: int) -> np.ndarray:
    """uint8 [k, m] Cauchy parity block P; G = [I | P]."""
    if k < 1 or m < 1 or k + m > 256:
        raise ValueError(f"stripe shape ({k}, {m}) not representable in GF(256)")
    p = np.zeros((k, m), dtype=np.uint8)
    for i in range(k):
        for j in range(m):
            p[i, j] = gf_inv(i ^ (k + j))
    return p


@functools.lru_cache(maxsize=None)
def generator_rows(k: int, m: int) -> np.ndarray:
    """uint8 [k+m, k]: row s maps the k data rows to fragment slot s
    (identity rows for s < k, P columns for the parity slots)."""
    return np.concatenate(
        [np.eye(k, dtype=np.uint8), parity_matrix(k, m).T], axis=0
    )


def gf_matinv(a: np.ndarray) -> np.ndarray:
    """GF(256) Gauss-Jordan inverse of a small k x k matrix (host)."""
    k = a.shape[0]
    aug = np.concatenate(
        [np.array(a, dtype=np.uint8), np.eye(k, dtype=np.uint8)], axis=1
    )

    def scale(row: np.ndarray, s: int) -> np.ndarray:
        out = EXP[LOG[row.astype(np.int32)] + LOG[s]]
        return np.where(row != 0, out, 0).astype(np.uint8)

    for col in range(k):
        nz = np.nonzero(aug[col:, col])[0]
        if len(nz) == 0:
            raise np.linalg.LinAlgError("singular matrix over GF(256)")
        piv = col + int(nz[0])
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = scale(aug[col], gf_inv(int(aug[col, col])))
        for r in range(k):
            if r != col and aug[r, col]:
                aug[r] ^= scale(aug[col], int(aug[r, col]))
    return aug[:, k:]


@functools.lru_cache(maxsize=None)
def decode_matrix(k: int, m: int, slots: tuple[int, ...]) -> np.ndarray:
    """uint8 [k, k]: left-inverse of G restricted to the k surviving
    fragment ``slots`` — ``data = decode_matrix @ fragments[slots]``.
    Cached per erasure pattern (there are only C(k+m, k) of them)."""
    if len(slots) != k:
        raise ValueError(f"need exactly k={k} slots, got {len(slots)}")
    return gf_matinv(generator_rows(k, m)[list(slots)])


# ---------------------------------------------------------------------------
# Encode / decode — fragment matrices
# ---------------------------------------------------------------------------


def encode_np(data: np.ndarray, m: int) -> np.ndarray:
    """uint8 [k, L] data rows -> [k+m, L] fragment rows (systematic)."""
    k = data.shape[0]
    parity = gf_matmul_np(parity_matrix(k, m).T, data)
    return np.concatenate([np.asarray(data, dtype=np.uint8), parity], axis=0)


def encode(data: torch.Tensor, m: int) -> torch.Tensor:
    """Tensor twin of :func:`encode_np` (via :func:`gf_matmul`), on
    ``data``'s device."""
    k = data.shape[0]
    parity = gf_matmul(parity_matrix(k, m).T, data)
    return torch.cat([data.to(torch.uint8), parity], dim=0)


def decode_np(fragments: np.ndarray, slots: tuple[int, ...], k: int,
              m: int) -> np.ndarray:
    """[k, L] surviving fragment rows (slot order ``slots``) -> data rows."""
    return gf_matmul_np(decode_matrix(k, m, tuple(slots)), fragments)


def decode(fragments: torch.Tensor, slots: tuple[int, ...], k: int,
           m: int) -> torch.Tensor:
    """Tensor twin of :func:`decode_np`: the survivor inverse is a tiny
    host matrix; applying it stays a batched device matmul."""
    return gf_matmul(decode_matrix(k, m, tuple(slots)), fragments)


# ---------------------------------------------------------------------------
# Blob helpers — the CoSim byte path
# ---------------------------------------------------------------------------


def split_blob(data: bytes, k: int) -> np.ndarray:
    """bytes -> uint8 [k, ceil(len/k)] data rows, zero padded."""
    length = len(data)
    frag_len = -(-length // k) if length else 0
    arr = np.zeros((k, frag_len), dtype=np.uint8)
    flat = np.frombuffer(data, dtype=np.uint8)
    arr.reshape(-1)[:length] = flat
    return arr


def encode_blob(data: bytes, k: int, m: int) -> list[bytes]:
    """bytes -> k+m fragment byte strings of ceil(len/k) bytes each."""
    rows = encode_np(split_blob(data, k), m)
    return [rows[s].tobytes() for s in range(k + m)]


def decode_blob(fragments: dict[int, bytes], k: int, m: int,
                length: int) -> bytes:
    """Any >= k fragments (slot -> bytes) -> the original payload."""
    slots = tuple(sorted(fragments))[:k]
    if len(slots) < k:
        raise ValueError(
            f"need >= {k} fragments to decode, got {len(fragments)}"
        )
    frag_len = -(-length // k) if length else 0
    rows = np.stack([
        np.frombuffer(fragments[s], dtype=np.uint8) for s in slots
    ]) if frag_len else np.zeros((k, 0), dtype=np.uint8)
    if all(s < k for s in slots):
        data = rows          # all-systematic survivors: no field math at all
    else:
        data = decode_np(rows, slots, k, m)
    return data.reshape(-1)[:length].tobytes()


# Fragment storage framing: each stored fragment is self-describing —
# a 4-byte big-endian payload length ahead of the row bytes — so a
# rebuilt master (election after the old one died) can recover a
# stripe's exact payload length from ANY surviving fragment.  The
# header is framing, not payload: repair-byte accounting counts row
# bytes only (BASELINE.md documents the convention).
_FRAME = 4


def frag_key(name: str, slot: int) -> str:
    """The LocalStore key a stripe fragment lives under."""
    return f"{name}#s{slot}"


def parse_frag_key(key: str) -> tuple[str, int] | None:
    """Inverse of :func:`frag_key`; None for non-fragment keys."""
    base, sep, tail = key.rpartition("#s")
    if not sep or not tail.isdigit():
        return None
    return base, int(tail)


def pack_fragment(row: bytes, length: int) -> bytes:
    return length.to_bytes(_FRAME, "big") + row


def unpack_fragment(blob: bytes) -> tuple[int, bytes]:
    """-> (payload length, row bytes)."""
    return int.from_bytes(blob[:_FRAME], "big"), blob[_FRAME:]


def repair_fragments(fragments: dict[int, bytes], lost_slots: list[int],
                     k: int, m: int, length: int) -> dict[int, bytes]:
    """Rebuild ``lost_slots`` from any k surviving fragments: decode the
    data rows, re-encode, and return just the requested slots — the
    fetch-k-re-encode step ``SDFSCluster.fail_recover`` executes."""
    payload = decode_blob(fragments, k, m, length)
    rows = encode_np(split_blob(payload, k), m)
    return {s: rows[s].tobytes() for s in lost_slots}
