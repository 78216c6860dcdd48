"""Replica placement: uniform random without replacement until 4 replicas.

The port of the JAX package's ``gossipfs_tpu/sdfs/placement.py``.
Reference: ``Init_replica`` (master/master.go:129-150) draws random members
until it has 4 distinct ones.  Note the reference's latent bug — it draws with
``rand.Intn(len(members)-1)``, which can never select the *last* member of the
snapshot; we implement the evidently intended uniform choice (documented
deviation, caught by statistical test).

Three implementations with identical semantics:
  * ``place`` — plain Python over a membership list (control-plane path).
  * ``place_batch`` — vectorized torch placement of many files at once over
    an alive mask, for the 100k-node SDFS co-sim (BASELINE config 5).  Two
    methods behind one call: the exact Gumbel top-k (O(n_files x N) — fine
    to ~8k members) and, at traffic-plane scale, a rejection-free SAMPLED
    draw (O(n_files x m), m = a small static oversample) that never
    materializes an [n_files, N] score matrix.
  * ``place_batch_np`` — the host-side (numpy) batch form the metadata
    master uses for thousands-of-puts-per-round workloads
    (``SDFSMaster.handle_put_batch``).

The tensor functions draw from the port's threefry (``random.py``) and
return what the JAX package's return for the same key, bit for bit:

  * the Gumbel method ranks each row by the 23 uniform bits behind jax's
    ``gumbel`` draw (``-log(-log(u))`` of ``u = uniform(tiny, 1)``), since
    the index ranking is all it returns and the transform is strictly
    increasing in those bits (XLA's float32 ``log`` included, over all
    2^23 of them); no float ``log`` of this device enters the result;
  * ``jax.lax.top_k``'s order (ties to the lower index) is a stable
    descending sort;
  * the dropped scatter of ``first_k_distinct`` writes to a spare column
    that is sliced off.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.sdfs.types import REPLICATION_FACTOR

# place_batch switches from the exact Gumbel top-k to the sampled draw
# above this member count: the Gumbel path's [n_files, N] perturbed-score
# matrix is exact but costs n_files x N scores (1.6 GB at 2048 files over
# 100k members), while the sampled path is O(n_files x OVERSAMPLE)
BATCH_GUMBEL_MAX_N = 8192

# draws per file on the sampled path: first-k-distinct of iid uniform
# draws IS uniform-without-replacement; with k=4 picks the chance of
# fewer than k distinct among 8k draws is ~(k/n_alive)^(m-k) — negligible
# whenever n_alive >> k (the regime the method is selected for), and a
# short row falls back to -1 slots the caller retries
OVERSAMPLE_FACTOR = 8


def place(
    members: list[int], rng: random.Random, k: int = REPLICATION_FACTOR
) -> list[int]:
    """Choose min(k, len(members)) distinct replica nodes, uniformly."""
    if len(members) <= k:
        return list(members)
    return rng.sample(list(members), k)


def top_k_desc(scores: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values and
    their indices, ties to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def first_kept(nodes: torch.Tensor, keep_on: torch.Tensor,
               k: int) -> torch.Tensor:
    """[rows, m] draws -> [rows, k]: the first k draws (``nodes >= 0``)
    whose ``keep_on`` value no earlier draw of the row shares, -1 padded.
    ``first_k_distinct`` keys on the node itself, the stripe planner's
    ``first_k_group_distinct`` on its group."""
    rows, m = nodes.shape
    dev = nodes.device
    # dup[i, j, j2] — draw j repeats an EARLIER draw j2 < j of the same row
    ar = torch.arange(m, device=dev)
    dup = (keep_on[:, :, None] == keep_on[:, None, :]) & (
        ar[None, :] < ar[:, None])[None]
    is_new = ~dup.any(dim=2) & (nodes >= 0)
    rank = torch.cumsum(is_new, dim=1) - 1
    take = is_new & (rank < k)
    # one spare column takes every dropped write (jax's mode="drop")
    out = torch.full((rows, k + 1), -1, dtype=torch.int32, device=dev)
    out.scatter_(1, torch.where(take, rank, k),
                 torch.where(take, nodes.to(torch.int32), -1))
    return out[:, :k]


def first_k_distinct(nodes: torch.Tensor, k: int) -> torch.Tensor:
    """[rows, m] draws -> [rows, k] first-k-distinct per row, -1 padded.

    Keeping the FIRST occurrence of each value in draw order is exactly
    sequential rejection sampling, so the result is uniform without
    replacement given iid uniform draws.
    """
    return first_kept(nodes, nodes, k)


def sample_members(key: torch.Tensor, mask: torch.Tensor, rows: int,
                   m: int) -> torch.Tensor:
    """[rows, m] node ids drawn iid-uniformly over ``mask``'s true set.

    Rank-to-index via searchsorted on the mask's cumsum — no [rows, N]
    intermediate, no dynamic-shape nonzero, no host read (the draw's bound
    is the device count).  Rows are -1 when the mask is empty.
    """
    n_set = mask.sum()
    cum = torch.cumsum(mask.to(torch.int64), dim=0)
    ranks = trandom.randint(key, (rows, m), 0, torch.clamp(n_set, min=1))
    nodes = torch.searchsorted(cum, ranks.to(torch.int64) + 1)
    return torch.where(n_set > 0, nodes.to(torch.int32), -1)


def place_batch(
    key: torch.Tensor,
    alive: torch.Tensor,
    n_files: int,
    k: int = REPLICATION_FACTOR,
    method: str = "auto",
) -> torch.Tensor:
    """int32 [n_files, k] — independent uniform placements over live nodes.

    ``method="gumbel"``: samples without replacement per file via Gumbel
    top-k over the alive mask (exact — if fewer than k nodes are alive,
    dead slots are filled with -1).  ``method="sampled"``: rejection-free
    oversampled draw (``sample_members`` + first-k-distinct) that scales
    to 100k+ members; a row may carry -1 slots when the draw collides
    (vanishingly rare at n_alive >> k) or n_alive < k — callers treat -1
    as an unplaced slot and retry.  ``"auto"`` picks gumbel at or below
    ``BATCH_GUMBEL_MAX_N`` members, sampled above.
    """
    n = alive.shape[0]
    if method == "auto":
        method = "gumbel" if n <= BATCH_GUMBEL_MAX_N else "sampled"
    if method == "gumbel":
        # the 23 uniform bits behind jax.random.gumbel(key, (n_files, n)),
        # which is strictly increasing in them; masked entries rank below
        # every draw, as jax's -inf does
        bits = trandom.bits32(key, (n_files, n)) >> 9
        scores = torch.where(alive[None, :], bits, -1)
        _, idx = top_k_desc(scores, k)
        enough = alive.sum() >= torch.arange(1, k + 1, device=alive.device)
        return torch.where(enough[None, :], idx.to(torch.int32), -1)
    if method != "sampled":
        raise ValueError(f"unknown placement method: {method!r}")
    nodes = sample_members(key, alive, n_files, OVERSAMPLE_FACTOR * k)
    return first_k_distinct(nodes, k)


def place_batch_np(
    rng: np.random.Generator,
    members: np.ndarray,
    n_files: int,
    k: int = REPLICATION_FACTOR,
) -> np.ndarray:
    """Host-side batch placement: int64 [n_files, k] over a member array.

    The metadata master's thousands-of-new-files-per-round path
    (``SDFSMaster.handle_put_batch``): one Gumbel top-k over the member
    list per call — same uniform-without-replacement semantics as
    ``place``, different (still uniform) draws, numpy only so the
    control plane stays host-side.  Fewer than k members: every file
    gets the whole list (``place``'s small-cluster rule).
    """
    members = np.asarray(members, dtype=np.int64)
    n_m = len(members)
    if n_m <= k:
        return np.tile(members, (n_files, 1)) if n_m else np.empty(
            (n_files, 0), dtype=np.int64
        )
    g = rng.gumbel(size=(n_files, n_m))
    idx = np.argpartition(-g, k - 1, axis=1)[:, :k]
    return members[idx]
