"""Tensorized placement + repair planning over the live [N] alive mask.

The port of the JAX package's ``gossipfs_tpu/traffic/planner.py``: torch
ops on the masks' device, equal to the JAX package's for the same key.

The per-file Python repair loop (``SDFSMaster.plan_repairs``) is the right
shape at CLI scale; at the north-star scale — 100k+ members, tens of
thousands of files, thousands of arrivals per round — placement and repair
planning must be ARRAY programs against the same [N] masks the gossip
layer already produces.  This module is that program:

  * **placement** — ``sdfs/placement.py::place_batch`` (with the
    rejection-free sampled method) places thousands of files per round
    without an [n_files, N] intermediate;
  * **repair planning** — the whole replicas-lost x under-replicated-files
    diff is ONE masked computation: per-file surviving-replica counts from
    ``alive[replicas]``, deficiency scores, and a single top k picking
    the ``budget`` most-deficient repairable files (the repair-storm
    scheduler: a rack-kill's thousand deficient files drain at
    budget/round, most-endangered first, instead of serializing); the
    top k is a stable descending sort, ties to the lower file row, as
    ``jax.lax.top_k`` orders them;
  * **commit** — survivors compact to the row front, fresh reachable
    non-replica picks fill the tail, all in-array.

Quorum arithmetic is IMPORTED from ``sdfs/quorum.py`` (``write_quorum`` /
``read_quorum``) — never re-derived here.

``ReplicaTable`` is the host-side wrapper the scale bench drives
(``traffic_bench.py --scale``): it holds the replica table on the device
and exposes place / plan+commit / ack-accounting steps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.sdfs.placement import (
    OVERSAMPLE_FACTOR,
    first_k_distinct,
    place_batch,
    sample_members,
    top_k_desc,
)
from gossipfs_tpu_torch.sdfs.quorum import read_quorum, write_quorum
from gossipfs_tpu_torch.sdfs.types import REPLICATION_FACTOR


class RepairPlan(NamedTuple):
    """One budgeted planning pass over the whole table (device tensors).

    ``idx``/``valid`` — the up-to-``budget`` chosen file rows (invalid
    slots are budget headroom beyond the deficient count); ``source`` —
    first reachable surviving replica per chosen file; ``need`` — copies
    required; ``picks`` — [budget, k] fresh reachable non-replica nodes
    (-1 past ``need``); ``deficient`` — total repairable-deficient files
    BEFORE the budget cut (the backlog gauge); ``lost`` — files whose
    replicas are all gone (unrecoverable this pass).
    """

    idx: torch.Tensor
    valid: torch.Tensor
    source: torch.Tensor
    need: torch.Tensor
    picks: torch.Tensor
    deficient: torch.Tensor
    lost: torch.Tensor


def _working(replicas: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[F, k] — replica slot holds a node currently in ``mask``."""
    return (replicas >= 0) & mask[replicas.clamp(min=0).long()]


def plan_repairs_tensor(
    key: torch.Tensor,
    replicas: torch.Tensor,
    n_files,
    alive: torch.Tensor,
    reach: torch.Tensor,
    budget: int,
    k: int = REPLICATION_FACTOR,
) -> RepairPlan:
    """The masked-top-k repair planner (semantics of
    ``SDFSMaster.plan_repairs``, vectorized): deficient = fewer than
    min(k, n_alive) surviving replicas, at least one survivor reachable
    (the copy source); the ``budget`` most-deficient files get
    ``k - survivors`` fresh picks drawn uniformly without replacement
    from reachable non-replica nodes.  Deterministic under ``key``.
    ``n_files`` is an int or a 0-d tensor.
    """
    dev = replicas.device
    cap = replicas.shape[0]
    used = torch.arange(cap, device=dev) < n_files
    working = _working(replicas, alive) & used[:, None]
    w = working.sum(dim=1)
    target = torch.clamp(alive.sum(), max=k)
    sourced = working & reach[replicas.clamp(min=0).long()]
    placed = used & (replicas >= 0).any(dim=1)
    lost = placed & (w == 0)
    deficient = placed & (w < target) & (w > 0) & sourced.any(dim=1)

    score = torch.where(deficient, (k - w).to(torch.int32), 0)
    top, idx = top_k_desc(score, min(budget, cap))
    valid = top > 0

    # the first reachable survivor of each row (jnp.argmax on bools: the
    # first maximum, slot 0 when none is)
    src_slot = torch.argmax(sourced[idx].to(torch.int32), dim=1)
    forb = replicas[idx]
    source = torch.where(
        valid, torch.gather(forb, 1, src_slot[:, None])[:, 0], -1
    )
    need = torch.where(valid, k - w[idx], 0)

    # fresh picks: oversampled reachable draws, banned = the file's own
    # current replicas (dead ones included — a dead-but-listed node must
    # not be re-picked; it may still hold stale bytes and rejoin)
    draws = sample_members(key, reach, idx.shape[0], OVERSAMPLE_FACTOR * k)
    banned = (
        (draws[:, :, None] == forb[:, None, :]) & (forb >= 0)[:, None, :]
    ).any(dim=2)
    picks_full = first_k_distinct(torch.where(banned, -1, draws), k)
    picks = torch.where(
        torch.arange(k, device=dev)[None, :] < need[:, None], picks_full, -1
    )
    return RepairPlan(
        idx=idx, valid=valid, source=source, need=need, picks=picks,
        deficient=deficient.sum(), lost=lost,
    )


def commit_repairs(
    replicas: torch.Tensor,
    idx: torch.Tensor,
    valid: torch.Tensor,
    picks: torch.Tensor,
    alive: torch.Tensor,
    k: int = REPLICATION_FACTOR,
) -> torch.Tensor:
    """Apply a :class:`RepairPlan` in-array: each chosen row becomes
    survivors (compacted to the front) + the landed picks — exactly
    ``commit_repair``'s survivors-plus-successful-copies rule.  Returns a
    new table; ``replicas`` is left as it was."""
    rows = replicas[idx]
    working = _working(rows, alive)
    _, order = torch.sort((~working).to(torch.int8), dim=1, stable=True)
    compacted = torch.gather(rows, 1, order)
    w = working.sum(dim=1)
    pos = torch.arange(k, device=replicas.device)[None, :]
    pick_idx = pos - w[:, None]
    shifted = torch.gather(picks, 1, pick_idx.clamp(0, k - 1))
    newrow = torch.where(
        pos < w[:, None],
        compacted,
        torch.where((pick_idx >= 0) & (shifted >= 0), shifted, -1),
    )
    newrow = torch.where(valid[:, None], newrow, rows)
    out = replicas.clone()
    out[idx] = newrow.to(replicas.dtype)
    return out


def replication_stats(
    replicas: torch.Tensor,
    n_files,
    alive: torch.Tensor,
    reach: torch.Tensor,
    k: int = REPLICATION_FACTOR,
) -> torch.Tensor:
    """int32 [k + 3] summary vector: histogram of surviving-replica counts
    (0..k live replicas — slot 0 is the lost-file count) plus acked-write
    reachability: files whose reachable replicas meet the WRITE quorum,
    and files meeting the READ quorum (``sdfs/quorum.py`` — the single
    owner of both thresholds)."""
    dev = replicas.device
    cap = replicas.shape[0]
    used = torch.arange(cap, device=dev) < n_files
    placed = used & (replicas >= 0).any(dim=1)
    w = (_working(replicas, alive) & placed[:, None]).sum(dim=1)
    # unplaced rows add 0 at bin k, as the JAX package's scatter does
    hist = torch.zeros((k + 1,), dtype=torch.int32, device=dev)
    hist.scatter_add_(0, torch.where(placed, w, k), placed.to(torch.int32))
    r = (_working(replicas, reach) & placed[:, None]).sum(dim=1)
    w_ok = (placed & (r >= write_quorum(k))).sum()
    r_ok = (placed & (r >= read_quorum(k))).sum()
    return torch.cat([hist, torch.stack([w_ok, r_ok]).to(torch.int32)])


class ReplicaTable:
    """Device-resident file->replica table: the 100k-member traffic lane.

    The byte plane is out of scope here (BASELINE.md documents the honest
    CPU-pinned boundary); what this models EXACTLY is the metadata
    plane's placement and repair decisions against live membership masks
    — the part that was per-file Python and is now O(1) array steps per
    round at any N the masks support.  The table lives on ``device`` (the
    card unless the caller asks for the CPU); each pass reads back the
    same host counters as the JAX package's.
    """

    def __init__(self, capacity: int, n: int,
                 k: int = REPLICATION_FACTOR, seed: int = 0,
                 device="cuda"):
        self.capacity = capacity
        self.n = n
        self.k = k
        self.device = torch.device(device)
        self.replicas = torch.full((capacity, k), -1, dtype=torch.int32,
                                   device=self.device)
        self.n_files = 0
        self._key = trandom.PRNGKey(seed, device=self.device)
        self._ctr = 0

    def _next_key(self) -> torch.Tensor:
        self._ctr += 1
        return trandom.fold_in(self._key, self._ctr)

    def place(self, alive: torch.Tensor, count: int,
              method: str = "auto") -> torch.Tensor:
        """Place ``count`` new files over ``alive``; returns their rows."""
        if self.n_files + count > self.capacity:
            raise ValueError("ReplicaTable capacity exceeded")
        rows = place_batch(self._next_key(), alive, count, self.k,
                           method=method)
        self.replicas[self.n_files:self.n_files + count] = rows
        self.n_files += count
        return rows

    def plan_and_commit(self, alive: torch.Tensor, reach: torch.Tensor,
                        budget: int) -> dict:
        """One budgeted repair pass; commits landed picks in-array and
        returns the pass's host-side counters."""
        plan = plan_repairs_tensor(
            self._next_key(), self.replicas, self.n_files,
            alive, reach, budget, self.k,
        )
        self.replicas = commit_repairs(
            self.replicas, plan.idx, plan.valid, plan.picks, alive, self.k
        )
        # the four counters in one host read
        executed, deficient, copies, lost = torch.stack([
            plan.valid.sum(), plan.deficient, (plan.picks >= 0).sum(),
            plan.lost.sum()]).tolist()
        return {
            "repairs_executed": executed,
            "repairs_pending": max(deficient - executed, 0),
            "copies_ordered": copies,
            "files_lost": lost,
        }

    def stats(self, alive: torch.Tensor, reach: torch.Tensor) -> dict:
        v = replication_stats(
            self.replicas, self.n_files, alive, reach, self.k
        ).tolist()
        return {
            "files": self.n_files,
            "replica_histogram": v[: self.k + 1],
            "write_quorum_reachable": int(v[self.k + 1]),
            "read_quorum_reachable": int(v[self.k + 2]),
        }
