"""Stripe-aware placement + repair planning over the live [N] masks.

The port of the JAX package's ``gossipfs_tpu/erasure/planner.py``: the
tensor functions are torch ops on the masks' device, equal to the JAX
package's for the same key; the host functions (``place_stripe``,
``pick_repair_targets``) are copies.  It extends the tensor replica
planner (``traffic/planner.py``) to the erasure plane:

  * **placement** — ``place_stripes`` draws k+m distinct fragment
    holders per stripe with RACK-disjointness against a group vector:
    the same rejection-free sampled machinery as ``place_batch``'s
    sampled method, with the first-k-distinct dedup keyed on
    ``racks[node]`` instead of the node id (distinct racks imply
    distinct nodes).  A correlated rack kill then costs a stripe at
    most ONE fragment — the whole point of paying m parities.
  * **repair planning** — ``plan_stripe_repairs_tensor`` is the same
    one-shot masked-top-k diff with per-stripe fragment-deficit
    budgeting: score = (k+m) - live_fragments, masked to repairable
    stripes, so the budget drains MOST-ENDANGERED-FIRST (a stripe at
    k live fragments is one loss from data death; lost >= m fragments
    IS data loss).  Lost stripes (live < k) are unreconstructable and
    reported, never planned.  The scores are small integers, so ties
    are the rule: the top k is a stable descending sort, ties to the
    lower stripe row, as ``jax.lax.top_k`` orders them.

Threshold math is IMPORTED from ``sdfs/quorum.py``
(``stripe_read_quorum`` / ``stripe_write_quorum``) — never re-derived
here.
"""

from __future__ import annotations

import random
from typing import NamedTuple

import torch

from gossipfs_tpu_torch.sdfs.placement import (
    OVERSAMPLE_FACTOR,
    first_k_distinct,
    first_kept,
    sample_members,
    top_k_desc,
)
from gossipfs_tpu_torch.sdfs.quorum import (stripe_read_quorum,
                                            stripe_write_quorum)
from gossipfs_tpu_torch.sdfs.types import (STRIPE_K, STRIPE_M,
                                           STRIPE_WRITE_SLACK)


class StripePlan(NamedTuple):
    """One budgeted stripe-repair planning pass (device tensors).

    ``idx``/``valid`` — the up-to-``budget`` chosen stripe rows;
    ``need`` — fragments to rebuild per chosen stripe; ``picks`` —
    [budget, k+m] slot-aligned fresh holders (-1 where the slot is
    healthy); ``degraded`` — repairable stripes below full strength
    BEFORE the budget cut; ``lost`` — [F] stripes with fewer than k
    live fragments (data loss this pass).
    """

    idx: torch.Tensor
    valid: torch.Tensor
    need: torch.Tensor
    picks: torch.Tensor
    degraded: torch.Tensor
    lost: torch.Tensor


def first_k_group_distinct(nodes: torch.Tensor, groups: torch.Tensor,
                           k: int) -> torch.Tensor:
    """[rows, m] draws -> [rows, k] first k draws with DISTINCT group
    ids, -1 padded — ``placement.first_k_distinct`` with the dup mask
    keyed on ``groups[node]``; the kept values are still the nodes."""
    g = torch.where(nodes >= 0, groups[nodes.clamp(min=0).long()], -1)
    return first_kept(nodes, g, k)


def place_stripes(
    key: torch.Tensor,
    alive: torch.Tensor,
    racks: torch.Tensor,
    n_stripes: int,
    k: int = STRIPE_K,
    m: int = STRIPE_M,
) -> torch.Tensor:
    """int32 [n_stripes, k+m] — fragment holders drawn uniformly over
    live nodes, one per DISTINCT rack (``racks`` is the [N] group
    vector).  Slots beyond the sampled distinct-rack count are -1 (the
    caller's unplaced-slot retry rule, as in ``place_batch``)."""
    draws = sample_members(key, alive, n_stripes,
                           OVERSAMPLE_FACTOR * (k + m))
    return first_k_group_distinct(draws, racks, k + m)


def place_stripe(members: list[int], racks: dict[int, int] | list[int],
                 rng: random.Random, k: int = STRIPE_K,
                 m: int = STRIPE_M) -> list[int]:
    """Host twin of :func:`place_stripes` for the control-plane path
    (``sdfs/master.py``): k+m distinct holders, rack-BALANCED — each
    pass takes at most one node per rack, so with R racks no rack ever
    holds more than ceil((k+m)/R) fragments.  With R >= k+m that is
    full rack-disjointness; smaller clusters degrade gracefully (a
    correlated rack kill then costs at most ceil((k+m)/R) fragments,
    which stays <= m down to R = 4 at the default (4, 2) shape)."""
    pool = list(members)
    rng.shuffle(pool)
    chosen: list[int] = []
    while pool and len(chosen) < k + m:
        seen_racks: set[int] = set()
        next_pool: list[int] = []
        for node in pool:
            if len(chosen) < k + m and racks[node] not in seen_racks:
                seen_racks.add(racks[node])
                chosen.append(node)
            else:
                next_pool.append(node)
        pool = next_pool
    return chosen


def pick_repair_targets(candidates: list[int],
                        racks: dict[int, int] | list[int],
                        rack_load: dict[int, int], need: int,
                        rng: random.Random) -> list[int]:
    """Host-side repair placement: up to ``need`` distinct nodes from
    ``candidates``, always picking the least-loaded rack first
    (``rack_load`` counts the stripe's surviving fragments per rack) —
    so repair restores :func:`place_stripe`'s ceil((k+m)/R) per-rack
    bound instead of eroding it."""
    pool = list(candidates)
    rng.shuffle(pool)
    load = dict(rack_load)
    picks: list[int] = []
    cap = 0
    while pool and len(picks) < need:
        cap += 1  # this pass admits racks holding < cap fragments
        next_pool: list[int] = []
        for node in pool:
            if len(picks) < need and load.get(racks[node], 0) < cap:
                load[racks[node]] = load.get(racks[node], 0) + 1
                picks.append(node)
            else:
                next_pool.append(node)
        pool = next_pool
    return picks


def _live_slots(holders: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[F, k+m] — fragment slot holds a node currently in ``mask``."""
    return (holders >= 0) & mask[holders.clamp(min=0).long()]


def plan_stripe_repairs_tensor(
    key: torch.Tensor,
    holders: torch.Tensor,
    n_stripes,
    alive: torch.Tensor,
    reach: torch.Tensor,
    budget: int,
    k: int = STRIPE_K,
    m: int = STRIPE_M,
) -> StripePlan:
    """The masked-top-k stripe-repair planner: degraded = fewer than
    min(k+m, n_alive) live fragments but still >= k REACHABLE ones (the
    re-encode needs k sources); the ``budget`` largest-deficit stripes
    get slot-aligned fresh holders drawn uniformly from reachable
    non-holder nodes.  Deterministic under ``key``.  ``n_stripes`` is an
    int or a 0-d tensor."""
    dev = holders.device
    width = k + m
    cap = holders.shape[0]
    used = torch.arange(cap, device=dev) < n_stripes
    live = _live_slots(holders, alive) & used[:, None]
    w = live.sum(dim=1)
    target = torch.clamp(alive.sum(), max=width)
    sources = (_live_slots(holders, reach) & used[:, None]).sum(dim=1)
    placed = used & (holders >= 0).any(dim=1)
    lost = placed & (w < stripe_read_quorum(k, m))
    degraded = placed & ~lost & (w < target) & (
        sources >= stripe_read_quorum(k, m)
    )

    score = torch.where(degraded, (width - w).to(torch.int32), 0)
    top, idx = top_k_desc(score, min(budget, cap))
    valid = top > 0

    rows = holders[idx]
    hole = valid[:, None] & ~_live_slots(rows, alive)
    need = hole.sum(dim=1)

    draws = sample_members(key, reach, idx.shape[0],
                           OVERSAMPLE_FACTOR * width)
    banned = (
        (draws[:, :, None] == rows[:, None, :]) & (rows >= 0)[:, None, :]
    ).any(dim=2)
    picks_flat = first_k_distinct(torch.where(banned, -1, draws), width)
    # scatter the flat picks into the holed slots, in slot order
    rank = torch.cumsum(hole, dim=1) - 1
    picks = torch.where(
        hole,
        torch.gather(picks_flat, 1, rank.clamp(0, width - 1)),
        -1,
    )
    return StripePlan(idx=idx, valid=valid, need=need, picks=picks,
                      degraded=degraded.sum(), lost=lost)


def commit_stripe_repairs(
    holders: torch.Tensor,
    idx: torch.Tensor,
    valid: torch.Tensor,
    picks: torch.Tensor,
) -> torch.Tensor:
    """Apply a :class:`StripePlan` in-array: landed picks fill their
    slots, healthy slots keep their holders (slot-aligned, so no
    compaction — the codec's row order IS the slot order).  Returns a
    new table; ``holders`` is left as it was."""
    rows = holders[idx]
    newrow = torch.where(valid[:, None] & (picks >= 0), picks, rows)
    out = holders.clone()
    out[idx] = newrow
    return out


def stripe_stats(
    holders: torch.Tensor,
    n_stripes,
    alive: torch.Tensor,
    reach: torch.Tensor,
    k: int = STRIPE_K,
    m: int = STRIPE_M,
    slack: int = STRIPE_WRITE_SLACK,
) -> torch.Tensor:
    """int32 [k+m+4] summary: histogram of live-fragment counts (0..k+m;
    the sub-k bins are data loss) + stripes meeting the write and read
    quorums over REACHABLE fragments (``sdfs/quorum.py`` owns both) +
    the degraded count.  Unplaced rows count into a spare bin past the
    histogram that is sliced off (jax's dropped ``width + 1`` index)."""
    dev = holders.device
    width = k + m
    cap = holders.shape[0]
    used = torch.arange(cap, device=dev) < n_stripes
    placed = used & (holders >= 0).any(dim=1)
    w = (_live_slots(holders, alive) & placed[:, None]).sum(dim=1)
    hist = torch.zeros((width + 2,), dtype=torch.int32, device=dev)
    hist.scatter_add_(0, torch.where(placed, w, width + 1),
                      placed.to(torch.int32))
    r = (_live_slots(holders, reach) & placed[:, None]).sum(dim=1)
    w_ok = (placed & (r >= stripe_write_quorum(k, m, slack))).sum()
    r_ok = (placed & (r >= stripe_read_quorum(k, m))).sum()
    degraded = (placed & (w >= stripe_read_quorum(k, m))
                & (w < width)).sum()
    tail = torch.stack([w_ok, r_ok, degraded]).to(torch.int32)
    return torch.cat([hist[: width + 1], tail])
