"""Quorum arithmetic for replicated reads/writes — the ONE owner.

Reference: ``cal_quorum_num`` computes ``Ceil((len+1)/2)`` with *integer*
division, so the Ceil is a no-op and the quorum is ``floor((n+1)/2)`` — 2 of 4
replicas for BOTH writes and reads (slave/slave.go:717-722).  The report
claims "ACK by 3 replicas" for writes — ``ceil((n+1)/2)`` = 3 of 4, the
W=3/R=2 pair whose ``W + R > n`` inequality is what actually guarantees a
read quorum intersects the last acked write.  The code disagrees with the
report, and we reproduce the CODE's behavior (the actually-deployed
semantics, BASELINE.md "Protocol constants"); ``claimed_write_quorum``
exposes the report's intended value so the discrepancy stays checkable.

Single-ownership rule (pinned by a lint test in tests/test_traffic.py):
every consumer — ``sdfs/cluster.py``'s ack counting, the traffic plane's
planner/harness (``gossipfs_tpu_torch/traffic/``) — imports these functions.
No re-derived ``(n + 1) // 2`` exists anywhere else in the tree.

The stripe thresholds below extend the same ownership to the erasure
plane (``gossipfs_tpu_torch/erasure/``): a (k, m) stripe reads at k-of-(k+m)
and acks a write at (k+m-f)-of-(k+m).  gossipfs-lint's
stripe-quorum-ownership rule flags any re-derived ``k + m - f``
threshold comparison outside this module.
"""

from __future__ import annotations


def quorum(n_replicas: int) -> int:
    """The deployed quorum: floor((n+1)/2) — 2 of 4 for writes AND reads."""
    return (n_replicas + 1) // 2


def write_quorum(n_replicas: int) -> int:
    """W — acks required before a put commits (slave.go:717-722 deployed
    arithmetic; the report claims ``claimed_write_quorum``)."""
    return quorum(n_replicas)


def read_quorum(n_replicas: int) -> int:
    """R — replica version reports required before a get proceeds."""
    return quorum(n_replicas)


def claimed_write_quorum(n_replicas: int) -> int:
    """The report's claimed W: the Ceil ``cal_quorum_num`` INTENDED —
    ceil((n+1)/2), i.e. 3 of 4 — which with R=2 satisfies W + R > n.
    Documented-discrepancy accessor only; nothing executes this policy."""
    return n_replicas // 2 + 1


def stripe_read_quorum(k: int, m: int) -> int:
    """R for a (k, m) stripe: ANY k of the k+m fragments reconstruct the
    payload (the MDS property of the systematic RS code in
    ``gossipfs_tpu_torch/erasure/codec.py``), so reads proceed at exactly k."""
    if k < 1 or m < 1:
        raise ValueError(f"stripe shape needs k >= 1 and m >= 1, got ({k}, {m})")
    return k


def stripe_write_quorum(k: int, m: int, slack: int) -> int:
    """W for a (k, m) stripe: (k + m - slack) fragment acks commit a put.

    ``slack`` is the number of fragment landings a writer may still be
    waiting on at ack time.  It must stay <= m - 1 so an acked write
    retains at least one parity fragment of durability margin (losing
    every un-acked fragment still leaves >= k live, and the read quorum
    k intersects the acked set: W + R = 2k + m - slack > k + m)."""
    if k < 1 or m < 1:
        raise ValueError(f"stripe shape needs k >= 1 and m >= 1, got ({k}, {m})")
    if not 0 <= slack <= m - 1:
        raise ValueError(f"write slack must be in [0, m-1], got {slack} for m={m}")
    return k + m - slack
