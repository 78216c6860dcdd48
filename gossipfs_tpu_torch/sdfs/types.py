"""SDFS metadata types.

Reference equivalents: ``master.File_info{Node_list, Version, Timestamp}``
(reference: master/master.go:22-31) and the per-node filename->version registry
``sdfs_slave.SDFSSLAVE`` (sdfs_slave/sdfs_slave.go:10-18).  Time is measured in
gossip rounds (1 round == 1 s), like everything in the TPU build.
"""

from __future__ import annotations

import dataclasses

REPLICATION_FACTOR = 4        # 4 replicas, tolerates 3 failures (master.go:104,131)
WRITE_CONFLICT_WINDOW = 60    # write-write conflict window, rounds (master.go:225)
CONFIRM_TIMEOUT = 30          # conflict-confirmation timeout, rounds (server.go:172)
RECOVERY_DELAY = 8            # heartbeats to wait before re-replication (slave.go:1123)

# Erasure mode defaults (redundancy="stripe"): a (4, 2) systematic RS
# stripe stores 6 fragments of S/4 bytes each — 1.5x storage vs the 4x
# of full replication — and survives any 2 fragment losses.  The write
# slack lets the put ack one fragment early (5 of 6 landed) while still
# leaving one parity of post-ack margin; see sdfs/quorum.py.
STRIPE_K = 4                  # data fragments per stripe
STRIPE_M = 2                  # parity fragments per stripe
STRIPE_WRITE_SLACK = 1        # un-landed fragments tolerated at ack time


@dataclasses.dataclass
class FileInfo:
    """Metadata the master keeps per SDFS file (master/master.go:22-31)."""

    node_list: list[int]      # replica node ids
    version: int
    timestamp: int            # round of last successful put


@dataclasses.dataclass
class StripeInfo:
    """Metadata the master keeps per stripe-mode file: one holder node
    per fragment SLOT (index < k is data, >= k is parity), -1 for a slot
    whose fragment is currently unplaced/lost.  The slot order is the
    codec's row order, so repair re-encodes straight into the holes."""

    fragment_nodes: list[int]   # len k+m, slot -> holder node id (-1 = none)
    version: int
    timestamp: int              # round of last successful put
    length: int                 # payload bytes (fragments are padded to S/k)


@dataclasses.dataclass(frozen=True)
class StripeRepairPlan:
    """One stripe's budgeted repair order: re-encode ``slots`` from any k
    surviving fragments and land them on ``new_nodes`` (slot-aligned)."""

    file: str
    version: int
    slots: tuple[int, ...]       # fragment slots to rebuild
    new_nodes: tuple[int, ...]   # target holder per slot (same order)
    survivors: tuple[int, ...]   # slots whose fragments were live at plan time


@dataclasses.dataclass(frozen=True)
class ReplicatePlan:
    """One file's re-replication order (master.Replicate_info, master.go:27-31)."""

    file: str
    source: int               # first reachable healthy replica to copy from
    version: int
    new_nodes: tuple[int, ...]  # nodes that must receive a copy
    survivors: tuple[int, ...] = ()  # replicas that already hold the data
