"""Membership snapshots: read the simulated cluster while a bulk run goes on.

The port's copy of the JAX package's ``gossipfs_tpu/utils/snapshot.py``.
``SimDetector.advance_bulk(rounds, snapshot_every=k)`` splits the horizon
into k-round chunks, runs them from a background thread, and publishes a
:class:`Snapshot` to a latest-wins :class:`SnapshotBuffer` as each chunk
completes; another thread (the shim) reads ``buffer.latest()`` for a
consistent mid-run membership view.

One difference from the JAX package: the port's round loops update the
lanes IN PLACE, so the next chunk overwrites what the chunk-boundary state
held.  A snapshot therefore owns its status: a device copy of the
``[N, N]`` status (1 B per entry) taken in stream order at the chunk
boundary, before the next chunk is queued.  That keeps the JAX package's
point-in-time guarantee: what a snapshot reads is its own round, whatever
has run since.
"""

from __future__ import annotations

import dataclasses
import threading
from functools import cached_property

import numpy as np
import torch

from gossipfs_tpu_torch.core.state import MEMBER


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One consistent point-in-time view of the whole cluster.

    ``status_lanes`` is the snapshot's own copy of the ``[N, N]`` status
    at the chunk boundary (on the lanes' device; row reads transfer one
    ``[N]`` slice).  A latest-wins buffer keeps at most one alive, so
    holding it does not accumulate device memory."""

    round: int
    alive: np.ndarray             # bool [N], fetched at the boundary
    status_lanes: torch.Tensor    # int8 [N, N], owned by the snapshot

    def membership(self, node: int) -> list[int]:
        row = self.status_lanes[node].cpu().numpy()
        return np.nonzero(row == MEMBER)[0].tolist()

    @cached_property
    def status(self) -> np.ndarray:
        """Full ``[N, N]`` status matrix (one bulk transfer; prefer
        :meth:`membership` for single-observer reads)."""
        return self.status_lanes.cpu().numpy()


class SnapshotBuffer:
    """Latest-wins buffer written by the chunk pipeline, read by any thread."""

    def __init__(self, keep_history: bool = False):
        self._lock = threading.Lock()
        self._latest: Snapshot | None = None
        self._history: list[Snapshot] | None = [] if keep_history else None

    def push(self, snap: Snapshot) -> None:
        with self._lock:
            self._latest = snap
            if self._history is not None:
                self._history.append(snap)

    def clear(self) -> None:
        """Drop the latest view (and history): called when a new bulk run
        starts, so stale rounds cannot serve reads and the previous run's
        snapshots are released."""
        with self._lock:
            self._latest = None
            if self._history is not None:
                self._history = []

    def latest(self) -> Snapshot | None:
        with self._lock:
            return self._latest

    @property
    def history(self) -> list[Snapshot]:
        with self._lock:
            return list(self._history or [])
