"""The FailureDetector interface: the seam between the detector and the
code that consumes it.

The port's copy of the JAX package's ``gossipfs_tpu/detector/api.py``
(which imports nothing of JAX; the port keeps its own copy all the same).
Feed membership events in, advance time, read each node's membership view
and the detection event stream out.  Consumers (the SDFS master's
placement logic, the CLI, the shim) do not care which implementation
runs behind it: the simulated cluster on the card (detector/sim.py) or
real sockets.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable


@dataclasses.dataclass(frozen=True)
class DetectionEvent:
    """One detector firing: ``observer`` declared ``subject`` failed at ``round``."""

    round: int
    observer: int
    subject: int
    false_positive: bool  # subject was actually alive (ground truth known in sim)


@runtime_checkable
class FailureDetector(Protocol):
    """Protocol every detector implementation satisfies."""

    def join(self, node: int) -> None:
        """Node (re)joins through the introducer (CLI ``join``)."""

    def leave(self, node: int) -> None:
        """Voluntary departure with LEAVE broadcast (CLI ``leave``)."""

    def crash(self, node: int) -> None:
        """Crash-stop fault injection."""

    def advance(self, rounds: int = 1) -> None:
        """Advance simulated/real time by whole heartbeat periods."""

    def membership(self, observer: int) -> list[int]:
        """Observer's current member list (CLI ``lsm``)."""

    def alive_nodes(self) -> list[int]:
        """Ground-truth live set (what the SDFS master consumes)."""

    def drain_events(self) -> list[DetectionEvent]:
        """Detection events since the last drain.

        The sim reports one event per newly-detected subject, attributed
        to the lowest-index observer that fired that round (bulk and
        interactive paths agree; effectively the reference's semantics,
        where the first detector's REMOVE broadcast preempts the rest).
        The socket engines report whichever of their detectors actually
        fired first in real time.
        """
