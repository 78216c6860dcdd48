"""Detection-quality metrics: time-to-detect, convergence, false-positive rate.

The port of the JAX package's ``metrics/detection.py`` reductions over a
run's outputs (already numpy there): the round loop's ``MetricsCarry`` and
stacked ``RoundMetrics`` come back from the device once, at the end.  The
partition-aware part (the scenario engine's observables) reduces one
round's state on the device (:func:`partition_round_stats`) and a series
of those rows plus the detection events on the host
(:func:`summarize_partition`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gossipfs_tpu_torch.core.state import MEMBER, SimState
from gossipfs_tpu_torch.ops.merge_update import row_chunks


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class DetectionReport:
    """Summary of one simulation run's failure-detection behavior.

    Under the SWIM lifecycle ``true_detections``/``false_positives`` count
    SUSPECT -> FAILED confirmations and the suspicion fields are live; on
    the crash-only loop they are zeros/empty.
    """

    n: int
    rounds: int
    # per tracked crash: rounds from crash to first detection / full removal
    ttd_first: dict[int, int]        # node -> rounds (or -1 if never detected)
    ttd_converged: dict[int, int]    # node -> rounds (or -1 if never converged)
    true_detections: int
    false_positives: int
    false_positive_rate: float       # FP events / (alive-observer x subject x round)
    final_alive: int
    suspects_entered: int = 0
    refutations: int = 0
    fp_suppressed: int = 0
    ttd_suspect: dict[int, int] = dataclasses.field(default_factory=dict)
    suspect_to_confirm: dict[int, int] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def summarize(carry, per_round, crash_rounds: dict[int, int] | None = None,
              n_effective: int | None = None) -> DetectionReport:
    """Reduce a run's outputs to a DetectionReport.

    ``crash_rounds``: {node: round it was crashed} for scheduled faults
    whose detection latency should be reported.  ``n_effective``: the
    live-cohort size of a padded run (FPR opportunities then count real
    subjects only)."""
    first = _np(carry.first_detect)
    conv = _np(carry.converged)
    first_sus = _np(carry.first_suspect)
    tp = _np(per_round.true_detections)
    fp = _np(per_round.false_positives)
    n_alive = _np(per_round.n_alive)
    rounds = len(tp)
    n = first.shape[0] if n_effective is None else n_effective

    ttd_first, ttd_conv = {}, {}
    ttd_sus, sus2conf = {}, {}
    for node, r0 in (crash_rounds or {}).items():
        ttd_first[node] = int(first[node] - r0) if first[node] >= 0 else -1
        ttd_conv[node] = int(conv[node] - r0) if conv[node] >= 0 else -1
        if first_sus[node] >= 0:
            ttd_sus[node] = int(first_sus[node] - r0)
            if first[node] >= 0:
                sus2conf[node] = int(first[node] - first_sus[node])

    # opportunities ~= sum over rounds of alive * (n - 1) observer-subject pairs
    opportunities = float(np.sum(n_alive.astype(np.int64)) * max(n - 1, 1))
    return DetectionReport(
        n=n,
        rounds=rounds,
        ttd_first=ttd_first,
        ttd_converged=ttd_conv,
        true_detections=int(tp.sum()),
        false_positives=int(fp.sum()),
        false_positive_rate=float(fp.sum()) / opportunities if opportunities else 0.0,
        final_alive=int(n_alive[-1]),
        suspects_entered=int(_np(per_round.suspects_entered).sum()),
        refutations=int(_np(per_round.refutations).sum()),
        fp_suppressed=int(_np(per_round.fp_suppressed).sum()),
        ttd_suspect=ttd_sus,
        suspect_to_confirm=sus2conf,
    )


# ---------------------------------------------------------------------------
# Partition-aware metrics (scenario engine)
# ---------------------------------------------------------------------------


def partition_round_stats(state: SimState, pid: torch.Tensor) -> torch.Tensor:
    """One round's partition observables, reduced on the state's device.

    ``pid`` int32 [N] partition ids (scenarios.FaultScenario.pid_at).
    Returns int32 [5]: ``[cross_members, cross_hb_max, cross_complete,
    views_complete, n_alive]``:

    * ``cross_members``: MEMBER entries live observers hold for subjects
      on a DIFFERENT side, the view divergence between the sides (0 once
      both sides have fully accepted the split);
    * ``cross_hb_max``: max heartbeat counter any live observer holds for
      a cross-side subject.  The MAX, not a sum: same-side relays keep
      redistributing values that crossed before the split, but no cross
      entry can ever EXCEED the split-time max without an actual
      cross-partition message.  Any increase during a split is
      propagation;
    * ``cross_complete``: every live observer lists every live CROSS-side
      subject, the partition-reconvergence predicate after heal;
    * ``views_complete``: every live observer lists every live subject;
    * ``n_alive``: ground-truth live count.

    Works in row chunks, so the temporaries stay small at any N."""
    n = state.n
    dev = state.hb.device
    alive = state.alive
    pid = pid.to(device=dev, dtype=torch.int32)
    cross_members = torch.zeros((), dtype=torch.int32, device=dev)
    cross_hb_max = torch.zeros((), dtype=torch.int32, device=dev)
    cross_ok = torch.ones((), dtype=torch.bool, device=dev)
    all_ok = torch.ones((), dtype=torch.bool, device=dev)
    for r0, r1 in row_chunks(n, n):
        cross = pid[r0:r1, None] != pid[None, :]
        live_rows = alive[r0:r1, None]
        member = (state.asl[r0:r1] & 3) == MEMBER
        cross_live = cross & live_rows
        cross_members += (member & cross_live).sum(dtype=torch.int32)
        hb_true = state.hb[r0:r1].to(torch.int32) + state.hb_base[None, :]
        cross_hb_max = torch.maximum(
            cross_hb_max, torch.where(cross_live, hb_true, 0).amax())
        missing = live_rows & alive[None, :] & ~member
        cross_ok &= ~(missing & cross).any()
        all_ok &= ~missing.any()
    return torch.stack([
        cross_members, cross_hb_max, cross_ok.to(torch.int32),
        all_ok.to(torch.int32), alive.sum(dtype=torch.int32)])


@dataclasses.dataclass
class PartitionReport:
    """Scenario-engine observables of one partition/heal cycle."""

    n: int
    split_at: int                 # first round cross messages drop
    heal_at: int                  # first round messages flow again
    split_brain_rounds: int       # rounds until both sides fully accepted
                                  # the split (cross view entries hit 0);
                                  # -1 = never during the window
    view_divergence_max: int      # max cross-side MEMBER entries held
    view_divergence_at_heal: int  # cross entries remaining when healed
    cross_hb_advances: int        # rounds where the cross heartbeat MAX
                                  # grew DURING the split (must be 0: no
                                  # cross-partition propagation)
    reconverge_rounds: int        # rounds after heal until every live view
                                  # again lists every live CROSS-side
                                  # member; -1 = not in horizon
    full_view_rounds: int         # rounds after heal until views are
                                  # complete INCLUDING same-side entries
                                  # (also gated by the protocol's endemic
                                  # background FP churn); -1 = not reached
    local_ttd: dict[int, int]     # partition-local detection: crashed node
                                  # -> rounds until a SAME-side observer
                                  # fired (-1 = never)
    cross_detections: int         # detections of other-side subjects
                                  # WHILE the split could cause them
                                  # (split_at..heal_at): expected
    local_false_positives: int    # detections of alive subjects the split
                                  # does NOT explain (same-side any time,
                                  # cross-side outside the split window):
                                  # real FPs, the partition-local FPR's
                                  # numerator
    local_fp_rate: float          # above / (sum_t n_alive * same-side
                                  # subjects): the partition-local FPR

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def summarize_partition(
    series: list[dict],
    events,
    pid: np.ndarray,
    split_at: int,
    heal_at: int,
    crash_rounds: dict[int, int] | None = None,
) -> PartitionReport:
    """Reduce a per-round stats series + detection events to a report.

    ``series``: one dict per completed round, ``{"round": r,
    "cross_members", "cross_hb_max", "cross_complete", "complete",
    "n_alive"}`` with ``r`` the state's round counter AFTER that round
    ran (the round executed with counter r-1); rounds are
    scenario-relative (armed at round 0).  ``events``: DetectionEvents
    drained over the same horizon.  ``crash_rounds``: same-side tracked
    crashes for the local-TTD rows.
    """
    by_round = {row["round"]: row for row in series}
    rounds = sorted(by_round)

    # the state produced by the last pre-split round has counter split_at;
    # every state in (split_at, heal_at] saw only filtered merges
    split_states = [r for r in rounds if split_at < r <= heal_at]
    div_max = max(
        (by_round[r]["cross_members"] for r in split_states), default=0
    )
    brain = -1
    for r in split_states:
        if by_round[r]["cross_members"] == 0:
            brain = r - split_at
            break
    div_heal = by_round[heal_at]["cross_members"] if heal_at in by_round else -1

    advances = 0
    prev = None
    for r in rounds:
        if split_at < r <= heal_at:
            cur = by_round[r]["cross_hb_max"]
            if prev is not None and cur > prev:
                advances += 1
            prev = cur
        elif r == split_at:
            prev = by_round[r]["cross_hb_max"]

    reconverge = full_view = -1
    for r in rounds:
        if r > heal_at and by_round[r]["cross_complete"] and reconverge < 0:
            reconverge = r - heal_at
        if r > heal_at and by_round[r]["complete"] and full_view < 0:
            full_view = r - heal_at
        if reconverge >= 0 and full_view >= 0:
            break

    local_ttd: dict[int, int] = {}
    for node, r0 in (crash_rounds or {}).items():
        hit = [
            e.round for e in events
            if e.subject == node and pid[e.observer] == pid[node]
            and e.round >= r0
        ]
        local_ttd[node] = (min(hit) - r0) if hit else -1

    tracked = set(crash_rounds or ())
    # an event's false_positive flag IS ground-truth "subject was alive".
    # A cross-side detection is "the split working as designed" only
    # while the split could have caused it: firing from the split round
    # through heal.  Cross-side detections OUTSIDE that window, like
    # same-side ones of alive subjects any time, are real false positives.
    cross_det = local_fp = 0
    for e in events:
        if e.subject in tracked:
            continue
        cross = pid[e.observer] != pid[e.subject]
        if cross and split_at <= e.round <= heal_at:
            cross_det += 1
        elif e.false_positive:
            local_fp += 1
    n = int(pid.shape[0])
    # same-side observer-subject opportunities, approximated with the
    # mean side size (exact at half/half splits)
    side = max(n // max(len(set(pid.tolist())), 1) - 1, 1)
    opportunities = float(sum(by_round[r]["n_alive"] for r in rounds)) * side
    return PartitionReport(
        n=n,
        split_at=split_at,
        heal_at=heal_at,
        split_brain_rounds=brain,
        view_divergence_max=int(div_max),
        view_divergence_at_heal=int(div_heal),
        cross_hb_advances=int(advances),
        reconverge_rounds=int(reconverge),
        full_view_rounds=int(full_view),
        local_ttd=local_ttd,
        cross_detections=int(cross_det),
        local_false_positives=int(local_fp),
        local_fp_rate=(local_fp / opportunities) if opportunities else 0.0,
    )
