"""The simulated cluster behind the FailureDetector seam (detector/api.py).

The port of the JAX package's ``gossipfs_tpu/detector/sim.py``: the round
loops (core/rounds.py) behind the per-node verbs the CLI, the co-sim and
the shim consume.

* :class:`SimDetector`: ``advance`` runs one ``gossip_round`` per round;
  ``advance_bulk`` runs ``run_rounds`` over the horizon, in chunks from a
  background thread when asked for snapshots (utils/snapshot.py).
* :class:`PackedDetector`: the capacity path, the lean loop's packed lanes
  (2 B per entry) advanced one round at a time through
  ``core/rounds.run_lean_packed`` with the carried counts threaded back
  in, joins applied as an O(N) column and row rewrite.

The port's loops update the lanes in place, so each detector owns its
state: a reader that keeps ``det.state`` across an advance sees it move.
While a bulk advance runs, the direct reads (``membership``,
``suspects``, ``alive_nodes``) wait for it; the snapshot buffer serves
reads meanwhile.

``SimDetector.load_scenario`` arms a ``scenarios.FaultScenario``: rule
windows count from the current round; interactive rounds then run
``gossip_round_scenario`` and bulk runs hand the compiled table to
``run_rounds``, each on the configured kernels (explicit edges rewritten,
aligned arcs in the group form).  ``PackedDetector`` has no scenario seam,
as in the JAX package.  Not ported yet: the flight recorder
(``attach_recorder``; the obs plane, ROADMAP Queue 1), which raises
``NotImplementedError``; its ``scenario_arm``/``scenario_clear`` rows come
with it.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core import rounds as R
from gossipfs_tpu_torch.core import topology
from gossipfs_tpu_torch.core.state import (
    MEMBER, SUSPECT, UNKNOWN, RoundEvents, SimState, init_state)
from gossipfs_tpu_torch.detector.api import DetectionEvent
from gossipfs_tpu_torch.scenarios import tensor as scn_tensor
from gossipfs_tpu_torch.utils.snapshot import Snapshot, SnapshotBuffer


class SimDetector:
    """N simulated gossip nodes advanced one tensor step per heartbeat."""

    def __init__(self, config: SimConfig, member_mask=None, seed: int = 0,
                 device="cuda"):
        self.config = config
        self.device = torch.device(device)
        if member_mask is not None:
            member_mask = torch.as_tensor(np.asarray(member_mask))
        self.state: SimState = init_state(config, member_mask, device=device)
        self._key = trandom.PRNGKey(seed, device=device)
        self._pending_crash: set[int] = set()
        self._pending_leave: set[int] = set()
        self._pending_join: set[int] = set()
        self._events: list[DetectionEvent] = []
        # finished bulk runs whose event synthesis waits until someone
        # reads events
        self._pending_bulk: list[tuple] = []
        self._bulk_thread: threading.Thread | None = None
        self._bulk_error: BaseException | None = None
        # one buffer reused across advance_bulk calls: readers hold THE
        # buffer, not one call's
        self._snap_buffer: SnapshotBuffer | None = None
        # cumulative suspicion lifecycle counters (``suspicion status``)
        self._sus_totals = {"suspects_entered": 0, "refutations": 0,
                            "fp_suppressed": 0, "confirms": 0}
        # armed fault scenario (scenarios/): the declarative schedule and
        # its compiled rule table
        self._scenario = None
        self._scn_tensor = None
        self._scn_round0 = 0     # the arming round (the table's round0)

    # -- not ported yet ----------------------------------------------------
    def attach_recorder(self, recorder) -> None:
        raise NotImplementedError(
            "the flight recorder (obs/) is not ported yet: ROADMAP Queue 1, "
            "item 13")

    # -- scenario engine ---------------------------------------------------
    def load_scenario(self, scenario) -> None:
        """Arm a ``scenarios.FaultScenario``: rule windows count from the
        CURRENT round.  Loading replaces any previous scenario; what the
        configuration cannot honor raises here, with nothing half-armed
        (``scenarios.tensor.require_scenario_config`` with the rule tables
        in hand: Bernoulli loss has no aligned-arc form, partition sides
        must be align-group-closed)."""
        if scenario.n != self.config.n:
            raise ValueError(
                f"scenario is for n={scenario.n}, detector has "
                f"n={self.config.n}"
            )
        scn_tensor.require_scenario_config(self.config, scenario)
        self._join_bulk()
        self._scn_round0 = int(self.state.round)
        self._scn_tensor = scn_tensor.compile_tensor(
            scenario, round0=self._scn_round0, device=self.device)
        self._scenario = scenario

    def clear_scenario(self) -> None:
        self._scenario = self._scn_tensor = None

    def scenario_status(self) -> dict | None:
        """Status document for the armed scenario (None when unarmed)."""
        if self._scenario is None:
            return None
        return self._scenario.status(int(self.state.round) - self._scn_round0)

    def _refuse_join_in_window(self, round_idx: int) -> None:
        """The join path is an instantaneous introducer row and column
        rewrite, not transport messages: the active fault rules cannot
        filter it, so it would teleport across a partition.  Refuse rather
        than simulate wrong dynamics."""
        if (self._scenario is not None and self._pending_join
                and self._scenario.active_at(round_idx - self._scn_round0)):
            raise NotImplementedError(
                "join during an active scenario window is not "
                "transport-filtered; advance past the fault windows "
                "(or clear_scenario) before joining")

    # -- event verbs -------------------------------------------------------
    def _check(self, node: int) -> int:
        if not 0 <= node < self.config.n:
            raise ValueError(f"node id {node} out of range [0, {self.config.n})")
        return node

    def join(self, node: int) -> None:
        self._pending_join.add(self._check(node))

    def leave(self, node: int) -> None:
        self._pending_leave.add(self._check(node))

    def crash(self, node: int) -> None:
        self._pending_crash.add(self._check(node))

    # -- time --------------------------------------------------------------
    def _join_bulk(self) -> None:
        """Wait for a bulk run in flight before touching the state; re-raise
        what its pipeline thread hit (a silently failed chunk would leave
        the detector at the pre-bulk round while callers believe it
        advanced)."""
        t = self._bulk_thread
        if t is not None and t.is_alive():
            t.join()
        self._bulk_thread = None
        err, self._bulk_error = self._bulk_error, None
        if err is not None:
            raise RuntimeError("bulk advancement failed mid-run") from err

    def _mask(self, nodes) -> torch.Tensor:
        m = torch.zeros((self.config.n,), dtype=torch.bool)
        if nodes:
            m[list(nodes)] = True
        return m.to(self.device)

    def _take_verbs(self) -> RoundEvents:
        ev = RoundEvents(crash=self._mask(self._pending_crash),
                         leave=self._mask(self._pending_leave),
                         join=self._mask(self._pending_join))
        self._pending_crash.clear()
        self._pending_leave.clear()
        self._pending_join.clear()
        return ev

    def advance(self, rounds: int = 1) -> None:
        self._join_bulk()
        # events of a finished bulk run precede this call's
        self._resolve_pending_bulk()
        cfg = self.config
        for _ in range(rounds):
            round_idx = int(self.state.round)
            self._refuse_join_in_window(round_idx)
            ev = self._take_verbs()
            # the interactive round takes k = fold_in(key, round) as its
            # edge key itself, with no split (the JAX package's advance)
            k = trandom.fold_in(self._key, round_idx)
            edges = (None if cfg.topology == "ring"
                     else topology.in_edges(cfg, k))
            if self._scenario is not None:
                self.state, metrics, any_fail, first_obs = (
                    R.gossip_round_scenario(
                        self.state, ev, edges, cfg, self._scn_tensor,
                        trandom.fold_in(k, R.SCN_FOLD)))
            else:
                self.state, metrics, any_fail, first_obs = R.gossip_round(
                    self.state, ev, edges, cfg)
            if cfg.suspicion is not None:
                self._accumulate_suspicion(
                    int(metrics.suspects_entered), int(metrics.refutations),
                    int(metrics.fp_suppressed),
                    int(metrics.true_detections)
                    + int(metrics.false_positives))
            if not bool(any_fail.any()):
                continue  # quiet round: one scalar transfer
            # eventful round: the per-subject vectors the round computes
            # anyway, O(N) host bytes; one event per detected subject,
            # attributed to the lowest-index firing observer
            af = any_fail.cpu().numpy()
            fo = first_obs.cpu().numpy()
            alive = self.state.alive.cpu().numpy()
            for subj in np.nonzero(af)[0]:
                self._events.append(DetectionEvent(
                    round=round_idx, observer=int(fo[subj]),
                    subject=int(subj), false_positive=bool(alive[subj])))

    def _accumulate_suspicion(self, entered: int, refuted: int, fp_sup: int,
                              confirms: int) -> None:
        t = self._sus_totals
        t["suspects_entered"] += entered
        t["refutations"] += refuted
        t["fp_suppressed"] += fp_sup
        t["confirms"] += confirms

    def advance_bulk(self, rounds: int, snapshot_every: int | None = None):
        """Advance many rounds through ``run_rounds`` (no per-round event
        reads); pending verbs apply on the first round.

        Without ``snapshot_every``: one call; event synthesis waits for
        ``drain_events``.  With it: the horizon runs in chunks of that many
        rounds (the metrics carry threads through, so the result equals
        one call) from a background thread, which publishes a
        ``utils.snapshot.Snapshot`` to the returned buffer as each chunk
        completes; the next chunk is queued before the previous one is
        published, two deep."""
        self._join_bulk()
        start = int(self.state.round)
        self._refuse_join_in_window(start)
        first = self._take_verbs()
        n = self.config.n
        events = RoundEvents(*(
            torch.zeros((rounds, n), dtype=torch.bool, device=self.device)
            for _ in range(3)))
        for full, m in zip(events, first):
            full[0] = m

        if snapshot_every is None:
            self.state, mcarry, per_round = R.run_rounds(
                self.state, self.config, rounds, self._key, events=events,
                scenario=self._scn_tensor)
            self._pending_bulk.append(
                (start, rounds, mcarry, self.state.alive, [per_round]))
            return None

        if self._snap_buffer is None:
            self._snap_buffer = SnapshotBuffer()
        buffer = self._snap_buffer
        buffer.clear()
        every = max(1, int(snapshot_every))
        chunks = [(off, min(every, rounds - off))
                  for off in range(0, rounds, every)]
        # the table armed NOW: a clear_scenario or load_scenario while the
        # chunks still run must not reach into them
        scn = self._scn_tensor

        def pipeline() -> None:
            try:
                st, mcarry, prev, per_rounds = self.state, None, None, []
                for off, ln in chunks:
                    ev = RoundEvents(*(m[off:off + ln] for m in events))
                    st, mcarry, per_round = R.run_rounds(
                        st, self.config, ln, self._key, events=ev,
                        mcarry0=mcarry, scenario=scn)
                    per_rounds.append(per_round)
                    # the boundary copy is queued before the next chunk,
                    # which rewrites the lanes in place
                    snap = self._boundary(st)
                    if prev is not None:
                        self._publish(*prev)
                    prev = (st, snap)
                self._publish(*prev)
                self._pending_bulk.append(
                    (start, rounds, mcarry, st.alive, per_rounds))
            except BaseException as e:  # re-raised by the next _join_bulk
                self._bulk_error = e

        t = threading.Thread(target=pipeline, daemon=True,
                             name="gossipfs-bulk")
        self._bulk_thread = t
        t.start()
        return buffer

    def _boundary(self, st: SimState):
        """Queue a chunk-boundary copy of the status and liveness; returns
        what :meth:`_publish` needs to wait for it."""
        status = st.status  # a new tensor, computed in stream order
        if self.device.type == "cuda":
            alive = torch.empty(st.alive.shape, dtype=torch.bool,
                                pin_memory=True)
            alive.copy_(st.alive, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            alive, done = st.alive.clone(), None
        return int(st.round), alive, status, done

    def _publish(self, st: SimState, snap) -> None:
        rnd, alive, status, done = snap
        if done is not None:
            done.synchronize()  # this chunk only: the next is queued behind
        self.state = st
        self._snap_buffer.push(Snapshot(round=rnd, alive=alive.numpy(),
                                        status_lanes=status))

    def _resolve_pending_bulk(self) -> None:
        """Detection events of finished bulk runs: per subject, the first
        detection round and its lowest firing observer from the metrics
        carry, the same first event the interactive path reports."""
        pending, self._pending_bulk = self._pending_bulk, []
        for start, rounds, mcarry, alive, per_rounds in pending:
            if self.config.suspicion is not None:
                for pr in per_rounds:
                    self._accumulate_suspicion(
                        int(pr.suspects_entered.sum()),
                        int(pr.refutations.sum()),
                        int(pr.fp_suppressed.sum()),
                        int(pr.true_detections.sum())
                        + int(pr.false_positives.sum()))
            first = mcarry.first_detect.cpu().numpy()
            observer = mcarry.first_observer.cpu().numpy()
            alive_h = alive.cpu().numpy()
            in_window = (first >= start) & (first < start + rounds)
            for subj in np.nonzero(in_window)[0]:
                self._events.append(DetectionEvent(
                    round=int(first[subj]), observer=int(observer[subj]),
                    subject=int(subj), false_positive=bool(alive_h[subj])))

    # -- views -------------------------------------------------------------
    def _status_row(self, observer: int) -> np.ndarray:
        self._join_bulk()
        return (self.state.asl[observer] & 3).cpu().numpy()

    def membership(self, observer: int) -> list[int]:
        # a SUSPECT entry is still in the list (pending refute or confirm)
        row = self._status_row(observer)
        return [int(j) for j in np.nonzero((row == MEMBER)
                                           | (row == SUSPECT))[0]]

    def suspects(self, observer: int) -> list[int]:
        """Entries the observer holds SUSPECT (empty with suspicion off)."""
        row = self._status_row(observer)
        return [int(j) for j in np.nonzero(row == SUSPECT)[0]]

    def suspicion_status(self) -> dict | None:
        """The suspicion vitals (CLI ``suspicion status``): per-node live
        suspect counts and the cumulative lifecycle totals; None when
        suspicion is off."""
        sus = self.config.suspicion
        if sus is None:
            return None
        self._join_bulk()
        self._resolve_pending_bulk()
        held = (self.state.asl & 3) == SUSPECT
        counts = (held.sum(dim=1) * self.state.alive).cpu().numpy()
        return {
            "enabled": True,
            "t_suspect": sus.t_suspect,
            "lh_multiplier": sus.lh_multiplier,
            "suspect_counts": {int(i): int(c) for i, c in enumerate(counts)
                               if c},
            "suspects_now": int(counts.sum()),
            **self._sus_totals,
        }

    def alive_nodes(self) -> list[int]:
        self._join_bulk()
        return [int(j) for j in
                np.nonzero(self.state.alive.cpu().numpy())[0]]

    def drain_events(self) -> list[DetectionEvent]:
        self._join_bulk()
        self._resolve_pending_bulk()
        out, self._events = self._events, []
        return out


class PackedDetector:
    """Interactive FailureDetector over the lean loop's packed lanes.

    The capacity path: the state is the lean loop's two int8 lanes
    (2 B per entry, updated in place) and every ``advance`` round runs one
    round of ``core/rounds.run_lean_packed`` with the carried per-receiver
    counts (and, on the Lifeguard lane, SUSPECT counts) threaded back in,
    so no round recounts them over ``[N, N]``.  ``crash``; ``leave`` as a
    silent death (no LEAVE broadcast on the lean loop); ``join`` applied
    before the round as an O(N) column and row rewrite with the matrix
    path's introducer-push, fail-list suppression and fresh-incarnation
    rebase semantics.  Detection events come from diffing the carried
    first-detection vector, so they match the bulk path's first-observer
    semantics."""

    def __init__(self, config: SimConfig, seed: int = 0, device="cuda"):
        if not R._lean_ok(config, False):
            raise ValueError(
                "PackedDetector requires a resident-round config "
                "(merge_kernel='pallas_rr' or aligned arcs, all-int8, "
                "random/random_arc, fresh cooldown, gossip-only)")
        self.config = config
        self.device = torch.device(device)
        (self._hb, self._asl, self._alive, self._hb_base, self._round,
         self._counts) = R.rr_packed_init(config, device=device)
        self._mcarry = R.MetricsCarry.init(config.n, device)
        self._key = trandom.PRNGKey(seed, device=device)
        self._pending_crash: set[int] = set()
        self._pending_join: list[int] = []
        self._events: list[DetectionEvent] = []
        # the Lifeguard lane carries the per-receiver SUSPECT counts
        # between rounds, like the member counts (a fresh cluster holds 0)
        self._lh = (config.suspicion is not None
                    and config.suspicion.lh_multiplier > 0)
        self._sus_counts = (torch.zeros(config.n, dtype=torch.int32,
                                        device=device) if self._lh else None)

    @property
    def round(self) -> int:
        return self._round

    # -- verbs -------------------------------------------------------------
    def _check(self, node: int) -> int:
        if not 0 <= node < self.config.n:
            raise ValueError(
                f"node id {node} out of range [0, {self.config.n})")
        return node

    def crash(self, node: int) -> None:
        self._pending_crash.add(self._check(node))

    def leave(self, node: int) -> None:
        # the lean fault model: a leave is a silent death, detected by
        # timeout
        self._pending_crash.add(self._check(node))

    def join(self, node: int) -> None:
        """Queue a (re)join, applied before the next round.  Joins within
        one round apply in call order, each seeing the previous (one join
        per round is bit-identical to the matrix path's batched form)."""
        j = self._check(node)
        if j not in self._pending_join:
            self._pending_join.append(j)

    def _join_one(self, j: int, crash_mask: torch.Tensor) -> bool:
        """One join, O(N): the matrix path's join (core/rounds.
        _apply_events) op for op on column and row ``j``.  Returns whether
        it took effect (one scalar transfer: a rare verb)."""
        hb, asl, hb_base, counts = self._hb, self._asl, self._hb_base, \
            self._counts
        n, intro = self.config.n, self.config.introducer
        # crashes land before joins in the same round
        alive_eff = self._alive & ~crash_mask
        if not bool(~alive_eff[j] & alive_eff[intro]):
            return False
        # column j: rebase to base 0 (the fresh incarnation's true hb 0
        # must encode exactly; old lanes renormalise, clipped at the
        # ceiling; floor sentinels stay sentinels)
        col_hb, col_as = hb[:, j].clone(), asl[:, j].clone()
        base_j = hb_base[j]
        sent = col_hb == -128
        true32 = col_hb.to(torch.int32) + base_j
        col_hb2 = torch.where((base_j != 0) & ~sent,
                              true32.clamp(-128, 127).to(torch.int8), col_hb)
        # receivers add the joiner unless it sits on their fail list
        # (FAILED: cooldown suppression); the introducer appends always
        st_col = col_as.to(torch.int32) & 3
        upd = (alive_eff & (st_col == UNKNOWN)) | (
            torch.arange(n, device=hb.device) == intro)
        hb[:, j] = torch.where(upd, 0, col_hb2).to(torch.int8)
        asl[:, j] = torch.where(upd, MEMBER - 128, col_as).to(torch.int8)
        hb_base[j] = 0
        counts += (upd & (st_col != MEMBER)).to(torch.int32)
        # the joiner's row := the introducer's post-append row (the
        # full-list push the joiner receives), a fresh fail list, and its
        # self entry at the fresh base's encoded 0
        intro_mem = (asl[intro].to(torch.int32) & 3) == MEMBER
        hz = torch.clamp(-hb_base, -128, 0).to(torch.int8)
        row_hb = torch.where(intro_mem, hb[intro], hz)
        row_as = torch.where(intro_mem, MEMBER - 128,
                             UNKNOWN - 128).to(torch.int8)
        row_hb[j] = 0
        row_as[j] = MEMBER - 128
        hb[j] = row_hb
        asl[j] = row_as
        self._alive[j] = True
        counts[j] = ((row_as.to(torch.int32) & 3) == MEMBER).sum(
            dtype=torch.int32)
        # a rejoin restarts the subject's detection and convergence clocks
        for f in self._mcarry:
            f[j] = -1
        if self._lh:
            # the joiner's fresh row holds no SUSPECT entry; the join's
            # adds write only UNKNOWN entries of the other rows
            self._sus_counts[j] = 0
        return True

    def advance(self, rounds: int = 1) -> None:
        n = self.config.n
        for _ in range(rounds):
            mask = torch.zeros((n,), dtype=torch.bool)
            if self._pending_crash:
                mask[list(self._pending_crash)] = True
                self._pending_crash.clear()
            if self._pending_join:
                # an effective join clears the node's same-round crash
                # bit: crashes land before joins, so crash(j) + join(j)
                # ends with j alive
                for j in self._pending_join:
                    if self._join_one(j, mask.to(self.device)):
                        mask[j] = False
                self._pending_join.clear()
            round_idx = self._round
            prev_first = self._mcarry.first_detect.clone()
            (self._hb, self._asl, self._alive, self._hb_base, self._round,
             self._counts, sus_counts, self._mcarry, per_round) = (
                R.run_lean_packed(
                    self._hb, self._asl, self._alive, self._hb_base,
                    round_idx, self.config, self._key, 1,
                    crash=mask[None], mcarry0=self._mcarry,
                    counts0=self._counts, sus_counts0=self._sus_counts))
            if self._lh:
                self._sus_counts = sus_counts
            if int(per_round.true_detections[0]) + int(
                    per_round.false_positives[0]) == 0:
                continue  # quiet round: two scalar transfers
            mc = self._mcarry
            fresh = ((mc.first_detect == round_idx)
                     & (prev_first < 0)).cpu().numpy()
            obs = mc.first_observer.cpu().numpy()
            alive_h = self._alive.cpu().numpy()
            for subj in np.nonzero(fresh)[0]:
                self._events.append(DetectionEvent(
                    round=round_idx, observer=int(obs[subj]),
                    subject=int(subj), false_positive=bool(alive_h[subj])))

    # -- views -------------------------------------------------------------
    def lanes(self) -> SimState:
        """The packed state as a ``SimState`` (sharing the lanes)."""
        return SimState(hb=self._hb, asl=self._asl, alive=self._alive,
                        round=self._round, hb_base=self._hb_base)

    def membership(self, observer: int) -> list[int]:
        row = (self._asl[observer] & 3).cpu().numpy()
        return [int(j) for j in np.nonzero(row == MEMBER)[0]]

    def alive_nodes(self) -> list[int]:
        return [int(j) for j in np.nonzero(self._alive.cpu().numpy())[0]]

    def drain_events(self) -> list[DetectionEvent]:
        out, self._events = self._events, []
        return out
