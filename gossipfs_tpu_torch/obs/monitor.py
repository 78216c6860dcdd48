"""Online health plane: a streaming invariant monitor over the event
schema.

The port's copy of the JAX package's ``gossipfs_tpu/obs/monitor.py``
(pure Python).

The flight recorder + ``obs/timeline.py`` can say what went wrong
AFTER a run ends; this module says it WHILE the events stream.  A
:class:`StreamMonitor` consumes ``gossipfs-obs/v1`` records one at a
time — attachable wherever ``attach_recorder`` works today (SimDetector,
UdpCluster, CoSim, the bulk-scan decode) via :class:`MonitorRecorder`,
and over deploy log tails / written traces via :meth:`StreamMonitor.
feed_jsonl` — and maintains two things:

* **incremental estimators** — rolling TTD and FPR, suppression ratio,
  the false-positive-confirm (split-brain evidence) window, and the
  acked-write durability ledger (``traffic.audit.DurabilityReplay``,
  the SAME state machine the post-hoc replay runs, so the two
  accountings cannot drift);

* **a declarative invariant table** (:data:`INVARIANTS`) — SWIM's
  accuracy story as machine-checkable rows: no confirm without a
  preceding SUSPECT, no acked write lost, reconvergence within a bound,
  rolling FPR under a storm threshold.  A violation is itself emitted
  as a schema event (``invariant_violation``), so ``obs/timeline.py``
  and the recorder lint maps stay the single source of truth for what
  can appear in a stream.

The monitor's :meth:`~StreamMonitor.summary` mirrors
``obs/timeline.py``'s post-hoc ``analyze`` estimator for estimator;
:func:`estimator_parity` is the standing ``monitor_parity`` oracle
(``verify_claims.py``): on the same stream the streaming and post-hoc
derivations must agree EXACTLY — any drift is a real accounting bug in
one of them.

Pure python + stdlib (the obs convention): the deploy lane's jax-free
tooling can tail its node logs through this too.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import statistics

from gossipfs_tpu_torch.obs import schema
from gossipfs_tpu_torch.obs.recorder import FlightRecorder
from gossipfs_tpu_torch.obs.schema import Event
from gossipfs_tpu_torch.traffic.audit import DurabilityReplay
from gossipfs_tpu_torch.traffic.workload import quantiles

# ---------------------------------------------------------------------------
# The invariant table — what "healthy" means, as declarative rows
# ---------------------------------------------------------------------------

INVARIANTS: dict[str, str] = {
    "no_confirm_without_suspect":
        "with the SWIM lifecycle armed, NO subject is confirmed FAILED "
        "without a preceding SUSPECT event (SWIM's accuracy mechanism; "
        "checked per confirm event as it streams)",
    "no_acked_write_lost":
        "every acked write survives on >= 1 event-known live replica at "
        "end of stream (the durability ledger's verdict; the traffic "
        "plane's standing claim)",
    "reconverge_bound":
        "every tracked crash is REMOVED cluster-wide within "
        "`reconverge_bound` rounds of max(crash round, clock_floor, any "
        "later scenario_clear) — t_fail + gossip diameter (+ slack) per "
        "Pittel's log-N bound; a miss is a stuck or split-brained view",
    "fpr_storm":
        "the rolling false-positive rate over the last `fpr_window` "
        "round_ticks stays <= `fpr_threshold` — the Lifeguard gray-"
        "failure signature (flapping, lossy links) is exactly an FPR "
        "storm, caught the round it starts instead of post-hoc",
}


@dataclasses.dataclass(frozen=True)
class MonitorParams:
    """Invariant thresholds (JSON-loadable — campaign case files carry
    one).  ``None`` disables the corresponding invariant row.

    ``expect_suspicion``: force the no-confirm-without-SUSPECT check on
    (``True``) or off (``False``); ``None`` infers it from the stream
    (suspicion counters present in ``round_tick`` rows — the same
    inference ``analyze`` uses).  ``clock_floor``: earliest round the
    reconvergence clock may start (a campaign sets it to the scenario
    horizon so convergence legitimately delayed by an armed fault
    window isn't flagged).
    """

    fpr_threshold: float | None = 1e-4
    fpr_window: int = 10
    reconverge_bound: int | None = None
    clock_floor: int = 0
    expect_suspicion: bool | None = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, doc: dict) -> "MonitorParams":
        return cls(**{k: doc[k] for k in
                      (f.name for f in dataclasses.fields(cls))
                      if k in doc})


class StreamMonitor:
    """Consume schema events online; keep estimators + check invariants.

    Feed order must be round-ordered (every recorder stream is; merged
    multi-node streams go through ``timeline.merge`` first).  ``observe``
    returns the violations THAT event raised (usually ``[]``) so an
    inline wrapper can append them to the same stream; ``finish`` runs
    the end-of-stream invariants (durability, unconverged crashes) and
    returns theirs.
    """

    def __init__(self, params: MonitorParams | None = None,
                 n: int | None = None):
        self.params = params or MonitorParams()
        self.n = n
        self.n_effective: int | None = None
        self.violations: list[Event] = []
        self._finished = False
        # -- analyze-mirror accounting (obs/timeline.py)
        self.crash_rounds: dict[int, int] = {}
        self._firsts: dict[str, dict[int, int]] = {}
        self._confirm_fp: dict[int, bool] = {}
        self.rounds = 0              # round_tick rows seen
        self.events_seen = 0
        self.true_detections = 0
        self.false_positives = 0
        self._alive_sum = 0
        self.suspicion = False
        self.suspects_entered = 0
        self.refutations = 0
        self.fp_suppressed = 0
        self._has_traffic = False
        self._client_ops: list[float] = []
        self._client_issued = 0
        self._client_acked = 0
        # -- durability ledger (shared state machine with audit.py); the
        # one-round buffer reorders crash/join ahead of same-round data
        # rows, so the incremental walk equals the post-hoc sorted one
        self._replay = DurabilityReplay()
        self._replay_round: int | None = None
        self._replay_buf: list[Event] = []
        # -- invariant state
        self._last_round = -1
        self._scenario_clears: list[int] = []
        self._fpr_win: collections.deque[tuple[int, int]] = \
            collections.deque(maxlen=max(1, self.params.fpr_window))
        self._in_storm = False
        self.storm_rounds = 0
        self.worst_window_fpr = 0.0
        # reconvergence clocks per ACTIVE crash episode: latest crash
        # round, cleared by the episode-ending remove (or a rejoin).
        # Separate from ``crash_rounds`` (which keeps the FIRST crash,
        # analyze's TTD convention): a rejoin + re-crash re-clocks the
        # deadline here without disturbing estimator parity.
        self._crash_episode: dict[int, int] = {}
        # split-brain evidence: the window over which ground-truth-alive
        # subjects stood confirmed FAILED (an event-derived lower bound)
        self._fp_confirm_first: int | None = None
        self._fp_confirm_last: int | None = None

    # -- feeding ------------------------------------------------------------
    def observe_header(self, header: dict) -> None:
        if self.n is None and header.get("n"):
            self.n = int(header["n"])
        if self.n_effective is None and header.get("n_effective"):
            self.n_effective = int(header["n_effective"])
        for k, v in (header.get("crash_rounds") or {}).items():
            self.crash_rounds[int(k)] = int(v)
            self._crash_episode.setdefault(int(k), int(v))

    def observe(self, ev: Event) -> list[Event]:
        """Consume one event; returns violations it raised (often [])."""
        if ev.kind == "invariant_violation":
            # a previously-monitored stream replaying through a fresh
            # monitor: re-derive, don't double-count
            return []
        out: list[Event] = []
        self.events_seen += 1
        self._last_round = max(self._last_round, ev.round)
        k = ev.kind

        if k == "crash" and ev.subject >= 0:
            self.crash_rounds.setdefault(ev.subject, ev.round)
            self._crash_episode[ev.subject] = ev.round  # latest wins
        elif k == "join" and ev.subject >= 0:
            # a rejoin ends any pending crash episode: the old entry's
            # convergence story is over (the carry resets too)
            self._crash_episode.pop(ev.subject, None)
        elif k == "round_tick":
            d = ev.detail
            self.rounds += 1
            self.true_detections += d.get("true_detections", 0)
            fp = d.get("false_positives", 0)
            self.false_positives += fp
            alive = d.get("n_alive", 0)
            self._alive_sum += alive
            if "suspects_entered" in d:
                self.suspicion = True
                self.suspects_entered += d.get("suspects_entered", 0)
                self.refutations += d.get("refutations", 0)
                self.fp_suppressed += d.get("fp_suppressed", 0)
            self._fpr_win.append((fp, alive))
            out.extend(self._check_fpr_storm(ev.round))
        elif k == "scenario_clear":
            self._scenario_clears.append(ev.round)
        elif k == "client_op":
            self._has_traffic = True
            self._client_issued += 1
            self._client_acked += bool(ev.detail.get("ok"))
            self._client_ops.append(ev.detail.get("ms", 0.0))

        if ev.subject >= 0 and k in ("suspect", "confirm", "remove"):
            slot = self._firsts.setdefault(k, {})
            if ev.subject not in slot:
                slot[ev.subject] = ev.round
                if k == "confirm" and "false_positive" in ev.detail:
                    self._confirm_fp[ev.subject] = bool(
                        ev.detail["false_positive"])
            if k == "confirm":
                out.extend(self._check_confirm(ev))
            elif k == "remove":
                out.extend(self._check_remove(ev))

        if k in ("replica_put", "stripe_put"):
            # the SAME gate analyze uses (put | client_op, set above) —
            # a repair/delete-only tail must not grow a durability doc
            # the post-hoc side omits (monitor_parity)
            self._has_traffic = True
        self._replay_observe(ev)
        return out

    def feed(self, events) -> list[Event]:
        out: list[Event] = []
        for ev in events:
            out.extend(self.observe(ev))
        return out

    def feed_jsonl(self, path) -> list[Event]:
        """Tail a written stream (bench ``--trace`` artifact, a deploy
        ``node<i>.log``) through the monitor — the file-attachment mode
        for engines the monitor can't sit inside.  Parses through
        ``obs.recorder.load_stream`` (the one reader timeline.py also
        uses, so the parity oracle's two sides read identically)."""
        from gossipfs_tpu_torch.obs.recorder import load_stream

        header, events = load_stream(path)
        if header is not None:
            self.observe_header(header)
        return self.feed(events)

    # -- durability replay (one-round reorder buffer) -----------------------
    def _replay_observe(self, ev: Event) -> None:
        if ev.kind not in ("crash", "join", "replica_put",
                           "replica_repair", "replica_delete",
                           "stripe_put", "stripe_repair"):
            return
        if self._replay_round is not None and ev.round > self._replay_round:
            self._replay_flush()
        self._replay_round = (ev.round if self._replay_round is None
                              else max(self._replay_round, ev.round))
        self._replay_buf.append(ev)

    def _replay_flush(self) -> None:
        for e in sorted(self._replay_buf,
                        key=lambda e: 0 if e.kind in ("crash", "join")
                        else 1):
            self._replay.observe(e)
        self._replay_buf = []

    # -- invariant checks ---------------------------------------------------
    def _violate(self, round_: int, invariant: str, subject: int = -1,
                 **detail) -> list[Event]:
        ev = Event(round=round_, observer=-1, subject=subject,
                   kind="invariant_violation",
                   detail={"invariant": invariant, **detail})
        self.violations.append(ev)
        return [ev]

    def _suspicion_armed(self) -> bool:
        if self.params.expect_suspicion is not None:
            return self.params.expect_suspicion
        return self.suspicion

    def _check_confirm(self, ev: Event) -> list[Event]:
        out: list[Event] = []
        if self._confirm_fp.get(ev.subject) or bool(
                ev.detail.get("false_positive")):
            if self._fp_confirm_first is None:
                self._fp_confirm_first = ev.round
            self._fp_confirm_last = ev.round
        if not self._suspicion_armed():
            return out
        s = self._firsts.get("suspect", {}).get(ev.subject)
        if s is None or s > ev.round:
            out += self._violate(
                ev.round, "no_confirm_without_suspect",
                subject=ev.subject, observer_confirm=ev.observer,
                suspect_round=s)
        return out

    def _reconv_deadline(self, crash_round: int) -> int | None:
        bound = self.params.reconverge_bound
        if bound is None:
            return None
        floor = max(crash_round, self.params.clock_floor,
                    *[c for c in self._scenario_clears
                      if c >= crash_round] or [crash_round])
        return floor + bound

    def _check_remove(self, ev: Event) -> list[Event]:
        # the episode-ending remove: evaluated once per crash episode
        # (repeat per-observer remove rows find the episode cleared)
        r0 = self._crash_episode.pop(ev.subject, None)
        if r0 is None:
            return []
        deadline = self._reconv_deadline(r0)
        if deadline is not None and ev.round > deadline:
            return self._violate(
                ev.round, "reconverge_bound", subject=ev.subject,
                crash_round=r0, deadline=deadline)
        return []

    def _check_fpr_storm(self, round_: int) -> list[Event]:
        thr = self.params.fpr_threshold
        if thr is None:
            return []
        fp = sum(f for f, _ in self._fpr_win)
        alive = sum(a for _, a in self._fpr_win)
        denom = float(alive) * max((self.n_effective or self.n or 1) - 1, 1)
        wfpr = (fp / denom) if denom else 0.0
        self.worst_window_fpr = max(self.worst_window_fpr, wfpr)
        if wfpr > thr:
            self.storm_rounds += 1
            if not self._in_storm:
                self._in_storm = True
                return self._violate(
                    round_, "fpr_storm", window_fpr=wfpr, threshold=thr,
                    window_rounds=len(self._fpr_win),
                    window_false_positives=fp)
        else:
            self._in_storm = False
        return []

    def finish(self) -> list[Event]:
        """End-of-stream invariants; idempotent."""
        if self._finished:
            return []
        self._finished = True
        self._replay_flush()
        out: list[Event] = []
        lost = self._replay.lost_files()
        if lost:
            out += self._violate(
                self._last_round, "no_acked_write_lost",
                files=lost, lost=len(lost))
        if self.params.reconverge_bound is not None:
            # crash episodes still open at end of stream: flag the ones
            # whose deadline the horizon has already passed
            for node, r0 in sorted(self._crash_episode.items()):
                deadline = self._reconv_deadline(r0)
                if deadline is not None and self._last_round > deadline:
                    out += self._violate(
                        self._last_round, "reconverge_bound", subject=node,
                        crash_round=r0, deadline=deadline, removed=False)
        return out

    # -- estimators ---------------------------------------------------------
    def summary(self) -> dict:
        """The estimator document — mirrors ``obs/timeline.py``'s
        ``analyze`` field for field (:data:`PARITY_FIELDS`), plus the
        monitor-only rows (violations, storm/stability extras)."""
        self.finish()
        firsts = self._firsts
        ttd_first, ttd_conv, ttd_sus, sus2conf = {}, {}, {}, {}
        for node, r0 in self.crash_rounds.items():
            c = firsts.get("confirm", {}).get(node)
            ttd_first[node] = (c - r0) if c is not None else -1
            rm = firsts.get("remove", {}).get(node)
            ttd_conv[node] = (rm - r0) if rm is not None else -1
            s = firsts.get("suspect", {}).get(node)
            if s is not None:
                ttd_sus[node] = s - r0
                if c is not None:
                    sus2conf[node] = c - s
        n_eff = self.n_effective or self.n
        opportunities = float(self._alive_sum) * max((n_eff or 1) - 1, 1)
        fpr = (self.false_positives / opportunities) if opportunities else 0.0
        ttd_vals = [v for v in ttd_first.values() if v >= 0]
        doc = {
            "schema": schema.SCHEMA,
            "n": self.n,
            "rounds": self.rounds,
            "events": self.events_seen,
            "tracked_crashes": len(self.crash_rounds),
            "detected": len(ttd_vals),
            "ttd_first": ttd_first,
            "ttd_converged": ttd_conv,
            "ttd_first_median": statistics.median(ttd_vals)
            if ttd_vals else None,
            "true_detections": self.true_detections,
            "false_positives": self.false_positives,
            "false_positive_rate": fpr,
            "suspicion": self.suspicion,
        }
        if self.suspicion:
            doc.update(
                suspects_entered=self.suspects_entered,
                refutations=self.refutations,
                fp_suppressed=self.fp_suppressed,
                ttd_suspect=ttd_sus,
                suspect_to_confirm=sus2conf,
                suspect_before_confirm=all(
                    subj in firsts.get("suspect", {})
                    and firsts["suspect"][subj] <= r
                    for subj, r in firsts.get("confirm", {}).items()
                ),
            )
        if self._confirm_fp:
            doc["confirm_false_positives"] = sum(self._confirm_fp.values())
        if self._has_traffic:
            doc["durability"] = self._replay.facts()
            if self._client_issued:
                doc["client_ops"] = {
                    "issued": self._client_issued,
                    "acked": self._client_acked,
                    **quantiles(self._client_ops),
                }
        # -- monitor-only rows (outside the parity surface)
        doc.update(
            invariant_violations=len(self.violations),
            violations=[v.to_record() for v in self.violations],
            suppression_ratio=(self.fp_suppressed / self.refutations
                               if self.refutations else None),
            storm_rounds=self.storm_rounds,
            worst_window_fpr=self.worst_window_fpr,
            split_brain_rounds=(
                self._fp_confirm_last - self._fp_confirm_first + 1
                if self._fp_confirm_first is not None else 0),
        )
        return doc

    def verdict(self) -> dict:
        """The compact machine verdict bench/campaign surfaces stamp."""
        self.finish()
        by: dict[str, int] = {}
        for v in self.violations:
            name = v.detail.get("invariant", "?")
            by[name] = by.get(name, 0) + 1
        return {
            "ok": not self.violations,
            "invariant_violations": len(self.violations),
            "by_invariant": by,
            "invariants_checked": sorted(self._checked_invariants()),
        }

    def _checked_invariants(self) -> list[str]:
        rows = ["no_acked_write_lost"]
        if self._suspicion_armed():
            rows.append("no_confirm_without_suspect")
        if self.params.fpr_threshold is not None:
            rows.append("fpr_storm")
        if self.params.reconverge_bound is not None:
            rows.append("reconverge_bound")
        return rows


class MonitorRecorder(FlightRecorder):
    """A FlightRecorder with a StreamMonitor riding inline.

    Drop-in wherever ``attach_recorder`` takes a FlightRecorder: every
    emitted event is observed as it happens, and any violation it raises
    is appended to the SAME stream (so the written artifact carries its
    own online verdict).  ``close``/``finish`` run the end-of-stream
    invariants first.
    """

    def __init__(self, path=None, monitor: StreamMonitor | None = None,
                 params: MonitorParams | None = None, source: str = "sim",
                 n: int | None = None, **meta):
        super().__init__(path, source=source, n=n, **meta)
        self.monitor = monitor or StreamMonitor(params=params, n=n)
        self.monitor.observe_header(self.header)

    def emit(self, ev: Event) -> None:
        super().emit(ev)
        if ev.kind == "invariant_violation":
            return
        for v in self.monitor.observe(ev):
            super().emit(v)

    def finish(self) -> None:
        for v in self.monitor.finish():
            super().emit(v)

    def close(self) -> None:
        self.finish()
        super().close()


# ---------------------------------------------------------------------------
# monitor_parity: streaming == post-hoc, exactly
# ---------------------------------------------------------------------------

# The estimator fields the streaming summary and obs/timeline.py's
# analyze() must agree on EXACTLY (absent-in-one == mismatch).  "events"
# and the monitor-only rows stay out: a monitored stream re-analyzed
# from disk legitimately carries the extra invariant_violation rows.
PARITY_FIELDS = (
    "n", "rounds", "tracked_crashes", "detected",
    "ttd_first", "ttd_converged", "ttd_first_median",
    "true_detections", "false_positives", "false_positive_rate",
    "suspicion", "suspects_entered", "refutations", "fp_suppressed",
    "ttd_suspect", "suspect_to_confirm", "suspect_before_confirm",
    "confirm_false_positives", "durability", "client_ops",
)

_MISSING = object()


def estimator_parity(post_hoc: dict, streaming: dict) -> dict:
    """Exact field-for-field comparison over :data:`PARITY_FIELDS`.

    Returns ``{"ok": bool, "mismatches": {field: [post, stream]}}`` —
    the ``monitor_parity`` claim requires ``ok`` on the selfcheck
    stream (obs/timeline.py ``--selfcheck --monitor``).
    """
    mismatches = {}
    for f in PARITY_FIELDS:
        a, b = post_hoc.get(f, _MISSING), streaming.get(f, _MISSING)
        if a is _MISSING and b is _MISSING:
            continue
        if a != b:
            mismatches[f] = [None if a is _MISSING else a,
                             None if b is _MISSING else b]
    return {"ok": not mismatches, "mismatches": mismatches}


def monitor_verdict(events, n: int, params: MonitorParams | None = None,
                    header: dict | None = None) -> dict:
    """One-call verdict for bench surfaces: stream decoded events through
    a fresh monitor, return ``verdict()`` + the headline estimators."""
    mon = StreamMonitor(params=params, n=n)
    if header:
        mon.observe_header(header)
    mon.feed(events)
    mon.finish()
    s = mon.summary()
    return {
        **mon.verdict(),
        "false_positive_rate": s["false_positive_rate"],
        "worst_window_fpr": s["worst_window_fpr"],
        "ttd_first_median": s["ttd_first_median"],
        "violations": s["violations"],
    }
