"""Co-simulation: the SDFS control plane driven by the simulated detector.

The port of the JAX package's ``gossipfs_tpu/cosim.py``, over the port's
``SimDetector`` (its rounds on the card unless the caller passes
``device="cpu"``) and the port's SDFS plane.  The control plane itself is
host Python, as in the JAX package; only the detector's rounds touch the
device, and each tick reads back one membership row.

This is the build's equivalent of the reference's whole-node runtime
(main.go:14-35): the failure detector produces membership views, the SDFS
master consumes them through the Update_member seam (reference:
slave/slave.go:478, master/master.go:46-48), detections trigger delayed
re-replication (slave.go:1122-1133), and a vanished master triggers election
(slave.go:452-457).  BASELINE config 5 drives the same control plane in
chunks (``run.run_cosim``).

Fidelity note: the metadata authority consumes the *master node's own
membership view* (its row of the sim tensor), not ground truth — exactly like
the reference, where placement decisions follow the master's possibly-stale
or false-positive-ridden MemberList.
"""

from __future__ import annotations

from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.detector.api import DetectionEvent
from gossipfs_tpu_torch.detector.sim import SimDetector
from gossipfs_tpu_torch.sdfs.cluster import SDFSCluster
from gossipfs_tpu_torch.sdfs.types import RECOVERY_DELAY, STRIPE_K, STRIPE_M
from gossipfs_tpu_torch.utils.eventlog import EventLog


def select_observer(
    view_live: list[int], reachable: set[int], master: int
) -> int | None:
    """Whose membership view the metadata authority consumes.

    Normally the master's own row (slave.go:478).  If the master process is
    down (its RPC port refuses — observable immediately, unlike gossip
    detection), consumers fall through to the election candidate: the lowest
    node of the previous view that answers RPC; failing that, any reachable
    node.  Shared by the interactive CoSim and the chunked bench co-sim so
    config-5 observer semantics can't drift between them.
    """
    if master in reachable:
        return master
    candidates = [x for x in view_live if x in reachable]
    if candidates:
        return min(candidates)
    return min(reachable) if reachable else None


class CoSim:
    """Gossip detector + SDFS cluster advancing in lockstep rounds."""

    def __init__(
        self,
        config: SimConfig,
        seed: int = 0,
        log: EventLog | None = None,
        election: str = "local",
        detector=None,
        repair_budget: int | None = None,
        redundancy: str = "replica",
        stripe_k: int = STRIPE_K,
        stripe_m: int = STRIPE_M,
        rack_size: int | None = None,
        device="cuda",
    ):
        """``election``: "local" computes election outcomes centrally inside
        ``update_membership`` (the in-process fast path); "rpc" defers them —
        the cluster only flags ``election_pending`` and the gRPC shim drives
        the real per-node Vote / AssignNewMaster protocol
        (``shim/service.ShimServicer.run_pending_election``, after each
        ``Advance``), matching the reference's distributed revote
        (slave.go:930-1051).

        ``detector``: any FailureDetector (default: a fresh SimDetector).
        The capacity-frontier interactive CLI passes a
        ``detector.sim.PackedDetector`` — same seam, rr-kernel state.

        ``repair_budget``: per-pass cap on executed re-replications (the
        traffic plane's repair-storm scheduler — ``SDFSCluster.
        fail_recover(budget=...)``); a pass that defers work schedules
        another pass NEXT round, so a mass failure drains at budget/round
        instead of serializing one giant pass.  None = unbounded (the
        reference's behavior).

        ``redundancy``: "replica" (4 full copies, the reference) or
        "stripe" — the erasure plane (``gossipfs_tpu_torch/erasure/``): puts
        land k+m rack-balanced Reed-Solomon fragments, repairs re-encode
        at ~1/k the bytes.  ``rack_size`` groups nodes into contiguous
        racks, the stripe placement's correlated-failure domain.

        ``device``: where the default SimDetector's rounds run (the card
        unless the caller asks for the CPU); ignored when ``detector`` is
        given."""
        if election not in ("local", "rpc"):
            raise ValueError(f"unknown election mode: {election!r}")
        self.config = config
        self.election = election
        self.detector = detector or SimDetector(config, seed=seed,
                                                device=device)
        self.cluster = SDFSCluster(config.n, seed=seed,
                                   introducer=config.introducer,
                                   redundancy=redundancy, stripe_k=stripe_k,
                                   stripe_m=stripe_m, rack_size=rack_size)
        self.log = log or EventLog()
        self._recover_at: list[int] = []  # rounds at which to run fail_recover
        self.events: list[DetectionEvent] = []
        if repair_budget is not None and repair_budget <= 0:
            raise ValueError(
                "repair_budget must be positive (None = unbounded)")
        self.repair_budget = repair_budget
        # traffic-plane vitals (obs.schema.VITALS_FIELDS tail): client ops
        # issued/acked through this co-sim plus the repair scheduler's
        # cumulative/backlog counters — the CLI `traffic status` verb and
        # the shim Vitals RPC render these
        self.ops_issued = 0
        self.ops_acked = 0
        self.repairs_done = 0
        # files currently reported lost (no replica in the view) — a heal
        # that brings replicas back clears the entry so a re-loss re-emits
        self._lost_reported: set[str] = set()
        # armed fault scenario (scenarios/): the detector gets the gossip
        # transport rules; the control plane additionally confines
        # RPC/scp-level reachability to the master's side of any active
        # partition (see _reachable)
        self.scenario = None
        self._scn_round0 = 0
        # flight recorder (obs/): forwarded to the detector's protocol
        # seams; the control plane adds its own events (election,
        # replica_put/repair) so one stream carries the WHOLE
        # crash -> ... -> repair timeline
        self._recorder = None

    # -- observability (obs/) ----------------------------------------------
    def attach_recorder(self, recorder) -> None:
        """Arm an obs.FlightRecorder on both planes: the detector's
        lifecycle events plus the SDFS control plane's."""
        det = self.detector
        if hasattr(det, "attach_recorder"):
            det.attach_recorder(recorder)
        self._recorder = recorder

    def _rec(self, kind: str, subject: int = -1, observer: int = -1,
             **detail) -> None:
        if self._recorder is None:
            return
        from gossipfs_tpu_torch.obs.schema import Event

        self._recorder.emit(Event(round=self.round, observer=observer,
                                  subject=subject, kind=kind,
                                  detail=detail))

    def vitals(self) -> dict:
        """The uniform counter set (obs.schema.VITALS_FIELDS) for the
        CLI ``metrics`` verb and the shim's ``Vitals`` RPC.  The sim
        knows ground truth, so every field is live; suspicion counters
        appear only when the lifecycle is armed (consumers render the
        absence as n/a)."""
        doc = {
            "engine": "sim",
            "round": self.round,
            "n_alive": len(self.detector.alive_nodes()),
            "detections": len(self.events),
            "false_positives": sum(
                1 for e in self.events if e.false_positive),
        }
        sus = self.suspicion_status()
        if sus is not None:
            doc.update({k: sus[k] for k in (
                "suspects_now", "suspects_entered", "refutations",
                "confirms", "fp_suppressed") if k in sus})
        doc.update(self.traffic_status())
        return doc

    def load_scenario(self, scenario) -> None:
        """Arm a scenarios.FaultScenario on BOTH planes: gossip transport
        (detector.load_scenario — every engine behind the FailureDetector
        seam supports it) and the SDFS control plane's reachability.
        Rule windows count from the current round."""
        det = self.detector
        if not hasattr(det, "load_scenario"):
            raise NotImplementedError(
                f"{type(det).__name__} has no scenario support"
            )
        det.load_scenario(scenario)
        self.scenario = scenario
        self._scn_round0 = self.round

    def clear_scenario(self) -> None:
        det = self.detector
        if hasattr(det, "clear_scenario"):
            det.clear_scenario()
        self.scenario = None

    def scenario_status(self) -> dict | None:
        if self.scenario is None:
            return None
        # one status-document producer: the detector's (load_scenario
        # guarantees it exists — a second hand-built copy here would
        # drift from the engine surfaces)
        return self.detector.scenario_status()

    def suspicion_status(self) -> dict | None:
        """Suspicion vitals (suspicion/) — the detector's document, same
        one-producer rule as scenario_status; None when the detector has
        no suspicion support or none is armed."""
        det = self.detector
        if hasattr(det, "suspicion_status"):
            return det.suspicion_status()
        return None

    def _reachable(self) -> set[int]:
        """Transport-level reachability from the control plane's seat.

        The metadata authority lives with the master, so under an active
        partition only the master's side answers its RPC/scp — replica
        pushes to the far side fail, which is exactly what starves a
        minority-side write of its quorum (reference: an scp to an
        unreachable VM fails immediately).  Without a scenario this is
        ground-truth liveness, as before.
        """
        alive = set(self.detector.alive_nodes())
        if self.scenario is None:
            return alive
        rel = self.round - self._scn_round0
        # outage-group members and dark-phase flappers answer no RPC/scp
        # at all (round-13 gray-failure rules)
        alive -= self.scenario.unreachable_at(rel)
        pid = self.scenario.pid_at(rel)
        if pid is None:
            return alive
        side = pid[self.cluster.master_node]
        return {x for x in alive if pid[x] == side}

    @property
    def round(self) -> int:
        det = self.detector
        return det.round if hasattr(det, "round") else int(det.state.round)

    def _observer(self) -> int | None:
        """See ``select_observer`` — the *view itself* stays pure gossip data:
        dead-but-undetected members remain in it, so placement/election react
        at detection time, not at crash time."""
        # "answers RPC" — partition-confined under an armed scenario
        return select_observer(
            self.cluster.live, self._reachable(), self.cluster.master_node
        )

    def tick(self, rounds: int = 1) -> None:
        """Advance the detector and let the control plane react per round."""
        for _ in range(rounds):
            self.detector.advance(1)
            now = self.round
            new_events = self.detector.drain_events()
            self.events.extend(new_events)
            for ev in new_events:
                # logged by the DETECTING machine (slave.go:474): the entry
                # lands in the observer's own Machine.log view
                self.log.write(
                    f"Failure Detected of node {ev.subject} by {ev.observer}",
                    round=now,
                    kind="failure_detected",
                    false_positive=ev.false_positive,
                    node=ev.observer,
                )
                # detection schedules recovery 8 heartbeats out (slave.go:1123)
                self._recover_at.append(now + RECOVERY_DELAY)
            observer = self._observer()
            if observer is not None:
                old_master = self.cluster.master_node
                self.cluster.update_membership(
                    self.detector.membership(observer),
                    reachable=sorted(self._reachable()),
                    now=now,
                    elect=self.election == "local",
                )
                if self.cluster.master_node != old_master:
                    # the reference logs the vote outcome (revote_master /
                    # Receive_vote, slave.go:930-984)
                    self.log.write(
                        f"Elected new master {self.cluster.master_node} "
                        f"(was {old_master})",
                        round=now,
                        kind="election",
                        node=self.cluster.master_node,  # the winner announces
                    )
                    self._rec("election", subject=self.cluster.master_node,
                              was=old_master)
            due = [r for r in self._recover_at if r <= now]
            if due:
                self._recover_at = [r for r in self._recover_at if r > now]
                plans = self.cluster.fail_recover(budget=self.repair_budget)
                self.repairs_done += len(plans)
                for plan in plans:
                    if self.cluster.redundancy == "stripe":
                        # a stripe repair has k sources, not one: the
                        # master coordinates, so it owns the log line
                        self.log.write(
                            f"Re-encoded {plan.file} v{plan.version} "
                            f"slots {list(plan.slots)} to "
                            f"{list(plan.new_nodes)}",
                            round=now,
                            kind="re_replicate",
                            node=self.cluster.master_node,
                        )
                        self._rec("stripe_repair",
                                  observer=self.cluster.master_node,
                                  file=plan.file, version=plan.version,
                                  slots=list(plan.slots),
                                  targets=list(plan.new_nodes))
                        continue
                    # logged by the SOURCE machine doing the Re_put
                    # (slave.go:1174)
                    self.log.write(
                        f"Re-replicated {plan.file} v{plan.version} "
                        f"from {plan.source} to {list(plan.new_nodes)}",
                        round=now,
                        kind="re_replicate",
                        node=plan.source,
                    )
                    self._rec("replica_repair", observer=plan.source,
                              file=plan.file, version=plan.version,
                              targets=list(plan.new_nodes))
                if self.cluster.last_repair_pending:
                    # budget deferred planned repairs: drain next round
                    # (the repair-storm scheduler's retry cadence)
                    self._recover_at.append(now + 1)
                # files with no replica left in the view: observable loss
                # evidence (recovers — and re-arms — across heals)
                lost_now = set(self.cluster.lost_files())
                lost_kind = ("stripe_lost"
                             if self.cluster.redundancy == "stripe"
                             else "replica_lost")
                for name in sorted(lost_now - self._lost_reported):
                    self.log.write(
                        f"All replicas of {name} lost from the view"
                        if lost_kind == "replica_lost" else
                        f"Stripe {name} below k live fragments in the view",
                        round=now, kind="lost",
                        node=self.cluster.master_node,
                    )
                    self._rec(lost_kind,
                              observer=self.cluster.master_node, file=name)
                self._lost_reported = lost_now

    # -- client verbs delegated with sim time ------------------------------
    def _put_event(self, name: str) -> None:
        """One acked put's schema event: the committed version plus the
        replica nodes that actually acked (reachable at commit time) —
        what the durability audit (traffic/audit.py) replays.  Stripe
        mode reports the slot-aligned fragment holders instead (-1 where
        the fragment did not land), plus the (k, m) shape the replay
        needs for its k-of-(k+m) loss line."""
        if self.cluster.redundancy == "stripe":
            sinfo = self.cluster.master.stripes.get(name)
            if sinfo is None:
                return
            fragments = [
                nd if nd >= 0 and nd in self.cluster.reachable else -1
                for nd in sinfo.fragment_nodes
            ]
            self._rec("stripe_put", observer=self.cluster.master_node,
                      file=name, version=sinfo.version, fragments=fragments,
                      k=self.cluster.stripe_k, m=self.cluster.stripe_m)
            return
        info = self.cluster.master.files.get(name)
        if info is None:
            return
        acked = [nd for nd in info.node_list if nd in self.cluster.reachable]
        self._rec("replica_put", observer=self.cluster.master_node,
                  file=name, version=info.version, replicas=acked)

    def put(self, name: str, data: bytes, confirm=None) -> bool:
        self.ops_issued += 1
        ok = self.cluster.put(name, data, now=self.round, confirm=confirm)
        # logged at the master handling Get_put_info (server.go:74-121)
        self.log.write(
            f"put {name} -> {'ok' if ok else 'rejected'}",
            round=self.round,
            kind="put",
            node=self.cluster.master_node,
        )
        if ok:
            self.ops_acked += 1
            self._put_event(name)
        return ok

    def put_batch(self, items, confirm=None) -> dict[str, bool]:
        """Batched write verb for the open-loop traffic plane: one
        vectorized placement draw for the round's new files
        (``SDFSCluster.put_batch``), per-file acks/events as usual."""
        self.ops_issued += len(items)
        results = self.cluster.put_batch(items, now=self.round,
                                         confirm=confirm)
        for name, ok in results.items():
            self.log.write(
                f"put {name} -> {'ok' if ok else 'rejected'}",
                round=self.round,
                kind="put",
                node=self.cluster.master_node,
            )
            if ok:
                self.ops_acked += 1
                self._put_event(name)
        return results

    def get(self, name: str) -> bytes | None:
        self.ops_issued += 1
        blob = self.cluster.get(name)
        if blob is not None:
            self.ops_acked += 1
        return blob

    def delete(self, name: str) -> bool:
        self.ops_issued += 1
        ok = self.cluster.delete(name)
        if ok:
            self.ops_acked += 1
            self.log.write(
                f"delete {name}", round=self.round, kind="delete",
                node=self.cluster.master_node,
            )
            self._rec("replica_delete", observer=self.cluster.master_node,
                      file=name)
            self._lost_reported.discard(name)
        return ok

    # -- traffic vitals (obs/schema.py VITALS_FIELDS tail) ------------------
    def traffic_status(self) -> dict:
        """The traffic-plane counter document: ops issued/acked through
        this co-sim, repairs executed, and the CURRENT repair backlog
        (budget-deferred plans from the last recovery pass plus files
        still under-replicated right now — computed on demand; cheap at
        interactive scale).  Stripe mode adds the erasure vitals
        (``stripes_degraded`` / ``fragments_lost``); replica mode leaves
        them ABSENT so consumers render n/a, never a fabricated 0."""
        cl = self.cluster
        if cl.redundancy == "stripe":
            pending = len(cl.master.plan_stripe_repairs(
                cl.live, reachable=cl.reachable
            ))
        else:
            pending = len(cl.master.plan_repairs(
                cl.live, reachable=cl.reachable
            ))
        doc = {
            "ops_issued": self.ops_issued,
            "ops_acked": self.ops_acked,
            "repairs_pending": pending,
            "repairs_done": self.repairs_done,
        }
        if cl.redundancy == "stripe":
            from gossipfs_tpu_torch.sdfs.quorum import stripe_read_quorum

            live_set = set(cl.live)
            width = cl.stripe_k + cl.stripe_m
            rq = stripe_read_quorum(cl.stripe_k, cl.stripe_m)
            degraded = 0
            frag_lost = 0
            for info in cl.master.stripes.values():
                w = sum(1 for nd in info.fragment_nodes if nd in live_set)
                if w < width:
                    frag_lost += width - w
                    if w >= rq:
                        degraded += 1
            doc["stripes_degraded"] = degraded
            doc["fragments_lost"] = frag_lost
        mon = getattr(self._recorder, "monitor", None)
        if mon is not None:
            # online health plane (obs/monitor.py): the live invariant
            # verdict rides the traffic/metrics surfaces.  Without an
            # attached monitor the field is ABSENT — consumers render
            # n/a, never a fabricated clean 0 (the round-8 rule)
            doc["invariant_violations"] = len(mon.violations)
        return doc
