"""Socket-engine campaign runners: the SAME committed case files, real
transports.

The port's copy of the JAX package's ``campaigns/engines.py``.  The socket
engines are host code; the tensor replay every verdict is held against
(:func:`run_case_engine`) runs the port's round loops on ``device``, the
card unless the caller names another.

Round 13's campaigns ran only the tensor engine; the UDP and deploy
lanes had never been driven through a fault family at all, even though
``ScenarioRuntime`` implements every primitive per message.  This module
closes that gap: :func:`run_case_engine` takes the SAME
``gossipfs-campaign-case/v1`` files tier-1 replays on the tensor engine
and drives them through

  * the asyncio UDP cluster (``detector/udp.py`` — real datagrams on
    localhost, the scenario armed at the ``UdpNode._send`` hook, crashes
    as socket teardown), recording a ``gossipfs-obs/v1`` stream whose
    ``round_tick`` rows carry the in-process ground truth
    (``UdpCluster.run(emit_round_ticks=True)``), or
  * the per-process deployment (``deploy/launcher.py`` — one OS process
    per node, the rule table pushed over the control plane with the
    round-14 bounded-backoff RPC discipline, crashes as ``kill -9``,
    events tailed from the per-node ``node<i>.log`` schema streams), or
  * the native C++ epoll engine (``native/engine.cc`` via
    ``gossipfs_tpu_torch/native.py`` — the sanitizer-certified runtime; the
    scenario compiled to the in-engine send-gate table, suspicion + the
    Lifeguard stretch running inside the engine, events drained over
    ``gfs_obs_drain`` and rendered through the same ``FlightRecorder``
    — the COHORT-EXACT lane: committed n=256+ cases run at their
    committed n, which the asyncio loop cannot sustain),

then feeds the recorded stream through ``StreamMonitor.feed_jsonl`` —
the SAME file-attachment seam, the SAME invariant table, the SAME
``MonitorParams`` the case file carries — and requires the verdict to
AGREE with the tensor replay's on every invariant both engines can
check.  A campaign case that reproduces its storm (or its absorption)
over real sockets is the strongest evidence the finding is protocol
physics, not a tensor-engine artifact — and a deploy campaign that
finishes at all under a correlated outage is itself evidence the
control plane degrades gracefully (the round-14 backoff hardening).

Real-socket runs are wall-clock and scheduling-jittered, so they are
NOT bit-reproducible like tensor replays; what must reproduce is the
VERDICT.  Committed cases are campaign-generated (family metadata in
the case doc), so :func:`scale_case` can regenerate the same family
point at a smaller n — the deploy lane's process budget is ~8 nodes,
not 256 — with the severity knobs (duty cycles, loss rates, outage
size) preserved and the fault cohorts re-picked around the scaled
tracked victims.
"""

from __future__ import annotations

import asyncio
import copy
import json
import pathlib
import tempfile
import time

from gossipfs_tpu_torch.campaigns.driver import (
    campaign_rounds,
    case_verdict_ok,
    load_case,
    make_scenario,
    run_case_doc,
)
from gossipfs_tpu_torch.obs.monitor import MonitorParams, StreamMonitor
from gossipfs_tpu_torch.scenarios.schedule import FaultScenario

ENGINES = ("tensor", "udp", "deploy", "native")


def scale_case(doc: dict, n: int) -> dict:
    """Regenerate a campaign case at a different cohort size.

    Only campaign-GENERATED cases scale (they carry ``family`` /
    ``axis`` / ``axis_value`` metadata plus the fixed knobs in the
    scenario name): the scenario is re-made by the same
    ``make_scenario`` rules at the new n — fractional cohorts (1/frac)
    scale naturally, absolute knobs (outage size, flap duty cycle) are
    preserved, and the fault nodes re-avoid the scaled tracked victims.
    Hand-written cases without the metadata are rejected rather than
    guessed at.
    """
    from gossipfs_tpu_torch.bench import tracked_victims

    if "family" not in doc or "axis" not in doc:
        raise ValueError(
            "case carries no campaign family metadata — only "
            "campaign-generated cases can be scaled; run it at its "
            "committed n instead")
    out = copy.deepcopy(doc)
    c = out["config"]
    old_sc = FaultScenario.from_json(json.dumps(doc["scenario"]))
    # fault_rounds: reconstruct the window length from the committed
    # scenario (make_scenario's windows are [start, start + rounds))
    rules = (*old_sc.flapping, *old_sc.link_faults, *old_sc.slow_nodes,
             *old_sc.partitions, *old_sc.outages)
    fault_rounds = max(r.end - r.start for r in rules)
    knobs = {}
    for kv in old_sc.name.split("-", 1)[1].split(","):
        k, _, v = kv.partition("=")
        knobs[k] = int(v)
    # make_scenario excludes `start` from the name; recover it from the
    # committed windows so a non-default start survives the rescale (the
    # probe/heal phase alignment the surface shows is crash_at-coupled)
    knobs["start"] = min(r.start for r in rules)
    avoid = set(tracked_victims(n, int(c["track"]))) | {0}
    sc = make_scenario(doc["family"], n, fault_rounds, avoid=avoid,
                       **knobs)
    out["scenario"] = json.loads(sc.to_json())
    n_old = int(c["n"])
    c["n"] = n
    if float(c.get("lh_frac", 0.0)) > 0 and int(c.get("lh_multiplier", 0)):
        # the Lifeguard degradation threshold is an ABSOLUTE suspect
        # count in disguise (frac x listed ~ frac x n): a case tuned to
        # sit between "4 simultaneous tracked probes" and "an 8-node
        # rack" must keep those COUNTS when the cohort shrinks, so the
        # fraction scales by n_old/n — 1/64 at n=256 (threshold ~4)
        # becomes 1/16 at n=64 (threshold ~4), not 1/64 (threshold ~1,
        # which would stretch on every routine probe)
        c["lh_frac"] = min(float(c["lh_frac"]) * n_old / n, 0.5)
    out["scaled_from"] = n_old
    return out


def _case_plan(doc: dict):
    """The run plan every socket engine derives from a case doc —
    ``(n, scenario, crash_at, rounds, victims)`` with ONE owner, so a
    change to the bound/rounds derivation cannot silently
    desynchronize the engines' run lengths (``campaign_rounds``'
    single-owner rationale, extended to the whole scaffold)."""
    from gossipfs_tpu_torch.bench import tracked_victims

    c = doc["config"]
    n = int(c["n"])
    sc = FaultScenario.from_json(json.dumps(doc["scenario"]))
    crash_at = int(c.get("crash_at", 10))
    bound = doc["monitor"].get("reconverge_bound") or (int(c["t_fail"]) + 6)
    rounds = campaign_rounds(sc.horizon, crash_at, bound)
    victims = tracked_victims(n, int(c["track"]))
    return n, sc, crash_at, rounds, victims


def _wire_knobs(c: dict) -> dict:
    """Optional dissemination knobs a case config may carry (round 20).

    ``delta=1`` switches the engine's membership refresh to the
    delta-piggyback profile (``protocol_spec.DELTA_GOSSIP``) with the
    case's ``delta_entries`` / ``anti_entropy_every``; absent, the
    engines keep the committed full-list wire format, so every existing
    case file runs bit-identically.  Both socket engines accept the same
    keys — one derivation, like ``_case_plan``.
    """
    if not int(c.get("delta", 0)):
        return {}
    return {
        "delta": True,
        "delta_entries": int(c.get("delta_entries", 16)),
        "anti_entropy_every": int(c.get("anti_entropy_every", 4)),
    }


def _suspicion_params(c: dict):
    if int(c.get("t_suspect", 0)) <= 0:
        return None
    from gossipfs_tpu_torch.suspicion import SuspicionParams

    return SuspicionParams(
        t_suspect=int(c["t_suspect"]),
        lh_multiplier=int(c.get("lh_multiplier", 0)),
        lh_frac=float(c.get("lh_frac", 0.25)),
    )


def _monitor_row(trace_path, params: MonitorParams, n: int,
                 crash_rounds: dict[int, int] | None = None) -> dict:
    """Feed one written stream through a fresh monitor (the
    ``feed_jsonl`` file-attachment seam — deliberately NOT the inline
    recorder: the committed artifact is re-derivable from the file
    alone) and shape the verdict like a campaign ledger row."""
    mon = StreamMonitor(params=params, n=n)
    if crash_rounds:
        mon.observe_header({"n": n, "crash_rounds": {
            str(k): v for k, v in crash_rounds.items()}})
    mon.feed_jsonl(trace_path)
    mon.finish()
    s = mon.summary()
    return {
        "verdict": "violated" if mon.violations else "pass",
        "monitor": mon.verdict(),
        # round_tick rows seen: zero means the stream cannot evaluate
        # the rolling-FPR invariant at all (deploy node logs carry no
        # ground-truth ticks) — verdict_agreement drops fpr_storm then
        "observed_round_ticks": s["rounds"],
        "estimators": {
            "false_positives": s["false_positives"],
            "false_positive_rate": s["false_positive_rate"],
            "worst_window_fpr": s["worst_window_fpr"],
            "ttd_first_median": s["ttd_first_median"],
            "detected": s["detected"],
            "tracked_crashes": s["tracked_crashes"],
        },
        "violations": s["violations"],
    }


def verdict_agreement(tensor_row: dict, engine_row: dict) -> dict:
    """Per-invariant agreement over the invariants BOTH engines checked.

    The UDP lane checks the full table (its ``round_tick`` rows carry
    ground truth); the deploy lane has no ground-truth FPR, so its
    stream never grows ``fpr_storm`` windows — comparing only the
    intersection keeps the agreement requirement honest instead of
    vacuously failing on unknowables.
    """
    a = tensor_row["monitor"]
    b = engine_row["monitor"]
    compared = sorted(set(a["invariants_checked"])
                      & set(b["invariants_checked"]))
    if engine_row.get("observed_round_ticks") == 0:
        # the invariant table lists fpr_storm whenever a threshold is
        # set, but a stream with no round_tick rows never evaluated it
        compared = [inv for inv in compared if inv != "fpr_storm"]
    mismatch = [
        inv for inv in compared
        if bool(a["by_invariant"].get(inv)) != bool(
            b["by_invariant"].get(inv))
    ]
    return {"match": not mismatch, "compared": compared,
            "mismatched": mismatch}


# ---------------------------------------------------------------------------
# UDP engine
# ---------------------------------------------------------------------------


def _free_udp_base(n: int) -> int:
    """A UDP port window with room for ``n`` sockets — the launcher's
    bind-and-hold probe (ONE owner), UDP-only: two concurrent campaign
    runners (a tier-1 smoke racing a committed-artifact run) must not
    land on the same window and cross-talk their clusters (observed: a
    fixed base_port made two overlapping runs merge memberships)."""
    from gossipfs_tpu_torch.deploy.launcher import _free_port_base

    return _free_port_base(n, tcp=False)


def _wire_delta(v0: dict, v1: dict, rounds: int) -> dict:
    """Measured-window wire accounting (the delta-gossip A/B surface):
    payload bytes and frame counts actually handed to the transport
    between two vitals snapshots, normalized per round."""
    bytes_sent = v1["bytes_sent"] - v0["bytes_sent"]
    return {
        "rounds": rounds,
        "bytes_sent": bytes_sent,
        "bytes_per_round": bytes_sent / max(rounds, 1),
        "frames_full": v1["frames_full"] - v0["frames_full"],
        "frames_delta": v1["frames_delta"] - v0["frames_delta"],
    }


async def _udp_case(doc: dict, trace: str, period: float,
                    warmup_timeout: float):
    """Drive one case on an in-process UdpCluster; returns the crash
    schedule ({victim: round}) for the monitor's TTD accounting plus
    the measured window's wire accounting."""
    from gossipfs_tpu_torch.detector.udp import UdpCluster
    from gossipfs_tpu_torch.obs.recorder import FlightRecorder

    c = doc["config"]
    n, sc, crash_at, rounds, victims = _case_plan(doc)

    from gossipfs_tpu_torch.config import SimConfig

    cluster = UdpCluster(
        n, base_port=_free_udp_base(n), period=period,
        t_fail=int(c["t_fail"]),
        t_cooldown=max(12, int(c["t_fail"]) + 4), fresh_cooldown=True,
        suspicion=_suspicion_params(c),
        # the campaign protocol profile — the same knobs
        # campaigns.campaign_config sets on the tensor engine (random
        # log-fanout push, gossip-only removal): verdict agreement must
        # compare PROTOCOLS, not the reference ring's O(N)-tick event
        # propagation (see UdpCluster's push notes)
        push="random", fanout=int(c.get("fanout", SimConfig.log_fanout(n))),
        remove_broadcast=False,
        **_wire_knobs(c),
    )
    await cluster.start_all()
    try:
        # fully-joined steady-state start, like the tensor campaign's
        # init_state (the O(N^2) protocol boot takes minutes at
        # campaign cohort sizes), then a short warmup OFF the
        # observational round clock (nodes tick on their own heartbeat
        # tasks; cluster._round stays 0, so the recorded stream's
        # rounds are scenario-relative like the tensor trace's) until
        # every counter is past the hb<=1 detection grace
        cluster.seed_full_membership()
        deadline = time.monotonic() + warmup_timeout
        while time.monotonic() < deadline:
            full = all(
                len(node.members) == n
                and min(m.hb for m in node.members.values()) > 1
                for node in cluster.nodes
            )
            if full:
                break
            await asyncio.sleep(period)
        else:
            raise TimeoutError(
                f"udp cluster (n={n}) did not converge within "
                f"{warmup_timeout}s of warmup")

        rec = FlightRecorder(trace, source="udp-campaign", n=n,
                             case=doc.get("family", "case"),
                             crash_rounds={str(v): crash_at
                                           for v in victims})
        cluster.attach_recorder(rec)
        cluster.load_scenario(sc)
        v0 = cluster.vitals()
        for r in range(rounds):
            if r == crash_at:
                for v in victims:
                    cluster.crash(v)
            await cluster.run(1, emit_round_ticks=True)
        wire = _wire_delta(v0, cluster.vitals(), rounds)
        rec.close()
        return {v: crash_at for v in victims}, wire
    finally:
        cluster.stop_all()


def udp_period(n: int) -> float:
    """The asyncio lane's default heartbeat period: one python event
    loop parses n full-list datagram fan-outs per period, and the
    engine is documented load-sensitive (UDPCAMPAIGN_r14) — n=64 runs
    all ride 0.1 s in the committed evidence while the n=24 tier-1
    smoke keeps 0.05 s.  ~1.5 ms of loop budget per node, floored at
    the small-lane 0.05 s."""
    return max(0.05, n / 640.0)


def run_case_udp(doc: dict, *, period: float | None = None,
                 trace: str | None = None,
                 warmup_timeout: float = 60.0) -> dict:
    """One case on the asyncio UDP engine; returns the ledger-row shape
    plus the written trace path (re-feed it through
    ``StreamMonitor.feed_jsonl`` to re-derive the verdict)."""
    if period is None:
        period = udp_period(int(doc["config"]["n"]))
    if trace is None:
        trace = tempfile.mktemp(prefix="udp_case_", suffix=".jsonl")
    crash_rounds, wire = asyncio.run(
        _udp_case(doc, trace, period, warmup_timeout))
    row = _monitor_row(trace, MonitorParams.from_dict(doc["monitor"]),
                       int(doc["config"]["n"]),
                       crash_rounds=crash_rounds)
    row.update(engine="udp", trace=str(trace), period=period, wire=wire)
    return row


# ---------------------------------------------------------------------------
# native engine (C++ epoll — campaigns/engines' third real transport)
# ---------------------------------------------------------------------------


def native_period(n: int) -> float:
    """The native lane's default heartbeat period: the engine is one
    epoll thread doing all N nodes' protocol work, and detection clocks
    are WALL time — a period the tick+merge pass can't keep costs
    false positives by PHYSICS (rounds lag, entries look stale), not
    protocol.  ~2 ms of budget per node: at n=256 the full-list merge
    pass costs ~60-100 ms/round on the 1-core box (measured via the
    round_tick ``tick_ms`` samples — n/1024 s was observably too tight:
    warmup churned with view-shrink storms), so n/512 leaves the round
    ~5x of headroom.  The floor is 0.1 s — 2x the asyncio lane's small-n
    floor on purpose: the native engine ticks EVERY node at the same
    instant (one loop), so entry ages are quantized to whole periods
    and the t_fail staleness edge is one scheduling hiccup wide, where
    the asyncio engine's per-node tasks stagger their phases across
    the period."""
    return max(0.1, n / 512.0)


def run_case_native(doc: dict, *, period: float | None = None,
                    trace: str | None = None,
                    warmup_timeout: float | None = None) -> dict:
    """One case on the native C++ epoll engine (real localhost
    datagrams, one OS thread) — the cohort-exact lane: the asyncio
    engine honestly melts past n~64 (UDPCAMPAIGN_r14), so committed
    n=256+ cases run here at their COMMITTED n instead of rescaled.

    Same contract as :func:`run_case_udp`: campaign protocol profile
    (random log-fanout push, gossip-only removal), seeded steady-state
    start, the scenario armed as the engine's send-gate table, the
    recorded ``gossipfs-obs/v1`` stream fed back through
    ``StreamMonitor.feed_jsonl``.  The native round_ticks carry
    in-process ground truth, so the full invariant table (fpr_storm
    included) evaluates; ``tick_ms`` rides every round_tick and the
    returned row carries the per-round latency histogram (the 'did the
    engine keep its period' evidence a real-time verdict rests on).
    """
    import time as _time

    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.native import NativeUdpDetector, latency_histogram
    from gossipfs_tpu_torch.obs.recorder import FlightRecorder, load_stream

    c = doc["config"]
    n, sc, crash_at, rounds, victims = _case_plan(doc)
    if period is None:
        period = native_period(n)
    if warmup_timeout is None:
        # scales with n for the same reason as run_ab_cell: the seeded
        # cold start's one-time staleness churn grows with cohort size
        warmup_timeout = max(120.0, 0.75 * n)
    if trace is None:
        trace = tempfile.mktemp(prefix="native_case_", suffix=".jsonl")

    det = NativeUdpDetector(
        n, base_port=_free_udp_base(n), period=period,
        t_fail=int(c["t_fail"]),
        t_cooldown=max(12, int(c["t_fail"]) + 4), fresh_cooldown=True,
        push="random", fanout=int(c.get("fanout", SimConfig.log_fanout(n))),
        remove_broadcast=False, suspicion=_suspicion_params(c),
        loops=int(c.get("loops", 1)),
        **_wire_knobs(c),
    )
    try:
        det.seed_full_membership()
        deadline = _time.monotonic() + warmup_timeout
        while not det.warm():
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"native cluster (n={n}) did not converge within "
                    f"{warmup_timeout}s of warmup")
            _time.sleep(period)
        rec = FlightRecorder(trace, source="native-campaign", n=n,
                             case=doc.get("family", "case"),
                             crash_rounds={str(v): crash_at
                                           for v in victims})
        # one relative clock for the stream AND the gate windows: the
        # absolute round attach_recorder rebased to anchors both
        r0 = det.attach_recorder(rec)
        det.load_scenario(sc, round0=r0)
        v0 = det.vitals()
        det.advance((r0 + crash_at) - det.round)
        for v in victims:
            det.crash(v)
        remaining = (r0 + rounds) - det.round
        if remaining > 0:
            det.advance(remaining)
        wire = _wire_delta(v0, det.vitals(), rounds)
        # stop the loop BEFORE draining: the drain's host-side parse is
        # seconds of CPU the 1-core epoll thread would otherwise lose —
        # enough wall time to stale entries and cascade manufactured
        # FPs into the recorded tail (gfs_stop's raison d'etre)
        det.stop()
        det.pump_obs()
        rec.close()
    finally:
        det.close()

    row = _monitor_row(trace, MonitorParams.from_dict(doc["monitor"]), n,
                       crash_rounds={v: crash_at for v in victims})
    _, events = load_stream(trace)
    row.update(engine="native", trace=str(trace), period=period,
               tick_ms=latency_histogram(events), wire=wire)
    return row


def run_ab_cell(n: int, *, delta: bool, loops: int = 1,
                rounds: int = 24, period: float | None = None,
                fanout: int | None = None, t_fail: int = 12,
                delta_entries: int = 16, anti_entropy_every: int = 6,
                settle: int | None = None,
                warmup_timeout: float | None = None) -> dict:
    """One quiet-cluster perf cell on the native engine — the delta
    A/B's measurement unit (``python -m gossipfs_tpu_torch.campaigns
    --ab``): warm a fresh
    n-node cluster in (delta, loops) mode, run ``rounds`` steady-state
    rounds, and report the wire accounting (bytes/round, full vs delta
    frame split) plus the per-round ``tick_ms`` histogram.  No faults:
    the verdict plane is the matrix's job; this cell isolates the two
    payoff observables — payload bytes and merge-pass latency.

    ``fanout`` defaults to max(16, log-fanout): delta mode concentrates
    a stable entry's refresh opportunities on anti-entropy rounds, so
    the per-node miss floor is ~e^-fanout per AE round — 16 keeps the
    expected misses over the run well under one node even at n=1024,
    and BOTH arms run the same fanout so the A/B isolates the wire
    format, not the push width.

    ``settle`` rounds run between warmup and the measurement window so
    per-peer delta cursors populate first — a cursor-less peer gets a
    full list, and with random push each peer pair first meets after
    ~n/fanout rounds in expectation, so an unsettled window measures
    mostly first-contact fulls instead of the steady-state delta mix.
    Defaults to 2*ceil(n/fanout) (residual cursor-less fraction ~e^-2);
    both arms settle identically so the A/B stays symmetric.

    ``t_fail`` defaults to 2x ``anti_entropy_every``: delta mode only
    GUARANTEES an entry refresh on anti-entropy rounds (the changed-
    first slots are recency-biased and the rr tail gets leftover
    capacity only), so the staleness budget must clear the AE cadence
    with margin — t_fail >= 2*anti_entropy_every keeps a single lost
    AE push from crossing the suspicion threshold on a quiet cluster."""
    import time as _time

    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.native import NativeUdpDetector, latency_histogram
    from gossipfs_tpu_torch.obs.recorder import FlightRecorder, load_stream

    if period is None:
        period = native_period(n)
    if fanout is None:
        fanout = max(16, SimConfig.log_fanout(n))
    if settle is None:
        settle = 2 * -(-n // fanout)
    if warmup_timeout is None:
        # the seeded cold start pays a one-time staleness cascade in
        # delta mode (every entry starts equally stale and the bounded
        # frames throttle first refreshes): n=1024 warms in ~120s of
        # churn that then fully quenches, so the gate scales with n
        warmup_timeout = max(300.0, 0.75 * n)
    knobs = {}
    if delta:
        knobs = dict(delta=True, delta_entries=delta_entries,
                     anti_entropy_every=anti_entropy_every)
    trace = tempfile.mktemp(prefix="ab_cell_", suffix=".jsonl")
    det = NativeUdpDetector(
        n, base_port=_free_udp_base(n), period=period, t_fail=t_fail,
        t_cooldown=t_fail + 4, fresh_cooldown=True, push="random",
        fanout=fanout, remove_broadcast=False, loops=loops, **knobs)
    try:
        det.seed_full_membership()
        deadline = _time.monotonic() + warmup_timeout
        while not det.warm():
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"ab cell (n={n}, delta={delta}, loops={loops}) "
                    f"did not converge within {warmup_timeout}s")
            _time.sleep(period)
        if settle > 0:
            det.advance(settle)
        rec = FlightRecorder(trace, source="native-ab", n=n, case="ab")
        det.attach_recorder(rec)
        v0 = det.vitals()
        det.advance(rounds)
        v1 = det.vitals()
        wire = _wire_delta(v0, v1, rounds)
        det.stop()
        det.pump_obs()
        rec.close()
    finally:
        det.close()
    _, events = load_stream(trace)
    cell = {
        "n": n, "delta": bool(delta), "loops": loops, "period": period,
        "fanout": fanout, "rounds": rounds, "settle": settle,
        "t_fail": t_fail,
        "false_positives": (v1["false_positives"]
                            - v0["false_positives"]),
        "n_alive": v1["n_alive"],
        "wire": wire, "tick_ms": latency_histogram(events),
    }
    if delta:
        cell["delta_entries"] = delta_entries
        cell["anti_entropy_every"] = anti_entropy_every
    return cell


# ---------------------------------------------------------------------------
# deploy engine
# ---------------------------------------------------------------------------


def _merge_streams(paths) -> str:
    """Stable round-order merge of several node logs into one stream
    file feed_jsonl can tail (obs/timeline.py's merge semantics:
    concatenate, stable-sort by round — per-node logs are already
    round-ordered)."""
    from gossipfs_tpu_torch.obs import schema
    from gossipfs_tpu_torch.obs.recorder import load_stream

    events = []
    for p in paths:
        _, evs = load_stream(p)
        events.extend(evs)
    events.sort(key=lambda e: e.round)
    out = tempfile.mktemp(prefix="deploy_case_", suffix=".jsonl")
    with open(out, "w", encoding="utf-8") as f:
        f.write(schema.dumps(schema.header("deploy-campaign")) + "\n")
        for e in events:
            f.write(schema.dumps(e.to_record()) + "\n")
    return out


def run_case_deploy(doc: dict, *, period: float = 0.1,
                    trace: str | None = None) -> dict:
    """One case on the per-process deployment.

    Spawns the launcher cluster, pushes the scenario + suspicion params
    over the (backoff-hardened) control plane, ``kill -9``s the tracked
    victims at the case's crash round, and tails the per-node
    ``node<i>.log`` schema streams through the monitor.  The deploy
    daemons have no ground-truth aliveness, so the verdict covers the
    invariants their streams can carry (``verdict_agreement`` compares
    only those against the tensor run).
    """
    from gossipfs_tpu_torch.deploy.launcher import Cluster

    c = doc["config"]
    n, sc, crash_at, rounds, victims = _case_plan(doc)

    cluster = Cluster(n, period=period, t_fail=int(c["t_fail"]))
    try:
        cluster.start()
        sus = _suspicion_params(c)
        if sus is not None:
            acked = cluster.load_suspicion(sus)
            if len(acked) != n:
                raise RuntimeError(f"suspicion push acked by {acked}")
        acked = cluster.load_scenario(sc)
        if len(acked) != n:
            raise RuntimeError(f"scenario push acked by {acked}")
        # scenario-relative clock: each node anchored its windows at the
        # push; read the survivors' round counters to place the crashes
        r0 = max((line.get("round", 0)
                  for line in cluster.vitals()), default=0)
        time.sleep(crash_at * period)
        for v in victims:
            cluster.kill9(v)
        time.sleep(max(rounds - crash_at, 0) * period)
        logs = [str(pathlib.Path(cluster.root) / f"node{i}.log")
                for i in range(n)]
    finally:
        cluster.stop()

    merged = _merge_streams(logs)
    # shift the monitor clocks to the arming-relative frame: the crash
    # landed ~crash_at rounds after the push-time round r0
    row = _monitor_row(
        merged, MonitorParams.from_dict(doc["monitor"]), n,
        crash_rounds={v: r0 + crash_at for v in victims})
    if trace is not None:
        pathlib.Path(merged).rename(trace)
        merged = trace
    row.update(engine="deploy", trace=str(merged), period=period,
               arming_round=r0)
    return row


# ---------------------------------------------------------------------------
# the one entry ``python -m gossipfs_tpu_torch.campaigns --engine`` calls
# ---------------------------------------------------------------------------


def run_case_engine(path, engine: str = "udp", *, scale_n: int | None = None,
                    period: float | None = None,
                    trace: str | None = None, device="cuda") -> dict:
    """Drive a committed case file through a socket engine and require
    its monitor verdict to agree with the tensor replay's, which runs on
    ``device`` before the socket engine starts (so the kernels' first
    build never lands inside a wall-clock run).

    Returns ``{"reproduced": ..., "agreement": {...}, "tensor": ...,
    "engine_row": ...}`` — ``reproduced`` is True iff the socket
    verdict reproduces the case's expectation AND agrees with the
    tensor run on every invariant both checked.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; pick from {ENGINES}")
    doc = load_case(path)
    if scale_n is not None:
        doc = scale_case(doc, scale_n)
    tensor = run_case_doc(doc, device=device)
    if engine == "tensor":
        return {**tensor, "engine": "tensor", "n": doc["config"]["n"]}
    if engine == "udp":
        row = run_case_udp(doc, **({"period": period} if period else {}),
                           trace=trace)
    elif engine == "native":
        row = run_case_native(doc, **({"period": period} if period else {}),
                              trace=trace)
    else:
        row = run_case_deploy(doc, **({"period": period} if period else {}),
                              trace=trace)
    agreement = verdict_agreement(tensor["row"], row)
    # the cross-engine contract is AGREEMENT with the tensor replay on
    # every invariant both checked.  The case's own expectation applies
    # on top only at the COMMITTED cohort size: a rescaled run's
    # breaking point legitimately moves (the absorption knife-edge is
    # cohort-sized — see scale_case / the n=64 twin's finding), so there
    # the tensor replay of the SAME scaled doc is the reference.
    reproduced = agreement["match"]
    expect_ok = None
    if doc.get("scaled_from") is None and (
        set(doc["expect"].get("invariants", []))
        <= set(row["monitor"]["invariants_checked"])
    ):
        expect_ok = case_verdict_ok(row, doc["expect"])
        reproduced = reproduced and expect_ok
    return {
        "engine": engine,
        "n": doc["config"]["n"],
        "scaled_from": doc.get("scaled_from"),
        "reproduced": bool(reproduced),
        "expect_reproduced": expect_ok,
        "agreement": agreement,
        "expect": doc["expect"],
        "tensor_verdict": tensor["row"]["verdict"],
        "engine_verdict": row["verdict"],
        "engine_row": row,
    }
