"""Campaign driver: scenario families x the streaming monitor oracle.

The port's copy of the JAX package's ``gossipfs_tpu/campaigns/driver.py``:
the tensor replay, on the port's round loops (on the card: the
explicit-edge merge K2 with the scenario's edge rewrite, whatever the
configuration's ``merge_kernel`` names), and the traffic-plane replay
(:func:`run_traffic_case_doc`: the durability harness's rack-kill storm
over the port's co-sim, its detector rounds on K2).

One campaign RUN (:func:`run_scenario`) is: build the north-star
gossip-only config at the requested (t_fail, t_suspect) knob, schedule
``track`` deterministic crashes (the TTD/reconvergence probes), run the
bulk tensor engine with the family's compiled fault scenario armed,
decode the run into ``gossipfs-obs/v1`` events (the flight recorder —
zero extra device work), and stream them through a
:class:`~gossipfs_tpu_torch.obs.monitor.StreamMonitor`.  The monitor's
verdict IS the run's verdict: estimators + the invariant table, no
hand-read artifacts.

Determinism: runs take no random churn (``crash_rate=0``) — the only
randomness is the per-round topology sampling and any Bernoulli loss
rules, both keyed from the run seed — so a committed regression case
replays bit-identically (the tier-1 smoke's contract).

Severity axes are searched two ways: :func:`sweep_axis` (grid) and
:func:`bisect_axis` (smallest violating value of a monotone axis — the
breaking point).  Confirmed breaking points are committed as CASE files
(:func:`write_case` / :func:`run_case`): scenario + config knobs +
monitor params + the expected verdict, self-contained.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib

from gossipfs_tpu_torch.bench import tracked_victims
from gossipfs_tpu_torch.obs import schema
from gossipfs_tpu_torch.obs.monitor import MonitorParams, StreamMonitor
from gossipfs_tpu_torch.scenarios.schedule import (
    CorrelatedOutage,
    FaultScenario,
    Flapping,
    LinkFault,
    Partition,
)

CASE_SCHEMA = "gossipfs-campaign-case/v1"

# severity axis per family (the knob sweep/bisect walks), with the
# family's fixed knob defaults.  ``frac`` knobs count as "1/frac of the
# cohort"; node sets are drawn deterministically, skipping the tracked
# crash victims and the introducer so the fault rules never overlap the
# TTD probes.
FAMILIES: dict[str, dict] = {
    "flap": {
        "axis": "down",
        "knobs": {"down": 4, "up": 2, "frac": 16, "start": 2},
        "doc": "flapping senders: `down` dark rounds per `up`+`down` "
               "cycle on 1/frac of the cohort — the Lifeguard gray "
               "failure; the breaking point is the dark span that "
               "outlives the (t_fail [+ t_suspect]) window",
    },
    "loss": {
        "axis": "rate_pct",
        "knobs": {"rate_pct": 50, "frac": 16, "start": 2},
        "doc": "Bernoulli loss on 1/frac of senders' outgoing links at "
               "rate_pct/100 — asymmetric lossy NICs",
    },
    "partition": {
        "axis": "split_len",
        "knobs": {"split_len": 12, "start": 5},
        "doc": "half/half netsplit held for split_len rounds, then "
               "healed — the split-brain / reconvergence probe",
    },
    "outage": {
        "axis": "size",
        "knobs": {"size": 8, "length": 10, "start": 5},
        "doc": "correlated rack blackout: `size` nodes lose ALL "
               "transport for `length` rounds, then resurface with "
               "frozen views",
    },
}


def campaign_config(n: int, t_fail: int = 5, t_suspect: int = 0,
                    lh_multiplier: int = 0, lh_frac: float = 0.25):
    """The campaign protocol profile: gossip-only random log-fanout on
    the XLA merge (the JAX package's oracle form; the port's rounds run
    it on the explicit-edge merge K2 — other kernel knobs reach the card
    through ``run_scenario(config=...)``).

    ``lh_multiplier``/``lh_frac`` (round 14): the Lifeguard local-health
    knobs, now first-class campaign axes — an observer whose own view
    holds more than ``lh_frac`` of its peers simultaneously SUSPECT
    stretches its confirmation window by ``1 + lh_multiplier``.  Use
    exact binary fractions (1/32, 1/64...) per suspicion/params.py.
    """
    from gossipfs_tpu_torch.config import SimConfig

    cfg = SimConfig(
        n=n, topology="random", fanout=SimConfig.log_fanout(n),
        remove_broadcast=False, fresh_cooldown=True, t_fail=t_fail,
        t_cooldown=max(12, t_fail + 4), merge_kernel="xla",
    )
    if t_suspect > 0:
        from gossipfs_tpu_torch.suspicion import SuspicionParams

        cfg = dataclasses.replace(
            cfg, suspicion=SuspicionParams(
                t_suspect=t_suspect, lh_multiplier=lh_multiplier,
                lh_frac=lh_frac))
    elif lh_multiplier > 0:
        raise ValueError(
            "lh_multiplier > 0 (Lifeguard local health) requires the "
            "SWIM lifecycle: pass t_suspect >= 1")
    return cfg


def _pick_nodes(n: int, count: int, avoid: set[int]) -> tuple[int, ...]:
    """First ``count`` ids outside ``avoid`` — deterministic, disjoint
    from the tracked crash victims."""
    out = []
    for x in range(n):
        if x not in avoid:
            out.append(x)
            if len(out) == count:
                break
    return tuple(out)


def make_scenario(family: str, n: int, fault_rounds: int,
                  avoid: set[int] | None = None, **knobs) -> FaultScenario:
    """Build one family scenario at a severity point (see FAMILIES)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; pick from "
                         f"{sorted(FAMILIES)}")
    kn = dict(FAMILIES[family]["knobs"])
    unknown = set(knobs) - set(kn)
    if unknown:
        raise ValueError(f"unknown {family} knobs {sorted(unknown)}; "
                         f"family takes {sorted(kn)}")
    kn.update(knobs)
    avoid = set(avoid or ())
    start = int(kn["start"])
    name = f"{family}-" + ",".join(
        f"{k}={kn[k]}" for k in sorted(kn) if k != "start")
    if family == "flap":
        nodes = _pick_nodes(n, max(n // int(kn["frac"]), 1), avoid)
        return FaultScenario(
            name=name, n=n,
            flapping=(Flapping(start=start, end=start + fault_rounds,
                               up=int(kn["up"]), down=int(kn["down"]),
                               nodes=nodes),))
    if family == "loss":
        nodes = _pick_nodes(n, max(n // int(kn["frac"]), 1), avoid)
        return FaultScenario(
            name=name, n=n,
            link_faults=(LinkFault(start=start, end=start + fault_rounds,
                                   rate=int(kn["rate_pct"]) / 100.0,
                                   src=nodes, dst=tuple(range(n))),))
    if family == "partition":
        return FaultScenario(
            name=name, n=n,
            partitions=(Partition(start=start,
                                  end=start + int(kn["split_len"]),
                                  groups=(tuple(range(n // 2)),)),))
    # outage
    nodes = _pick_nodes(n, int(kn["size"]), avoid)
    return FaultScenario(
        name=name, n=n,
        outages=(CorrelatedOutage(start=start,
                                  end=start + int(kn["length"]),
                                  nodes=nodes),))


def default_monitor_params(cfg, horizon: int) -> MonitorParams:
    """The campaign invariant knobs: FPR-storm threshold 1e-4 (healthy
    regimes measure ~4e-7, raw-t3 storms ~4e-3 — SUSPECT_r08), and the
    reconvergence bound: the armed detector's WORST-CASE confirmation
    window + gossip diameter + slack, clocked from the scenario horizon
    (faults legitimately delay convergence while armed).  The worst-case
    window is ``t_fail + t_suspect * (1 + lh_multiplier)`` under the
    SWIM lifecycle (``SuspicionParams.max_confirm_after`` — a
    local-health-stretched observer legitimately confirms, and
    stops gossiping, that much later) and plain ``t_fail`` without it;
    round 13's ``t_fail``-only bound under-counted armed suspicion by
    ``t_suspect`` and flagged correctly-converging lh runs."""
    diameter = math.ceil(math.log(max(cfg.n, 2))
                         / math.log(cfg.fanout + 1))
    worst = (cfg.suspicion.max_confirm_after(cfg.t_fail)
             if cfg.suspicion is not None else cfg.t_fail)
    return MonitorParams(
        fpr_threshold=1e-4,
        fpr_window=10,
        reconverge_bound=worst + diameter + 4,
        clock_floor=horizon,
        expect_suspicion=cfg.suspicion is not None,
    )


def campaign_rounds(horizon: int, crash_at: int, bound: int) -> int:
    """THE run-length derivation every engine shares: past the last
    fault window AND the tracked crashes' own detection horizon, plus
    the reconvergence deadline and slack.  One owner — the socket
    runners (campaigns/engines.py) are verdict-compared against the
    tensor replay round for round, so a drifted copy would silently
    compare different experiments."""
    return max(horizon, crash_at) + bound + 8


def run_scenario(n: int, scenario: FaultScenario | None, *,
                 t_fail: int = 5,
                 t_suspect: int = 0, lh_multiplier: int = 0,
                 lh_frac: float = 0.25, rounds: int | None = None,
                 seed: int = 0, track: int = 4, crash_at: int = 10,
                 params: MonitorParams | None = None,
                 config=None, device="cuda", plain: bool = False) -> dict:
    """One campaign run: bulk engine + decode + streaming monitor.

    ``config`` replaces the campaign profile as given (its kernel knobs
    included); ``device`` is where the rounds run; ``plain=True`` runs
    every kernel through its plain PyTorch version (the reference the
    kernels are held against on the card).

    ``scenario=None`` runs the QUIET baseline — no fault rules, same
    tracked crashes — which is what the local-health knob surface
    compares outage rows against (the deterministic t_fail=5 quiet run
    has ZERO false positives, so "FPR at the t_fail=5 baseline" is an
    exact-count comparison, not a tolerance).

    Returns the ledger row: verdict, monitor estimators, the violation
    list, and the violating event window (all decoded events within 2
    rounds of the first violation — the evidence a human reads)."""
    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.bench import tracked_crash_events
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.obs.recorder import decode_scan
    from gossipfs_tpu_torch.scenarios.tensor import compile_tensor

    if scenario is None:
        scenario = FaultScenario(name="quiet", n=n)
    cfg = config if config is not None else campaign_config(
        n, t_fail=t_fail, t_suspect=t_suspect,
        lh_multiplier=lh_multiplier, lh_frac=lh_frac)
    if params is None:
        params = default_monitor_params(cfg, scenario.horizon)
    if rounds is None:
        bound = params.reconverge_bound or (cfg.t_fail + 6)
        rounds = campaign_rounds(scenario.horizon, crash_at, bound)
    events, crash_rounds, churn_ok = tracked_crash_events(
        cfg, rounds, track, crash_at, device=device)
    final, carry, per_round = run_rounds(
        init_state(cfg, device=device), cfg, rounds,
        trandom.PRNGKey(seed, device=device),
        events=events, crash_only_events=True,
        scenario=compile_tensor(scenario, device=device), plain=plain,
    )
    evs = decode_scan(
        per_round, carry, n=cfg.n, crash_rounds=crash_rounds,
        alive=final.alive, suspicion=cfg.suspicion is not None,
    )
    mon = StreamMonitor(params=params, n=cfg.n)
    mon.observe_header(schema.header(
        "campaign", n=cfg.n,
        crash_rounds={str(k): v for k, v in crash_rounds.items()}))
    mon.feed(evs)
    mon.finish()
    s = mon.summary()
    window: list[dict] = []
    if mon.violations:
        w = mon.violations[0].round
        window = [e.to_record() for e in evs
                  if abs(e.round - w) <= 2][:48]
    return {
        "n": cfg.n,
        "t_fail": cfg.t_fail,
        "t_suspect": (cfg.suspicion.t_suspect if cfg.suspicion else 0),
        "lh_multiplier": (cfg.suspicion.lh_multiplier
                          if cfg.suspicion else 0),
        "lh_frac": (cfg.suspicion.lh_frac if cfg.suspicion else 0.0),
        "rounds": rounds,
        "seed": seed,
        "scenario": scenario.name,
        "horizon": scenario.horizon,
        "monitor_params": dataclasses.asdict(params),
        "verdict": "violated" if mon.violations else "pass",
        "monitor": mon.verdict(),
        "estimators": {
            "false_positives": s["false_positives"],
            "false_positive_rate": s["false_positive_rate"],
            "worst_window_fpr": s["worst_window_fpr"],
            "ttd_first_median": s["ttd_first_median"],
            "detected": s["detected"],
            "tracked_crashes": s["tracked_crashes"],
            "storm_rounds": s["storm_rounds"],
            "split_brain_rounds": s["split_brain_rounds"],
            **({"fp_suppressed": s["fp_suppressed"],
                "refutations": s["refutations"]} if s["suspicion"] else {}),
        },
        "violations": s["violations"],
        "violation_window": window,
    }


# ---------------------------------------------------------------------------
# the campaign ledger — a gossipfs-obs/v1 stream timeline.py ingests
# ---------------------------------------------------------------------------


class CampaignLedger:
    """JSONL ledger: the obs header row, then one ``campaign_verdict``
    event per run (detail = the ledger row).  ``obs/timeline.py``
    loads it like any other stream; the verdict rows ride ``detail``."""

    def __init__(self, path, family: str, n: int, axis: str, **meta):
        self.path = pathlib.Path(path)
        self.rows: list[dict] = []
        self._fh = open(self.path, "w", encoding="utf-8")
        self._fh.write(schema.dumps(schema.header(
            "campaign", n=n, family=family, axis=axis, **meta)) + "\n")

    def add(self, axis_value, row: dict) -> None:
        self.rows.append(row)
        ev = schema.Event(
            round=len(self.rows) - 1, observer=-1, subject=-1,
            kind="campaign_verdict",
            detail={"axis_value": axis_value, **row})
        self._fh.write(schema.dumps(ev.to_record()) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def sweep_axis(family: str, n: int, values, *, fault_rounds: int = 24,
               t_fail: int = 5, t_suspect: int = 0,
               lh_multiplier: int = 0, lh_frac: float = 0.25,
               seed: int = 0,
               track: int = 4, ledger: CampaignLedger | None = None,
               device="cuda", **fixed_knobs) -> dict:
    """Grid-sweep the family's severity axis; returns rows + the
    breaking points (axis values whose run violated an invariant)."""
    axis = _axis_checked(family, fixed_knobs)
    rows = []
    for v in values:
        sc, row = _run_point(family, n, axis, v, fault_rounds, t_fail,
                             t_suspect, lh_multiplier, lh_frac, seed,
                             track, fixed_knobs, device)
        rows.append(row)
        if ledger is not None:
            ledger.add(v, row)
    return {
        "family": family, "axis": axis, "n": n,
        "t_fail": t_fail, "t_suspect": t_suspect,
        "lh_multiplier": lh_multiplier, "lh_frac": lh_frac,
        "rows": rows,
        "breaking": [r["axis_value"] for r in rows
                     if r["verdict"] == "violated"],
    }


def bisect_axis(family: str, n: int, lo: int, hi: int, *,
                fault_rounds: int = 24, t_fail: int = 5,
                t_suspect: int = 0, lh_multiplier: int = 0,
                lh_frac: float = 0.25, seed: int = 0, track: int = 4,
                ledger: CampaignLedger | None = None,
                device="cuda", **fixed_knobs) -> dict:
    """Smallest axis value in [lo, hi] whose run violates an invariant
    (the axis must be severity-monotone — every family's is).  Probes
    the endpoints first: if ``lo`` already violates the breaking point
    is <= lo; if ``hi`` passes there is none in range."""
    axis = _axis_checked(family, fixed_knobs)
    evals: dict[int, dict] = {}

    def probe(v: int) -> dict:
        if v not in evals:
            _, row = _run_point(family, n, axis, v, fault_rounds, t_fail,
                                t_suspect, lh_multiplier, lh_frac, seed,
                                track, fixed_knobs, device)
            evals[v] = row
            if ledger is not None:
                ledger.add(v, row)
        return evals[v]

    out = {"family": family, "axis": axis, "n": n, "lo": lo, "hi": hi,
           "t_fail": t_fail, "t_suspect": t_suspect,
           "lh_multiplier": lh_multiplier, "lh_frac": lh_frac}
    if probe(hi)["verdict"] != "violated":
        return {**out, "breaking_point": None, "evals": len(evals),
                "rows": [evals[v] for v in sorted(evals)]}
    if probe(lo)["verdict"] == "violated":
        return {**out, "breaking_point": lo, "evals": len(evals),
                "rows": [evals[v] for v in sorted(evals)]}
    # invariant: lo passes, hi violates
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if probe(mid)["verdict"] == "violated":
            hi = mid
        else:
            lo = mid
    return {**out, "breaking_point": hi, "evals": len(evals),
            "rows": [evals[v] for v in sorted(evals)]}


def _axis_checked(family: str, fixed_knobs: dict) -> str:
    """The family's severity axis, rejecting a fixed-knob collision
    up front (before any run or ledger row) instead of letting the
    duplicate-kwarg TypeError surface mid-campaign."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; pick from "
                         f"{sorted(FAMILIES)}")
    axis = FAMILIES[family]["axis"]
    if axis in fixed_knobs:
        raise ValueError(
            f"{axis!r} is the {family} family's swept severity axis — "
            "give it via the sweep values / bisect range, not as a "
            "fixed knob")
    return axis


def _run_point(family, n, axis, value, fault_rounds, t_fail, t_suspect,
               lh_multiplier, lh_frac, seed, track, fixed_knobs, device):
    cfg = campaign_config(n, t_fail=t_fail, t_suspect=t_suspect,
                          lh_multiplier=lh_multiplier, lh_frac=lh_frac)
    # victims are a pure function of (cfg, track) — compute them first so
    # the family's fault nodes can avoid the TTD probes
    victims = tracked_victims(n, track, cfg.introducer)
    sc = make_scenario(family, n, fault_rounds,
                       avoid=set(victims) | {cfg.introducer},
                       **{axis: value}, **fixed_knobs)
    row = run_scenario(n, sc, t_fail=t_fail, t_suspect=t_suspect,
                       lh_multiplier=lh_multiplier, lh_frac=lh_frac,
                       seed=seed, track=track, device=device)
    return sc, {"axis_value": value, **row}


# ---------------------------------------------------------------------------
# regression case files — committed breaking points, replayed by tier-1
# ---------------------------------------------------------------------------


def write_case(path, scenario: FaultScenario, *, t_fail: int,
               t_suspect: int, seed: int, track: int,
               params: MonitorParams, expect: dict,
               lh_multiplier: int = 0, lh_frac: float = 0.25,
               crash_at: int = 10, **meta) -> None:
    """Commit one confirmed breaking point as a self-contained case:
    the scenario, the exact run knobs (local health included), the
    monitor params, and the verdict a replay must reproduce."""
    doc = {
        "schema": CASE_SCHEMA,
        "scenario": json.loads(scenario.to_json()),
        "config": {"n": scenario.n, "t_fail": t_fail,
                   "t_suspect": t_suspect,
                   "lh_multiplier": lh_multiplier, "lh_frac": lh_frac,
                   "crash_at": crash_at,
                   "seed": seed, "track": track},
        "monitor": dataclasses.asdict(params),
        "expect": expect,
        **meta,
    }
    pathlib.Path(path).write_text(json.dumps(doc, indent=2) + "\n")


def load_case(path) -> dict:
    """Parse + schema-check one committed case file (shared by the
    tensor replay below and the socket-engine runners in engines.py)."""
    doc = json.loads(pathlib.Path(path).read_text())
    if doc.get("schema") != CASE_SCHEMA:
        raise ValueError(f"{path}: not a {CASE_SCHEMA} case file")
    return doc


def case_verdict_ok(row: dict, expect: dict) -> bool:
    """Whether a replay row reproduces the case's expectation — the one
    predicate every engine's replay shares."""
    ok = row["verdict"] == expect["verdict"]
    for inv in expect.get("invariants", []):
        ok = ok and inv in row["monitor"]["by_invariant"]
    return bool(ok)


def run_traffic_case_doc(doc: dict, device="cuda") -> dict:
    """Replay a TRAFFIC-plane case: the durability harness's rack-kill
    storm (``traffic/harness.repair_storm``) in the case's redundancy
    mode — the campaign matrix's byte-plane leg, same self-contained
    knob contract as the gossip cases.  The verdict is the storm's
    durability triple: ``pass`` iff zero acked writes are lost under
    the cluster-state ledger AND the event replay AND the streaming
    monitor, with all three accountings in exact agreement (the
    ``no_acked_write_lost`` invariant holding verbatim in stripe mode).
    The co-sim's detector rounds run on ``device``."""
    from gossipfs_tpu_torch.traffic.harness import repair_storm
    from gossipfs_tpu_torch.traffic.workload import WorkloadSpec

    t = doc["traffic"]
    spec = WorkloadSpec(
        rate=float(t.get("rate", 4.0)),
        n_keys=int(t.get("n_keys", 32)),
        payload_cap=int(t.get("payload_cap", 4096)),
        seed=int(t.get("seed", 0)),
        redundancy=t.get("redundancy", "replica"),
        **({"stripe_k": int(t["stripe_k"])} if "stripe_k" in t else {}),
        **({"stripe_m": int(t["stripe_m"])} if "stripe_m" in t else {}),
    )
    out = repair_storm(
        int(t["n"]), spec, files=int(t.get("files", 32)),
        rack=tuple(t.get("rack", (8, 8))),
        repair_budget=int(t.get("repair_budget", 8)),
        seed=int(t.get("seed", 0)), device=device,
    )
    d = out["durability"]
    ok = (d["harness"]["lost"] == 0 and d["events"]["lost"] == 0
          and d["match"] and d["monitor"]["ok"]
          and d["monitor"]["match_events"])
    row = {
        "verdict": "pass" if ok else "violated",
        "lost": d["harness"]["lost"],
        "files_acked": d["harness"]["files_acked"],
        "rack_killed": out["rack_killed"],
        "repairs_total": out["repairs_total"],
        "repair_bytes_written": out["repair_bytes_written"],
        "repair_copies": out["repair_copies"],
        "durability": d,
        "traffic_vitals": out["traffic_vitals"],
    }
    expect = doc["expect"]
    reproduced = (row["verdict"] == expect["verdict"]
                  and row["lost"] == int(expect.get("lost", row["lost"])))
    return {"reproduced": bool(reproduced), "expect": expect, "row": row}


def run_case_doc(doc: dict, device="cuda") -> dict:
    """Replay one parsed case document — gossip cases on the tensor
    engine (on ``device``), ``"traffic"`` cases on the durability
    harness."""
    if "traffic" in doc:
        return run_traffic_case_doc(doc, device=device)
    sc = FaultScenario.from_json(json.dumps(doc["scenario"]))
    c = doc["config"]
    row = run_scenario(
        c["n"], sc, t_fail=c["t_fail"], t_suspect=c["t_suspect"],
        lh_multiplier=int(c.get("lh_multiplier", 0)),
        lh_frac=float(c.get("lh_frac", 0.25)),
        seed=c["seed"], track=c["track"],
        crash_at=int(c.get("crash_at", 10)),
        params=MonitorParams.from_dict(doc["monitor"]), device=device,
    )
    expect = doc["expect"]
    return {"reproduced": case_verdict_ok(row, expect), "expect": expect,
            "row": row}


def run_case(path, device="cuda") -> dict:
    """Replay a committed regression case; ``reproduced`` is the tier-1
    assertion: the verdict matches and (for violations) every expected
    invariant fired."""
    return run_case_doc(load_case(path), device=device)


# ---------------------------------------------------------------------------
# the local-health knob surface — (outage size x lh knobs) absorption map
# ---------------------------------------------------------------------------


def _slim(row: dict) -> dict:
    """One surface row, estimators only (the full violation windows make
    a sizes x knobs artifact unreadable)."""
    return {
        "verdict": row["verdict"],
        "by_invariant": row["monitor"]["by_invariant"],
        "false_positives": row["estimators"].get("false_positives"),
        "false_positive_rate": row["estimators"]["false_positive_rate"],
        "worst_window_fpr": row["estimators"]["worst_window_fpr"],
        "ttd_first_median": row["estimators"]["ttd_first_median"],
        "detected": row["estimators"]["detected"],
        "tracked_crashes": row["estimators"]["tracked_crashes"],
    }


def knob_surface(n: int, sizes, lh_points, *, t_fail: int = 3,
                 t_suspect: int = 2, baseline_t_fail: int = 5,
                 length: int = 10, start: int = 5, rounds: int = 35,
                 seed: int = 0, track: int = 4, crash_at: int = 10,
                 ledger: CampaignLedger | None = None,
                 device="cuda") -> dict:
    """Map the Lifeguard knob surface against correlated outages.

    For every outage ``size`` x ``(lh_multiplier, lh_frac)`` point, runs
    the outage scenario AND the quiet baseline at the SWIM knob
    (t_fail=3 + t_suspect=2 — the SUSPECT_r08 production profile, total
    window == the t_fail=5 reference), next to three reference rows: the
    raw t_fail=5 detector on the same outage (the designed-in storm),
    the lh-off SWIM knob on the same outage, and the lh-off quiet run.

    A point ABSORBS a size when (a) its outage run's FPR sits in the
    t_fail=5-class band — ``max(10x the t5 quiet baseline, 1e-6)``, the
    exact floor ``verify_claims.suspicion_fpr`` already uses (the quiet
    baseline is deterministic and measures 0.0; the floor admits the
    1-2 FP events from entries already past the detection window when
    the outage lands, ~7e-7, while rejecting the heal-race leak at
    ~7e-5 and the full storm at ~4e-4 by two orders each), (b) its
    outage run passes every monitor invariant, and (c) the
    tracked-crash median TTD grew at most one round over the lh-off
    QUIET baseline — on the outage run AND on the point's own quiet run
    (the stretch must not tax detection; the lh-off OUTAGE row is not a
    usable TTD reference, its storm confirms the probes before they
    crash).

    ``crash_at`` is a load-bearing axis, not a nuisance parameter: the
    probes' suspect windows overlap the outage's heal, and the surface
    at several crash_at values is what exposed the HEAL RACE — an
    observer whose rack refutations arrive staggered un-degrades while
    its remaining rack entries are still stale and confirms them (fp
    ~200 at crash_at >= 14, where the probe suspicions no longer cover
    the gap).  See BASELINE.md's knob-surface summary.

    Returns the surface document (LOCALHEALTH_r14.json's per-probe
    shape): baselines, one row per (size, point), and the absorption
    frontier.
    """
    cfg0 = campaign_config(n, t_fail=t_fail, t_suspect=t_suspect)
    avoid = set(tracked_victims(n, track, cfg0.introducer)) | {
        cfg0.introducer}

    def outage(size):
        return make_scenario("outage", n, length, avoid=avoid,
                             size=size, length=length, start=start)

    def point_row(sc, tf, ts, m, f):
        row = run_scenario(n, sc, t_fail=tf, t_suspect=ts,
                           lh_multiplier=m, lh_frac=f, rounds=rounds,
                           seed=seed, track=track, crash_at=crash_at,
                           device=device)
        if ledger is not None:
            ledger.add(sc.name if sc is not None else "quiet", row)
        return row

    base = {
        "t5_quiet": _slim(point_row(None, baseline_t_fail, 0, 0, 0.25)),
        "lh_off_quiet": _slim(point_row(None, t_fail, t_suspect, 0, 0.25)),
    }
    base["t5_outage"] = {
        str(s): _slim(point_row(outage(s), baseline_t_fail, 0, 0, 0.25))
        for s in sizes
    }
    base["lh_off_outage"] = {
        str(s): _slim(point_row(outage(s), t_fail, t_suspect, 0, 0.25))
        for s in sizes
    }

    def growth(a, b):
        if a is None or b is None:
            return None
        return a - b

    fpr_floor = max(10 * base["t5_quiet"]["false_positive_rate"], 1e-6)
    rows = []
    for (m, f) in lh_points:
        quiet = _slim(point_row(None, t_fail, t_suspect, m, f))
        qg = growth(quiet["ttd_first_median"],
                    base["lh_off_quiet"]["ttd_first_median"])
        for s in sizes:
            r = _slim(point_row(outage(s), t_fail, t_suspect, m, f))
            og = growth(r["ttd_first_median"],
                        base["lh_off_quiet"]["ttd_first_median"])
            absorbed = (
                r["false_positive_rate"] <= fpr_floor
                and r["verdict"] == "pass"
                and og is not None and og <= 1
                and qg is not None and qg <= 1
            )
            rows.append({
                "size": s, "lh_multiplier": m, "lh_frac": f,
                "outage": r, "quiet": quiet,
                "ttd_growth_outage": og, "ttd_growth_quiet": qg,
                "absorbed": absorbed,
            })
    return {
        "metric": "Lifeguard local-health knob surface vs correlated "
                  "outages (tensor engine, deterministic campaign runs)",
        "n": n, "t_fail": t_fail, "t_suspect": t_suspect,
        "baseline_t_fail": baseline_t_fail,
        "outage": {"length": length, "start": start},
        "rounds": rounds, "seed": seed, "track": track,
        "crash_at": crash_at,
        "fpr_floor": fpr_floor,
        "baselines": base,
        "rows": rows,
        "frontier": {
            str(s): [
                {"lh_multiplier": r["lh_multiplier"],
                 "lh_frac": r["lh_frac"]}
                for r in rows if r["size"] == s and r["absorbed"]
            ]
            for s in sizes
        },
    }
