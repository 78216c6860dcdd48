"""Detection-timeline analyzer over flight-recorder event streams.

The port's copy of the JAX package's ``tools/timeline.py`` (which imports
``gossipfs_tpu``, so it cannot serve the port): merges one or more JSONL
event streams (``obs/schema.py`` records: the ``--trace`` artifacts of
``bench``, ``frontier`` and ``curves``, anything a ``FlightRecorder``
wrote), reconstructs per-subject crash -> SUSPECT -> confirm -> REMOVE
timelines, and re-derives the detection metrics (TTD first / converged /
suspect, FPR, suppression totals) FROM EVENTS ALONE: a second,
independent accounting of the same run that must agree with
``metrics/detection.summarize``'s array reductions.  ``selfcheck`` runs
both on one fresh run of the port and compares them.

    python -m gossipfs_tpu_torch.obs.timeline TRACE.jsonl           # timelines
    python -m gossipfs_tpu_torch.obs.timeline TRACE.jsonl --json    # + metrics
    python -m gossipfs_tpu_torch.obs.timeline TRACE.jsonl --monitor
    python -m gossipfs_tpu_torch.obs.timeline --selfcheck --monitor \
        --n 1024 [--device cpu]

Streams carrying traffic-plane rows (``replica_put`` / ``client_op``)
also get the event-replayed durability accounting (``traffic/audit.py``)
and a client-op latency rollup.  A profile artifact
(``ROUNDPROF_*.jsonl``: ``python -m gossipfs_tpu_torch.roundprof``, or the
JAX package's ``bench/roundprof``) gets its own summary
(:func:`summarize_roundprof`): its header, its row count and its fastest
row.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

from gossipfs_tpu_torch.obs import schema
from gossipfs_tpu_torch.obs.recorder import load_stream
from gossipfs_tpu_torch.obs.schema import Event


def merge(paths: list[str]) -> tuple[list[dict], list[Event]]:
    """Merge per-node streams into one round-ordered event sequence."""
    headers, events = [], []
    for p in paths:
        h, evs = load_stream(p)
        if h is not None:
            headers.append(h)
        events.extend(evs)
    events.sort(key=lambda e: (e.round, e.subject, e.observer))
    return headers, events


def kind_sequence(events: list[Event], subject: int,
                  dedupe: bool = True) -> list[str]:
    """The subject's lifecycle-kind sequence, in round order.

    ``dedupe=True`` keeps each kind's FIRST occurrence only — the form
    the three-engine parity test compares (the socket engines emit
    per-observer suspect/remove rows; the scan emits any-observer
    singletons).  Ties within one round break by canonical lifecycle
    order, so engines that emit a round's events in different internal
    order still compare equal."""
    seq = [e.kind for e in sorted(
        (e for e in events
         if e.subject == subject and e.kind in schema.LIFECYCLE_KINDS),
        key=lambda e: (e.round, schema.LIFECYCLE_KINDS.index(e.kind)))]
    if not dedupe:
        return seq
    out: list[str] = []
    for k in seq:
        if k not in out:
            out.append(k)
    return out


def analyze(headers: list[dict], events: list[Event]) -> dict:
    """Event-derived run metrics + per-subject timelines.

    Totals and the FPR come from the ``round_tick`` counter rows (the
    per-round accounting); per-crash latencies come from the lifecycle
    rows (crash/suspect/confirm/remove) — mirroring exactly what
    ``summarize`` computes from the arrays, but from the stream alone.
    """
    n = next((h.get("n") for h in headers if h.get("n")), None)
    n_eff = next((h.get("n_effective") for h in headers
                  if h.get("n_effective")), None) or n

    # header-declared fault schedule (bench traces) + ground-truth rows
    crash_rounds: dict[int, int] = {}
    for h in headers:
        for k, v in (h.get("crash_rounds") or {}).items():
            crash_rounds[int(k)] = int(v)
    for e in events:
        if e.kind == "crash" and e.subject >= 0:
            crash_rounds.setdefault(e.subject, e.round)

    firsts: dict[str, dict[int, int]] = {}
    confirm_fp: dict[int, bool] = {}
    for e in events:
        if e.subject < 0 or e.kind not in ("suspect", "confirm", "remove"):
            continue
        slot = firsts.setdefault(e.kind, {})
        if e.subject not in slot:
            slot[e.subject] = e.round
            if e.kind == "confirm" and "false_positive" in e.detail:
                confirm_fp[e.subject] = bool(e.detail["false_positive"])

    ttd_first, ttd_conv, ttd_sus, sus2conf = {}, {}, {}, {}
    for node, r0 in crash_rounds.items():
        c = firsts.get("confirm", {}).get(node)
        ttd_first[node] = (c - r0) if c is not None else -1
        rm = firsts.get("remove", {}).get(node)
        ttd_conv[node] = (rm - r0) if rm is not None else -1
        s = firsts.get("suspect", {}).get(node)
        if s is not None:
            ttd_sus[node] = s - r0
            if c is not None:
                sus2conf[node] = c - s

    ticks = sorted((e for e in events if e.kind == "round_tick"),
                   key=lambda e: e.round)
    tp = sum(e.detail.get("true_detections", 0) for e in ticks)
    fp = sum(e.detail.get("false_positives", 0) for e in ticks)
    alive_sum = sum(e.detail.get("n_alive", 0) for e in ticks)
    suspicion = any("suspects_entered" in e.detail for e in ticks)
    # the same opportunity model summarize uses: alive observers x (n-1)
    # subjects per round
    opportunities = float(alive_sum) * max((n_eff or 1) - 1, 1)
    fpr = (fp / opportunities) if opportunities else 0.0

    ttd_vals = [v for v in ttd_first.values() if v >= 0]
    doc = {
        "schema": schema.SCHEMA,
        "n": n,
        "rounds": len(ticks),
        "events": len(events),
        # invariant_violation rows a live monitor stamped into the
        # stream (obs/monitor.py) — surfaced, not re-derived; run the
        # stream through a fresh StreamMonitor (--monitor) to re-check
        "invariant_violations": sum(
            1 for e in events if e.kind == "invariant_violation"),
        "tracked_crashes": len(crash_rounds),
        "detected": len(ttd_vals),
        "ttd_first": ttd_first,
        "ttd_converged": ttd_conv,
        "ttd_first_median": statistics.median(ttd_vals) if ttd_vals else None,
        "true_detections": tp,
        "false_positives": fp,
        "false_positive_rate": fpr,
        "suspicion": suspicion,
    }
    if suspicion:
        doc.update(
            suspects_entered=sum(e.detail.get("suspects_entered", 0)
                                 for e in ticks),
            refutations=sum(e.detail.get("refutations", 0) for e in ticks),
            fp_suppressed=sum(e.detail.get("fp_suppressed", 0)
                              for e in ticks),
            ttd_suspect=ttd_sus,
            suspect_to_confirm=sus2conf,
            # the lifecycle invariant: with suspicion on, NO subject
            # confirms FAILED without a preceding SUSPECT
            suspect_before_confirm=all(
                subj in firsts.get("suspect", {})
                and firsts["suspect"][subj] <= r
                for subj, r in firsts.get("confirm", {}).items()
            ),
        )
    if confirm_fp:
        doc["confirm_false_positives"] = sum(confirm_fp.values())

    # traffic-plane streams (traffic/harness.py --trace artifacts) carry
    # replica_put/repair/delete rows: re-derive the durability facts from
    # the events alone (traffic/audit.py — the same function the harness
    # diffs itself against) plus the client_op latency rollup
    if any(e.kind in ("replica_put", "stripe_put", "client_op")
           for e in events):
        from gossipfs_tpu_torch.traffic.audit import durability_from_events
        from gossipfs_tpu_torch.traffic.workload import quantiles

        doc["durability"] = durability_from_events(events)
        ops = [e for e in events if e.kind == "client_op"]
        if ops:
            doc["client_ops"] = {
                "issued": len(ops),
                "acked": sum(bool(e.detail.get("ok")) for e in ops),
                **quantiles([e.detail.get("ms", 0.0) for e in ops]),
            }
    return doc


def render_timeline(events: list[Event], subject: int) -> list[str]:
    rows = sorted((e for e in events if e.subject == subject),
                  key=lambda e: e.round)
    out = []
    for e in rows:
        who = "*" if e.observer < 0 else str(e.observer)
        extra = f" {e.detail}" if e.detail else ""
        out.append(f"  r{e.round:>6} {e.kind:<16} obs={who}{extra}")
    return out


def summarize_roundprof(path: str) -> dict:
    """A roundprof artifact's header (its schema, shape and backend), its
    row count and its fastest row (least ``ms_per_round``)."""
    rows = []
    header = None
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if schema.is_header(rec):
                header = rec
            elif "ms_per_round" in rec:
                rows.append(rec)
    best = min(rows, key=lambda r: r["ms_per_round"]) if rows else None
    return {"schema": (header or {}).get("schema"), "rows": len(rows),
            "header": header, "fastest": best}


def selfcheck(n: int = 1024, rounds: int = 60, seed: int = 0,
              trace_path: str | None = None, monitor: bool = False,
              device="cuda") -> dict:
    """Record a churn run of the port, then prove the two accountings
    agree.

    Runs the N-node gossip-only churn scenario WITH the SWIM suspicion
    lifecycle (8 tracked crashes + 1% churn, the curves.py shape) through
    ``run_rounds`` on ``device`` (on the card: the explicit-edge merge
    K2), decodes the run into a trace via the flight recorder, re-reads it
    through this analyzer, and asserts:

      * event-derived per-crash TTD (and its median) == ``summarize``'s,
        exactly;
      * event-derived FPR == ``summarize``'s, exactly (same integers,
        same opportunity model — any drift is a real accounting bug);
      * the lifecycle invariant: no confirm without a preceding suspect.

    ``monitor=True`` additionally tails the SAME trace file through the
    streaming invariant monitor (obs/monitor.py) and requires its
    incremental estimators to equal this analyzer's post-hoc derivation
    field for field (``estimator_parity`` — the ``monitor_parity``
    claim), with zero invariant violations on the healthy run.

    Also times the decode: the recorder runs after the run returns, on
    arrays ``summarize`` reads anyway, so the overhead is host-side.
    """
    import dataclasses
    import tempfile
    import time

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.bench import tracked_crash_events
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.metrics.detection import summarize
    from gossipfs_tpu_torch.obs.recorder import write_trace
    from gossipfs_tpu_torch.suspicion import SuspicionParams

    # the FAST knob (t_fail=3 + t_suspect=2, the SUSPECT_r08 headline):
    # under 1% churn this regime actually exercises the lifecycle —
    # thousands of refutations, nonzero fp_suppressed — so the exactness
    # checks below have teeth instead of comparing zeros
    cfg = dataclasses.replace(
        SimConfig(n=n, topology="random", fanout=SimConfig.log_fanout(n),
                  remove_broadcast=False, fresh_cooldown=True, t_fail=3,
                  t_cooldown=12, merge_kernel="xla"),
        suspicion=SuspicionParams(t_suspect=2),
    )
    events, crash_rounds, churn_ok = tracked_crash_events(
        cfg, rounds, 8, 10, device=device)
    final, carry, per_round = run_rounds(
        init_state(cfg, device=device), cfg, rounds,
        trandom.PRNGKey(seed, device=device),
        events=events, crash_rate=0.01, churn_ok=churn_ok,
        crash_only_events=True,
    )
    report = summarize(carry, per_round, crash_rounds)

    own_file = trace_path is None
    if own_file:
        fd, trace_path = tempfile.mkstemp(suffix=".jsonl", prefix="obs_")
        os.close(fd)
    t0 = time.perf_counter()
    n_events = write_trace(
        trace_path, per_round, carry, n=n, source="timeline-selfcheck",
        crash_rounds=crash_rounds, alive=final.alive, suspicion=True,
    )
    decode_ms = (time.perf_counter() - t0) * 1e3
    headers, evs = merge([trace_path])
    doc = analyze(headers, evs)
    parity = None
    if monitor:
        # the streaming path end-to-end: tail the written file itself
        # through a fresh monitor, then diff against the post-hoc doc
        from gossipfs_tpu_torch.obs.monitor import (
            StreamMonitor, estimator_parity)

        t1 = time.perf_counter()
        mon = StreamMonitor()
        mon.feed_jsonl(trace_path)
        mon.finish()
        monitor_ms = (time.perf_counter() - t1) * 1e3
        parity = estimator_parity(doc, mon.summary())
    if own_file:
        os.unlink(trace_path)

    ttd_events = {k: doc["ttd_first"][k] for k in crash_rounds}
    ttd_sum = dict(report.ttd_first)
    med_sum = [v for v in ttd_sum.values() if v >= 0]
    med_sum = statistics.median(med_sum) if med_sum else None
    out = {
        "n": n,
        "rounds": rounds,
        "events": n_events,
        "decode_ms": round(decode_ms, 2),
        "ttd_match": ttd_events == ttd_sum,
        "ttd_median_events": doc["ttd_first_median"],
        "ttd_median_summarize": med_sum,
        "fpr_events": doc["false_positive_rate"],
        "fpr_summarize": report.false_positive_rate,
        "fpr_match": doc["false_positive_rate"]
        == report.false_positive_rate,
        "detections_match": doc["true_detections"]
        == report.true_detections
        and doc["false_positives"] == report.false_positives,
        "suppression_match": doc["fp_suppressed"] == report.fp_suppressed
        and doc["refutations"] == report.refutations,
        "fp_suppressed": report.fp_suppressed,
        "suspect_before_confirm": bool(doc.get("suspect_before_confirm")),
    }
    if parity is not None:
        out["monitor_parity"] = parity["ok"]
        out["monitor_mismatches"] = parity["mismatches"]
        out["monitor_ms"] = round(monitor_ms, 2)
        out["monitor_violations"] = len(mon.violations)
    out["ok"] = (out["ttd_match"]
                 and out["ttd_median_events"] == out["ttd_median_summarize"]
                 and out["fpr_match"] and out["detections_match"]
                 and out["suppression_match"]
                 # non-triviality: the fast knob must have exercised the
                 # lifecycle, or the exact-match checks compared nothing
                 and out["fp_suppressed"] > 0
                 and out["suspect_before_confirm"]
                 # monitor parity (when requested): streaming estimators
                 # exactly equal this post-hoc derivation, zero
                 # violations on the healthy run
                 and (parity is None or (parity["ok"]
                                         and not mon.violations)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("paths", nargs="*", help="event-stream JSONL files "
                   "(bench --trace artifacts, deploy node logs)")
    p.add_argument("--subject", type=int, default=None,
                   help="render one subject's full timeline")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output only")
    p.add_argument("--selfcheck", action="store_true",
                   help="record a fresh churn run of the port and diff "
                        "the event-derived metrics against summarize's")
    p.add_argument("--monitor", action="store_true",
                   help="additionally run the stream(s) through the "
                        "streaming invariant monitor (obs/monitor.py) "
                        "and report its verdict + the monitor_parity "
                        "diff against this analyzer's post-hoc doc")
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--rounds", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="where --selfcheck runs (cpu: the plain versions)")
    args = p.parse_args(argv)

    if args.selfcheck:
        out = selfcheck(n=args.n, rounds=args.rounds, seed=args.seed,
                        monitor=args.monitor, device=args.device)
        print(json.dumps(out))
        return 0 if out["ok"] else 1

    if not args.paths:
        p.error("give at least one stream path (or --selfcheck)")

    # roundprof artifacts get their own summary
    first_head, _ = load_stream(args.paths[0])
    if first_head and first_head.get("schema") == schema.ROUNDPROF_SCHEMA:
        for path in args.paths:
            print(json.dumps({"path": path, **summarize_roundprof(path)}))
        return 0

    headers, events = merge(args.paths)
    doc = analyze(headers, events)
    if args.monitor:
        from gossipfs_tpu_torch.obs.monitor import (
            StreamMonitor, estimator_parity)

        mon = StreamMonitor()
        for h in headers:
            mon.observe_header(h)
        mon.feed(events)
        mon.finish()
        doc["monitor"] = mon.verdict()
        doc["monitor_parity"] = estimator_parity(doc, mon.summary())
    if args.json:
        print(json.dumps(doc))
        return 0
    print(f"{len(events)} events from {len(args.paths)} stream(s); "
          f"n={doc['n']} rounds={doc['rounds']}")
    subjects = ([args.subject] if args.subject is not None
                else sorted(doc["ttd_first"]))
    for s in subjects:
        seq = " -> ".join(kind_sequence(events, s)) or "(no events)"
        print(f"node {s}: {seq}")
        for line in render_timeline(events, s):
            print(line)
    drop = ("ttd_first", "ttd_converged", "ttd_suspect",
            "suspect_to_confirm")
    print(json.dumps({k: v for k, v in doc.items() if k not in drop}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
