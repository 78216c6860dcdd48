"""Time-to-detect and false-positive-rate curves, and netsplit rows, vs N.

The port of the JAX package's ``bench/curves.py``: its default sweep
(``sweep``: TTD and FPR vs N, the north star's curves) and its
``--partition`` rows (``partition_sweep``).  The t_fail surface
(``--t-fail-sweep``) and the suspicion A/B (``--suspicion``) are not
ported yet (ROADMAP Queue 1, item 4).

    python -m gossipfs_tpu_torch.curves [--ns 1024 4096 16384] [--rounds R]
        [--topology random|random_arc] [--trace PATH] [--monitor] [--out F]
    python -m gossipfs_tpu_torch.curves --partition [--ns N ...] [--out F]

``sweep``, per N: the north-star protocol (random fanout log2 N,
gossip-only dissemination, fresh cooldown, int8 view, int16 heartbeats)
for ``rounds`` rounds under 1 % random crash churn with 8 tracked crashes
at round 10, through ``run_rounds`` (on the card: the explicit-edge merge
K2, or K4 for ``random_arc``); the row holds the median and max
time-to-first-detection and to cluster-wide convergence over the tracked
crashes, the background FPR, and the row's kernel launches.  ``--trace``
writes each row's flight-recorder stream (``obs/``; ``python -m
gossipfs_tpu_torch.obs.timeline`` re-derives the row's TTD/FPR from it
alone) and ``--monitor`` stamps the invariant monitor's verdict into the
row; both decode after the run.

``partition_sweep``, per N: a random-fanout gossip-only cluster is split
into halves through ``SimDetector.load_scenario``, one tracked node
crashes inside each side mid-split, the split heals, and the per-round
device stats (``metrics.detection.partition_round_stats``) plus the
detection events reduce to a ``PartitionReport`` row.

Prints one JSON document.  Runs on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

import torch

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.bench import tracked_crash_events
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core.rounds import run_rounds
from gossipfs_tpu_torch.core.state import init_state
from gossipfs_tpu_torch.detector.sim import SimDetector
from gossipfs_tpu_torch.metrics.detection import (
    partition_round_stats, summarize, summarize_partition)
from gossipfs_tpu_torch.obs.monitor import monitor_verdict
from gossipfs_tpu_torch.obs.recorder import decode_scan, write_trace
from gossipfs_tpu_torch.ops import merge
from gossipfs_tpu_torch.scenarios import split_halves

DEFAULT_NS = (1024, 4096, 16384)
ROUNDS = 60
CRASH_AT = 10
TRACK = 8


def sweep_config(n: int, topology: str = "random", hb_dtype: str = "int16",
                 arc_align: int = 1, fanout: int | None = None) -> SimConfig:
    """One row's configuration: the JAX sweep's (its ``merge_kernel=
    "pallas"`` is the explicit-edge merge K2 here)."""
    return SimConfig(
        n=n,
        topology=topology,
        # aligned arcs need fanout % align == 0: round log2(N) up so
        # arc_align works without an explicit fanout
        fanout=fanout or (
            -(-SimConfig.log_fanout(n) // arc_align) * arc_align),
        arc_align=arc_align,
        remove_broadcast=False,
        fresh_cooldown=True,
        t_cooldown=12,
        merge_kernel="pallas",
        view_dtype="int8",
        hb_dtype=hb_dtype,
        merge_block_c=16_384,
    )


def sweep(ns=DEFAULT_NS, rounds=ROUNDS, crash_rate=0.01, seed=0,
          topology="random", hb_dtype="int16", time_rounds=False,
          arc_align=1, fanout=None, trace=None, monitor=False,
          device="cuda") -> dict:
    """TTD and FPR vs N (the JAX package's ``sweep``).

    ``topology`` sweeps "random" (iid fanout) or "random_arc" (windowed
    arc senders); ``hb_dtype="int8"`` is the all-int8 state.
    ``time_rounds=True`` adds a measured rounds/s per row (a second run on
    a fresh state, host clock ending in a device synchronize).
    ``trace`` writes each row's flight-recorder event stream, to
    ``trace`` itself for a single N and to ``{trace}.n{N}`` per row
    otherwise; the row then also names its event count and the host ms
    of the decode.  ``monitor=True`` streams each row's decoded events
    through the invariant monitor (obs/monitor.py) and stamps its verdict
    into the row.  The JAX sweep's ``donate`` has no twin: the port
    updates its lanes in place.  Each row also carries the launches of
    its run by kernel (none on the CPU, where the plain versions run)."""
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows = []
    for n in ns:
        cfg = sweep_config(n, topology, hb_dtype, arc_align, fanout)
        events, crash_rounds, churn_ok = tracked_crash_events(
            cfg, rounds, TRACK, CRASH_AT, device=dev)
        run = dict(events=events, crash_rate=crash_rate, churn_ok=churn_ok,
                   crash_only_events=True)
        # tracked_crash_events schedules crashes only: the promise keeps
        # the crash-only event path
        before = dict(merge.LAUNCH_COUNTS)
        final, carry, per_round = run_rounds(
            init_state(cfg, device=dev), cfg, rounds,
            trandom.PRNGKey(seed, device=dev), **run)
        sync()
        launches = {k: v - before.get(k, 0)
                    for k, v in merge.LAUNCH_COUNTS.items()
                    if v != before.get(k, 0)}
        report = summarize(carry, per_round, crash_rounds)
        sus = cfg.suspicion is not None
        traced = {}
        if trace:
            trace_path = trace if len(ns) == 1 else f"{trace}.n{n}"
            t0 = time.perf_counter()
            n_events = write_trace(
                trace_path, per_round, carry, n=n, source="curves",
                crash_rounds=crash_rounds, alive=final.alive,
                suspicion=sus, topology=topology, fanout=cfg.fanout)
            traced = {"trace": trace_path, "trace_events": n_events,
                      "trace_ms": (time.perf_counter() - t0) * 1e3}
        monitor_doc = None
        if monitor:
            evs = decode_scan(per_round, carry, n=n,
                              crash_rounds=crash_rounds, alive=final.alive,
                              suspicion=sus)
            monitor_doc = monitor_verdict(evs, n=n)
            # counts in the row; the evidence belongs to --trace artifacts
            del monitor_doc["violations"]
        rps = None
        if time_rounds:
            # free the measured run's state before the timing run's
            del final, carry, per_round
            st2 = init_state(cfg, device=dev)
            sync()
            t0 = time.perf_counter()
            run_rounds(st2, cfg, rounds, trandom.PRNGKey(seed, device=dev),
                       **run)
            sync()
            rps = round(rounds / (time.perf_counter() - t0), 2)
            del st2
        ttd_f = [v for v in report.ttd_first.values() if v >= 0]
        ttd_c = [v for v in report.ttd_converged.values() if v >= 0]
        rows.append({
            "n": n,
            "fanout": cfg.fanout,
            "hb_dtype": hb_dtype,
            "rounds_per_sec": rps,
            "tracked_crashes": len(crash_rounds),
            "detected": len(ttd_f),
            "ttd_first_median": statistics.median(ttd_f) if ttd_f else None,
            "ttd_first_max": max(ttd_f) if ttd_f else None,
            "ttd_converged_median": (statistics.median(ttd_c) if ttd_c
                                     else None),
            "ttd_converged_max": max(ttd_c) if ttd_c else None,
            "false_positive_rate": report.false_positive_rate,
            **traced,
            **({"monitor": monitor_doc} if monitor_doc else {}),
            "launches": launches,
        })
    align = ""
    if arc_align > 1:
        align = (f" align={arc_align}" if fanout
                 else f" rounded up to align={arc_align}")
    return {
        "metric": "time-to-detect & FPR vs N (rounds; 1 round == 1 s "
                  "reference time)",
        # per-row fanout is authoritative (rows[i]['fanout']); the header
        # names the rule: explicit, or log2(N) rounded up to the alignment
        "protocol": f"{topology} "
                    f"fanout={fanout if fanout else 'log2(N)'}{align}"
                    ", gossip-only dissemination, t_fail=5",
        "crash_churn": crash_rate,
        "rows": rows,
    }


def partition_sweep(ns=(1024,), seed=0, split_at=5, device="cuda") -> dict:
    """Scenario-engine partition rows.

    Per N: split the cohort into halves for ``t_fail + t_cooldown +
    diameter + slack`` rounds, crash one tracked node inside EACH side
    mid-split, heal, and reduce the per-round stats plus the detection
    events into a PartitionReport.  The claims the rows pin:

      * ``cross_hb_advances == 0``: zero cross-partition heartbeat
        propagation while the split holds (the edge filter is airtight);
      * ``split_brain_rounds`` ~ t_fail + t_cooldown + diameter: how long
        the two sides' views diverge before both accept the split;
      * partition-local detection keeps working: the same-side tracked
        crash is detected in ~t_fail rounds (``local_ttd``);
      * ``reconverge_rounds <= reconverge_bound`` (t_fail + gossip
        diameter): after heal the views knit back purely by gossip.

    The sweep steps the interactive ``SimDetector`` lane (one
    ``gossip_round_scenario`` per round: the separate-pass round with
    int32 lanes, its explicit-edge merge on K2).  The JAX package's
    ``--merge-kernel``/``--elementwise`` passthrough picks among its TPU
    kernels for the same rows and has no counterpart here.
    """
    rows = []
    for n in ns:
        fanout = SimConfig.log_fanout(n)
        cfg = SimConfig(
            n=n,
            topology="random",
            fanout=fanout,
            remove_broadcast=False,   # scenario runs are gossip-only
            fresh_cooldown=True,      # (scenarios/tensor.py gating)
            t_cooldown=6,
        )
        diameter = math.ceil(math.log(n) / math.log(fanout + 1))
        split_len = cfg.t_fail + cfg.t_cooldown + diameter + 8
        heal_at = split_at + split_len
        bound = cfg.t_fail + diameter
        horizon = heal_at + bound + 8

        det = SimDetector(cfg, seed=seed, device=device)
        sc = split_halves(n, start=split_at, end=heal_at)
        det.load_scenario(sc)
        pid = sc.partitions[0].pid(n)
        pid_dev = torch.from_numpy(pid).to(device)

        # one tracked crash per side, two rounds into the split: the
        # partition-local TTD/FPR evidence
        crash_a = n // 4
        crash_b = n // 2 + n // 4
        crash_rounds = {crash_a: split_at + 2, crash_b: split_at + 2}
        series = []
        for _ in range(horizon):
            if int(det.state.round) == split_at + 2:
                det.crash(crash_a)
                det.crash(crash_b)
            det.advance(1)
            row = partition_round_stats(det.state, pid_dev).cpu().numpy()
            series.append({
                "round": int(det.state.round),
                "cross_members": int(row[0]),
                "cross_hb_max": int(row[1]),
                "cross_complete": bool(row[2]),
                "complete": bool(row[3]),
                "n_alive": int(row[4]),
            })
        report = summarize_partition(
            series, det.drain_events(), pid, split_at, heal_at,
            crash_rounds=crash_rounds,
        )
        rows.append({
            "n": n,
            "fanout": fanout,
            "split_at": split_at,
            "heal_at": heal_at,
            "split_rounds": split_len,
            "reconverge_bound": bound,
            **report.as_dict(),
        })
    return {
        "metric": "netsplit behavior vs N (scenario engine; rounds, "
                  "1 round == 1 s reference time)",
        "protocol": "random fanout=log2(N), gossip-only dissemination, "
                    "t_fail=5, t_cooldown=6; half/half partition with "
                    "heal, one tracked crash per side",
        "rows": rows,
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ns", type=int, nargs="+", default=None,
                   help=f"cluster sizes (default {list(DEFAULT_NS)}; "
                        "--partition: [1024])")
    p.add_argument("--rounds", type=int, default=ROUNDS)
    p.add_argument("--topology", choices=["random", "random_arc"],
                   default="random")
    p.add_argument("--hb-dtype", choices=["int32", "int16", "int8"],
                   default="int16")
    p.add_argument("--time-rounds", action="store_true",
                   help="add measured rounds/s per row (second run)")
    p.add_argument("--arc-align", type=int, default=1,
                   help="tile-aligned arc bases (random_arc only)")
    p.add_argument("--fanout", type=int, default=None,
                   help="override fanout (default log2(N))")
    p.add_argument("--trace", type=str, default=None, metavar="PATH",
                   help="write each row's flight-recorder event stream "
                        "(obs/ JSONL) — TTD/FPR sweep rows only")
    p.add_argument("--monitor", action="store_true",
                   help="stamp the invariant monitor's verdict into each "
                        "row — TTD/FPR sweep rows only")
    p.add_argument("--partition", action="store_true",
                   help="scenario-engine netsplit rows (split-brain "
                        "duration, view divergence, reconvergence)")
    p.add_argument("--t-fail-sweep", action="store_true",
                   help="the (t_fail, t_suspect) surface: not ported yet")
    p.add_argument("--suspicion", action="store_true",
                   help="the suspicion A/B rows: not ported yet")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    if args.suspicion or args.t_fail_sweep:
        raise SystemExit(
            "gossipfs_tpu_torch.curves: --suspicion and --t-fail-sweep are "
            "not ported yet (ROADMAP Queue 1, item 4)")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.curves needs a CUDA device "
                         "(or --device cpu)")
    if args.partition:
        doc = partition_sweep(ns=tuple(args.ns or [1024]),
                              device=args.device)
    else:
        doc = sweep(ns=tuple(args.ns or DEFAULT_NS), rounds=args.rounds,
                    topology=args.topology, hb_dtype=args.hb_dtype,
                    time_rounds=args.time_rounds, arc_align=args.arc_align,
                    fanout=args.fanout, trace=args.trace,
                    monitor=args.monitor, device=args.device)
    doc = json.dumps(doc)
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")


if __name__ == "__main__":
    sys.exit(main())
