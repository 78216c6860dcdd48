"""SDFS-under-load benchmark, on the card.

The port of the JAX package's ``bench/traffic_bench.py`` (the
``TRAFFIC_r12.json`` and ``ERASURE_r18.json`` lanes).  Two lanes, one
document:

* **cosim lane** (full fidelity, small N): the open-loop workload
  (``traffic/workload.py``) against the interactive CoSim — steady state,
  churn, writes racing a timed partition, and a rack-kill repair storm
  under a per-round repair budget.  Every run is flight-recorded; the
  document embeds BOTH durability accountings (harness ledger vs event
  replay, ``traffic/audit.py``) and their exact-match verdict.  The
  detector's rounds run on the card (K2, the explicit-edge merge); the
  control plane and the byte plane are host Python.

* **scale lane** (the >=100k-member requirement): the TENSORIZED planner
  (``traffic/planner.py``) drives placement + budgeted repair planning
  against evolving [N] alive masks at N=100,000+ on the card — thousands
  of placements per round and the whole repair diff as one masked top k,
  with steady/churn/partition/rack-storm mask schedules and measured
  wall-time per planning round (host clock around work that ends in a
  device synchronize).  No per-file Python anywhere in the per-round
  path.

    python -m gossipfs_tpu_torch.traffic_bench --all
    python -m gossipfs_tpu_torch.traffic_bench --partition-race --n 64 \
        --trace /tmp/traffic.jsonl
    python -m gossipfs_tpu_torch.traffic_bench --scale --device cpu \
        --scale-n 4096 --scale-files 256

``--erasure-matrix`` is the ERASURE lane: the same four cosim scenarios
in ``redundancy="stripe"`` mode (k data + m parity Reed-Solomon
fragments, ``erasure/``) plus a replica-mode repair-storm twin at the
SAME failure schedule, so the document carries the measured
stripe-vs-replica repair-bandwidth ratio next to the durability
verdicts.  Every cosim row is redundancy-self-describing.

Runs on the card; ``--device cpu`` runs the plain versions on the CPU
(host-clock times, not device ones).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gossipfs_tpu_torch.sdfs.types import STRIPE_K, STRIPE_M
from gossipfs_tpu_torch.traffic.workload import WorkloadSpec


def default_spec(rate: float = 8.0, n_keys: int = 96, seed: int = 0,
                 redundancy: str = "replica", stripe_k: int = STRIPE_K,
                 stripe_m: int = STRIPE_M) -> WorkloadSpec:
    """The bench mix: 30% puts / 2% deletes / 68% gets, Zipf keys, the
    reference-shard size distribution with capped materialized bytes."""
    return WorkloadSpec(rate=rate, n_keys=n_keys, seed=seed,
                        redundancy=redundancy, stripe_k=stripe_k,
                        stripe_m=stripe_m)


# ---------------------------------------------------------------------------
# cosim lane
# ---------------------------------------------------------------------------


def cosim_lane(n: int, rounds: int, rate: float, seed: int,
               trace: str | None = None, only: str | None = None,
               redundancy: str = "replica", stripe_k: int = STRIPE_K,
               stripe_m: int = STRIPE_M, device="cuda") -> dict:
    from gossipfs_tpu_torch.traffic import harness

    spec = default_spec(rate=rate, seed=seed, redundancy=redundancy,
                        stripe_k=stripe_k, stripe_m=stripe_m)
    out: dict = {}
    # single-run flags write PATH itself; --all suffixes per run
    t = lambda name: (  # noqa: E731
        (trace if only else f"{trace}.{name}") if trace else None)
    if only in (None, "steady"):
        out["steady"] = harness.steady_state(
            n, rounds, spec, seed=seed, trace=t("steady"), device=device)
    if only in (None, "churn"):
        out["churn"] = harness.churn(
            n, rounds, spec, seed=seed, trace=t("churn"), device=device)
    if only in (None, "partition_race"):
        out["partition_race"] = harness.partition_race(
            n, spec, seed=seed, trace=t("partition"), device=device)
    if only in (None, "repair_storm"):
        out["repair_storm"] = harness.repair_storm(
            n, spec, files=max(96, n * 2), rack=(n // 4, max(4, n // 8)),
            repair_budget=8, seed=seed, trace=t("storm"), device=device)
    for row in out.values():
        # artifact rows self-describe their redundancy mode
        row["redundancy"] = spec.redundancy
        if spec.redundancy == "stripe":
            row["stripe_k"], row["stripe_m"] = spec.stripe_k, spec.stripe_m
    return out


def erasure_matrix(n: int, rounds: int, rate: float, seed: int,
                   trace: str | None = None, stripe_k: int = STRIPE_K,
                   stripe_m: int = STRIPE_M, device="cuda") -> dict:
    """The ERASURE lane: the whole gray-failure scenario matrix in
    stripe mode, plus a replica repair-storm twin at the SAME failure
    schedule (same seed, same victim set — the master/introducer never
    dies in these scenarios, so the schedules coincide exactly) for the
    repair-bandwidth comparison."""
    from gossipfs_tpu_torch.traffic import harness

    doc = cosim_lane(n, rounds, rate, seed, trace=trace,
                     redundancy="stripe", stripe_k=stripe_k,
                     stripe_m=stripe_m, device=device)
    doc["redundancy"] = "stripe"
    doc["stripe_k"], doc["stripe_m"] = stripe_k, stripe_m
    rspec = default_spec(rate=rate, seed=seed)
    twin = harness.repair_storm(
        n, rspec, files=max(96, n * 2), rack=(n // 4, max(4, n // 8)),
        repair_budget=8, seed=seed, device=device)
    twin["redundancy"] = "replica"
    doc["replica_storm_twin"] = twin
    sb = doc["repair_storm"]["repair_bytes_written"]
    sc = doc["repair_storm"]["repair_copies"]
    rb = twin["repair_bytes_written"]
    rc = twin["repair_copies"]
    doc["repair_bandwidth"] = {
        "stripe_bytes": sb,
        "stripe_units": sc,
        "replica_bytes": rb,
        "replica_units": rc,
        # bytes written per unit of lost redundancy repaired — the
        # ~k-fold erasure saving (a lost fragment re-encodes ceil(S/k)
        # row bytes where a lost replica re-copies all S), held against
        # 1/k
        "per_unit_ratio": (round((sb / sc) / (rb / rc), 4)
                           if sc and rc and rb else None),
        # total traffic at the same failure schedule, reported honestly
        # but NOT the 1/k claim: the (k+m)-wide stripe exposes more
        # units to the same rack kill than R=4 replicas, so totals
        # scale by (k+m)/(R*k) — 0.375 at (4,2) vs the reference's R=4
        "total_ratio": round(sb / rb, 4) if rb else None,
        "bound_1_over_k": round(1.0 / stripe_k, 4),
    }
    scenarios = ("steady", "churn", "partition_race", "repair_storm")
    doc["losses_total"] = sum(
        doc[s]["durability"]["harness"]["lost"] for s in scenarios)
    doc["matches_all"] = all(
        doc[s]["durability"]["match"]
        and doc[s]["durability"]["monitor"]["match_events"]
        for s in scenarios)
    return doc


# ---------------------------------------------------------------------------
# scale lane: the tensorized planner at >= 100k members
# ---------------------------------------------------------------------------


def scale_lane(n: int = 100_000, files_per_round: int = 2048,
               rounds: int = 24, budget: int = 4096,
               churn_rate: float = 0.01, seed: int = 0,
               device="cuda") -> dict:
    """Placement + repair planning over live [N] masks at traffic scale.

    The mask schedule packs all four regimes into one run: steady
    placement, then 1%-per-round crash churn, then a half/half
    reachability partition window (acked-write accounting vs the WRITE
    quorum — imported, not re-derived), then a rack-sized correlated
    kill whose deficit drains at ``budget`` repairs per round.  The
    detector's view is modeled as ground truth delayed by t_fail rounds
    (the gossip layer's detection latency); at 100k members the real
    detector runs on the frontier lane (``frontier.py``), and this lane
    consumes the same [N] mask shape it produces.  The masks and the
    table live on ``device``; ``planner_ms`` is the host clock around a
    round's place, plan+commit and stats, ending in a device synchronize.
    """
    import numpy as np

    from gossipfs_tpu_torch.traffic.planner import ReplicaTable

    t_fail = 5
    rng = np.random.default_rng(seed)
    capacity = files_per_round * rounds + 8
    dev = torch.device(device)
    table = ReplicaTable(capacity, n, seed=seed, device=dev)
    alive_h = np.ones(n, dtype=bool)
    history = [alive_h.copy()]

    rack_lo, rack_size = n // 2, max(n // 100, 64)
    churn_start = rounds // 4
    part_start, part_end = rounds // 2, rounds // 2 + rounds // 6
    rack_round = (3 * rounds) // 4

    rows = []
    total_placed = 0
    backlog = 0
    for r in range(rounds):
        # ground-truth fault schedule
        if r >= churn_start:
            kill = rng.random(n) < churn_rate
            alive_h &= ~kill
        if r == rack_round:
            alive_h[rack_lo:rack_lo + rack_size] = False
        history.append(alive_h.copy())
        # the planner consumes the DETECTED view (t_fail rounds stale)
        view_h = history[max(0, len(history) - 1 - t_fail)]
        # reachability: ground truth, partition-confined in the window
        reach_h = alive_h.copy()
        partition_active = part_start <= r < part_end
        if partition_active:
            reach_h[n // 2:] = False  # master's side = [0, n/2)
        # the planner's (detection-lagged) view
        alive = torch.from_numpy(view_h).to(dev)
        reach = torch.from_numpy(reach_h).to(dev)
        truth = torch.from_numpy(alive_h).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

        t0 = time.perf_counter()
        placed_rows = table.place(reach if partition_active else alive,
                                  files_per_round, method="sampled")
        pass_stats = table.plan_and_commit(alive, reach, budget)
        stats = table.stats(truth, reach)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        total_placed += int((placed_rows >= 0).all(dim=1).sum())
        backlog = pass_stats["repairs_pending"]
        rows.append({
            "round": r,
            "n_alive": int(alive_h.sum()),
            "phase": ("partition" if partition_active else
                      "rack_storm" if r >= rack_round else
                      "churn" if r >= churn_start else "steady"),
            "planner_ms": round(ms, 2),
            "files": table.n_files,
            **pass_stats,
            "write_quorum_reachable": stats["write_quorum_reachable"],
            "replica_histogram": stats["replica_histogram"],
        })

    # drain the rack storm's remaining backlog at budget/round
    drain_rounds = 0
    alive = torch.from_numpy(alive_h).to(dev)
    while backlog > 0 and drain_rounds < 64:
        pass_stats = table.plan_and_commit(alive, alive, budget)
        backlog = pass_stats["repairs_pending"]
        drain_rounds += 1
    final = table.stats(alive, alive)
    per_round_ms = [row["planner_ms"] for row in rows[1:]]  # row 0 warms up
    return {
        "metric": "tensorized placement/repair planning vs [N] alive masks",
        "n": n,
        "files_per_round": files_per_round,
        "rounds": rounds,
        "repair_budget": budget,
        "placed_total": total_placed,
        "planner_ms_median": round(sorted(per_round_ms)[
            len(per_round_ms) // 2], 2) if per_round_ms else None,
        "placements_per_sec": round(
            files_per_round * 1e3 / (sorted(per_round_ms)[
                len(per_round_ms) // 2]), 1) if per_round_ms else None,
        "storm_drain_rounds_post_run": drain_rounds,
        "final": final,
        "rows": rows,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=64,
                   help="cosim-lane member count")
    p.add_argument("--rounds", type=int, default=24)
    p.add_argument("--rate", type=float, default=8.0,
                   help="open-loop ops per round")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steady", action="store_true")
    p.add_argument("--churn", action="store_true")
    p.add_argument("--partition-race", action="store_true")
    p.add_argument("--repair-storm", action="store_true")
    p.add_argument("--redundancy", choices=("replica", "stripe"),
                   default="replica",
                   help="cosim-lane byte plane: 4 full replicas or k+m "
                        "Reed-Solomon fragments (gossipfs_tpu/erasure/)")
    p.add_argument("--stripe-k", type=int, default=STRIPE_K)
    p.add_argument("--stripe-m", type=int, default=STRIPE_M)
    p.add_argument("--erasure-matrix", action="store_true",
                   help="the ERASURE lane: all four cosim scenarios "
                        "in stripe mode + a replica repair-storm twin at "
                        "the same failure schedule (bandwidth ratio)")
    p.add_argument("--scale", action="store_true",
                   help="the tensorized-planner lane at --scale-n members")
    p.add_argument("--scale-n", type=int, default=100_000)
    p.add_argument("--scale-files", type=int, default=2048,
                   help="placements per round in the scale lane")
    p.add_argument("--scale-budget", type=int, default=4096)
    p.add_argument("--all", action="store_true",
                   help="all four cosim runs + the scale lane")
    p.add_argument("--trace", type=str, default=None, metavar="PATH",
                   help="flight-recorder stream(s); single-run flags "
                        "write PATH itself, --all writes PATH.<run>")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = args.device
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.traffic_bench needs a CUDA "
                         "device (or --device cpu)")

    picked = [k for k, v in (("steady", args.steady),
                             ("churn", args.churn),
                             ("partition_race", args.partition_race),
                             ("repair_storm", args.repair_storm)) if v]
    doc: dict = {
        "metric": "SDFS plane under open-loop load "
                  "(throughput, quorum latency, durability)",
        "workload": {
            "mix": "put 0.30 / delete 0.02 / get 0.68",
            "popularity": "zipf(1.1)",
            "sizes": "reference-shard magnitudes (64 KB..4 MB logical; "
                     "materialized bytes capped — BASELINE.md boundary)",
        },
    }
    red = dict(redundancy=args.redundancy, stripe_k=args.stripe_k,
               stripe_m=args.stripe_m, device=dev)
    if args.erasure_matrix:
        doc["erasure_matrix"] = erasure_matrix(
            args.n, args.rounds, args.rate, args.seed, trace=args.trace,
            stripe_k=args.stripe_k, stripe_m=args.stripe_m, device=dev)
    elif args.all or not (picked or args.scale):
        doc.update(cosim_lane(args.n, args.rounds, args.rate, args.seed,
                              trace=args.trace, **red))
        doc["scale"] = scale_lane(args.scale_n, args.scale_files,
                                  budget=args.scale_budget, seed=args.seed,
                                  device=dev)
    else:
        for name in picked:
            doc.update(cosim_lane(args.n, args.rounds, args.rate, args.seed,
                                  trace=args.trace, only=name, **red))
        if args.scale:
            doc["scale"] = scale_lane(args.scale_n, args.scale_files,
                                      budget=args.scale_budget,
                                      seed=args.seed, device=dev)
    doc["device"] = (torch.cuda.get_device_name(dev)
                     if torch.device(dev).type == "cuda" else "cpu")
    out = json.dumps(doc)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return doc


if __name__ == "__main__":
    main()
