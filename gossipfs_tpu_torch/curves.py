"""Netsplit behavior vs N: the scenario engine's partition rows.

The port of the JAX package's ``bench/curves.py --partition``
(``partition_sweep``), the entry point that made its committed netsplit
artifact; its other sweeps (TTD/FPR vs N, the t_fail surface, the
suspicion A/B) are not ported yet.

    python -m gossipfs_tpu_torch.curves --partition [--ns N ...] [--out F]

Per N: a random-fanout gossip-only cluster is split into halves through
``SimDetector.load_scenario``, one tracked node crashes inside each side
mid-split, the split heals, and the per-round device stats
(``metrics.detection.partition_round_stats``) plus the detection events
reduce to a ``PartitionReport`` row.  Prints one JSON document.  Runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.detector.sim import SimDetector
from gossipfs_tpu_torch.metrics.detection import (
    partition_round_stats, summarize_partition)
from gossipfs_tpu_torch.scenarios import split_halves


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
    p.add_argument("--ns", type=int, nargs="+", default=[1024])
    p.add_argument("--partition", action="store_true",
                   help="scenario-engine netsplit rows (split-brain "
                        "duration, view divergence, reconvergence)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    if not args.partition:
        raise SystemExit(
            "gossipfs_tpu_torch.curves: only --partition is ported; the "
            "TTD/FPR, t_fail and suspicion sweeps are still to come")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.curves needs a CUDA device "
                         "(or --device cpu)")
    doc = json.dumps(partition_sweep(ns=tuple(args.ns), device=args.device))
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")


if __name__ == "__main__":
    sys.exit(main())
