"""Full-scale sharded correctness run: a 100k-class N over ranks.

The port of ``gossipfs_tpu/bench/full_scale.py`` (the BASELINE config 4
program): the arc topology at fanout log N, all-int8 lanes, gossip-only
with fresh cooldown, 1 % crash churn and ``track`` tracked crashes at
round ``crash_at``, through ``parallel.mesh.run_rounds_sharded`` over
``devices`` ranks, one column shard each (``N / devices`` subjects).  It
reports the BASELINE metrics (time to detect, convergence, FPR) of the
tracked crashes.  Each rank is a process of its own on
``cuda:(rank % device_count)``, so on a one-card machine every rank
shares ``cuda:0`` (the ranks then time-slice the card and sum their
counts over gloo through the host: the rounds/s is not a multi-GPU
speed).  Each rank builds its block in place (no ``[N, N]`` tensor
anywhere); the separate-pass round runs the arc merge K4 on it.

    python -m gossipfs_tpu_torch.full_scale --n 65536 --rounds 16 \\
        --devices 8 [--out FULLSCALE_TORCH.json]

Prints one JSON line, the JAX package's fields; ``--out`` keeps the
newest run as ``current`` and the earlier ones in ``history``.  Each
rank's peak device memory and kernel launches go to standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch
import torch.distributed as dist

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.bench import tracked_crash_events
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core.rounds import RoundMetrics
from gossipfs_tpu_torch.core.state import init_shard
from gossipfs_tpu_torch.metrics.detection import summarize
from gossipfs_tpu_torch.ops import merge
from gossipfs_tpu_torch.parallel import distributed
from gossipfs_tpu_torch.parallel.mesh import (
    gather_carry, run_rounds_sharded, shard_ctx)


def full_scale_config(n: int) -> SimConfig:
    """The JAX package's full-scale configuration at ``n`` nodes."""
    return SimConfig(
        n=n,
        topology="random_arc",
        fanout=SimConfig.log_fanout(n),
        remove_broadcast=False,
        fresh_cooldown=True,
        t_cooldown=12,
        merge_kernel="xla",
        view_dtype="int8",
        hb_dtype="int8",
    )


def _rank(rank: int, world: int, device, n: int, rounds: int, crash_at: int,
          track: int, crash_rate: float, seed: int) -> dict:
    cfg = full_scale_config(n)
    ctx = shard_ctx(distributed.global_group(), n)
    state = init_shard(cfg, ctx, device=device)
    events, crash_rounds, churn_ok = tracked_crash_events(
        cfg, rounds, track, crash_at, device=device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    if ctx.group is not None:
        dist.barrier(ctx.group)
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    _, carry, per_round = run_rounds_sharded(
        state, cfg, rounds, trandom.PRNGKey(seed, device=device), ctx,
        events=events, crash_rate=crash_rate, churn_ok=churn_ok,
        crash_only_events=True)   # tracked_crash_events schedules crashes
    if cuda:
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    out = {"elapsed": elapsed,
           "launches": {k: v for k, v in merge.LAUNCH_COUNTS.items() if v},
           "peak_bytes": (torch.cuda.max_memory_allocated(device) if cuda
                          else None),
           "device": (torch.cuda.get_device_name(device) if cuda
                      else "CPU"),
           "backend": (dist.get_backend(ctx.group) if ctx.group is not None
                       else None)}
    carry = gather_carry(carry, ctx)
    if carry is not None:
        out.update(carry=carry, crash_rounds=crash_rounds,
                   per_round=RoundMetrics(*(m.cpu() for m in per_round)))
    return out


def run(n: int, rounds: int, crash_at: int, track: int, crash_rate: float,
        devices: int, seed: int, *, device="cuda",
        timeout: float = 3600.0) -> dict:
    """One full-scale run over ``devices`` ranks; returns the JSON
    document (the JAX package's fields) and prints each rank's peak
    device memory and kernel launches to standard error."""
    threads = max(1, (os.cpu_count() or 1) // devices)
    ranks = distributed.launch(
        _rank, devices, (n, rounds, crash_at, track, crash_rate, seed),
        timeout=timeout, device=device, threads=threads)
    head = ranks[0]
    for r, res in enumerate(ranks):
        peak = ("" if res["peak_bytes"] is None else
                f"peak device memory {res['peak_bytes'] / 2**30:.3f} GiB, ")
        print(f"full_scale: rank {r} {peak}launches {res['launches']}",
              file=sys.stderr)
    report = summarize(head["carry"], head["per_round"], head["crash_rounds"])
    ttd_f = [v for v in report.ttd_first.values() if v >= 0]
    ttd_c = [v for v in report.ttd_converged.values() if v >= 0]
    cfg = full_scale_config(n)
    names = sorted({res["device"] for res in ranks})
    cards = (len({str(distributed.device_for_rank(r, device))
                  for r in range(devices)}) if str(device) == "cuda" else 0)
    where = (f"{cards} card(s): {', '.join(names)}" if cards
             else ", ".join(names))
    elapsed = head["elapsed"]
    return {
        "metric": ("full-scale sharded correctness run (BASELINE config 4 "
                   "program)"),
        "n": n,
        "shards": devices,
        "columns_per_shard": n // devices,
        "fanout": cfg.fanout,
        "topology": cfg.topology,
        "rounds": rounds,
        "crash_churn": crash_rate,
        "tracked_crashes": len(head["crash_rounds"]),
        "detected": len(ttd_f),
        "ttd_first_median": statistics.median(ttd_f) if ttd_f else None,
        "ttd_first_max": max(ttd_f) if ttd_f else None,
        "ttd_converged_median": statistics.median(ttd_c) if ttd_c else None,
        "ttd_converged_max": max(ttd_c) if ttd_c else None,
        "false_positive_rate": report.false_positive_rate,
        "wall_seconds": elapsed,
        "rounds_per_sec": rounds / elapsed,
        "backend": (f"{devices} rank processes on {where}, "
                    f"{head['backend'] or 'one process'}"),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=98_304)
    p.add_argument("--rounds", type=int, default=18)
    p.add_argument("--crash-at", type=int, default=3)
    p.add_argument("--track", type=int, default=8)
    p.add_argument("--crash-rate", type=float, default=0.01)
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (rank r on cuda:r % device_count) or cpu")
    args = p.parse_args(argv)
    result = run(args.n, args.rounds, args.crash_at, args.track,
                 args.crash_rate, args.devices, args.seed, device=args.device)
    print(json.dumps(result))
    if args.out:
        # one file name: the newest run is "current", superseded runs
        # accumulate in "history"; replaced atomically
        doc = {"current": result, "history": []}
        if os.path.exists(args.out):
            with open(args.out) as f:
                prev = json.load(f)
            if "current" in prev:
                doc["history"] = [prev["current"]] + prev.get("history", [])
            else:
                doc["history"] = [prev]
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(doc) + "\n")
        os.replace(tmp, args.out)


if __name__ == "__main__":
    sys.exit(main())
