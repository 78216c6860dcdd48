"""Single-card capacity frontier: the rr production profile at N = 65,536.

The port of the JAX package's ``gossipfs_tpu/bench/frontier.py``:
``SimConfig.packed_rr`` (random fanout log2 N, gossip-only with fresh
cooldown, all-int8 lanes) built straight in the lean loop's packed layout
(``core/rounds.rr_packed_init``: 2 B per entry, 8.6 GB at N = 65,536) and
run through the lean loop's core (``core/rounds.run_lean_packed``) on the
resident round, under 1 % crash churn with 8 tracked crashes.

    python -m gossipfs_tpu_torch.frontier                  # N = 65,536
    python -m gossipfs_tpu_torch.frontier --n 100000       # padded to 100,352

A literal N pads up to the JAX package's admissible quantum (the stripe
width ``--block-c``, and for arcs also its 1,024-row arc chunk) with dead
pad nodes, so both packages run the same ``n_padded`` and draw the same
edges.  One warm-up round builds the kernel; the timed run starts from a
fresh state (set-up not timed) and ends in a device synchronize.  Prints
one JSON line: the JAX package's fields, less ``rr_rotate``,
``merge_block_r`` and ``row_budget_bytes`` (TPU VMEM layout, which the
port does not have), plus the device, its peak memory and the timed
run's resident-round launches by form (none on the CPU, where the plain
version runs).
``--elementwise swar`` runs the resident round's SWAR form.  ``--trace
PATH`` writes the timed run's flight-recorder stream (``obs/``; analyze it
with ``python -m gossipfs_tpu_torch.obs.timeline``), decoded after the
run from outputs ``summarize`` reads anyway, with the pad subjects past N
masked out (``n_effective``); the JSON then also carries ``trace``,
``trace_events`` and the decode's host ms.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time

import torch

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.bench import tracked_crash_events
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core import rounds as R
from gossipfs_tpu_torch.metrics.detection import summarize
from gossipfs_tpu_torch.obs.recorder import write_trace
from gossipfs_tpu_torch.ops import merge

# the JAX package's arc-chunk quantum (gossipfs_tpu/ops/merge_pallas.py
# ARC_CHUNK), copied so the padded N is the same in both packages
ARC_CHUNK = 1024


def pad_quantum(block_c: int, topology: str) -> int:
    """The JAX package's admissible-N quantum: the stripe width, and for
    arcs also its arc chunk."""
    q = block_c
    if topology == "random_arc":
        q = math.lcm(q, ARC_CHUNK)
    return q


def frontier_config(n: int, block_c: int = 1024, topology: str = "random",
                    arc_align: int = 1, fanout: int | None = None,
                    elementwise: str = "lanes"):
    """(config, n_padded): ``SimConfig.packed_rr`` at the padded N, with
    the JAX frontier's fanout rule (aligned arcs round log2 N up to a
    multiple of the alignment)."""
    n_pad = -(-n // pad_quantum(block_c, topology)) * pad_quantum(
        block_c, topology)
    over = dict(topology=topology, arc_align=arc_align,
                elementwise=elementwise)
    if fanout:
        over["fanout"] = fanout
    elif arc_align > 1:
        lf = SimConfig.log_fanout(n_pad)
        over["fanout"] = -(-lf // arc_align) * arc_align
    return SimConfig.packed_rr(n_pad, block_c, **over), n_pad


def run(n: int = 65_536, rounds: int = 20, block_c: int = 1024,
        crash_at: int = 3, track: int = 8, crash_rate: float = 0.01,
        seed: int = 0, topology: str = "random", arc_align: int = 1,
        fanout: int | None = None, elementwise: str = "lanes",
        trace: str | None = None, device="cuda") -> dict:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.frontier needs a CUDA device "
                         "(or device='cpu')")
    cfg, n_pad = frontier_config(n, block_c, topology, arc_align, fanout,
                                 elementwise)
    padded = n_pad != n
    if not R._lean_ok(cfg, False):
        raise ValueError(f"{cfg} does not take the lean loop")
    events, crash_rounds, churn_ok = tracked_crash_events(
        cfg, rounds, track, crash_at, device=dev,
        n_live=n if padded else None)
    mask = (torch.arange(n_pad, device=dev) < n) if padded else None
    key = trandom.PRNGKey(seed, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def go(num_rounds: int):
        hb, asl, alive, hb_base, rnd, counts = R.rr_packed_init(
            cfg, member_mask=mask, device=dev)
        sync()
        t0 = time.perf_counter()
        out = R.run_lean_packed(
            hb, asl, alive, hb_base, rnd, cfg, key, num_rounds,
            crash=events.crash[:num_rounds], crash_rate=crash_rate,
            churn_ok=churn_ok, counts0=counts)
        sync()
        return out, time.perf_counter() - t0

    go(1)  # warm-up: the kernel's build and load
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    merge.reset_launch_counts()
    out, elapsed = go(rounds)
    launches = {f: v for f, v in merge.FORM_LAUNCHES.items() if v}
    mcarry, per_round = out[7], out[8]
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    report = summarize(mcarry, per_round, crash_rounds,
                       n_effective=n if padded else None)
    traced = {}
    if trace:
        # off the timed run: the lanes stay on the device, only the [N]
        # liveness and the metrics leave
        t0 = time.perf_counter()
        n_events = write_trace(
            trace, per_round, mcarry, n=n_pad, source="frontier",
            crash_rounds=crash_rounds, alive=out[2],
            n_effective=n if padded else None, topology=topology,
            merge_block_c=block_c, elementwise=elementwise)
        traced = {"trace": trace, "trace_events": n_events,
                  "trace_ms": (time.perf_counter() - t0) * 1e3}
    ttd_f = [v for v in report.ttd_first.values() if v >= 0]
    ttd_c = [v for v in report.ttd_converged.values() if v >= 0]
    return {
        "metric": "single-card capacity frontier (resident-round kernel, "
                  "packed 2 B/entry lanes)",
        "n": n,
        "n_padded": n_pad,
        "pad_nodes": n_pad - n,
        "entries": n_pad * n_pad,
        "merge_block_c": block_c,
        "fanout": cfg.fanout,
        "arc_align": arc_align,
        "topology": topology,
        "rounds": rounds,
        "crash_churn": crash_rate,
        "elementwise": elementwise,
        "tracked_crashes": len(crash_rounds),
        "detected": len(ttd_f),
        "ttd_first_median": statistics.median(ttd_f) if ttd_f else None,
        "ttd_first_max": max(ttd_f) if ttd_f else None,
        "ttd_converged_median": statistics.median(ttd_c) if ttd_c else None,
        "false_positive_rate": report.false_positive_rate,
        "seconds_per_round": elapsed / rounds,
        "rounds_per_sec": rounds / elapsed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "peak_memory_bytes": peak,
        "launches": launches,
        **traced,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=65_536)
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--block-c", type=int, default=1024,
                   help="the JAX package's stripe width: sets the padding "
                        "quantum only")
    p.add_argument("--crash-at", type=int, default=3)
    p.add_argument("--track", type=int, default=8)
    p.add_argument("--crash-rate", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--topology", type=str, default="random")
    p.add_argument("--arc-align", type=int, default=1,
                   help="aligned arc bases (random_arc only)")
    p.add_argument("--fanout", type=int, default=None)
    p.add_argument("--elementwise", choices=("lanes", "swar"),
                   default="lanes",
                   help="swar: the resident round's SWAR form")
    p.add_argument("--trace", type=str, default=None, metavar="PATH",
                   help="write the timed run's flight-recorder event "
                        "stream (obs/ JSONL) to PATH")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    doc = run(args.n, args.rounds, args.block_c, args.crash_at, args.track,
              args.crash_rate, args.seed, args.topology, args.arc_align,
              args.fanout, args.elementwise, args.trace, args.device)
    print(json.dumps(doc))
    return doc


if __name__ == "__main__":
    main()
