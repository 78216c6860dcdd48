"""Headline benchmark of the port: simulated gossip rounds/s on one GPU.

The JAX package's headline (``bench.py``) on the port: the tile-aligned
arc profile (``SimConfig.headline``: N = 16,384, fanout 16 in two aligned
groups of 8, gossip-only dissemination with fresh cooldown, all-int8
lanes) for ``ROUNDS`` rounds under 1 % random crash-stop churn per round.
Each attempt starts from a fresh fully-joined state (set-up, not timed)
and is timed with CUDA events around the whole ``run_rounds`` call, after
one warm-up run; the headline is the median attempt.  ``--suspicion`` arms
the SWIM lifecycle at the JAX package's fast knob (``t_fail=3``,
``SuspicionParams(t_suspect=2)``), its ``bench.py --suspicion`` anchor; the
round then runs the resident round's suspicion form.  ``--elementwise
swar`` runs the resident round's SWAR form (4 packed subjects per int32
word), as the JAX package's chip bench does; the default stays ``lanes``
so the headline series stays continuous, and the JSON line records the
choice.

    python -m gossipfs_tpu_torch.bench [--n N] [--rounds R] [--attempts A]
                                       [--suspicion] [--elementwise swar]
                                       [--trace PATH] [--monitor]

``--trace PATH`` writes the last attempt's flight-recorder event stream
(``obs/``; analyze it with ``python -m gossipfs_tpu_torch.obs.timeline``)
and ``--monitor`` streams the same decoded events through the invariant
monitor, stamps its verdict into the JSON and exits 1 on a violation.
Both decode the outputs after the attempts, off the timed window: the
rounds and their kernel launches are the same with or without them.

Prints one JSON line.  Runs on the card; ``--device cpu`` runs the plain
versions on the CPU (a host-clock time, not a device one).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core.rounds import run_rounds
from gossipfs_tpu_torch.core.state import RoundEvents, init_state
from gossipfs_tpu_torch.obs.monitor import monitor_verdict
from gossipfs_tpu_torch.obs.recorder import decode_scan, write_trace
from gossipfs_tpu_torch.ops import merge
from gossipfs_tpu_torch.suspicion import SuspicionParams

N = 16_384
ROUNDS = 100
CRASH_RATE = 0.01


def tracked_victims(n: int, track: int, introducer: int = 0,
                    n_live: int | None = None) -> list[int]:
    """``track`` crash victims spread evenly over the live ids (the first
    ``n_live``, default all ``n``), skipping the introducer (the JAX
    package's bench/run.py derivation)."""
    live = n if n_live is None else n_live
    track = min(track, live - 1)
    stride = max(live // (track + 1), 1)
    nodes = [(introducer + (k + 1) * stride) % live for k in range(track)]
    return sorted({x for x in nodes if x != introducer})


def tracked_crash_events(cfg: SimConfig, rounds: int, track: int, at: int,
                         device="cuda", n_live: int | None = None):
    """Schedule ``track`` deterministic crashes at round ``at``.

    Returns (RoundEvents [rounds, N], {node: crash_round}, churn_ok): the
    churn mask keeps the tracked nodes and the introducer out of random
    churn, as the JAX package's bench does.  ``n_live``: the live cohort of
    a padded configuration (gossipfs_tpu_torch.frontier): the victims come
    from its ids and the dead pad ids past it stay out of churn too."""
    n = cfg.n
    nodes = tracked_victims(n, track, cfg.introducer, n_live)
    at = min(at, rounds - 1)
    crash = torch.zeros((rounds, n), dtype=torch.bool, device=device)
    crash[at, nodes] = True
    zeros = torch.zeros_like(crash)
    churn_ok = torch.ones((n,), dtype=torch.bool, device=device)
    churn_ok[nodes] = False
    churn_ok[cfg.introducer] = False
    if n_live is not None:
        churn_ok[n_live:] = False
    return (RoundEvents(crash=crash, leave=zeros, join=zeros),
            {node: at for node in nodes}, churn_ok)


def timed_run(cfg: SimConfig, rounds: int, seed: int = 0,
              crash_rate: float = CRASH_RATE, device="cuda", **run_kw):
    """One ``run_rounds`` call from a fresh state: (seconds, its outputs
    (state, MetricsCarry, RoundMetrics)).  ``run_kw`` passes on to
    ``run_rounds`` (events, churn mask, ``plain``, ...).  On the card the
    seconds are device time (CUDA events around the call, set-up
    excluded); on the CPU, the host clock's."""
    state = init_state(cfg, device=device)
    key = trandom.PRNGKey(seed, device=device)
    dev = torch.device(device)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = run_rounds(state, cfg, rounds, key, crash_rate=crash_rate,
                         **run_kw)
        return time.perf_counter() - t0, out
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run_rounds(state, cfg, rounds, key, crash_rate=crash_rate,
                     **run_kw)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, out


def headline_config(n: int, suspicion: bool,
                    elementwise: str = "lanes") -> SimConfig:
    """The bench's configuration: the headline, with the SWIM lifecycle at
    the fast knob (t_fail 3, t_suspect 2) under ``suspicion``."""
    cfg = SimConfig.headline(n, elementwise=elementwise)
    if suspicion:
        cfg = dataclasses.replace(cfg, t_fail=3,
                                  suspicion=SuspicionParams(t_suspect=2))
    return cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--attempts", type=int, default=5)
    ap.add_argument("--suspicion", action="store_true",
                    help="arm the SWIM lifecycle (t_fail=3, t_suspect=2)")
    ap.add_argument("--elementwise", choices=merge.ELEMENTWISE,
                    default="lanes",
                    help="swar: the resident round's SWAR form")
    ap.add_argument("--trace", type=str, default=None, metavar="PATH",
                    help="write the last attempt's flight-recorder event "
                         "stream (obs/ JSONL) to PATH, decoded after the "
                         "timed window")
    ap.add_argument("--monitor", action="store_true",
                    help="stream the last attempt's decoded events "
                         "through the invariant monitor (obs/monitor.py), "
                         "stamp its verdict into the JSON, exit 1 on a "
                         "violation")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    on_card = torch.device(dev).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.bench needs a CUDA device "
                         "(or --device cpu)")
    cfg = headline_config(args.n, args.suspicion, args.elementwise)
    timed_run(cfg, args.rounds, device=dev)  # warm-up: kernel build, load
    merge.reset_launch_counts()
    secs = []
    for _ in range(args.attempts):
        sec, out = timed_run(cfg, args.rounds, device=dev)
        secs.append(sec)
    launches = merge.LAUNCH_COUNTS["resident_round"]
    form_launches = {k: v for k, v in merge.FORM_LAUNCHES.items() if v}
    rates = sorted(args.rounds / s for s in secs)
    sus = ", suspicion t_fail=3 t_suspect=2" if args.suspicion else ""
    median = statistics.median(rates)
    device = torch.cuda.get_device_name(dev) if on_card else "cpu"
    obs = decode_last(out, cfg, args.trace, args.monitor)
    doc = {
        "metric": (f"simulated gossip rounds/sec, N={args.n}, fanout=16 "
                   f"tile-aligned arc, 1% crash churn{sus} ({device})"),
        "value": median,
        "median": median,
        "best": rates[-1],
        "attempts": len(rates),
        "unit": "rounds/s",
        # the reference's heartbeat loop runs 1 round per second
        "vs_baseline": median,
        "device": device,
        "kernel": ("resident_round_cuda" if on_card
                   else "resident_round_plain"),
        "launches": launches,
        "elementwise": args.elementwise,
        "form_launches": form_launches,
        "suspicion": (None if cfg.suspicion is None
                      else dataclasses.asdict(cfg.suspicion)),
        **obs,
    }
    print(json.dumps(doc))
    if args.monitor and not doc["monitor"]["ok"]:
        # a headline over a run that broke a protocol invariant is not a
        # headline (the verdict is stamped above)
        raise SystemExit(1)
    return doc


def decode_last(out, cfg: SimConfig, trace: str | None,
                monitor: bool) -> dict:
    """The ``--trace``/``--monitor`` fields of the JSON from one attempt's
    outputs, decoded on the host after the timed window: the monitor's
    verdict (its violation list stays in the trace) and the trace's path,
    event count and the host ms of each decode."""
    state, carry, per_round = out
    n, sus = cfg.n, cfg.suspicion is not None
    doc: dict = {}
    if monitor:
        t0 = time.perf_counter()
        evs = decode_scan(per_round, carry, n=n, alive=state.alive,
                          suspicion=sus)
        doc["monitor"] = monitor_verdict(evs, n=n)
        del doc["monitor"]["violations"]
        doc["monitor_ms"] = (time.perf_counter() - t0) * 1e3
    if trace:
        t0 = time.perf_counter()
        doc["trace_events"] = write_trace(
            trace, per_round, carry, n=n, source="bench", alive=state.alive,
            suspicion=sus, elementwise=cfg.elementwise,
            merge_kernel=cfg.merge_kernel, crash_rate=CRASH_RATE)
        doc["trace"] = trace
        doc["trace_ms"] = (time.perf_counter() - t0) * 1e3
    return doc


if __name__ == "__main__":
    main()
