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

Prints one JSON line.  Needs a CUDA device: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

import torch

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core.rounds import run_rounds
from gossipfs_tpu_torch.core.state import RoundEvents, init_state
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
              crash_rate: float = CRASH_RATE) -> float:
    """Seconds of device time for one ``run_rounds`` call from a fresh
    state (CUDA events around the call, set-up excluded)."""
    state = init_state(cfg, device="cuda")
    key = trandom.PRNGKey(seed, device="cuda")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run_rounds(state, cfg, rounds, key, crash_rate=crash_rate)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.bench needs a CUDA device")
    cfg = headline_config(args.n, args.suspicion, args.elementwise)
    timed_run(cfg, args.rounds)  # warm-up: kernel build and load
    merge.reset_launch_counts()
    secs = [timed_run(cfg, args.rounds) for _ in range(args.attempts)]
    rates = sorted(args.rounds / s for s in secs)
    sus = ", suspicion t_fail=3 t_suspect=2" if args.suspicion else ""
    median = statistics.median(rates)
    doc = {
        "metric": (f"simulated gossip rounds/sec, N={args.n}, fanout=16 "
                   f"tile-aligned arc, 1% crash churn{sus} "
                   f"({torch.cuda.get_device_name(0)})"),
        "value": median,
        "median": median,
        "best": rates[-1],
        "attempts": len(rates),
        "unit": "rounds/s",
        # the reference's heartbeat loop runs 1 round per second
        "vs_baseline": median,
        "device": torch.cuda.get_device_name(0),
        "kernel": "resident_round_cuda",
        "launches": merge.LAUNCH_COUNTS["resident_round"],
        "elementwise": args.elementwise,
        "form_launches": {k: v for k, v in merge.FORM_LAUNCHES.items()
                          if v},
        "suspicion": (None if cfg.suspicion is None
                      else dataclasses.asdict(cfg.suspicion)),
    }
    print(json.dumps(doc))
    return doc


if __name__ == "__main__":
    main()
