"""Native C++ engine benchmark: real-socket gossip faster than real time.

The reference's runtime is pinned to 1 round/s by its hardcoded 1 s
heartbeat driver (main.go:27-33).  The C++ epoll engine (native/engine.cc)
runs the same protocol over real localhost UDP datagrams with a
configurable period — this runner measures how much faster than the
reference's wall clock the native runtime sustains the full protocol
(send/receive/merge/detect per node per round), and checks a crash is
still detected in t_fail rounds:

  python -m gossipfs_tpu_torch.native_rt
  python -m gossipfs_tpu_torch.native_rt --n 48 --period 0.004

Prints one JSON line {n, period_s, rounds, elapsed_s, rounds_per_sec,
vs_reference, detection_rounds}.  The port's copy of the JAX package's
``bench/native_rt.py`` (host code only).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def run(n: int = 32, period: float = 0.005, rounds: int = 200) -> dict:
    from gossipfs_tpu_torch.deploy.launcher import _free_port_base
    from gossipfs_tpu_torch.native import NativeUdpDetector

    # a free UDP window, never a fixed base: another cluster may be
    # running on this host
    cluster = NativeUdpDetector(n, base_port=_free_port_base(n, tcp=False),
                                period=period, fresh_cooldown=True)
    try:
        warm = 12  # converge membership + pass the hb grace
        cluster.advance(warm)
        victim = n // 2
        crash_round = cluster.round
        cluster.crash(victim)
        t0 = time.perf_counter()
        cluster.advance(rounds)
        elapsed = time.perf_counter() - t0
        events = [e for e in cluster.drain_events() if e.subject == victim]
        detection_rounds = (
            min(e.round for e in events) - crash_round if events else -1
        )
        rps = rounds / elapsed
        return {
            "n": n,
            "period_s": period,
            "rounds": rounds,
            "elapsed_s": round(elapsed, 3),
            "rounds_per_sec": round(rps, 1),
            # the reference's driver advances 1 round per wall-clock second
            "vs_reference": round(rps, 1),
            "detection_rounds": detection_rounds,
        }
    finally:
        cluster.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--period", type=float, default=0.005)
    p.add_argument("--rounds", type=int, default=200)
    args = p.parse_args(argv)
    print(json.dumps(run(n=args.n, period=args.period, rounds=args.rounds)))


if __name__ == "__main__":
    sys.exit(main())
