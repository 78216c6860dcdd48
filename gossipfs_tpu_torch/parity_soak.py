"""Parity soak: the lean loop against the separate-pass loop, bit for bit,
over a long crash-churn horizon (the twin of the JAX package's
``tools/parity_soak.py``).

The JAX tool holds its compiled resident-round kernel against the XLA
path.  Here the same configuration -- the aligned-arc headline profile
with a ``pallas_rr`` merge, all-int8 lanes, gossip-only dissemination and
fresh cooldown, 0.5 % crash churn -- runs from one seeded state through
both of the port's loops: the LEAN loop (``run_rounds``: K3, the resident
round, in its one-pass form (f) wherever ``rr_resident="auto"`` takes it,
else its two-launch form) and the SEPARATE-PASS loop (the round's torch
stages, then K4, the arc merge; under ``--scenario`` the masked group
form in torch ops, as the JAX package runs that case in XLA).  Two
independent kernel paths must agree on every lane (hb, age, status,
alive, hb_base), the whole carry and every per-round metric after
hundreds of rounds.

    python -m gossipfs_tpu_torch.parity_soak --rounds 300        # N = 16,384
    python -m gossipfs_tpu_torch.parity_soak --suspicion --scenario
    python -m gossipfs_tpu_torch.parity_soak --device cpu --n 512 \\
        --rounds 16 --elementwise swar --suspicion --scenario

One JSON line: the JAX tool's keys (each lane and metric's equality,
``all_equal``, ``total_detections``, ...) plus each path's seconds, its
route and its kernel launches; exit 1 unless ``all_equal``.  On the card
every launch is a kernel (a kernel that does not build or launch raises:
nothing falls back to the CPU or to a plain version); ``--device cpu``
runs the kernels' plain versions, as the CPU tests do.  The JAX tool's
``--block-c``, ``--block-r`` (Pallas tiling) and ``--interpret`` (its
CPU form, which ``--device cpu`` replaces) have no meaning here and are
gone.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core import rounds as R
from gossipfs_tpu_torch.core.state import init_state
from gossipfs_tpu_torch.ops import merge


def soak_config(n: int, fanout: int = 16, arc_align: int = 8,
                elementwise: str = "lanes",
                suspicion: bool = False) -> SimConfig:
    """The JAX tool's configuration, field for field: the headline arcs
    with a ``pallas_rr`` merge; ``suspicion`` arms the SWIM lifecycle at
    the fast knob (t_fail=3, t_suspect=2)."""
    kw = {}
    if suspicion:
        from gossipfs_tpu_torch.suspicion.params import SuspicionParams

        kw.update(t_fail=3, suspicion=SuspicionParams(t_suspect=2))
    return SimConfig(
        n=n, topology="random_arc", fanout=fanout, arc_align=arc_align,
        remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
        merge_kernel="pallas_rr", view_dtype="int8", rr_resident="auto",
        hb_dtype="int8", elementwise=elementwise, **kw)


def soak_scenario(n: int, rounds: int, device):
    """The JAX tool's scenario: a half/half partition from round 3 to
    max(rounds / 2, 8) and a stride-3 slow sender set of min(n / 16, 256)
    nodes for the whole horizon, compiled on ``device``."""
    from gossipfs_tpu_torch.scenarios import FaultScenario, Partition, SlowNode
    from gossipfs_tpu_torch.scenarios.tensor import compile_tensor

    return compile_tensor(FaultScenario(
        name="soak-split", n=n,
        partitions=(Partition(start=3, end=max(rounds // 2, 8),
                              groups=(tuple(range(n // 2)),)),),
        slow_nodes=(SlowNode(start=0, end=rounds, stride=3,
                             nodes=tuple(range(min(n // 16, 256)))),),
    ), device=device)


def _timed(device, fn):
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(device)
    launched = {k: v for k, v in merge.LAUNCH_COUNTS.items() if v}
    return out, time.perf_counter() - t0, launched


def soak(n: int = 16_384, rounds: int = 300, crash_rate: float = 0.005,
         arc_align: int = 8, fanout: int = 16, seed: int = 42,
         elementwise: str = "lanes", suspicion: bool = False,
         scenario: bool = False, device="cuda") -> dict:
    """Both loops from one seeded state; the JSON document."""
    cfg = soak_config(n, fanout, arc_align, elementwise, suspicion)
    scn = soak_scenario(n, rounds, device) if scenario else None
    kw = dict(crash_rate=crash_rate, scenario=scn)
    route = R.route(cfg, False, scn)
    if route[0] != "lean":
        raise ValueError(f"the soak's configuration does not take the lean "
                         f"loop: {route}")
    key = trandom.PRNGKey(seed, device=device)
    lean, lean_s, lean_launch = _timed(device, lambda: R.run_rounds(
        init_state(cfg, device=device), cfg, rounds, key, **kw))
    sep, sep_s, sep_launch = _timed(device, lambda: R._run_general(
        init_state(cfg, device=device), cfg, rounds, key, None, crash_rate,
        0.0, None, None, False, False, scn))
    (sl, cl, ml), (sg, cg, mg) = lean, sep
    eq = torch.equal
    checks = {
        "hb": eq(sl.hb, sg.hb),
        "age": eq(R._unpack(sl.asl)[1], R._unpack(sg.asl)[1]),
        "status": eq(R._unpack(sl.asl)[0], R._unpack(sg.asl)[0]),
        "alive": eq(sl.alive, sg.alive),
        "hb_base": eq(sl.hb_base, sg.hb_base),
        "first_detect": eq(cl.first_detect, cg.first_detect),
        "converged": eq(cl.converged, cg.converged),
        "true_detections": eq(ml.true_detections, mg.true_detections),
        "false_positives": eq(ml.false_positives, mg.false_positives),
    }
    if suspicion:
        checks.update({
            "first_suspect": eq(cl.first_suspect, cg.first_suspect),
            "suspects_entered": eq(ml.suspects_entered, mg.suspects_entered),
            "refutations": eq(ml.refutations, mg.refutations),
            "fp_suppressed": eq(ml.fp_suppressed, mg.fp_suppressed),
        })
    # beyond the JAX tool's keys: the whole carry and every metric
    checks["carry"] = all(eq(a, b) for a, b in zip(cl, cg))
    checks["metrics"] = all(eq(a, b) for a, b in zip(ml, mg))
    doc = {
        "n": n, "rounds": rounds, "arc_align": arc_align,
        "elementwise": elementwise, "kernel": cfg.merge_kernel,
        "suspicion": bool(suspicion), "scenario": bool(scenario),
        **checks,
        "all_equal": all(checks.values()),
        "total_detections": int(ml.true_detections.sum()),
    }
    if suspicion:
        doc["total_suspects"] = int(ml.suspects_entered.sum())
        doc["total_refutations"] = int(ml.refutations.sum())
    doc.update(device=str(device), route=route[1],
               separate_kernel=R.merge_kernel(cfg, scn is not None),
               lean_s=lean_s, separate_s=sep_s,
               lean_launches=lean_launch, separate_launches=sep_launch)
    return doc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gossipfs_tpu_torch.parity_soak",
        description="the lean loop (K3) against the separate-pass loop "
                    "(K4), bit for bit, over a crash-churn horizon")
    p.add_argument("--n", type=int, default=16_384)
    p.add_argument("--rounds", type=int, default=300)
    p.add_argument("--crash-rate", type=float, default=0.005)
    p.add_argument("--arc-align", type=int, default=8)
    p.add_argument("--fanout", type=int, default=16)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--elementwise", choices=("lanes", "swar"),
                   default="lanes",
                   help="elementwise form for BOTH loops (swar = packed "
                        "4-subject words: K3's SWAR kernel and the SWAR "
                        "tick of the separate-pass round)")
    p.add_argument("--suspicion", action="store_true",
                   help="arm the SWIM lifecycle at the fast knob "
                        "(t_fail=3, t_suspect=2) on BOTH loops, the "
                        "suspicion counters compared too")
    p.add_argument("--scenario", action="store_true",
                   help="arm a timed half/half partition + slow-sender "
                        "scenario on BOTH loops: K3's edge_filter form "
                        "against the separate-pass masked group form")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the kernels) or cpu (their plain "
                        "versions)")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.parity_soak needs a CUDA "
                         "device (or --device cpu)")
    doc = soak(args.n, args.rounds, args.crash_rate, args.arc_align,
               args.fanout, args.seed, args.elementwise, args.suspicion,
               args.scenario, device=dev)
    print(json.dumps(doc))
    return 0 if doc["all_equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
