"""Time the headline program over the resident round's run-time choices.

The port of the JAX package's ``tools/sweep_rr.py``, which timed the
exact bench program (``run_rounds`` over tile-aligned ``random_arc``
fanout 16, ``arc_align`` 8, a ``pallas_rr`` merge with all-int8 lanes, 1 %
crash churn) across the Pallas kernel's TPU tiles, ``merge_block_c`` x
``merge_block_r``.  The port's K3 fixes its geometry when it is compiled
(ops/merge.py ``ONEPASS_BLOCKINGS``, ``ONEPASS_SMEM``; the two-launch
grid is sized inside csrc/resident_round.cu), so those two fields are
recorded in each row and ignored.  The points are the choices the port
has at run time: ``rr_resident`` "on" (K3's one-pass form (f), in the
blocking ``ops/merge.onepass_blocking`` picks: 8 x 32 to N = 19,264, 16 x
16 past it, so ``--n 65536`` runs it) and "off" (its two-launch form) x
``elementwise`` "lanes" and "swar".  Where the one-pass form does not
hold the shape (``--n 131072``, past N = 109,056 on aligned arcs), its
rows print ``ops/merge.onepass_refusal`` as ``skipped``, where the JAX
tool printed "no resident VMEM fit".

Each point runs the same program from the same seeded state, best of
``--reps`` runs (CUDA events around ``run_rounds`` on the card, set-up
not timed; the JAX tool's one-second pauses between runs were for a
shared TPU and are gone), and prints one JSON line: the JAX tool's
``block_c``, ``block_r``, ``ms_per_round`` and ``rounds_per_sec``, plus
the point, its route and launches, and ``digest``
(``utils/digest.tensors_digest``) of the final lanes, carry and every
per-round metric.  Every point that runs
must give the same digest: the last line is ``{"digests_equal": ...}``,
and the exit code is 1 where they differ.

    python -m gossipfs_tpu_torch.sweep_rr --rounds 100 --reps 4
    python -m gossipfs_tpu_torch.sweep_rr --n 65536 --rounds 10 --reps 1
    python -m gossipfs_tpu_torch.sweep_rr --n 131072 --rr-resident on
    python -m gossipfs_tpu_torch.sweep_rr --device cpu --n 512 --rounds 4 \\
        --reps 1
"""

from __future__ import annotations

import argparse
import itertools
import json

import torch

from gossipfs_tpu_torch.bench import timed_run
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core import rounds as R
from gossipfs_tpu_torch.ops import merge
from gossipfs_tpu_torch.utils.digest import tensors_digest

CRASH_RATE = 0.01
RESIDENT = ("on", "off")


def sweep_config(n: int, rr_resident: str, elementwise: str,
                 block_c: int = 2048, block_r: int = 512,
                 arc_align: int = 8, fanout: int = 16) -> SimConfig:
    """The JAX tool's configuration, field for field, at one point."""
    return SimConfig(
        n=n, topology="random_arc", fanout=fanout, arc_align=arc_align,
        remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
        merge_kernel="pallas_rr", merge_block_r=block_r,
        view_dtype="int8", merge_block_c=block_c, rr_resident=rr_resident,
        hb_dtype="int8", elementwise=elementwise)


def points(resident=RESIDENT, elementwise=merge.ELEMENTWISE) -> list:
    """The swept points: (rr_resident, elementwise)."""
    return list(itertools.product(resident, elementwise))


def refusal(n: int, rr_resident: str, elementwise: str, arc_align: int = 8,
            fanout: int = 16) -> str | None:
    """Why the point cannot run at ``n``: the one-pass form's refusal for
    ``rr_resident="on"`` (ops/merge.onepass_refusal), else None."""
    if rr_resident != "on":
        return None
    form = merge.kernel_form(fanout, arc_align)
    return merge.onepass_refusal(n, n, form, elementwise)


def run_digest(state, carry, metrics) -> str:
    """The digest (utils/digest.py) of a run's final lanes, alive,
    hb_base, carry and every per-round metric."""
    return tensors_digest([state.hb, state.asl, state.alive, state.hb_base,
                           *carry, *metrics])


def time_point(cfg: SimConfig, rounds: int, reps: int, device) -> dict:
    """Best of ``reps`` runs of ``rounds`` rounds from the seeded state:
    the seconds, the last run's digest, its route and launches."""
    timed_run(cfg, rounds, crash_rate=CRASH_RATE, device=device)  # warm-up
    best, digest = float("inf"), None
    for _ in range(reps):
        before = merge.launch_snapshot()
        sec, out = timed_run(cfg, rounds, crash_rate=CRASH_RATE,
                             device=device)
        best = min(best, sec)
        d = run_digest(*out)
        if digest is not None and d != digest:
            raise AssertionError(f"sweep_rr: two runs of one point differ "
                                 f"({digest} against {d})")
        digest = d
    _, forms = merge.launches_since(before)
    return {"seconds": best, "digest": digest,
            "route": R.route(cfg)[1], "launches": forms}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gossipfs_tpu_torch.sweep_rr",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=16_384)
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--rr-resident", nargs="*", choices=RESIDENT,
                   default=list(RESIDENT))
    p.add_argument("--elementwise", nargs="*", choices=merge.ELEMENTWISE,
                   default=list(merge.ELEMENTWISE))
    p.add_argument("--block-c", type=int, default=2048,
                   help="the JAX kernel's stripe width: recorded, ignored")
    p.add_argument("--block-r", type=int, default=512,
                   help="the JAX kernel's receiver block: recorded, ignored")
    p.add_argument("--arc-align", type=int, default=8)
    p.add_argument("--fanout", type=int, default=16)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.sweep_rr needs a CUDA device "
                         "(or --device cpu)")
    digests, ran, skipped = set(), 0, 0
    for resident, ew in points(args.rr_resident, args.elementwise):
        row = {"block_c": args.block_c, "block_r": args.block_r,
               "rr_resident": resident, "elementwise": ew}
        why = refusal(args.n, resident, ew, args.arc_align, args.fanout)
        if why is not None:
            print(json.dumps({**row, "skipped": why}), flush=True)
            skipped += 1
            continue
        cfg = sweep_config(args.n, resident, ew, args.block_c, args.block_r,
                           args.arc_align, args.fanout)
        r = time_point(cfg, args.rounds, args.reps, dev)
        digests.add(r["digest"])
        ran += 1
        print(json.dumps({
            **row,
            "ms_per_round": r["seconds"] / args.rounds * 1e3,
            "rounds_per_sec": args.rounds / r["seconds"],
            "route": r["route"], "launches": r["launches"],
            "digest": r["digest"], "device": (
                torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        }), flush=True)
    print(json.dumps({"digests_equal": len(digests) <= 1,
                      "points_run": ran, "points_skipped": skipped}))
    return 0 if len(digests) <= 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
