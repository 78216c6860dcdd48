"""Per-round timing and bandwidth use of every merge route, on the card.

The port of the JAX package's ``bench/roundprof.py``:

    python -m gossipfs_tpu_torch.roundprof                  # N = 16,384
    python -m gossipfs_tpu_torch.roundprof --n 8192 --rounds 50
    python -m gossipfs_tpu_torch.roundprof --suspicion --n 2048
    python -m gossipfs_tpu_torch.roundprof --device cpu --n 256 --rounds 2

For each named configuration (the JAX package's names and ``SimConfig``
fields) this prints one JSON row: ms a round and rounds/s (each rep from
a fresh state, CUDA events around the ``run_rounds`` call, as
``bench.timed_run`` times it), the loop and kernel form
``core/rounds.route`` sends the configuration to, the kernel launches of
one run, and the bandwidth block: the bytes the round's kernels and torch
stages must move (:func:`round_bytes`), the achieved GB/s against the
card's HBM rate, and the protocol's information floor (4 N^2 bytes: each
entry's two bytes read once and written once), whose implied rate is the
ceiling of any round.  A lean row (the resident round K3) also times its
two-launch twin (``rr_resident="off"``) beside the one-pass form the
route picks.

The first line is a header (``obs/schema.ROUNDPROF_SCHEMA``) naming the
shape, the backend (``gpu`` / ``cpu``) and the device, so the artifact
reads back through ``python -m gossipfs_tpu_torch.obs.timeline``.
``--device cpu`` runs the plain versions on the host clock.

The JAX package admits its stripe and rr rows by its TPU tile limits
(``stripe_supported``), which the port does not carry.  Here the rows
exist where the port's own limits take them (K5's ``STRIPE_MAX_N``,
``core/rounds.route``, which refuses an ``rr_resident="on"`` row that
``ops/merge.onepass_fits`` does not hold) and where their 4,096-column
stripe field (``merge_block_c``, kept for equal fields) divides N: the
same row set as the JAX package's at N = 2,048 and 16,384.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from gossipfs_tpu_torch.bench import timed_run
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core import rounds as core_rounds
from gossipfs_tpu_torch.obs import schema as obs_schema
from gossipfs_tpu_torch.ops import merge, merge_update

# the JAX package's stripe width, kept as the stripe and rr rows'
# ``merge_block_c`` (the port ignores the field)
STRIPE_BLOCK_C = 4096
# HBM3 rate of the NVIDIA H100 SXM 80GB (data sheet), GB/s
HBM_PEAK_GBS = 3350.0
CRASH_RATE = 0.01


def base_config(n: int) -> SimConfig:
    return SimConfig(
        n=n,
        topology="random",
        fanout=SimConfig.log_fanout(n),
        remove_broadcast=False,
        fresh_cooldown=True,
        t_cooldown=12,
        merge_kernel="xla",
        view_dtype="int8",
        merge_block_c=16_384,
        hb_dtype="int16",
    )


def _route_ok(cfg: SimConfig) -> bool:
    """Whether ``core/rounds.route`` takes the configuration (it refuses
    an ``rr_resident="on"`` lean row the one-pass form cannot hold)."""
    try:
        core_rounds.route(cfg)
    except ValueError:
        return False
    return True


def _stripe_rows(n: int, cfg: SimConfig) -> dict[str, SimConfig]:
    out = {
        "pallas_stripe": dataclasses.replace(
            cfg, merge_kernel="pallas_stripe", merge_block_c=STRIPE_BLOCK_C),
        "arc_stripe": dataclasses.replace(
            cfg, topology="random_arc", merge_kernel="pallas_stripe",
            merge_block_c=STRIPE_BLOCK_C),
        "stripe_hb8": dataclasses.replace(
            cfg, merge_kernel="pallas_stripe", merge_block_c=STRIPE_BLOCK_C,
            hb_dtype="int8"),
        "arc_hb8": dataclasses.replace(
            cfg, topology="random_arc", merge_kernel="pallas_stripe",
            merge_block_c=STRIPE_BLOCK_C, hb_dtype="int8"),
        "arc_hb8_xla": dataclasses.replace(
            cfg, topology="random_arc", merge_kernel="xla", hb_dtype="int8"),
        "rr": dataclasses.replace(
            cfg, merge_kernel="pallas_rr", merge_block_c=STRIPE_BLOCK_C,
            hb_dtype="int8", merge_block_r=256),
        "rr_arc": dataclasses.replace(
            cfg, topology="random_arc", merge_kernel="pallas_rr",
            merge_block_c=STRIPE_BLOCK_C, hb_dtype="int8", merge_block_r=256),
        "rr_arc_resident": dataclasses.replace(
            cfg, topology="random_arc", merge_kernel="pallas_rr",
            merge_block_c=2048, hb_dtype="int8", merge_block_r=256,
            rr_resident="on"),
        # the headline: aligned arcs of 16, bench.py's exact config
        "rr_arc_al_resident": dataclasses.replace(
            cfg, topology="random_arc", fanout=16, arc_align=8,
            merge_kernel="pallas_rr", merge_block_c=2048, hb_dtype="int8",
            merge_block_r=512, rr_resident="on"),
    }
    out["rr_arc_al_resident_swar"] = dataclasses.replace(
        out["rr_arc_al_resident"], elementwise="swar")
    return out


def stripe_rows_admitted(n: int) -> bool:
    """Whether the stripe and rr rows exist at N (module docstring): K5
    takes their int8 view, their stripe field divides N, and the route
    takes every one of them."""
    if n % STRIPE_BLOCK_C or not merge_update.stripe_admits(n, "int8"):
        return False
    return all(_route_ok(c) for c in _stripe_rows(n, base_config(n)).values())


def variants(n: int) -> dict[str, SimConfig]:
    cfg = base_config(n)
    out = {
        "xla": cfg,
        "pallas_gather": dataclasses.replace(cfg, merge_kernel="pallas"),
        # all-int8 rounds, lanes vs SWAR packed-word elementwise
        "xla_hb8": dataclasses.replace(cfg, hb_dtype="int8"),
        "xla_hb8_swar": dataclasses.replace(
            cfg, hb_dtype="int8", elementwise="swar"),
    }
    if stripe_rows_admitted(n):
        out.update(_stripe_rows(n, cfg))
    return out


def suspicion_variants(n: int, interpret: bool = True) -> dict[str, SimConfig]:
    """Suspicion on against off on the same kernel configuration: the
    separate-pass SWAR pair and the resident-round pair.  ``interpret``
    (the JAX package's default, kept for equal fields) names its
    interpret kernel in ``merge_kernel``; the port runs the same CUDA
    kernel either way, and the CLI names ``pallas_rr``."""
    from gossipfs_tpu_torch.suspicion import SuspicionParams

    sus = SuspicionParams(t_suspect=2)
    xla = dataclasses.replace(
        base_config(n), hb_dtype="int8", elementwise="swar", t_fail=3,
    )
    rr = SimConfig(
        n=n, topology="random_arc", fanout=-(-SimConfig.log_fanout(n) // 8) * 8,
        arc_align=8, remove_broadcast=False, fresh_cooldown=True,
        t_cooldown=12, t_fail=3,
        merge_kernel="pallas_rr_interpret" if interpret else "pallas_rr",
        merge_block_c=min(2048, n // 2), view_dtype="int8", hb_dtype="int8",
        merge_block_r=128, rr_resident="on", elementwise="swar",
    )
    return {
        "xla_swar": xla,
        "xla_swar_sus": dataclasses.replace(xla, suspicion=sus),
        "rr_swar": rr,
        "rr_swar_sus": dataclasses.replace(rr, suspicion=sus),
    }


def round_bytes(cfg: SimConfig) -> dict:
    """Bytes a round of ``cfg`` must move through HBM, by phase, on the
    route ``core/rounds.route`` gives it.

    Like the bound column of the kernel table (``PERF.md``), each phase
    counts its inputs read once and its outputs written once, and only the
    ``[N, N]`` traffic (per-subject vectors and edges are O(N F)):

    * ``floor``: the protocol's information floor, each entry's two bytes
      (hb int8 and the packed age|status byte) read once and written once,
      4 N^2 bytes, the same for every row;
    * the lean loop (K3): ``view_build_read`` (both packed lanes),
      ``receiver_read`` (the two-launch form reads them again; the
      one-pass form parks its rows in shared memory: 0), ``lane_write``,
      and ``recv_count_side``, its four int32 ``[N]`` count outputs;
    * the separate-pass loop: ``tick_view_pass`` (the torch tick reads
      and writes the hb and packed lanes, the view build writes the
      view), ``merge_kernel`` (K2, K4 or K5: the view read once, the lanes
      read and written) and ``member_count_pass`` (the pre-tick count
      reads the packed byte).
    """
    n = cfg.n
    nn = n * n
    hb_b = {"int32": 4, "int16": 2, "int8": 1}[cfg.hb_dtype]
    view_b = {"int32": 4, "int16": 2, "int8": 1}[cfg.view_dtype]
    floor = 2 * nn * 2
    loop, form = core_rounds.route(cfg)
    if loop == "lean":
        packed = nn * 2
        phases = {
            "view_build_read": packed,
            "receiver_read": 0 if form.endswith("/onepass") else packed,
            "lane_write": packed,
            "recv_count_side": 4 * 4 * n,
        }
    else:
        lanes_rw = nn * (hb_b + 1)  # hb + the packed age|status byte
        phases = {
            "tick_view_pass": 2 * lanes_rw + nn * view_b,
            "merge_kernel": nn * view_b + 2 * lanes_rw,
            "member_count_pass": nn,
        }
    return {"phases": phases, "total": sum(phases.values()), "floor": floor}


def bandwidth_row(cfg: SimConfig, seconds_per_round: float) -> dict:
    b = round_bytes(cfg)
    gbs = b["total"] / seconds_per_round / 1e9
    floor_s = b["floor"] / (HBM_PEAK_GBS * 1e9)
    return {
        "modeled_bytes_per_round": b["total"],
        "achieved_gb_per_s": gbs,
        "pct_of_peak_hbm": 100.0 * gbs / HBM_PEAK_GBS,
        "floor_bytes_per_round": b["floor"],
        "floor_implied_ceiling_rounds_per_sec": 1.0 / floor_s,
        "phase_bytes": b["phases"],
    }


def time_config(cfg: SimConfig, rounds: int, reps: int = 3,
                device="cuda", warm: int | None = None
                ) -> tuple[float, dict, dict]:
    """Best seconds a round over ``reps`` runs, each from a fresh state
    (``bench.timed_run``: the lanes move in place), after one warm-up
    run of ``warm`` rounds (default ``rounds``); with the kernel launches
    and the resident round's forms of one run."""
    timed_run(cfg, warm or rounds, crash_rate=CRASH_RATE, device=device)
    before = merge.launch_snapshot()
    best = float("inf")
    for _ in range(reps):
        sec, _ = timed_run(cfg, rounds, crash_rate=CRASH_RATE, device=device)
        best = min(best, sec)
    launches, forms = merge.launches_since(before)
    one = {k: v // reps for k, v in launches.items()}
    return best / rounds, one, {k: v // reps for k, v in forms.items()}


def profile_row(name: str, cfg: SimConfig, rounds: int, device,
                backend: str, reps: int = 3, warm: int | None = None
                ) -> dict:
    """One row of the table (module docstring), best of ``reps`` after a
    warm-up run of ``warm`` rounds."""
    per_round, launches, forms = time_config(cfg, rounds, reps, device,
                                             warm)
    row = {
        "config": name, "n": cfg.n,
        "ms_per_round": per_round * 1e3,
        "rounds_per_sec": 1.0 / per_round,
        "elementwise": cfg.elementwise,
        "rr_rotate": cfg.rr_rotate,
        "merge_kernel": cfg.merge_kernel,
        "suspicion": cfg.suspicion is not None,
        "backend": backend,
        "route": list(core_rounds.route(cfg)),
        "launches": launches,
        "forms": forms,
        **bandwidth_row(cfg, per_round),
    }
    if row["route"][0] == "lean":
        off = dataclasses.replace(cfg, rr_resident="off")
        sec, launches, forms = time_config(off, rounds, reps, device, warm)
        row["two_launch"] = {
            "ms_per_round": sec * 1e3, "route": list(core_rounds.route(off)),
            "launches": launches, "forms": forms,
            **bandwidth_row(off, sec)}
    return row


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=16_384)
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--only", nargs="*", default=None)
    p.add_argument("--suspicion", action="store_true",
                   help="suspicion on against off on the same kernel "
                        "configuration (the separate-pass SWAR pair and "
                        "the resident-round pair)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.roundprof needs a CUDA device "
                         "(or --device cpu)")
    backend = "gpu" if on_card else "cpu"
    print(json.dumps({
        "schema": obs_schema.ROUNDPROF_SCHEMA, "tool": "roundprof",
        "n": args.n, "rounds": args.rounds,
        **({"mode": "suspicion_ab"} if args.suspicion else {}),
        "backend": backend,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "hbm_peak_gb_per_s": HBM_PEAK_GBS,
    }), flush=True)
    table = (suspicion_variants(args.n, interpret=False)
             if args.suspicion else variants(args.n))
    rows = []
    for name, cfg in table.items():
        if args.only and name not in args.only:
            continue
        rows.append(profile_row(name, cfg, args.rounds, dev, backend))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
