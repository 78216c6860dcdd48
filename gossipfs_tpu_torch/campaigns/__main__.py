"""Adversarial campaign CLI — sweep/bisect scenario space with the
streaming monitor as the oracle (gossipfs_tpu_torch/campaigns/).

The port's twin of the JAX package's campaign CLI, with every mode, run
as ``python -m gossipfs_tpu_torch.campaigns``.  The tensor side (replays,
sweeps, surfaces) runs on ``--device`` (default ``cuda``, the card;
without one it exits unless ``--device cpu``); the socket engines are
host code.

    # grid-sweep a severity axis, ledger every verdict
    python -m gossipfs_tpu_torch.campaigns --family flap --n 256 \
        --t-fail 3 --values 2 3 4 5 6 --ledger CAMPAIGN.jsonl

    # bisect to the exact breaking point, commit it as a regression case
    python -m gossipfs_tpu_torch.campaigns --family flap --n 256 \
        --t-fail 3 --bisect 1 10 --ledger CAMPAIGN.jsonl \
        --commit regressions/flap_storm_n256.json

    # replay a committed case (the tier-1 smoke's command form)
    python -m gossipfs_tpu_torch.campaigns \
        --case regressions/flap_storm_n256.json

    # the SAME case over a REAL-SOCKET engine, verdict required to agree
    # with the tensor replay (campaigns/engines.py; --scale-n re-makes
    # campaign-family cases at a socket-budget cohort).  The native
    # C++ epoll engine is the COHORT-EXACT lane: committed n=256 cases
    # run at their committed n (the asyncio loop melts past n~64)
    python -m gossipfs_tpu_torch.campaigns \
        --case regressions/outage_storm_n256.json --engine udp
    python -m gossipfs_tpu_torch.campaigns \
        --case regressions/outage_storm_n256.json --engine native
    python -m gossipfs_tpu_torch.campaigns \
        --case regressions/flap_storm_n256.json --engine deploy --scale-n 8

    # a case pair over one engine (the verify_claims `native_cohort`
    # claim: the committed storm + its absorption twin must reproduce
    # their pre/post-fix verdicts over the native transport)
    python -m gossipfs_tpu_torch.campaigns --engine native \
        --pair regressions/outage_storm_n256.json \
               regressions/outage_absorbed_n256.json

    # the three-engine verdict matrix over every committed case
    # (NATIVECAMPAIGN_r16.json is the committed artifact of this)
    python -m gossipfs_tpu_torch.campaigns --matrix \
        --out NATIVECAMPAIGN_r16.json

    # map the Lifeguard local-health knob surface vs correlated outages
    # (LOCALHEALTH_r14.json is the committed artifact of this command)
    python -m gossipfs_tpu_torch.campaigns --surface --n 256 \
        --t-fail 2 --t-suspect 3 --sizes 2 8 16 \
        --lh-point 4:0.015625 --lh-point 8:0.015625 \
        --crash-at 10 12 20 --out LOCALHEALTH_r14.json

    # re-verify a committed surface's chosen absorption point
    # (the verify_claims.py `outage_absorption` claim's command)
    python -m gossipfs_tpu_torch.campaigns \
        --absorption LOCALHEALTH_r14.json

Families and their severity axes: ``campaigns.FAMILIES`` (flap/down,
loss/rate_pct, partition/split_len, outage/size).  Extra fixed knobs
ride ``--knob k=v``; the Lifeguard local-health knobs ride
``--lh-multiplier`` / ``--lh-frac`` (campaign axes since round 14).
The ledger is a ``gossipfs-obs/v1`` stream (header + ``campaign_verdict``
rows) — ``python -m gossipfs_tpu_torch.obs.timeline`` ingests it unchanged.  Prints ONE JSON
document; exit 0 iff the requested action succeeded (a sweep/bisect
that found breaking points still exits 0 — finding them is the job;
--case exits nonzero when NOT reproduced, --absorption when NOT
absorbed).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

# the directory holding the package: the regression cases live there, and
# a child interpreter finds the package through it from any cwd
_REPO = pathlib.Path(__file__).resolve().parents[2]


def _parse_lh_points(specs):
    pts = []
    for s in specs:
        m, _, f = s.partition(":")
        pts.append((int(m), float(f)))
    return pts


def _surface(args) -> dict:
    from gossipfs_tpu_torch import campaigns

    pts = _parse_lh_points(args.lh_point or ["4:0.015625"])
    sizes = args.sizes or [2, 8, 16]
    probe_models = {}
    for ca in (args.crash_at or [10]):
        probe_models[str(ca)] = campaigns.knob_surface(
            args.n, sizes, pts, t_fail=args.t_fail,
            t_suspect=args.t_suspect, seed=args.seed, track=args.track,
            crash_at=ca, device=args.device,
        )
    # auto-pick the committed point: the smallest absorbed rack, least
    # stretch, coarsest threshold — tie-broken toward the earliest
    # probe model (the hardest one the point still absorbs under)
    chosen = None
    for ca in sorted(probe_models, key=int):
        for r in probe_models[ca]["rows"]:
            if not r["absorbed"]:
                continue
            key = (r["size"], r["lh_multiplier"], -r["lh_frac"], int(ca))
            if chosen is None or key < chosen[0]:
                chosen = (key, ca, r)
    doc = {
        "schema": "gossipfs-localhealth/v1",
        "n": args.n, "t_fail": args.t_fail, "t_suspect": args.t_suspect,
        "sizes": sizes,
        "lh_points": [{"lh_multiplier": m, "lh_frac": f}
                      for (m, f) in pts],
        "probe_models": probe_models,
        "chosen": None if chosen is None else {
            "crash_at": int(chosen[1]),
            **{k: chosen[2][k] for k in
               ("size", "lh_multiplier", "lh_frac", "outage", "quiet",
                "ttd_growth_outage", "ttd_growth_quiet", "absorbed")},
        },
        "command": ("python -m gossipfs_tpu_torch.campaigns --surface --n %d "
                    "--t-fail %d --t-suspect %d --seed %d --track %d "
                    "--sizes %s %s --crash-at %s" % (
                        args.n, args.t_fail, args.t_suspect, args.seed,
                        args.track,
                        " ".join(str(s) for s in sizes),
                        " ".join(f"--lh-point {m}:{f}" for m, f in pts),
                        " ".join(str(c) for c in (args.crash_at or [10])),
                    )),
    }
    return doc


def _absorption(path, device) -> dict:
    """Re-run a committed surface's CHOSEN point (baselines included)
    and re-evaluate the absorption predicate from fresh runs — the
    ``outage_absorption`` claim."""
    from gossipfs_tpu_torch import campaigns

    art = json.loads(open(path).read())
    ch = art.get("chosen")
    if not ch:
        return {"absorbed": False, "error": f"{path} has no chosen point"}
    # re-run with the COMMITTED point's full run knobs — the chosen
    # probe model records seed/track/rounds, and defaulting them here
    # would re-verify different experiments than the artifact's
    probe = art["probe_models"][str(ch["crash_at"])]
    fresh = campaigns.knob_surface(
        art["n"], [ch["size"]],
        [(ch["lh_multiplier"], ch["lh_frac"])],
        t_fail=art["t_fail"], t_suspect=art["t_suspect"],
        crash_at=ch["crash_at"], seed=probe.get("seed", 0),
        track=probe.get("track", 4), rounds=probe.get("rounds", 35),
        length=probe["outage"]["length"], start=probe["outage"]["start"],
        device=device,
    )
    row = fresh["rows"][0]
    return {
        "claim": "outage_absorption",
        "artifact": path,
        "absorbed": bool(row["absorbed"]),
        "chosen": {k: ch[k] for k in ("size", "lh_multiplier", "lh_frac",
                                      "crash_at")},
        "outage": row["outage"],
        "quiet": row["quiet"],
        "ttd_growth_outage": row["ttd_growth_outage"],
        "ttd_growth_quiet": row["ttd_growth_quiet"],
        "fpr_floor": fresh["fpr_floor"],
        "baseline_t5_outage": fresh["baselines"]["t5_outage"][
            str(ch["size"])],
    }


def _engine_cell(out: dict) -> dict:
    """One verdict-matrix cell from a run_case_engine result."""
    cell = {
        "n": out["n"],
        "scaled_from": out.get("scaled_from"),
        "verdict": out["engine_verdict"],
        # the tensor replay this row's agreement was judged against —
        # for a rescaled row that is the SCALED doc's replay, not the
        # committed-cohort one in the case's `tensor` column
        "tensor_reference_verdict": out["tensor_verdict"],
        "reproduced": out["reproduced"],
        "agreement": out["agreement"],
    }
    row = out.get("engine_row") or {}
    if "period" in row:
        cell["period"] = row["period"]
    if "tick_ms" in row:
        cell["tick_ms"] = row["tick_ms"]
    return cell


def _pair(args) -> dict:
    """Two committed cases through ONE engine — the storm/absorption
    pre/post-fix pair the `native_cohort` claim re-runs: both must
    reproduce their committed verdicts AND agree with the tensor
    replay per invariant."""
    from gossipfs_tpu_torch.campaigns.engines import run_case_engine

    cases = {}
    ok = True
    for path in args.pair:
        out = run_case_engine(path, engine=args.engine,
                              scale_n=args.scale_n, period=args.period,
                              device=args.device)
        cases[os.path.basename(path)] = {
            "expect": out["expect"],
            "tensor_verdict": out["tensor_verdict"],
            "engine": _engine_cell(out),
        }
        ok = ok and out["reproduced"]
    return {"claim": "case_pair", "engine": args.engine,
            "reproduced": ok, "cases": cases}


def _child(argv: list[str]) -> dict:
    """Run this CLI in a fresh interpreter and parse its JSON line."""
    import subprocess

    cmd = [sys.executable, "-m", "gossipfs_tpu_torch.campaigns", *argv]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_REPO), env.get("PYTHONPATH")) if p)
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=1800, env=env)
    for line in reversed(out.stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"no JSON from {cmd}: {out.stdout[-300:]}\n"
                       f"{out.stderr[-300:]}")


def _case_subprocess(path, engine: str, scale_n: int | None,
                     period: float | None, device: str) -> dict:
    """One engine row in a FRESH interpreter.  The real-time lanes are
    load-sensitive by physics (wall-clock staleness), and a matrix run
    accumulates in-process state — tensors from the tensor replays,
    GC pressure, event-loop residue — that measurably starves a
    subsequent socket run (observed: the committed udp twin flipping
    violated inside a long matrix process, passing standalone).
    Subprocess isolation makes every cell the same experiment the
    standalone `--case` command runs.  The child gets ``--device``: its
    tensor replay runs there, before its socket engine starts."""
    argv = ["--case", str(path), "--engine", engine, "--device", device]
    if scale_n is not None:
        argv += ["--scale-n", str(scale_n)]
    if period is not None:
        argv += ["--period", str(period)]
    return _child(argv)


def _gossip_cases() -> list:
    """The committed gossip campaign cases, as (path, doc): the socket
    engines replay those.  ``regressions/`` also holds a conformance
    schedule and a traffic-plane case, which no socket engine replays
    (the JAX package's CLI reads every file there and stops at the
    first of them)."""
    from gossipfs_tpu_torch.campaigns.driver import CASE_SCHEMA

    out = []
    for path in sorted((_REPO / "regressions").glob("*.json")):
        doc = json.loads(path.read_text(encoding="utf-8"))
        if doc.get("schema") == CASE_SCHEMA and "traffic" not in doc:
            out.append((path, doc))
    return out


def _matrix(args) -> dict:
    """The three-engine verdict matrix over every committed regression
    case (the NATIVECAMPAIGN_r16.json artifact): tensor at the
    committed n (the reference), native COHORT-EXACT at the committed
    n, udp at the committed n when it fits the asyncio cohort budget
    and scale_case-rescaled otherwise.  Every engine cell runs in its
    own subprocess (see _case_subprocess).  Agreement is required per
    invariant both engines checked; `all_agree` summarizes the matrix.
    """
    from gossipfs_tpu_torch import campaigns

    cases = {}
    all_agree = True
    native_cohort_max = 0
    rescale_boundaries = []
    for path, doc in _gossip_cases():
        n = int(doc["config"]["n"])
        nat = _case_subprocess(path, "native", None, args.period,
                               args.device)
        scale = None if n <= args.udp_budget else args.udp_budget
        udp = _case_subprocess(path, "udp", scale, args.period, args.device)
        row = {
            "n": n,
            "family": doc.get("family"),
            "expect": doc["expect"],
            # the tensor replay of the committed doc (deterministic —
            # the native lane runs it cohort-exact)
            "tensor": {"verdict": nat["tensor_verdict"],
                       "reproduced": nat["tensor_verdict"]
                       == doc["expect"]["verdict"]},
            "native": _engine_cell(nat),
            "udp": _engine_cell(udp),
        }
        cases[path.name] = row
        udp_ok = udp["reproduced"]
        if not udp_ok and udp.get("scaled_from") is not None:
            # rescale boundaries, caught in-matrix — the reason the
            # cohort-exact native lane exists.  Two known classes:
            # (a) scaled_reference_flips (the round-14 knife-edge): the
            #     SCALED tensor replay flips its verdict while the
            #     socket engine still shows the committed-cohort
            #     behavior ("the absorption knife-edge is cohort-sized
            #     — the case does not simply rescale"; the committed
            #     engine-calibrated twin outage_absorbed_udp_n64.json
            #     exists for exactly this);
            # (b) knee_at_boundary: a BISECTED breaking point rescaled
            #     onto a jittered real-time transport sits at the
            #     boundary by construction (the knee is the MINIMUM
            #     violating severity on synchronous tensor rounds;
            #     receipt-stamping slack is ~one FP per window —
            #     measured worst windows 0.7-1.3x threshold across
            #     runs of the scaled flap knee).
            # Both are recorded findings, not matrix failures: the
            # binding all-invariant agreement for these cases is their
            # COHORT-EXACT native row.  Anything else (e.g. a scaled
            # mild case storming) still fails the matrix.
            reason = None
            if udp["engine_verdict"] == doc["expect"]["verdict"]:
                reason = "scaled_reference_flips"
            elif (doc.get("axis_value") is not None
                  and doc["expect"]["verdict"] == "violated"
                  and set(udp["agreement"]["mismatched"])
                  <= set(doc["expect"].get("invariants", []))):
                reason = "knee_at_boundary"
            if reason is not None:
                rescale_boundaries.append({
                    "case": path.name,
                    "reason": reason,
                    "scaled_to": udp["n"],
                    "mismatched": udp["agreement"]["mismatched"],
                    "engine_verdict": udp["engine_verdict"],
                    "scaled_tensor_verdict": udp["tensor_verdict"],
                    "committed_expect": doc["expect"]["verdict"],
                })
                udp_ok = True
        all_agree = all_agree and nat["reproduced"] and udp_ok
        if nat["reproduced"]:
            native_cohort_max = max(native_cohort_max, n)
    return {
        "schema": "gossipfs-nativecampaign/v1",
        "metric": "three-engine (tensor/udp/native) campaign verdict "
                  "matrix over every committed regression case; native "
                  "runs are cohort-exact at the committed n, udp rows "
                  "above the asyncio budget are scale_case-rescaled "
                  "(agreement judged vs the scaled tensor replay; "
                  "known rescale-boundary classes — a scaled reference "
                  "that itself flips verdict, a bisected knee sitting "
                  "at the threshold on a jittered transport — land in "
                  "rescale_boundaries with the cohort-exact native row "
                  "as the binding agreement)",
        "engines": ["tensor", "udp", "native"],
        "udp_budget": args.udp_budget,
        "native_cohort_max_n": native_cohort_max,
        "all_agree": all_agree,
        "rescale_boundaries": rescale_boundaries,
        "cases": cases,
        "command": "python -m gossipfs_tpu_torch.campaigns --matrix "
                   "--udp-budget %d"
                   % args.udp_budget,
    }


def _ab_cell_subprocess(n: int, delta: int, loops: int, rounds: int,
                        period: float | None) -> dict:
    """One A/B cell in a FRESH interpreter (same isolation rationale
    as _case_subprocess — the cells are real-time measurements).  An
    A/B cell runs the native engine only: the child never opens the
    card."""
    argv = ["--ab-cell", str(n), "--ab-delta", str(delta),
            "--ab-cell-loops", str(loops), "--ab-rounds", str(rounds)]
    if period is not None:
        argv += ["--period", str(period)]
    return _child(argv)


def _ab(args) -> dict:
    """The delta-piggyback A/B grid (full-list vs delta x k epoll
    loops x cohort sizes) on the native engine: bytes/round and the
    per-round tick latency, quiet cluster, both arms at the same
    fanout.  ``ok`` requires (a) the delta arm's payload reduction at
    the LARGEST n to reach --ab-target on some loop count, (b) every
    delta cell's p50 tick inside the lane's period budget
    (native_period(n)), and (c) zero false positives in every cell —
    the honesty check that the bytes saved did not come out of
    correctness."""
    from gossipfs_tpu_torch.campaigns.engines import native_period

    cells = []
    for n in args.ab_ns:
        for loops in args.ab_loop_grid:
            for delta in (0, 1):
                cells.append(_ab_cell_subprocess(
                    n, delta, loops, args.ab_rounds, args.period))
    by = {(c["n"], c["loops"], bool(c["delta"])): c for c in cells}
    reduction = {}
    p50_tick_ms = {}
    for n in args.ab_ns:
        for k in args.ab_loop_grid:
            full, dl = by[(n, k, False)], by[(n, k, True)]
            key = f"n{n}_k{k}"
            reduction[key] = (full["wire"]["bytes_per_round"]
                              / dl["wire"]["bytes_per_round"])
            p50_tick_ms[key] = {"full": full["tick_ms"]["p50_ms"],
                                "delta": dl["tick_ms"]["p50_ms"]}
    n_max = max(args.ab_ns)
    headline = max(reduction[f"n{n_max}_k{k}"]
                   for k in args.ab_loop_grid)
    budget_ms = {n: native_period(n) * 1000.0 for n in args.ab_ns}
    p50_ok = all(
        by[(n, k, True)]["tick_ms"]["p50_ms"] <= budget_ms[n]
        for n in args.ab_ns for k in args.ab_loop_grid)
    fp_ok = all(c["false_positives"] == 0 for c in cells)
    doc = {
        "schema": "gossipfs-delta-ab/v1",
        "metric": "full-list vs delta-piggyback wire payload and tick "
                  "latency on the native engine, k epoll loops, quiet "
                  "cluster, both arms at identical fanout",
        "ns": args.ab_ns, "loop_grid": args.ab_loop_grid,
        "rounds": args.ab_rounds,
        "cells": cells,
        "bytes_reduction": reduction,
        "p50_tick_ms": p50_tick_ms,
        "p50_budget_ms": {str(n): budget_ms[n] for n in args.ab_ns},
        "headline_reduction": headline,
        "target_reduction": args.ab_target,
        "zero_false_positives": fp_ok,
        "p50_within_budget": p50_ok,
        "ok": headline >= args.ab_target and p50_ok and fp_ok,
    }
    if args.ab_udp_case:
        u = _case_subprocess(args.ab_udp_case, "udp", None, args.period,
                             args.device)
        wire = (u.get("engine_row") or {}).get("wire")
        doc["udp_slice"] = {
            "case": os.path.basename(args.ab_udp_case),
            "reproduced": u["reproduced"],
            "verdict": u["engine_verdict"],
            "agreement": u["agreement"],
            "wire": wire,
        }
        doc["ok"] = doc["ok"] and u["reproduced"] \
            and bool(wire and wire["frames_delta"] > 0)
    return doc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--family", choices=None, default=None,
                   help="scenario family (campaigns.FAMILIES)")
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--t-fail", type=int, default=5)
    p.add_argument("--t-suspect", type=int, default=0,
                   help="arm the SWIM lifecycle at this suspect window "
                        "(0 = raw)")
    p.add_argument("--lh-multiplier", type=int, default=0,
                   help="Lifeguard local-health stretch multiplier "
                        "(needs --t-suspect; a campaign axis since "
                        "round 14)")
    p.add_argument("--lh-frac", type=float, default=0.25,
                   help="local-health degradation threshold (fraction "
                        "of listed peers simultaneously SUSPECT; use "
                        "exact binary fractions)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--track", type=int, default=4,
                   help="tracked crashes per run (TTD/reconvergence "
                        "probes)")
    p.add_argument("--fault-rounds", type=int, default=24,
                   help="how long the family's fault window stays armed")
    p.add_argument("--values", type=int, nargs="+", default=None,
                   help="grid-sweep these severity-axis values")
    p.add_argument("--bisect", type=int, nargs=2, metavar=("LO", "HI"),
                   default=None,
                   help="bisect the severity axis over [LO, HI] to the "
                        "smallest violating value")
    p.add_argument("--knob", action="append", default=[],
                   metavar="K=V", help="fix a family knob (repeatable)")
    p.add_argument("--ledger", type=str, default=None,
                   help="write the campaign ledger JSONL here")
    p.add_argument("--commit", type=str, default=None,
                   help="commit the confirmed breaking point as a "
                        "regression case file at this path")
    p.add_argument("--case", type=str, default=None,
                   help="replay a committed regression case instead of "
                        "running a campaign")
    p.add_argument("--engine", choices=("tensor", "udp", "deploy",
                                        "native"),
                   default="tensor",
                   help="engine for --case/--pair replays: tensor "
                        "(default), udp (asyncio real sockets), deploy "
                        "(one OS process per node), native (C++ epoll — "
                        "the cohort-exact lane) — socket verdicts must "
                        "agree with the tensor replay")
    p.add_argument("--pair", type=str, nargs=2, default=None,
                   metavar=("CASE_A", "CASE_B"),
                   help="replay TWO committed cases through --engine "
                        "(the storm/absorption pre/post-fix pair; exit "
                        "0 iff both reproduce)")
    p.add_argument("--matrix", action="store_true",
                   help="run every committed regressions/ case through "
                        "tensor+udp+native and emit the verdict-matrix "
                        "artifact (NATIVECAMPAIGN_r16.json)")
    p.add_argument("--udp-budget", type=int, default=64,
                   help="--matrix: cohort budget for the asyncio lane — "
                        "bigger committed cases are scale_case-rescaled "
                        "to it (the native lane always runs cohort-"
                        "exact)")
    p.add_argument("--scale-n", type=int, default=None,
                   help="re-make a campaign-family case at this cohort "
                        "size before replaying (the deploy lane's "
                        "process budget; campaigns/engines.scale_case)")
    p.add_argument("--period", type=float, default=None,
                   help="socket-engine heartbeat period in seconds")
    p.add_argument("--trace", type=str, default=None,
                   help="keep the socket engine's recorded obs stream "
                        "at this path")
    p.add_argument("--surface", action="store_true",
                   help="map the local-health knob surface vs "
                        "correlated outages (campaigns.knob_surface)")
    p.add_argument("--sizes", type=int, nargs="+", default=None,
                   help="--surface: outage sizes")
    p.add_argument("--lh-point", action="append", default=None,
                   metavar="M:FRAC",
                   help="--surface: a (lh_multiplier, lh_frac) point "
                        "(repeatable)")
    p.add_argument("--crash-at", type=int, nargs="+", default=None,
                   help="--surface: tracked-probe crash rounds to map "
                        "(the probe model is a load-bearing axis — see "
                        "campaigns.knob_surface on the heal race)")
    p.add_argument("--out", type=str, default=None,
                   help="--surface/--matrix: write the artifact here too")
    p.add_argument("--absorption", type=str, default=None, metavar="ART",
                   help="re-verify a committed surface artifact's "
                        "chosen point (the outage_absorption claim)")
    p.add_argument("--ab", action="store_true",
                   help="delta-piggyback A/B grid on the native engine "
                        "(full vs delta x --ab-loop-grid x --ab-ns); "
                        "with --matrix, both land in one cohort "
                        "artifact (COHORT_r20.json)")
    p.add_argument("--ab-ns", type=int, nargs="+",
                   default=[256, 512, 1024],
                   help="--ab: cohort sizes")
    p.add_argument("--ab-loop-grid", type=int, nargs="+", default=[1, 4],
                   help="--ab: epoll loop counts (gfs_configure loops=k)")
    p.add_argument("--ab-rounds", type=int, default=24,
                   help="--ab: measured steady-state rounds per cell")
    p.add_argument("--ab-target", type=float, default=4.0,
                   help="--ab: required bytes/round reduction at the "
                        "largest --ab-ns")
    p.add_argument("--ab-udp-case", type=str, default=None,
                   help="--ab: also replay this committed delta case "
                        "on the udp engine (the delta_cohort claim's "
                        "verdict-agreement slice)")
    p.add_argument("--ab-cell", type=int, default=None, metavar="N",
                   help=argparse.SUPPRESS)
    p.add_argument("--ab-delta", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--ab-cell-loops", type=int, default=1,
                   help=argparse.SUPPRESS)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the tensor side runs (replays, sweeps, "
                        "surfaces): cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.ab_cell:
        # the native engine alone: no tensor side, no device check
        from gossipfs_tpu_torch.campaigns.engines import run_ab_cell

        out = run_ab_cell(args.ab_cell, delta=bool(args.ab_delta),
                          loops=args.ab_cell_loops,
                          rounds=args.ab_rounds, period=args.period)
        print(json.dumps(out))
        return 0

    import torch

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.campaigns needs a CUDA device "
                         "(or --device cpu)")

    from gossipfs_tpu_torch import campaigns

    if args.absorption:
        out = _absorption(args.absorption, args.device)
        print(json.dumps(out))
        return 0 if out["absorbed"] else 1

    if args.surface:
        out = _surface(args)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
                f.write("\n")
        print(json.dumps(out))
        return 0

    if args.ab and args.matrix:
        # the round-20 cohort artifact: the three-engine verdict matrix
        # (n=1024 cohort-exact included) + the delta A/B perf grid
        matrix = _matrix(args)
        ab = _ab(args)
        out = {
            "schema": "gossipfs-cohort/v1",
            "matrix": matrix,
            "ab": ab,
            "all_agree": matrix["all_agree"],
            "native_cohort_max_n": matrix["native_cohort_max_n"],
            "headline_reduction": ab["headline_reduction"],
            "ok": matrix["all_agree"] and ab["ok"],
            "command": ("python -m gossipfs_tpu_torch.campaigns --matrix --ab "
                        "--ab-ns %s --out COHORT_r20.json"
                        % " ".join(str(n) for n in args.ab_ns)),
        }
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
                f.write("\n")
        print(json.dumps({k: out[k] for k in
                          ("schema", "all_agree", "native_cohort_max_n",
                           "headline_reduction", "ok")}))
        return 0 if out["ok"] else 1

    if args.ab:
        out = _ab(args)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
                f.write("\n")
        print(json.dumps(out))
        return 0 if out["ok"] else 1

    if args.matrix:
        out = _matrix(args)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
                f.write("\n")
        print(json.dumps(out))
        return 0 if out["all_agree"] else 1

    if args.pair:
        if args.engine == "tensor":
            p.error("--pair compares a SOCKET engine against the tensor "
                    "replay; pick --engine udp|deploy|native")
        out = _pair(args)
        print(json.dumps(out))
        return 0 if out["reproduced"] else 1

    if args.case:
        if args.engine == "tensor":
            if args.scale_n:
                p.error("--scale-n applies to socket engines "
                        "(--engine udp|deploy)")
            out = campaigns.run_case(args.case, device=args.device)
        else:
            out = campaigns.run_case_engine(
                args.case, engine=args.engine, scale_n=args.scale_n,
                period=args.period, trace=args.trace, device=args.device,
            )
        print(json.dumps(out))
        return 0 if out["reproduced"] else 1

    if not args.family:
        p.error("--family (or --case / --pair / --matrix / --surface / "
                "--absorption) is required")
    if args.family not in campaigns.FAMILIES:
        p.error(f"unknown family {args.family!r}; pick from "
                f"{sorted(campaigns.FAMILIES)}")
    if (args.values is None) == (args.bisect is None):
        p.error("pick exactly one of --values / --bisect")
    knobs = {}
    for kv in args.knob:
        k, _, v = kv.partition("=")
        knobs[k] = int(v)

    axis = campaigns.FAMILIES[args.family]["axis"]
    if axis in knobs:
        p.error(f"--knob {axis}=... fixes the {args.family} family's "
                "swept severity axis; give it via --values / --bisect")
    ledger = None
    if args.ledger:
        ledger = campaigns.CampaignLedger(
            args.ledger, family=args.family, n=args.n, axis=axis,
            t_fail=args.t_fail, t_suspect=args.t_suspect,
            lh_multiplier=args.lh_multiplier, lh_frac=args.lh_frac,
            seed=args.seed)
    common = dict(fault_rounds=args.fault_rounds, t_fail=args.t_fail,
                  t_suspect=args.t_suspect,
                  lh_multiplier=args.lh_multiplier, lh_frac=args.lh_frac,
                  seed=args.seed, track=args.track, ledger=ledger,
                  device=args.device, **knobs)
    if args.values is not None:
        out = campaigns.sweep_axis(args.family, args.n, args.values,
                                   **common)
        breaking = min(out["breaking"], default=None)
    else:
        lo, hi = args.bisect
        out = campaigns.bisect_axis(args.family, args.n, lo, hi, **common)
        breaking = out["breaking_point"]
    if ledger is not None:
        ledger.close()
        out["ledger"] = args.ledger

    if args.commit and breaking is not None:
        # re-derive the committed point's scenario (same avoid set as
        # the runs) and stamp the case with the observed verdict
        row = next(r for r in out["rows"]
                   if r["axis_value"] == breaking)
        from gossipfs_tpu_torch.bench import tracked_crash_events
        from gossipfs_tpu_torch.obs.monitor import MonitorParams

        cfg = campaigns.driver.campaign_config(
            args.n, t_fail=args.t_fail, t_suspect=args.t_suspect,
            lh_multiplier=args.lh_multiplier, lh_frac=args.lh_frac)
        _, crash_rounds, _ = tracked_crash_events(
            cfg, args.fault_rounds + 1, args.track, 10, device="cpu")
        sc = campaigns.make_scenario(
            args.family, args.n, args.fault_rounds,
            avoid=set(crash_rounds) | {cfg.introducer},
            **{axis: breaking}, **knobs)
        campaigns.write_case(
            args.commit, sc, t_fail=args.t_fail,
            t_suspect=args.t_suspect,
            lh_multiplier=args.lh_multiplier, lh_frac=args.lh_frac,
            seed=args.seed, track=args.track,
            params=MonitorParams.from_dict(row["monitor_params"]),
            expect={"verdict": "violated",
                    "invariants": sorted(
                        row["monitor"]["by_invariant"])},
            family=args.family, axis=axis, axis_value=breaking,
        )
        out["committed"] = args.commit
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
