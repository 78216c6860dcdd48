"""Re-verify every headline claim end to end through the port, one command.

The port of the JAX package's ``tools/verify_claims.py``: one claim for
each of its claims, under the same name, with the same predicate, run
through the port's own surfaces (``python -m gossipfs_tpu_torch.<...>``,
never the JAX package or its tools) on the twin's ``--device`` (default
the card; the surfaces without one, ``analysis.spec_verify``, run as
they are).  It runs the surfaces, not cached artifacts, and prints one
JSON line a claim (``claim``, ``claimed``, ``measured``, ``tolerance``,
``result``; ``source`` names where the claimed value was measured), then
``{"all_pass": ...}``; the exit code is 0 iff every claim passed.

A rate passes at ``measured >= claimed * (1 - tolerance)``; the other
claims are predicates (1.0 when they hold).  A claimed rate is a card
figure the repository's PERF.md records, named in ``source``: the JAX
package's TPU figures are no claims of the port.  Where the port has no
recorded card figure for a claim, it prints ``"claimed": null, "result":
"MEASURED"`` with what it measured, and the claim is left out of
``all_pass``.  ``rr_row_budget`` holds the port's own admission
(``shard_anchor --ladder --budget-only``: shard bytes against the H100's
stated 80 GB) where the JAX claim held its TPU VMEM row budget.

    python -m gossipfs_tpu_torch.verify_claims                 # all
    python -m gossipfs_tpu_torch.verify_claims --only headline soak
    python -m gossipfs_tpu_torch.verify_claims --device cpu --only spec_clean
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = "gossipfs_tpu_torch"


def run_json(cmd: list, timeout: int = 1800) -> dict:
    """The last JSON object line ``cmd`` prints, run from the repository's
    root."""
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=timeout)
    for line in reversed(out.stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"no JSON from {cmd}: {out.stdout[-500:]}\n"
                       f"{out.stderr[-500:]}")


def _suspicion_ok(d: dict) -> float:
    """suspicion_fpr predicate over the SUSPECT artifact rows.

    Per N: (a) churn — suspicion-on at the fast knob keeps median
    TTD-first <= t_fail + t_suspect (the t_fail=5-class latency) with
    FPR within 10x of the t_fail=5 baseline (floor 1e-6 ~ 60 FP events,
    so a zero-FP baseline window can't fail a handful of events) instead
    of the raw-t3 storm; (b) loss — suspicion-on FPR strictly below
    suspicion-off at the same t_fail, with refutations actually doing
    the suppressing (fp_suppressed > 0).
    """
    by = {(r["n"], r["fault"], r["mode"]): r for r in d["rows"]}
    for n in sorted({r["n"] for r in d["rows"]}):
        base = by[(n, "churn", "baseline-t5")]
        on = by[(n, "churn", "suspect-t3")]
        raw = by[(n, "churn", "raw-t3")]
        bound = on["t_fail"] + on["t_suspect"]
        if on["ttd_first_median"] is None or on["ttd_first_median"] > bound:
            return 0.0
        if on["false_positive_rate"] > max(
            10 * base["false_positive_rate"], 1e-6
        ):
            return 0.0
        if not on["false_positive_rate"] < raw["false_positive_rate"]:
            return 0.0
        loss_on = by[(n, "loss", "suspect-t3")]
        loss_raw = by[(n, "loss", "raw-t3")]
        if not loss_on["false_positive_rate"] < loss_raw["false_positive_rate"]:
            return 0.0
        if loss_on["fp_suppressed"] <= 0 or on["fp_suppressed"] <= 0:
            return 0.0
    return 1.0


def _row_budget_ok(d: dict) -> float:
    """rr_row_budget over the port's ladder admission: every row within
    the limit is admitted (and none over it), the 524,288-row shard at the
    JAX tool's 512-column stripe field is among them, and every admitted
    row's formula bytes are within the limit."""
    rows = d["ladder"]
    return 1.0 if (
        all(r["admissible"] == (r["shard_bytes"] <= r["budget_limit_bytes"])
            for r in rows)
        and any(r["admissible"] and r["n_global"] >= 524_288
                and r["merge_block_c"] == 512 for r in rows)
        and all(r["shard_bytes"] <= r["budget_limit_bytes"]
                for r in rows if r["admissible"])
    ) else 0.0


def _frontier_ok(d: dict) -> float:
    return d["rounds_per_sec"] if d["detected"] == 8 else 0.0


def _partition_ok(d: dict) -> float:
    return 1.0 if all(
        r["cross_hb_advances"] == 0
        and 0 <= r["reconverge_rounds"] <= r["reconverge_bound"]
        for r in d["rows"]) else 0.0


def _erasure_ok(d: dict) -> float:
    m = d["erasure_matrix"]
    rb = m["repair_bandwidth"]
    return 1.0 if (m["losses_total"] == 0 and m["matches_all"]
                   and rb["per_unit_ratio"] is not None
                   and rb["per_unit_ratio"] <= rb["bound_1_over_k"]) else 0.0


def _traffic_ok(d: dict) -> float:
    pr = d["partition_race"]
    du = pr["durability"]
    return 1.0 if (du["match"] and du["harness"]["lost"] == 0
                   and du["events"]["lost"] == 0
                   and du["harness"]["files_acked"] > 0
                   and pr["rejected_during_split"] > 0
                   and du["monitor"]["ok"]
                   and du["monitor"]["match_events"]) else 0.0


def _ok(key: str = "ok"):
    return lambda d: 1.0 if d[key] else 0.0


# The JAX package's headline is 100 rounds at N = 16,384; its port's
# recorded card figure is chip_smoke.py phase 5's ms a round.  The
# frontier, ceiling and anchor figures are each claim's own command on the
# card (PERF.md section 6), K3's one-pass form at those N.
HEADLINE_MS = 2.0384
FRONTIER_MS = 50.5280
CEILING_MS = 92.5134
ANCHOR_MS = 12.8987


def claims(device: str) -> dict:
    """name: (command, extractor, claimed value or None, relative
    tolerance, source of the claimed value).  Each command runs a port
    surface on ``device``."""
    py = [sys.executable, "-m"]
    dev = ["--device", device]
    return {
        "headline": (
            py + [f"{PORT}.bench", *dev], lambda d: d["value"],
            1e3 / HEADLINE_MS, 0.3,
            f"chip_smoke.py phase 5, PR 10's final run: {HEADLINE_MS} ms "
            "a round at N = 16,384 (PERF.md section 5)"),
        "frontier_65536": (
            py + [f"{PORT}.frontier", "--n", "65536", "--rounds", "60",
                  "--block-c", "2048", "--topology", "random_arc",
                  "--arc-align", "8", *dev],
            _frontier_ok, 1e3 / FRONTIER_MS, 0.3,
            f"this claim's command on the card (aligned arcs, K3's "
            f"one-pass form): {FRONTIER_MS} ms a round at N = 65,536 "
            "(PERF.md section 6)"),
        "ceiling_86016": (
            py + [f"{PORT}.frontier", "--n", "86016", "--rounds", "60",
                  "--block-c", "1024", "--topology", "random_arc",
                  "--arc-align", "8", *dev],
            _frontier_ok, 1e3 / CEILING_MS, 0.3,
            f"this claim's command on the card (K3's one-pass "
            f"form): {CEILING_MS} ms a round at N = 86,016 (PERF.md "
            "section 6)"),
        "soak": (
            py + [f"{PORT}.parity_soak", "--n", "16384", "--rounds", "100",
                  *dev],
            _ok("all_equal"), 1.0, 0.0, "a predicate"),
        "anchor_98304": (
            py + [f"{PORT}.shard_anchor", "--n", "98304", "--shards", "8",
                  "--block-c", "2048", "--fanout", "24", "--rounds", "40",
                  "--reps", "3", *dev],
            lambda d: d["implied_rounds_per_sec"], 1e3 / ANCHOR_MS, 0.3,
            f"this claim's command on the card (the [98,304 x "
            f"12,288] shard on K3's one-pass form): {ANCHOR_MS} ms a round "
            "(PERF.md section 6)"),
        "partition_reconv": (
            py + [f"{PORT}.curves", "--partition", "--ns", "1024", *dev],
            _partition_ok, 1.0, 0.0, "a predicate"),
        "suspicion_fpr": (
            py + [f"{PORT}.curves", "--suspicion", "--ns", "1024", *dev],
            _suspicion_ok, 1.0, 0.0, "a predicate"),
        "rr_row_budget": (
            py + [f"{PORT}.shard_anchor", "--ladder", "--budget-only",
                  *dev],
            _row_budget_ok, 1.0, 0.0, "a predicate"),
        "fastpath_parity": (
            py + [f"{PORT}.parity_soak", "--n", "2048", "--rounds", "16",
                  "--crash-rate", "0.02", "--elementwise", "swar",
                  "--suspicion", "--scenario", *dev],
            lambda d: 1.0 if (d["all_equal"] and d["total_suspects"] > 0
                              and d["total_refutations"] > 0) else 0.0,
            1.0, 0.0, "a predicate"),
        "trace_invariants": (
            py + [f"{PORT}.obs.timeline", "--selfcheck", "--n", "1024",
                  *dev],
            _ok(), 1.0, 0.0, "a predicate"),
        "monitor_parity": (
            py + [f"{PORT}.obs.timeline", "--selfcheck", "--monitor", "--n",
                  "1024", *dev],
            lambda d: 1.0 if (d["ok"] and d["monitor_parity"]
                              and d["monitor_violations"] == 0) else 0.0,
            1.0, 0.0, "a predicate"),
        "outage_absorption": (
            py + [f"{PORT}.campaigns", "--absorption",
                  "LOCALHEALTH_r14.json", *dev],
            _ok("absorbed"), 1.0, 0.0, "a predicate"),
        "native_cohort": (
            py + [f"{PORT}.campaigns", "--engine", "native", "--pair",
                  "regressions/outage_storm_n256.json",
                  "regressions/outage_absorbed_n256.json", *dev],
            _ok("reproduced"), 1.0, 0.0, "a predicate"),
        "delta_cohort": (
            py + [f"{PORT}.campaigns", "--ab", "--ab-ns", "256",
                  "--ab-loop-grid", "1", "--ab-rounds", "16",
                  "--ab-target", "2.0", "--ab-udp-case",
                  "regressions/outage_mild_delta_udp_n24.json", *dev],
            _ok(), 1.0, 0.0, "a predicate"),
        "spec_clean": (
            py + [f"{PORT}.analysis.spec_verify"],
            _ok(), 1.0, 0.0, "a predicate"),
        "spec_conformance": (
            py + [f"{PORT}.conformance", "--slice", *dev],
            lambda d: 1.0 if (d["ok"] and d["coverage_complete"]) else 0.0,
            1.0, 0.0, "a predicate"),
        "erasure_durability": (
            py + [f"{PORT}.traffic_bench", "--erasure-matrix", "--n", "64",
                  *dev],
            _erasure_ok, 1.0, 0.0, "a predicate"),
        "traffic_durability": (
            py + [f"{PORT}.traffic_bench", "--partition-race", "--n", "64",
                  *dev],
            _traffic_ok, 1.0, 0.0, "a predicate"),
    }


def verify(name: str, claim: tuple) -> dict:
    """Run one claim: its JSON line."""
    cmd, extract, want, tol, source = claim
    try:
        got = extract(run_json(cmd))
        result = ("MEASURED" if want is None
                  else "PASS" if got >= want * (1.0 - tol) else "FAIL")
    except Exception as e:  # noqa: BLE001 — report, keep verifying
        got, result = f"ERROR: {e}", "FAIL"
    return {"claim": name, "claimed": want, "measured": got,
            "tolerance": tol, "result": result, "source": source}


def main(argv=None) -> int:
    table = claims("cuda")
    p = argparse.ArgumentParser(
        prog="python -m gossipfs_tpu_torch.verify_claims",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--only", nargs="*", default=None,
                   help=f"subset of {sorted(table)}")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("gossipfs_tpu_torch.verify_claims needs a "
                             "CUDA device (or --device cpu)")
    table = claims(args.device)
    names = args.only or list(table)
    unknown = sorted(set(names) - set(table))
    if unknown:
        p.error(f"unknown claims {unknown}: one of {sorted(table)}")
    ok = True
    for name in names:
        row = verify(name, table[name])
        ok &= row["result"] in ("PASS", "MEASURED")
        print(json.dumps(row), flush=True)
    print(json.dumps({"all_pass": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
