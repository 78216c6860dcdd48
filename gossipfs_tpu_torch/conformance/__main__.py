"""Conformance-fuzzing CLI: the corpus x engine matrix, one command.

The port's twin of the JAX package's conformance CLI, run as
``python -m gossipfs_tpu_torch.conformance``.  The tensor column runs on
``--device`` (default ``cuda``, the card; without one it exits unless
``--device cpu``); the socket columns are host code.

    python -m gossipfs_tpu_torch.conformance --matrix \
        --out matrix.json                   # full corpus, every engine
    python -m gossipfs_tpu_torch.conformance --slice
                                            # pinned fast subset
    python -m gossipfs_tpu_torch.conformance --replay \
        regressions/conformance_malformed_udp.json
                                            # re-run a committed repro

Every mode prints one final JSON line and exits nonzero when any
verdict row flips.

``--matrix --evidence <red_row.json>`` embeds a captured PRE-FIX
verdict row in the artifact and re-runs the same (family, seed, engine)
cell now for the green twin — the SPEC_r17 red->green evidence pattern.
"""

from __future__ import annotations

import argparse
import json
import sys

from gossipfs_tpu_torch.conformance import harness, schedules, verdict

#: the fast slice: the oracle selfcheck sweeps every family, the tensor
#: column runs every family it can, and the udp column is pinned to the
#: two shortest wire-verb families (8 + 12 rounds) so the slice stays
#: seconds, not minutes.  The native column is the matrix's.
SLICE_UDP_FAMILIES = ("leave_broadcast", "suspect_flood")


def _summary(matrix: dict) -> dict:
    return {
        "ok": matrix["all_agree"],
        "cases": matrix["cases"],
        "rows": len(matrix["rows"]),
        "engines_run": matrix["engines_run"],
        "coverage_complete": matrix["coverage"]["complete"],
        "disagreements": matrix["disagreements"],
    }


def _emit(summary: dict) -> int:
    print(json.dumps(summary, sort_keys=True))
    return 0 if summary["ok"] else 1


def run_slice(device="cuda") -> dict:
    """The pinned subset (no native toolchain needed); the tensor column
    runs on ``device``."""
    rows = []
    for fam, spec in schedules.FAMILIES.items():
        case = schedules.generate(fam, seed=0)
        ref = harness.run_case_reference(case)
        rows.append(verdict.oracle_selfcheck(case, ref))
        if "tensor" in spec["engines"]:
            rows.append(verdict.compare(
                case, ref, harness.run_case_tensor(case, device=device)))
        if fam in SLICE_UDP_FAMILIES and "udp" in spec["engines"]:
            rows.append(verdict.compare(
                case, ref, harness.run_case_udp(case)))
    failing = [r for r in rows if not r["ok"]]
    return {
        "ok": not failing,
        "cases": len(schedules.FAMILIES),
        "rows": len(rows),
        "engines_run": sorted({r["engine"] for r in rows}),
        "coverage_complete": schedules.coverage()["complete"],
        "disagreements": [
            {"family": r["family"], "seed": r["seed"], "engine": r["engine"],
             "failed_checks": sorted(k for k, c in r["checks"].items()
                                     if not c["ok"])}
            for r in failing
        ],
    }


def _green_twin(red_row: dict, device) -> dict:
    """Re-run the red row's exact (family, seed, engine) cell on the
    current tree — the post-fix half of the evidence pair."""
    case = schedules.generate(red_row["family"], seed=red_row["seed"])
    ref = harness.run_case_reference(case)
    if red_row["engine"] == "tensor":
        bundle = harness.run_case_tensor(case, device=device)
    else:
        bundle = harness.RUNNERS[red_row["engine"]](case)
    return verdict.compare(case, ref, bundle)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--matrix", action="store_true",
                      help="full corpus x engine matrix")
    mode.add_argument("--slice", action="store_true",
                      help="pinned fast subset (the spec_conformance claim)")
    mode.add_argument("--replay", metavar="CASE_JSON",
                      help="re-run one committed case doc")
    p.add_argument("--engines", nargs="*", default=None,
                   help="restrict engine columns (reference always runs)")
    p.add_argument("--seeds", nargs="*", type=int, default=[0])
    p.add_argument("--out", default=None,
                   help="write the full matrix doc here (--matrix only)")
    p.add_argument("--evidence", default=None,
                   help="captured pre-fix red verdict row to embed "
                        "red->green in --out (--matrix only)")
    p.add_argument("--device", default="cuda",
                   help="where the tensor column runs: cuda (default) or "
                        "cpu")
    args = p.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("gossipfs_tpu_torch.conformance needs a CUDA "
                             "device (or --device cpu)")

    if args.slice:
        return _emit(run_slice(args.device))

    if args.replay:
        with open(args.replay, encoding="utf-8") as f:
            case = schedules.parse(f.read())
        rows = verdict.run_case(case, engines=args.engines,
                                device=args.device)
        failing = [r for r in rows if not r["ok"]]
        return _emit({
            "ok": not failing,
            "cases": 1,
            "rows": len(rows),
            "engines_run": sorted({r["engine"] for r in rows}),
            "coverage_complete": schedules.coverage()["complete"],
            "disagreements": [
                {"family": r["family"], "seed": r["seed"],
                 "engine": r["engine"],
                 "failed_checks": sorted(k for k, c in r["checks"].items()
                                         if not c["ok"])}
                for r in failing
            ],
        })

    corpus = schedules.generate_corpus(seeds=tuple(args.seeds))
    matrix = verdict.run_matrix(corpus, engines=args.engines,
                                device=args.device)
    if args.out:
        doc = {"schema": "gossipfs-conformance-evidence/v1",
               "matrix": matrix}
        if args.evidence:
            with open(args.evidence, encoding="utf-8") as f:
                red = json.load(f)
            doc["divergence"] = {
                "finding": (
                    "detector/udp.py _decode parsed hb with a bare "
                    "int(float(...)): one malformed chunk raised and "
                    "aborted the WHOLE datagram, losing every valid "
                    "entry sharing it (the native codec skips bad "
                    "entries).  The malformed_codec family's "
                    "mixed_refresh payload — a refuting incarnation "
                    "advance riding with a truncated entry — made the "
                    "asymmetry observable: the udp engine confirmed a "
                    "live node dead.  Fixed by per-entry skip; minimal "
                    "repro committed (shrink.py, signature-pinned)."),
                "red": red,
                "green": _green_twin(red, args.device),
                "minimized": "regressions/conformance_malformed_udp.json",
            }
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
    return _emit(_summary(matrix))


if __name__ == "__main__":
    sys.exit(main())
