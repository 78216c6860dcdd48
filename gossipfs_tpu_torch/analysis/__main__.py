"""gossipfs-lint CLI for the port (the twin of the JAX package's
``tools/lint.py``).

Usage::

    python -m gossipfs_tpu_torch.analysis              # AST rules; exit 1
                                                       # on findings
    python -m gossipfs_tpu_torch.analysis --list       # rule table
    python -m gossipfs_tpu_torch.analysis --rule NAME  # a subset
    python -m gossipfs_tpu_torch.analysis --probe      # + the budget probe,
                                                       # on the card
    python -m gossipfs_tpu_torch.analysis --probe --device cpu
    python -m gossipfs_tpu_torch.analysis --json       # findings as JSON
    python -m gossipfs_tpu_torch.analysis --overlay \\
        gossipfs_tpu_torch/x.py=tests/fixtures/lint/y.py

Exit codes: 0 clean, 1 findings, 2 usage or internal error (an
unreadable overlay, no CUDA device for ``--probe`` without ``--device
cpu``, no g++).  The AST rules import neither torch nor the package's
modules; the probe imports ``ops/`` and, on the card, builds and launches
the kernels.
"""

from __future__ import annotations

import argparse
import json
import sys

from gossipfs_tpu_torch.analysis import REGISTRY, RepoIndex, run_rules


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="gossipfs-lint",
        description="repo-wide invariant analyzer over the PyTorch port "
                    "(gossipfs_tpu_torch/analysis/)")
    ap.add_argument("--list", action="store_true",
                    help="list registered rules and exit")
    ap.add_argument("--rule", action="append", default=None,
                    help="run only this rule (repeatable)")
    ap.add_argument("--probe", action="store_true",
                    help="include probe rules (imports torch; on the card "
                         "builds and launches the kernels)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where probe rules run (default cuda; cpu runs "
                         "their header half alone)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    ap.add_argument("--overlay", action="append", default=[],
                    metavar="VIRTUAL=REAL",
                    help="mount REAL file at repo-relative VIRTUAL path")
    args = ap.parse_args(argv)

    if args.list:
        for name, r in sorted(REGISTRY.items()):
            print(f"{name} [{r.kind}]: {r.description}")
        return 0

    if args.rule:
        unknown = set(args.rule) - set(REGISTRY)
        if unknown:
            print(f"unknown rule(s): {sorted(unknown)} (see --list)",
                  file=sys.stderr)
            return 2

    overlay = {}
    for spec in args.overlay:
        if "=" not in spec:
            print(f"bad --overlay (want VIRTUAL=REAL): {spec}",
                  file=sys.stderr)
            return 2
        virt, real = spec.split("=", 1)
        overlay[virt] = real

    kinds = ("ast", "probe") if args.probe else ("ast",)
    try:
        # internal errors land on exit code 2, never on a traceback that
        # exits 1, which a hook would read as "findings exist"
        findings = run_rules(RepoIndex(overlay=overlay, device=args.device),
                             names=args.rule, kinds=kinds)
    except (ImportError, SyntaxError, OSError, RuntimeError) as e:
        print(f"lint internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps([f.__dict__ for f in findings], indent=2))
    else:
        for f in findings:
            print(f)
        if findings:
            print(f"\n{len(findings)} finding(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
