"""spec_clean for the port: the gossipfs-spec rules verified both ways,
one JSON line (the twin of the JAX package's ``tools/spec_verify.py``).

Green half: the analyzer's CLI (``python -m gossipfs_tpu_torch.analysis``,
every AST rule, the spec extractors included) must exit 0 on the tree.
Red half: each spec rule -- every ``spec-*`` rule and ``scan-carry-arity``
-- must exit NONZERO with its committed seeded-drift fixture mounted at
the rule's extraction point: a rule that cannot fire on its own fixture
is a dead check, and a tree that fails clean has drifted from the
contract.  The CLI runs in this process (its ``main``, exit codes as
returned), so the check costs one parse of the tree, not a process a
rule.

    python -m gossipfs_tpu_torch.analysis.spec_verify   # exit 0 iff ok
"""

from __future__ import annotations

import contextlib
import io
import json
import sys

from gossipfs_tpu_torch.analysis import REGISTRY
from gossipfs_tpu_torch.analysis.__main__ import main as lint_main
from gossipfs_tpu_torch.analysis.framework import REPO_ROOT

FIXTURES = REPO_ROOT / "tests" / "fixtures"

# the cross-language protocol-contract rules: the spec-prefixed
# extractors plus the seam-arity rule that rides with them
SPEC_RULES = sorted(
    name for name in REGISTRY
    if name.startswith("spec-") or name == "scan-carry-arity"
)


def _lint(*args: str) -> int:
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return lint_main(list(args))


def verify() -> dict:
    """The spec_clean document: ``repo_clean``, the per-rule fixture
    runs, and ``ok``."""
    repo_clean = _lint() == 0
    fixtures = []
    for name in SPEC_RULES:
        r = REGISTRY[name]
        rc = _lint("--rule", name, "--overlay",
                   f"{r.fixture_at}={FIXTURES / r.fixture}")
        fixtures.append({"rule": name, "fixture": r.fixture,
                         "mounted_at": r.fixture_at, "exit_code": rc,
                         "fired": rc == 1})
    red = sum(1 for f in fixtures if f["fired"])
    ok = repo_clean and red == len(fixtures) and bool(fixtures)
    return {
        "claim": "spec_clean",
        "repo_clean": repo_clean,
        "fixtures_total": len(fixtures),
        "fixtures_red": red,
        "ok": bool(ok),
        "fixtures": fixtures,
    }


def main(argv: list[str] | None = None) -> int:
    if argv:
        print(f"spec_verify takes no arguments, got {argv}", file=sys.stderr)
        return 2
    doc = verify()
    print(json.dumps(doc))
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
