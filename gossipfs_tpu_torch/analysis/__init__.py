"""gossipfs-lint for the port: the repo-wide invariant analyzer over
``gossipfs_tpu_torch/``, and the protocol contract as data.

The port's twin of the JAX package's ``gossipfs_tpu/analysis/``: one
AST-based framework (standard library only for the AST rules) whose rules
read the port's own sources, never the JAX package's:

* single ownership of owned expressions (quorum math, backoff schedule,
  obs line parsing, quantile rollup, the ``n/a`` rendering) and of the
  kernels' shared-memory budgets (``smem-budget-ownership``: csrc header
  budget functions, Python constants in ``ops/``) -- ``rules_ownership``
* obs-schema coverage of every metric field and log site -- ``rules_obs``
* the native engine's event kinds / vitals fields against the port's
  schema, across the language boundary -- ``rules_native``
* config capability gates documented (BASELINE.md's matrix and the
  README's port block) -- ``rules_config``
* device hygiene of ``core/`` and ``ops/`` (no host randomness or clock,
  no per-round host sync or branch on a device value) -- ``rules_device``
* asyncio hygiene of the socket engine -- ``rules_asyncio``
* the conformance corpus against the contract -- ``rules_conformance``
* gossipfs-spec: ``protocol_spec`` (the port's copy of the contract)
  statically diffed against the tensor ``_tick``/``_tick_swar``,
  ``detector/udp.py`` and the ``// @gfs:`` annotations of
  ``native/engine.cc``, and the arity of the round loops' seams --
  ``rules_spec``
* the shared-memory budget probe (g++ over the csrc headers; on the card
  the built kernels' attributes) -- ``probes``

Run it: ``python -m gossipfs_tpu_torch.analysis`` (exit 1 on any
finding; ``--probe`` adds the probe, on the card unless ``--device cpu``),
``python -m gossipfs_tpu_torch.analysis.spec_verify`` (every spec rule red
on its fixture, green on the tree), or ``run_rules()``.  Every rule has a
committed fixture under ``tests/fixtures/lint/`` or
``tests/fixtures/lint_torch/`` proving it fires
(``tests/test_torch_analysis.py``).
"""

from gossipfs_tpu_torch.analysis.framework import (  # noqa: F401
    REGISTRY,
    Finding,
    RepoIndex,
    Rule,
    rule,
    run_rules,
)

# Importing the rule modules populates REGISTRY.
from gossipfs_tpu_torch.analysis import (  # noqa: E402,F401
    probes,
    protocol_spec,
    rules_asyncio,
    rules_config,
    rules_conformance,
    rules_device,
    rules_native,
    rules_obs,
    rules_ownership,
    rules_spec,
)

__all__ = ["REGISTRY", "Finding", "RepoIndex", "Rule", "rule", "run_rules",
           "protocol_spec"]
