"""Trigger fixture for the smem-budget-probe rule: the drift it exists to
catch is a Python budget formula that stops charging a term the kernel
allocates.  The probe reconciles formulas with the compiled headers, so
this fixture names the term to drop instead of a file to mount:
tests/test_torch_analysis.py calls
``probes.fixture_findings(<this file>)``, which drops K5's two count
blocks from ``merge_update.stripe_smem``, and asserts the probe fires."""

DROP = "stripe_count_blocks"
