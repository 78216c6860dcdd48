"""Trigger fixture for the Python half of the smem-budget-ownership rule:
a module outside ops/ that defines its own copies of the budget constants
the route admits shapes by.  Mounted under gossipfs_tpu_torch/core/ by
tests/test_torch_analysis.py only -- never imported."""

ONEPASS_SMEM = 227 * 1024       # the card's limit, re-derived
STRIPE_MAX_N = 32_768           # K5's row limit, drifted
