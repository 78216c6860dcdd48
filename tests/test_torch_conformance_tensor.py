"""The port's conformance tensor column against the JAX package's.

``harness.run_case_tensor(case, device="cpu")`` (the port's
``SimDetector`` at N = 8: fanout 3, min_group 4, int16 view, int32 hb,
suspicion on in all but ``direct_confirm``, a blackout scenario's edge
rewrite in ``refute_race``) gives the JAX package's whole bundle: events
(schedule-relative, refutes included), checkpoints and final status.  The
matrix over the reference and tensor columns equals the JAX package's
document.
"""

from __future__ import annotations

import pytest
import torch

from gossipfs_tpu.conformance import harness as jax_harness
from gossipfs_tpu.conformance import schedules as jax_schedules
from gossipfs_tpu.conformance import verdict as jax_verdict
from gossipfs_tpu_torch.conformance import harness, schedules, verdict
from gossipfs_tpu_torch.ops import merge

torch.set_num_threads(1)

TENSOR_FAMILIES = [f for f, meta in schedules.FAMILIES.items()
                   if "tensor" in meta["engines"]]


def test_tensor_families():
    assert TENSOR_FAMILIES == ["refute_race", "confirm_expiry",
                               "direct_confirm", "leave_broadcast"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("family", TENSOR_FAMILIES)
def test_tensor_bundle_matches_jax(family, seed):
    case = jax_schedules.generate(family, seed)
    want = jax_harness.run_case_tensor(case)
    merge.reset_launch_counts()
    got = harness.run_case_tensor(case, device="cpu")
    assert not any(merge.LAUNCH_COUNTS.values())    # plain on the CPU
    assert got["events"] == want["events"]
    assert got["checkpoints"] == want["checkpoints"]
    assert got["final"] == want["final"]
    assert got == want
    assert verdict.compare(case, harness.run_case_reference(case), got)["ok"]


def test_matrix_document_matches_jax():
    corpus = jax_schedules.generate_corpus((0,))
    engines = ("reference", "tensor")
    want = jax_verdict.run_matrix(corpus, engines=engines)
    got = verdict.run_matrix(corpus, engines=engines, device="cpu")
    assert got == want
    assert got["all_agree"] and got["engines_run"] == list(engines)
    # naming the tensor column alone keeps the oracle's self-check rows,
    # as in the JAX package (left to default, the engines are every
    # column each family declares, socket columns included)
    assert verdict.run_matrix(corpus, engines=("tensor",), device="cpu") \
        == jax_verdict.run_matrix(corpus, engines=("tensor",))
