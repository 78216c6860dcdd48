"""The port's analyzer against the JAX package's, rule for rule.

For each rule whose idiom carries over unchanged (ownership, obs, native,
asyncio, conformance, and six of the spec rules), the JAX package's
committed fixture is mounted at the JAX rule's own mount point for the
JAX rule, and at the port's path for the port's rule: both must report
the same (rule, line) set.  The two native rules read the same
``native/engine.cc`` stand-in and must give identical findings, message
for message.  Both trees are clean, so every finding is the fixture's.
"""

from __future__ import annotations

import pathlib

import pytest

from gossipfs_tpu.analysis import REGISTRY as JAX_REGISTRY
from gossipfs_tpu.analysis import RepoIndex as JaxIndex
from gossipfs_tpu_torch.analysis import REGISTRY, RepoIndex

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"

# the rules whose idiom carries over: the port mounts the JAX fixture
CARRIED = ("quorum-ownership", "stripe-quorum-ownership",
           "backoff-ownership", "obsparse-ownership", "quantile-ownership",
           "na-render-ownership", "obs-scan-coverage", "obs-logsite-coverage",
           "native-obs-kinds", "asyncio-hygiene", "conformance-verb-coverage",
           "spec-dissemination", "spec-delta-dissemination",
           "spec-refute-rate-limit", "spec-runtime-protocol",
           "spec-native-annotations", "spec-obs-kind-coverage")
NATIVE = ("native-obs-kinds", "spec-native-annotations")


def _both(name: str):
    jr, pr = JAX_REGISTRY[name], REGISTRY[name]
    assert pr.fixture == f"lint/{jr.fixture}", (name, pr.fixture)
    fixture = FIXTURES / pr.fixture
    jax = jr.check(JaxIndex(overlay={jr.fixture_at: fixture}))
    port = pr.check(RepoIndex(overlay={pr.fixture_at: fixture}))
    return jax, port


@pytest.mark.parametrize("name", CARRIED)
def test_same_findings_as_the_jax_rule(name):
    jax, port = _both(name)
    assert port, f"{name} did not fire on the JAX fixture"
    assert {(f.rule, f.line) for f in port} == {
        (f.rule, f.line) for f in jax}


@pytest.mark.parametrize("name", NATIVE)
def test_native_rules_give_identical_findings(name):
    jax, port = _both(name)
    assert [(f.rule, f.path, f.line, f.message) for f in port] == [
        (f.rule, f.path, f.line, f.message) for f in jax]


@pytest.mark.parametrize("name", NATIVE)
def test_native_rules_agree_on_the_real_engine(name):
    """On the committed engine both packages' rules are clean: the port
    reads the same native/engine.cc its native.py builds."""
    assert JAX_REGISTRY[name].check(JaxIndex()) == []
    assert REGISTRY[name].check(RepoIndex()) == []


def test_carried_rules_cover_every_unrenamed_idiom_neutral_rule():
    rewritten = {"spec-transition-order", "scan-carry-arity",
                 "config-gate-docs", "jit-hygiene", "vmem-scratch-ownership",
                 "rr-scratch-budget"}
    assert set(CARRIED) == set(JAX_REGISTRY) - rewritten
