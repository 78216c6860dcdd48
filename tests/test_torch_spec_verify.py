"""spec_verify for the port (``python -m
gossipfs_tpu_torch.analysis.spec_verify``) against the JAX package's
``tools/spec_verify.py``.

The twin prints one JSON line with the JAX tool's keys and the same
``ok``; each spec rule (every ``spec-*`` rule and ``scan-carry-arity``)
goes red on its fixture and green on the port's tree.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest

from gossipfs_tpu_torch.analysis import spec_verify

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def port_doc():
    return spec_verify.verify()


def test_twin_matches_the_jax_tool(port_doc):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(REPO / "tools" /
                                              "spec_verify.py")],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=240, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    jax = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(port_doc) == set(jax)
    assert port_doc["ok"] is jax["ok"] is True
    assert port_doc["claim"] == jax["claim"] == "spec_clean"
    assert port_doc["fixtures_total"] == jax["fixtures_total"]
    assert [f["rule"] for f in port_doc["fixtures"]] == [
        f["rule"] for f in jax["fixtures"]]
    assert set(port_doc["fixtures"][0]) == set(jax["fixtures"][0])


def test_cli_prints_one_json_line(capsys):
    assert spec_verify.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["ok"] is True
    assert spec_verify.main(["--bogus"]) == 2


@pytest.mark.parametrize("name", spec_verify.SPEC_RULES)
def test_spec_rule_red_on_fixture_green_on_tree(port_doc, name):
    row = next(f for f in port_doc["fixtures"] if f["rule"] == name)
    assert row["fired"] and row["exit_code"] == 1, row
    assert spec_verify._lint("--rule", name) == 0
    assert port_doc["repo_clean"]


def test_spec_rules_are_the_jax_tools():
    assert spec_verify.SPEC_RULES == sorted(
        ["scan-carry-arity", "spec-delta-dissemination", "spec-dissemination",
         "spec-native-annotations", "spec-obs-kind-coverage",
         "spec-refute-rate-limit", "spec-runtime-protocol",
         "spec-transition-order"])
