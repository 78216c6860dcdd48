"""The port imports neither JAX nor the JAX package.

In a fresh interpreter with ``sys.modules["jax"] = None`` (so any
``import jax`` fails), every ``gossipfs_tpu_torch`` module and
``chip_smoke.py`` import, and no ``gossipfs_tpu.*`` module gets loaded.
A source scan also catches imports deferred into function bodies.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "gossipfs_tpu_torch"
# the package's sources (its gitignored kernel build directory excluded)
SOURCES = sorted(p for p in PORT.rglob("*.py")
                 if "_build" not in p.relative_to(PORT).parts)
SOURCES.append(ROOT / "chip_smoke.py")

PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import gossipfs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    gossipfs_tpu_torch.__path__, "gossipfs_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "gossipfs_tpu" or m.startswith("gossipfs_tpu."))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["leaked"] == []
    for mod in ("config", "random", "core.state", "core.topology",
                "core.rounds", "ops.merge", "ops.merge_update", "ops._build",
                "ops.swar",
                "ops.fanout_max", "metrics.detection", "models.presets",
                "convert", "bench", "detector.api", "detector.sim",
                "utils.snapshot", "frontier", "curves", "scenarios",
                "scenarios.schedule", "scenarios.runtime",
                "scenarios.tensor", "parallel.mesh",
                "parallel.distributed", "full_scale", "obs", "obs.schema",
                "obs.recorder", "obs.monitor", "obs.timeline", "traffic",
                "traffic.audit", "traffic.workload", "campaigns",
                "campaigns.driver", "analysis", "analysis.protocol_spec",
                "suspicion.runtime", "conformance", "conformance.schedules",
                "conformance.harness", "conformance.verdict",
                "conformance.shrink", "run", "entry", "sdfs",
                "sdfs.types", "sdfs.quorum", "sdfs.store", "sdfs.election",
                "sdfs.placement", "sdfs.master", "sdfs.cluster",
                "utils.eventlog", "erasure", "erasure.codec",
                "erasure.planner", "traffic.planner", "traffic.harness",
                "cosim", "traffic_bench", "sdfs_ops", "shim",
                "shim.gossipfs_pb2", "shim.wire", "shim.retry",
                "shim.client", "shim.service", "shim.cli", "wire_ops",
                "utils.checkpoint", "utils.profiling", "obs.profile",
                "roundprof", "soak_hb16", "sweep_merge",
                "detector.udp", "native", "deploy", "deploy.launcher",
                "deploy.node", "campaigns.engines", "campaigns.__main__",
                "conformance.__main__", "native_rt", "ref_workflow",
                "analysis.framework", "analysis.probes",
                "analysis.rules_asyncio", "analysis.rules_config",
                "analysis.rules_conformance", "analysis.rules_device",
                "analysis.rules_native", "analysis.rules_obs",
                "analysis.rules_ownership", "analysis.rules_spec",
                "analysis.__main__", "analysis.spec_verify", "parity_soak",
                "sweep_rr", "shard_anchor", "stub_bisect", "verify_claims"):
        assert f"gossipfs_tpu_torch.{mod}" in doc["modules"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "gossipfs_tpu"), (
                f"{path.relative_to(ROOT)} imports {name}")
