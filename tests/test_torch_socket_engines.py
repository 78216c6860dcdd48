"""The port's socket engines over real localhost datagrams (tier-1 lane).

Twins of what the JAX package runs in its fast lane, with its tolerant
assertions (these engines are wall-clock; exact rounds are the lockstep
test's job, ``test_torch_udp_lockstep.py``):

* the asyncio ``UdpCluster``: 10 nodes join to full membership, and a
  crash is detected (not as a false positive) and removed everywhere;
* the native C++ engine: 8 nodes converge, detect a crash, and rejoin
  the node after its cooldown;
* the conformance smoke: one short schedule (``leave_broadcast``) through
  the reference oracle, the tensor column on the CPU and the udp column,
  every row agreeing.

Every cluster takes its ports from a free window (``_free_port_base``):
the JAX package's tests bind fixed ports in another worker.  The deploy
node's import chain is checked to stay free of torch.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys

from gossipfs_tpu_torch import native
from gossipfs_tpu_torch.conformance import harness, schedules, verdict
from gossipfs_tpu_torch.deploy.launcher import _free_port_base
from gossipfs_tpu_torch.detector.udp import UdpCluster


def _udp_base(n: int) -> int:
    return _free_port_base(n, tcp=False)


def test_udp_join_converges_to_full_membership():
    async def scenario():
        c = UdpCluster(n=10, base_port=_udp_base(10), period=0.05)
        try:
            await c.start_all()
            await c.run(12)
            return [c.membership(i) for i in range(10)]
        finally:
            c.stop_all()

    for view in asyncio.run(scenario()):
        assert view == list(range(10))


def test_udp_crash_detection_and_remove_broadcast():
    async def scenario():
        c = UdpCluster(n=10, base_port=_udp_base(10), period=0.1,
                       fresh_cooldown=True)
        try:
            await c.start_all()
            await c.run(10)
            c.crash(4)
            for _ in range(10):
                await c.run(c.t_fail + 5)
                views = [c.membership(i) for i in c.alive_nodes()]
                if all(4 not in v for v in views):
                    break
            return c.drain_events(), views
        finally:
            c.stop_all()

    events, views = asyncio.run(scenario())
    assert any(e.subject == 4 and not e.false_positive for e in events)
    for view in views:
        assert 4 not in view


def test_native_converges_detects_and_rejoins():
    with native.NativeUdpDetector(n=8, base_port=_udp_base(8), period=0.1,
                                  fresh_cooldown=True) as det:
        det.advance(4)
        for obs in range(8):
            assert det.membership(obs) == list(range(8))
        assert det.alive_nodes() == list(range(8))

        det.crash(5)
        det.advance(12)  # t_fail=5 periods + dissemination slack
        assert 5 not in det.alive_nodes()
        events = det.drain_events()
        assert any(e.subject == 5 and not e.false_positive for e in events)
        for obs in (0, 3, 7):
            assert 5 not in det.membership(obs)

        det.advance(8)   # the cooldown expires first
        det.join(5)
        det.advance(10)
        assert 5 in det.alive_nodes()
        assert 5 in det.membership(0)


def test_conformance_smoke_reference_tensor_udp():
    case = schedules.generate("leave_broadcast", seed=0)
    ref = harness.run_case_reference(case)
    assert verdict.oracle_selfcheck(case, ref)["ok"]
    rows = [verdict.compare(case, ref,
                            harness.run_case_tensor(case, device="cpu")),
            verdict.compare(case, ref, harness.run_case_udp(case))]
    for row in rows:
        assert row["ok"], (row["engine"], row["checks"])
    assert [r["engine"] for r in rows] == ["tensor", "udp"]


def test_deploy_node_imports_no_torch():
    probe = ("import json, sys; import gossipfs_tpu_torch.deploy.node, "
             "gossipfs_tpu_torch.deploy.launcher; print(json.dumps("
             "sorted(m for m in ('torch', 'jax', 'gossipfs_tpu') "
             "if m in sys.modules)))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
