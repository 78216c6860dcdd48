"""The distributed election through the port's RPC surface against the JAX
package's, on the CPU (the twin of ``tests/test_election_rpc.py``).

Each package's ``CoSim(election="rpc")`` sits behind its own live shim,
its central ``cluster._elect`` shortcut poisoned; the same script kills
the master, and the new master must emerge through each server's own
Vote / AssignNewMaster handlers: the winner, the election's log line and
every reply equal.  Then the traffic driver: ``drive_shim`` through the
port's server against ``drive_cosim`` on the port's ``CoSim`` and against
the JAX package's ``drive_shim`` through its own server.
"""

from __future__ import annotations

import pytest
import torch

from gossipfs_tpu import cosim as jcosim
from gossipfs_tpu.config import SimConfig as JConfig
from gossipfs_tpu.shim import client as jclient
from gossipfs_tpu.shim import service as jservice
from gossipfs_tpu.traffic import workload as jworkload
from gossipfs_tpu_torch import cosim as tcosim
from gossipfs_tpu_torch.config import SimConfig as TConfig
from gossipfs_tpu_torch.shim import client as tclient
from gossipfs_tpu_torch.shim import service as tservice
from gossipfs_tpu_torch.traffic import workload as tworkload

torch.set_num_threads(1)


def poisoned(self, now=0):  # pragma: no cover - must never run
    raise AssertionError("central _elect used in rpc election mode")


class RpcPair:
    def __init__(self, monkeypatch, n: int = 10, seed: int = 3):
        self.jsim = jcosim.CoSim(JConfig(n=n), seed=seed, election="rpc")
        self.tsim = tcosim.CoSim(TConfig(n=n), seed=seed, election="rpc",
                                 device="cpu")
        for sim in (self.jsim, self.tsim):
            monkeypatch.setattr(type(sim.cluster), "_elect", poisoned)
        self.jserver = jservice.ShimServer(self.jsim, port=0).start()
        self.tserver = tservice.ShimServer(self.tsim, port=0).start()
        self.jc = jclient.ShimClient(self.jserver.address, timeout=30.0)
        self.tc = tclient.ShimClient(self.tserver.address, timeout=30.0)

    def call(self, method: str, **req) -> dict:
        want = self.jc.call(method, **req)
        got = self.tc.call(method, **req)
        assert got == want, (method, req)
        return got

    def check(self):
        assert self.tsim.cluster.master_node == self.jsim.cluster.master_node
        assert self.tsim.cluster.election_pending == \
            self.jsim.cluster.election_pending
        assert self.tsim.log.entries == self.jsim.log.entries

    def close(self):
        for c in (self.jc, self.tc):
            c.close()
        for s in (self.jserver, self.tserver):
            s.stop()


@pytest.fixture()
def rpc_pair(monkeypatch):
    p = RpcPair(monkeypatch)
    try:
        yield p
    finally:
        p.close()


def test_master_crash_elects_via_rpc_surface(rpc_pair):
    p = rpc_pair
    assert p.call("Put", file="meta.txt", data_b64="c3Vydml2ZXM=")["ok"]
    p.call("Advance", rounds=3)
    p.call("Crash", node=0)
    p.call("Advance", rounds=12)
    p.check()
    assert p.tsim.cluster.master_node == 1
    assert not p.tsim.cluster.election_pending
    lines = p.call("Grep", pattern="Vote/AssignNewMaster")["lines"]
    assert lines and lines[0]["kind"] == "election"
    assert p.call("Get", file="meta.txt")["data_b64"] == "c3Vydml2ZXM="
    assert p.call("Ls", file="meta.txt")["replicas"]
    assert p.call("Put", file="after.txt", data_b64="bmV3")["ok"]
    p.call("ShowMetadata")
    p.check()


def test_split_vote_stalls_until_majority(rpc_pair):
    p = rpc_pair
    n_live = len(p.tsim.cluster.live)
    for voter in range(n_live // 2):
        assert not p.call("Vote", candidate=7, voter=voter)["elected"]
    assert p.tsim.cluster.master_node == 0
    assert p.call("Vote", candidate=7, voter=n_live // 2)["elected"]
    assert p.tsim.cluster.master_node == 7
    p.check()


def test_winner_crash_during_rebuild_aborts_and_reelects(rpc_pair):
    p = rpc_pair
    p.call("Advance", rounds=3)
    p.call("Crash", node=0)
    killed = {}
    for name, server, sim in (("jax", p.jserver, p.jsim),
                              ("port", p.tserver, p.tsim)):
        orig = server.servicer._self_call
        killed[name] = []

        def crash_winner(method, _orig=orig, _sim=sim, _k=killed[name],
                         **req):
            if method == "AssignNewMaster" and not _k:
                _k.append(req["master"])
                _sim.detector.crash(req["master"])
                _sim.detector.advance(1)
            return _orig(method, **req)

        server.servicer._self_call = crash_winner
    p.call("Advance", rounds=12)
    assert killed["port"] == killed["jax"] == [1]
    p.check()
    p.call("Advance", rounds=12)
    p.check()
    assert p.tsim.cluster.master_node == 2
    assert not p.tsim.cluster.election_pending


def test_local_mode_unchanged():
    sim = tcosim.CoSim(TConfig(n=10), seed=3, device="cpu")
    sim.tick(3)
    sim.detector.crash(0)
    sim.tick(12)
    assert sim.cluster.master_node == 1


def test_run_pending_election_is_a_no_op_outside_rpc_mode():
    sim = tcosim.CoSim(TConfig(n=6), seed=0, device="cpu")
    assert tservice.ShimServicer(sim).run_pending_election() is False


SPEC = dict(rate=3.0, n_keys=8, put_frac=0.8, delete_frac=0.1, seed=6)


def test_drive_shim_matches_cosim_and_the_reference():
    """The same op stream through the port's gRPC boundary: issued and
    acked counts equal the in-process driver's, and the whole window row
    (latencies aside) equals the JAX package's ``drive_shim``."""
    rounds = 4
    local_sim = tcosim.CoSim(TConfig(n=12), seed=3, device="cpu")
    local_sim.tick(3)
    local = tworkload.drive_cosim(local_sim,
                                  tworkload.Workload(
                                      tworkload.WorkloadSpec(**SPEC)),
                                  rounds)
    remote = {}
    for name, cosim, cfg, service, client, wl in (
            ("port", tcosim, TConfig, tservice, tclient, tworkload),
            ("jax", jcosim, JConfig, jservice, jclient, jworkload)):
        kw = {"device": "cpu"} if name == "port" else {}
        sim = cosim.CoSim(cfg(n=12), seed=3, **kw)
        server = service.ShimServer(sim, port=0).start()
        c = client.ShimClient(server.address, timeout=30.0)
        try:
            c.advance(3)
            remote[name] = wl.drive_shim(
                c, wl.Workload(wl.WorkloadSpec(**SPEC)), rounds,
                start_round=sim.round)
            remote[name + "_log"] = list(sim.log.entries)
        finally:
            c.close()
            server.stop()
    got = remote["port"]
    assert got["ops_issued"] == local["ops_issued"]
    assert got["ops_acked"] == local["ops_acked"]
    for kind in ("put", "get", "delete"):
        for k in ("issued", "acked"):
            assert got["by_op"][kind][k] == local["by_op"][kind][k]

    def counts(doc):
        return {k: v for k, v in doc.items() if k != "by_op"} | {
            op: (r["issued"], r["acked"]) for op, r in doc["by_op"].items()}

    assert counts(got) == counts(remote["jax"])
    assert remote["port_log"] == remote["jax_log"]
