"""The port's gRPC shim (``shim/service.py``) against the JAX package's, on
the CPU.

Every script of ``tests/test_grpc_shim.py`` runs through both packages'
servers, each over its own ``CoSim`` (same config, same seed; the port's
rounds on K2's plain version), on ephemeral localhost ports: every reply
is equal (the protocol is integer: exact equality), and each script's own
assertions hold on the port's replies.  Then the wire: the JAX package's
``ShimClient`` drives the port's server, and the two packages' method
tables are one.
"""

from __future__ import annotations

import socket
import time

import numpy as np
import pytest
import torch

from gossipfs_tpu import cosim as jcosim
from gossipfs_tpu.config import SimConfig as JConfig
from gossipfs_tpu.shim import client as jclient
from gossipfs_tpu.shim import service as jservice
from gossipfs_tpu.shim import wire as jwire
from gossipfs_tpu_torch import cosim as tcosim
from gossipfs_tpu_torch.config import SimConfig as TConfig
from gossipfs_tpu_torch.sdfs.types import REPLICATION_FACTOR
from gossipfs_tpu_torch.shim import client as tclient
from gossipfs_tpu_torch.shim import service as tservice
from gossipfs_tpu_torch.shim import wire as twire

torch.set_num_threads(1)


class ShimPair:
    """One script, two servers: the JAX package's and the port's."""

    def __init__(self, n: int = 12, seed: int = 3, **server_kw):
        self.jsim = jcosim.CoSim(JConfig(n=n), seed=seed)
        self.tsim = tcosim.CoSim(TConfig(n=n), seed=seed, device="cpu")
        self.jserver = jservice.ShimServer(self.jsim, port=0,
                                           **server_kw).start()
        self.tserver = tservice.ShimServer(self.tsim, port=0,
                                           **server_kw).start()
        self.jc = jclient.ShimClient(self.jserver.address, timeout=30.0)
        self.tc = tclient.ShimClient(self.tserver.address, timeout=30.0)

    def call(self, method: str, **req) -> dict:
        want = self.jc.call(method, **req)
        got = self.tc.call(method, **req)
        assert got == want, (method, req)
        return got

    def both(self, fn):
        """``fn`` of each package's client; the results equal."""
        want, got = fn(self.jc), fn(self.tc)
        assert got == want
        return got

    def close(self) -> None:
        for c in (self.jc, self.tc):
            c.close()
        for s in (self.jserver, self.tserver):
            s.stop()


@pytest.fixture()
def pair():
    p = ShimPair()
    try:
        yield p
    finally:
        p.close()


def seeded_bytes(size: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def test_membership_verbs_roundtrip(pair):
    assert pair.call("AliveNodes")["nodes"] == list(range(12))
    assert pair.call("Lsm", observer=0)["members"] == list(range(12))
    pair.call("Advance", rounds=3)
    pair.call("Crash", node=5)
    assert pair.call("Advance", rounds=10)["round"] == 13
    assert 5 not in pair.call("AliveNodes")["nodes"]
    assert 5 not in pair.call("Lsm", observer=0)["members"]
    resp = pair.call("Events")
    assert any(e["subject"] == 5 and not e["false_positive"]
               for e in resp["events"])
    follow_up = pair.call("Events", since=resp["next"])
    assert follow_up["events"] == [] and follow_up["next"] == resp["next"]
    pair.call("Leave", node=7)
    pair.call("Join", node=5)
    pair.call("Advance", rounds=4)
    for obs in (0, 5, 11):
        pair.call("Lsm", observer=obs)
    pair.call("Vitals")


def test_put_get_delete_ls_store(pair):
    payload = b"wikipedia dump shard" * 100
    assert pair.both(lambda c: c.put("file1.txt", payload))
    assert pair.both(lambda c: c.get("file1.txt")) == payload
    replicas = pair.call("Ls", file="file1.txt")["replicas"]
    assert len(replicas) == REPLICATION_FACTOR
    assert pair.call("Store", node=replicas[0])["listing"]["file1.txt"] == 1
    pair.call("ShowMetadata")
    assert pair.call("Delete", file="file1.txt")["ok"]
    assert pair.call("Get", file="file1.txt") == {"found": False,
                                                   "data_b64": ""}
    assert pair.call("Ls", file="file1.txt")["replicas"] == []


def test_multi_mb_payload_roundtrip(pair):
    payload = seeded_bytes(4 * 1024 * 1024, 5)
    assert pair.both(lambda c: c.put("file5.txt", payload))
    assert pair.both(lambda c: c.get("file5.txt")) == payload


def test_write_write_conflict_window(pair):
    assert pair.both(lambda c: c.put("f.txt", b"v1"))
    assert not pair.both(lambda c: c.put("f.txt", b"v2"))
    assert pair.both(lambda c: c.put("f.txt", b"v2", confirm=True))
    assert pair.both(lambda c: c.get("f.txt")) == b"v2"


def test_get_put_info_and_update_file_version(pair):
    info = pair.call("GetPutInfo", file="a.txt")
    assert info["ok"] and info["version"] == 1
    info2 = pair.call("GetPutInfo", file="a.txt")
    assert (info2["ok"], info2["conflict"]) == (False, True)
    info3 = pair.call("GetPutInfo", file="a.txt", confirm=True)
    assert info3["ok"] and info3["version"] == 2
    node = info["replicas"][0]
    pair.call("UpdateFileVersion", node=node, file="a.txt", version=2)
    assert pair.call("GetFileData", node=node,
                     file="a.txt")["local_version"] == 2
    assert pair.call("GetFileInfo", file="a.txt")["version"] == 2
    assert pair.call("GetFileInfo", file="none.txt")["version"] == -1


def test_remote_reput_copies_bytes(pair):
    assert pair.both(lambda c: c.put("r.txt", b"replicate me"))
    held = pair.call("Ls", file="r.txt")["replicas"]
    target = next(i for i in range(12) if i not in held)
    assert pair.call("RemoteReput", source=held[0], target=target,
                     file="r.txt", version=1)["ok"]
    assert pair.call("Store", node=target)["listing"]["r.txt"] == 1
    assert not pair.call("RemoteReput", source=target, target=held[0],
                         file="nope.txt", version=1)["ok"]


def test_vote_majority_elects(pair):
    n_live = len(pair.tsim.cluster.live)
    for voter in range(n_live // 2 + 1):
        resp = pair.call("Vote", candidate=1, voter=voter)
    assert resp["elected"]
    assert pair.tsim.cluster.master_node == pair.jsim.cluster.master_node \
        == 1
    pair.call("Vote", candidate=3, voter=0)
    assert pair.call("Vote", candidate=1, voter=0)["votes"] == 1


def test_assign_new_master_returns_listing(pair):
    assert pair.both(lambda c: c.put("m.txt", b"x"))
    node = pair.call("Ls", file="m.txt")["replicas"][0]
    resp = pair.call("AssignNewMaster", node=node, master=2)
    assert resp["listing"] == {"m.txt": 1}
    assert pair.tsim.cluster.master_node == 2


def test_get_update_meta_plans_repairs(pair):
    assert pair.both(lambda c: c.put("p.txt", b"y"))
    replicas = pair.call("Ls", file="p.txt")["replicas"]
    view = [i for i in range(12) if i != replicas[0]]
    (plan,) = pair.call("GetUpdateMeta", membership=view)["plans"]
    assert plan["file"] == "p.txt" and replicas[0] not in plan["new_nodes"]
    assert set(plan["survivors"]) == set(replicas) - {replicas[0]}
    assert pair.tsim.cluster.live == list(range(12))
    assert pair.tsim.cluster.master_node == 0


def test_grep_and_delete_file_data(pair):
    pair.both(lambda c: c.put("g.txt", b"z"))
    lines = pair.call("Grep", pattern=r"put g\.txt")["lines"]
    assert lines and lines[0]["kind"] == "put"
    replicas = pair.call("Ls", file="g.txt")["replicas"]
    old = pair.call("GetDeleteInfo", file="g.txt")["old_replicas"]
    assert set(old) == set(replicas)
    for node in old:
        assert pair.call("DeleteFileData", node=node, file="g.txt")["ok"]
    assert pair.call("Store", node=old[0])["listing"] == {}


def test_grep_rpc_node_filter(pair):
    pair.call("Advance", rounds=2)
    pair.call("Crash", node=6)
    pair.call("Advance", rounds=12)
    all_lines = pair.call("Grep", pattern="Failure Detected")["lines"]
    assert all_lines
    obs = int(all_lines[0]["node"])
    scoped = pair.call("Grep", pattern="Failure Detected", node=obs)["lines"]
    assert scoped and all(int(e["node"]) == obs for e in scoped)
    other = next(k for k in range(12)
                 if k != 6 and k not in {int(e["node"]) for e in all_lines})
    assert pair.call("Grep", pattern="Failure Detected",
                     node=other)["lines"] == []


def test_advance_bulk_serves_snapshot_reads(pair):
    pair.call("Advance", rounds=3)
    pair.call("Crash", node=5)
    assert pair.call("AdvanceBulk", rounds=20,
                     snapshot_every=5)["round_target"] == 23
    replies = {}
    for name, c in (("jax", pair.jc), ("port", pair.tc)):
        deadline = time.monotonic() + 60
        seen = []
        while time.monotonic() < deadline:
            reply = c.call("Lsm", observer=0)
            seen.append(reply.get("as_of_round"))
            if reply.get("as_of_round") == 23:
                break
            time.sleep(0.005)
        assert set(seen) <= {None, 8, 13, 18, 23}
        served = [r for r in seen if r is not None]
        assert served == sorted(served) and served[-1] == 23
        replies[name] = (reply, c.call("AliveNodes"))
    assert replies["port"] == replies["jax"]
    assert 5 not in replies["port"][0]["members"]
    assert replies["port"][1]["as_of_round"] == 23
    pair.call("Advance", rounds=1)
    reply = pair.call("Lsm", observer=0)
    assert "as_of_round" not in reply and 5 not in reply["members"]
    pair.call("Events")


def test_conflict_confirmation_callback_roundtrip(pair):
    """Both masters dial one requester (the port's server) back; its
    prompt's answer decides each put."""
    asked: list[str] = []

    def prompt(name: str) -> bool:
        asked.append(name)
        return True

    requester = tservice.ShimServer(
        tcosim.CoSim(TConfig(n=4), seed=9, device="cpu"), port=0,
        confirm_handler=prompt).start()
    try:
        assert pair.call("Put", file="w.txt", data_b64="")["ok"] is True
        reply = pair.call("GetPutInfo", file="w.txt",
                          callback=requester.address)
        assert reply["ok"] is True and asked == ["w.txt", "w.txt"]
        requester.servicer.confirm_handler = lambda name: False
        reply = pair.call("GetPutInfo", file="w.txt",
                          callback=requester.address)
        assert (reply["ok"], reply["conflict"]) == (False, True)
    finally:
        requester.stop()
    assert pair.call("GetPutInfo", file="w.txt")["conflict"] is True


def test_put_verb_forwards_callback(pair):
    answers = iter([True, True, False, False])
    requester = tservice.ShimServer(
        tcosim.CoSim(TConfig(n=4), seed=9, device="cpu"), port=0,
        confirm_handler=lambda name: next(answers)).start()
    try:
        assert pair.both(lambda c: c.put("v.txt", b"abc")) is True
        assert pair.call("Put", file="v.txt", data_b64="",
                         callback=requester.address)["ok"] is True
        assert pair.call("Put", file="v.txt", data_b64="",
                         callback=requester.address)["ok"] is False
    finally:
        requester.stop()


def test_conflict_confirmation_timeout_rejects():
    """A requester that accepts the connection and never answers is a
    reject after ``confirm_timeout`` seconds, on both servers."""
    p = ShimPair(confirm_timeout=1.0)
    silent = socket.socket()
    silent.bind(("127.0.0.1", 0))
    silent.listen(2)
    blackhole = f"127.0.0.1:{silent.getsockname()[1]}"
    try:
        assert p.call("Put", file="t.txt", data_b64="")["ok"] is True
        for c in (p.jc, p.tc):
            t0 = time.monotonic()
            reply = c.call("GetPutInfo", file="t.txt", callback=blackhole)
            elapsed = time.monotonic() - t0
            assert (reply["ok"], reply["conflict"]) == (False, True)
            assert 0.9 <= elapsed < 10.0
        reply = p.call("GetPutInfo", file="t.txt", callback="127.0.0.1:9")
        assert (reply["ok"], reply["conflict"]) == (False, True)
    finally:
        silent.close()
        p.close()


def test_servicer_vitals_in_process():
    sim = tcosim.CoSim(TConfig(n=8, remove_broadcast=False,
                               fresh_cooldown=True), seed=0, device="cpu")
    (line,) = tservice.ShimServicer(sim).Vitals({}, None)["lines"]
    assert line["engine"] == "sim" and line["round"] == 0


def test_method_surface_and_wire_tables_match_the_reference():
    assert tservice.ShimServicer.METHODS == jservice.ShimServicer.METHODS
    assert twire.SERVICE == jwire.SERVICE == "gossipfs.Shim"
    assert twire.MAX_MESSAGE_MB == jwire.MAX_MESSAGE_MB
    assert {k: tuple(c.DESCRIPTOR.full_name for c in v)
            for k, v in twire.METHOD_TYPES.items()} == \
        {k: tuple(c.DESCRIPTOR.full_name for c in v)
         for k, v in jwire.METHOD_TYPES.items()}
    # one gossipfs.proto in the descriptor pool: the same message classes
    assert twire.pb.PutRequest is jwire.pb.PutRequest


def test_reference_client_drives_the_port_server():
    """The JAX package's ShimClient, unchanged, against the port's server:
    the wire is one contract."""
    sim = tcosim.CoSim(TConfig(n=10), seed=1, device="cpu")
    server = tservice.ShimServer(sim, port=0).start()
    client = jclient.ShimClient(server.address, timeout=30.0)
    try:
        assert client.advance(3) == 3
        payload = seeded_bytes(300_000, 7)
        assert client.put("x.txt", payload)
        assert client.get("x.txt") == payload
        client.crash(6)
        assert client.advance(10) == 13
        assert 6 not in client.lsm(0)
        assert 6 not in client.alive_nodes()
        assert len(client.ls("x.txt")) == REPLICATION_FACTOR
        assert client.advance_bulk(5, snapshot_every=5) == 18
        assert client.grep("Failure Detected")
        assert client.call("Vitals")["lines"][0]["engine"] == "sim"
    finally:
        client.close()
        server.stop()
