"""The port's SDFS plane (``sdfs/``: master, cluster, quorum, election,
store, types) against the JAX package's, on the CPU.

The port keeps its own copies of these host modules (the JAX package's
import its placement and codec, which import JAX).  Both clusters run the
same operation sequences, in both redundancy modes: single and batch puts
(the batch crossing the vectorized placement threshold), conflicting
puts, gets with read-repair, deletes, membership views with dead and
unreachable nodes, budgeted repair passes (the per-file and the
vectorized planners), a master death and its election with the metadata
rebuild.  Every op's result, every executed plan, the master's metadata,
every store and the repair byte counters are equal after each step.
"""

from __future__ import annotations

import dataclasses

import pytest

from gossipfs_tpu.sdfs import cluster as jcluster
from gossipfs_tpu.sdfs import election as jelection
from gossipfs_tpu.sdfs import quorum as jquorum
from gossipfs_tpu_torch.sdfs import cluster as tcluster
from gossipfs_tpu_torch.sdfs import election as telection
from gossipfs_tpu_torch.sdfs import quorum as tquorum
from gossipfs_tpu_torch.sdfs import types as ttypes


def as_plain(x):
    """Dataclasses (distinct classes in the two packages) as dicts."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, dict):
        return {k: as_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [as_plain(v) for v in x]
    return x


def snapshot(c) -> dict:
    """Everything the cluster holds that an op can change."""
    return {
        "master_node": c.master_node,
        "files": as_plain(c.master.files),
        "stripes": as_plain(c.master.stripes),
        "members": c.master.members,
        "live": c.live,
        "reachable": sorted(c.reachable),
        "stores": {i: (s.listing(), dict(s._blobs))
                   for i, s in c.stores.items()},
        "pending": c.last_repair_pending,
        "bytes": (c.repair_bytes_written, c.repair_copies),
        "election_pending": c.election_pending,
    }


class Pair:
    """The same cluster in both packages, each op applied to both."""

    def __init__(self, **kw):
        self.j = jcluster.SDFSCluster(**kw)
        self.t = tcluster.SDFSCluster(**kw)

    def do(self, name, *args, **kw):
        a = getattr(self.j, name)(*args, **kw)
        b = getattr(self.t, name)(*args, **kw)
        assert as_plain(b) == as_plain(a), name
        assert snapshot(self.t) == snapshot(self.j), name
        return b


def blob(i: int, size: int = 97) -> bytes:
    return bytes((i * 31 + j) % 256 for j in range(size))


def script(p: Pair, n: int) -> None:
    yes = lambda: True  # noqa: E731
    # a batch of 70 new files: crosses BATCH_PLAN_THRESHOLD (64), so the
    # replica master places them in one vectorized draw
    p.do("put_batch", [(f"b{i}.txt", blob(i)) for i in range(70)], now=1)
    for i in range(6):
        assert p.do("put", f"s{i}.txt", blob(100 + i, 250 + i), now=2)
    # conflict window: rejected without confirmation, taken with it
    assert not p.do("put", "s0.txt", blob(7), now=10)
    assert p.do("put", "s0.txt", blob(8), now=10, confirm=yes)
    p.do("put_batch", [("s1.txt", blob(9)), ("new.txt", blob(10))], now=11)
    p.do("get", "s0.txt")
    p.do("get", "missing.txt")
    assert p.do("delete", "s5.txt")
    assert not p.do("delete", "s5.txt")
    # a correlated failure: four nodes gone from the view, two more alive
    # but unreachable; budgeted repair passes drain it
    dead = {2, 3, 5, 8}
    view = [x for x in range(n) if x not in dead]
    reach = [x for x in view if x not in (1, 9)]
    p.do("update_membership", view, reachable=reach, now=20)
    for budget in (3, 7, None):
        p.do("fail_recover", budget=budget)
    p.do("lost_files")
    p.do("update_membership", view, now=21)
    p.do("fail_recover")
    for i in (0, 1, 2, 3, 69):
        p.do("get", f"b{i}.txt")
    p.do("ls", "s2.txt")
    p.do("store_listing", 4)
    # the master dies: with elect=False only the flag is set, then the
    # central election rebuilds the metadata from the surviving stores
    view = [x for x in view if x != p.t.master_node]
    p.do("update_membership", view, now=30, elect=False)
    assert p.t.election_pending
    p.do("update_membership", view, now=31)
    assert p.t.master_node == min(view)
    p.do("fail_recover", budget=5)
    assert p.do("put", "b4.txt", blob(44), now=32)
    for i in (4, 5, 6):
        p.do("get", f"b{i}.txt")
    p.do("lost_files")
    # a wipe-out of most of the view: files are lost, the count equal
    p.do("update_membership", view[:3], now=40)
    p.do("fail_recover")
    p.do("lost_files")


@pytest.mark.parametrize("seed,n", [(0, 14), (3, 24)])
def test_replica_mode_sequence_matches_jax(seed, n):
    """n = 14 keeps at most 16 reachable candidates (the vectorized
    planner's exact Gumbel branch), n = 24 more (its oversampled one)."""
    p = Pair(n=n, seed=seed)
    script(p, n)
    assert p.t.repair_copies > 0


@pytest.mark.parametrize("rack_size", [None, 4])
def test_stripe_mode_sequence_matches_jax(rack_size):
    n = 16
    p = Pair(n=n, seed=1, redundancy="stripe", rack_size=rack_size)
    script(p, n)
    assert p.t.repair_copies > 0


def test_quorum_and_election_functions_match_jax():
    for r in range(1, 9):
        for name in ("quorum", "write_quorum", "read_quorum",
                     "claimed_write_quorum"):
            assert getattr(tquorum, name)(r) == getattr(jquorum, name)(r)
    for k, m in ((4, 2), (2, 1), (6, 3)):
        assert tquorum.stripe_read_quorum(k, m) == \
            jquorum.stripe_read_quorum(k, m)
        for slack in range(m):
            assert tquorum.stripe_write_quorum(k, m, slack) == \
                jquorum.stripe_write_quorum(k, m, slack)
    with pytest.raises(ValueError, match="write slack"):
        tquorum.stripe_write_quorum(4, 2, 2)
    assert telection.successor([5, 2, 9]) == 2
    assert telection.successor([]) is None
    assert telection.tally({1, 2, 3}, 5) and not telection.tally({1, 2}, 4)
    regs = {1: {"a": 3, "b": 1}, 2: {"a": 2}, 4: {"a": 3, "c": 7},
            6: {"a": 1}, 7: {"a": 3}}
    assert as_plain(telection.rebuild_metadata(regs, now=9)) == \
        as_plain(jelection.rebuild_metadata(regs, now=9))
    assert ttypes.REPLICATION_FACTOR == 4 and ttypes.RECOVERY_DELAY == 8
