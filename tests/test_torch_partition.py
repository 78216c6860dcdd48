"""The partition metrics, ``SimDetector``'s scenario seam and the partition
sweep, against the JAX package.

* ``partition_round_stats`` on the same states (mid-split and after heal)
  and ``summarize_partition`` on the same series and events;
* ``SimDetector.load_scenario`` / ``clear_scenario`` / ``scenario_status``,
  the load-time arc capability checks, the join-in-window refusal, and
  ``advance`` / ``advance_bulk`` (one call and chunked) event streams
  equal to the JAX detector's for one verb script, random edges and
  aligned arcs;
* ``curves.partition_sweep`` at N = 256 and 1,024 equal field for field
  to the reference's, the N = 1,024 row also held against the committed
  ``PARTITION_r07.json`` in the fields its random stream does not decide;
  the CLI.
Tolerance: exact (``local_fp_rate`` is the same float expression of equal
integers).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu import scenarios as jscn
from gossipfs_tpu.bench import curves as jcurves
from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.detector.sim import SimDetector as JaxDetector
from gossipfs_tpu.metrics import detection as jdet
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu_torch import curves
from gossipfs_tpu_torch import scenarios as tscn
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.detector.sim import PackedDetector, SimDetector
from gossipfs_tpu_torch.metrics import detection as tdet
from gossipfs_tpu_torch.suspicion import SuspicionParams

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N = 64
RANDOM = dict(n=N, topology="random", fanout=6, remove_broadcast=False,
              fresh_cooldown=True, t_fail=3, t_cooldown=6, view_dtype="int8",
              hb_dtype="int16")
ARCS = dict(n=N, topology="random_arc", fanout=16, arc_align=8,
            remove_broadcast=False, fresh_cooldown=True, t_fail=3,
            t_cooldown=6, view_dtype="int8", hb_dtype="int8")


def pair(kw, sus=True, seed=5):
    j = JaxDetector(JaxConfig(**kw, suspicion=JaxSus(t_suspect=2)
                              if sus else None), seed=seed)
    t = SimDetector(SimConfig(**kw, suspicion=SuspicionParams(t_suspect=2)
                              if sus else None), seed=seed, device="cpu")
    return j, t


def fault(mod, arcs: bool):
    """A split, slow senders and (on random edges) lossy links; on arcs
    flappers and an outage instead."""
    kw = dict(
        partitions=(mod.Partition(start=2, end=10,
                                  groups=(tuple(range(N // 2)),)),),
        slow_nodes=(mod.SlowNode(start=0, end=14, stride=3,
                                 nodes=(1, 2, 40)),))
    if arcs:
        kw.update(flapping=(mod.Flapping(start=1, end=12, up=2, down=2,
                                         nodes=(8, 9, 50)),),
                  outages=(mod.CorrelatedOutage(start=3, end=7,
                                                nodes=(20, 21, 22)),))
    else:
        kw.update(link_faults=(mod.LinkFault(
            start=0, end=12, rate=0.4, src=tuple(range(16, 32)),
            dst=tuple(range(N))),))
    return mod.FaultScenario(name="faults", n=N, **kw)


def same_state(j, t):
    np.testing.assert_array_equal(t.state.hb.numpy(), np.asarray(j.state.hb))
    np.testing.assert_array_equal(t.state.status.numpy(),
                                  np.asarray(j.state.status))
    np.testing.assert_array_equal(t.state.alive.numpy(),
                                  np.asarray(j.state.alive))
    assert t.state.round == int(j.state.round)


def script(d, mod, arcs, advance):
    """Arm mid-run (round0 = 3), crash inside the windows, run past the
    horizon, clear, join, go on."""
    advance(d, 3)
    d.load_scenario(fault(mod, arcs))
    d.crash(5)
    advance(d, 4)
    d.crash(45)
    advance(d, 14)
    d.clear_scenario()
    d.join(5)
    advance(d, 5)


@pytest.mark.parametrize("path", ["interactive", "bulk", "chunked"])
@pytest.mark.parametrize("shape", ["random", "arcs"])
def test_scenario_script_matches_jax(shape, path):
    arcs = shape == "arcs"
    j, t = pair(ARCS if arcs else RANDOM)

    def advance(d, r):
        if path == "interactive":
            d.advance(r)
        elif path == "bulk" or not isinstance(d, SimDetector):
            d.advance_bulk(r)
        else:
            d.advance_bulk(r, snapshot_every=3)

    script(j, jscn, arcs, advance)
    script(t, tscn, arcs, advance)
    want = [dataclasses.astuple(e) for e in j.drain_events()]
    got = [dataclasses.astuple(e) for e in t.drain_events()]
    assert got == want
    assert any(e[2] == 45 for e in got) and any(e[3] for e in got)
    same_state(j, t)
    assert t.suspicion_status() == j.suspicion_status()
    assert t.suspicion_status()["refutations"] > 0
    assert t.alive_nodes() == j.alive_nodes()


def test_scenario_status_and_clear():
    j, t = pair(RANDOM)
    assert t.scenario_status() is None
    for d, mod in ((j, jscn), (t, tscn)):
        d.advance(2)
        d.load_scenario(fault(mod, False))
        d.advance(3)
    assert t.scenario_status() == j.scenario_status()
    st = t.scenario_status()
    assert st["round"] == 3 and st["active"] and st["horizon"] == 14
    assert len(st["rules"]) == 3
    t.clear_scenario()
    assert t.scenario_status() is None
    # loading replaces: the windows count from the new arming round
    t.load_scenario(tscn.split_halves(N, 1, 4))
    assert t.scenario_status()["round"] == 0


def test_load_time_checks_and_join_refusal():
    j, t = pair(ARCS, sus=False)
    for d, mod in ((j, jscn), (t, tscn)):
        loss = mod.FaultScenario(name="loss", n=N, link_faults=(
            mod.LinkFault(start=0, end=10, rate=0.5, src=(1, 2),
                          dst=tuple(range(N))),))
        with pytest.raises(ValueError, match="no group form"):
            d.load_scenario(loss)
        assert d.scenario_status() is None      # nothing half-armed
        with pytest.raises(ValueError, match="align-group-closed"):
            d.load_scenario(mod.FaultScenario(name="p", n=N, partitions=(
                mod.Partition(start=0, end=4, groups=((0, 1, 2),)),)))
        with pytest.raises(ValueError, match="scenario is for n=32"):
            d.load_scenario(mod.split_halves(32, 0, 4))
        d.load_scenario(mod.split_halves(N, 2, 6))
        d.advance(3)
        d.join(7)
        with pytest.raises(NotImplementedError,
                           match="join during an active scenario window"):
            d.advance(1)
        with pytest.raises(NotImplementedError,
                           match="join during an active scenario window"):
            d.advance_bulk(2)
        d.advance(0)
    # the REMOVE broadcast cannot be filtered: refused at load
    t2 = SimDetector(SimConfig(n=16), device="cpu")
    with pytest.raises(ValueError, match="remove_broadcast"):
        t2.load_scenario(tscn.split_halves(16, 0, 4))
    assert not hasattr(PackedDetector, "load_scenario")


def test_partition_round_stats_and_summary_match_jax():
    j, t = pair(RANDOM, sus=False, seed=2)
    pid = jscn.split_halves(N, 2, 18).partitions[0].pid(N)
    series = {"j": [], "t": []}
    for d, mod in ((j, jscn), (t, tscn)):
        d.load_scenario(mod.split_halves(N, 2, 18))
    for r in range(32):
        if r == 4:
            for d in (j, t):
                d.crash(10)
                d.crash(50)
        j.advance(1)
        t.advance(1)
        want = np.asarray(jdet.partition_round_stats(j.state,
                                                     jnp.asarray(pid)))
        got = tdet.partition_round_stats(t.state, torch.from_numpy(pid))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"round {r}")
        for key, row, rnd in (("j", want, int(j.state.round)),
                              ("t", got.numpy(), t.state.round)):
            series[key].append({
                "round": rnd, "cross_members": int(row[0]),
                "cross_hb_max": int(row[1]), "cross_complete": bool(row[2]),
                "complete": bool(row[3]), "n_alive": int(row[4])})
    assert series["t"] == series["j"]
    assert any(r["cross_complete"] for r in series["t"])
    crash_rounds = {10: 4, 50: 4}
    want = jdet.summarize_partition(series["j"], j.drain_events(), pid, 2, 18,
                                    crash_rounds=crash_rounds)
    got = tdet.summarize_partition(series["t"], t.drain_events(), pid, 2, 18,
                                   crash_rounds=crash_rounds)
    assert got.as_dict() == want.as_dict()
    assert got.cross_hb_advances == 0 and got.reconverge_rounds > 0
    assert got.cross_detections > 0
    assert [f.name for f in dataclasses.fields(tdet.PartitionReport)] == [
        f.name for f in dataclasses.fields(jdet.PartitionReport)]


@pytest.mark.parametrize("n", [256, 1024])
def test_partition_sweep_matches_jax(n):
    want = jcurves.partition_sweep(ns=(n,))
    got = curves.partition_sweep(ns=(n,), device="cpu")
    assert got == want
    row = got["rows"][0]
    assert row["cross_hb_advances"] == 0
    assert 0 < row["reconverge_rounds"] <= row["reconverge_bound"]
    if n != 1024:
        return
    # the JAX package's committed netsplit artifact (N = 1,024): equal in
    # every field the split's shape decides.  Its draw-dependent counts
    # (cross_detections, local_false_positives and its rate,
    # full_view_rounds) come from an older random stream: today's JAX
    # package gives this run's, not the file's.
    doc = json.loads((ROOT / "PARTITION_r07.json").read_text())
    committed = doc["rows"][0]
    assert got["metric"] == doc["metric"]
    assert got["protocol"] == doc["protocol"]
    mine = json.loads(json.dumps(row))      # JSON object keys are strings
    assert set(mine) == set(committed)
    for key in ("n", "fanout", "split_at", "heal_at", "split_rounds",
                "reconverge_bound", "split_brain_rounds",
                "view_divergence_max", "view_divergence_at_heal",
                "cross_hb_advances", "reconverge_rounds", "local_ttd"):
        assert mine[key] == committed[key], key


def test_curves_cli(tmp_path, capsys):
    out = tmp_path / "p.json"
    curves.main(["--partition", "--n", "64", "--device", "cpu", "--out",
                 str(out)])
    doc = json.loads(capsys.readouterr().out)
    assert doc == json.loads(out.read_text())
    assert doc["rows"][0]["n"] == 64
    # the TTD/FPR sweep is ported (tests/test_torch_curves_sweep.py); the
    # suspicion A/B is not
    with pytest.raises(SystemExit, match="not ported yet"):
        curves.main(["--suspicion", "--device", "cpu"])
