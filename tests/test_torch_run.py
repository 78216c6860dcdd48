"""The port's BASELINE scenario runner (``gossipfs_tpu_torch/run.py``)
against the JAX package's ``bench/run.py``, on the CPU.

* ``run_scenario`` reports equal the JAX reports, timing fields aside:
  ``parity-10`` at its full size, ``sim-1k``, ``sim-10k-crash`` and
  ``sim-100k`` cut to N = 256 and 30 rounds;
* each run starts from a fresh state, so the warm-up run does not move
  the timed run's outputs, which equal one ``run_rounds`` call;
* ``sim-100k-sdfs`` (config 5) at N = 256 gives the JAX report and its
  ``cosim`` dict (the SDFS co-simulation over the membership, chunk by
  chunk), timing fields aside; over rank processes it raises, naming
  ROADMAP Queue 1 item 2;
* the CLI prints and writes the report, and refuses the card without one;
* ``--devices 2`` (two gloo rank processes on the CPU) gives the
  single-process report;
* ``ops/merge.launches_since`` (the runner's and the curves' launch
  counts) reports only the counts that moved since its snapshot.
"""

from __future__ import annotations

import json

import pytest
import torch

from gossipfs_tpu.bench import run as jax_run
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch import run
from gossipfs_tpu_torch.bench import tracked_crash_events
from gossipfs_tpu_torch.core.rounds import run_rounds
from gossipfs_tpu_torch.core.state import init_state
from gossipfs_tpu_torch.models import presets
from gossipfs_tpu_torch.ops import merge

torch.set_num_threads(1)

TIMING = {"elapsed_s", "rounds_per_sec", "speedup_vs_realtime"}
PORT_ONLY = {"device", "launches"}
CUT = dict(n_override=256, rounds_override=30)


@pytest.mark.parametrize("name,kw", [
    ("parity-10", {}), ("sim-1k", CUT), ("sim-10k-crash", CUT),
    ("sim-100k", CUT)])
def test_report_matches_jax(name, kw):
    want = jax_run.run_scenario(name, **kw)
    got = run.run_scenario(name, device="cpu", **kw)
    assert set(got) - set(want) == PORT_ONLY
    assert {k: got[k] for k in want if k not in TIMING} == \
        {k: v for k, v in want.items() if k not in TIMING}
    assert got["platform"] == "cpu" and got["device"] == "cpu"
    assert got["launches"] == {}            # the plain versions ran
    assert got["detection"]["true_detections"] > 0


def test_outputs_equal_one_run_rounds_call():
    sc = presets.ALL["sim-10k-crash"]
    rep, (final, carry, per_round) = run.run_scenario(
        sc, device="cpu", return_outputs=True, **CUT)
    cfg = run.scenario_config(sc, 256)
    events, _, churn_ok = tracked_crash_events(cfg, 30, 4, 10,
                                               device="cpu")
    s, c, m = run_rounds(init_state(cfg, device="cpu"), cfg, 30,
                         trandom.PRNGKey(0, device="cpu"), events=events,
                         crash_rate=sc.crash_rate, churn_ok=churn_ok,
                         crash_only_events=True)
    for a, b in zip((final.hb, final.asl, final.alive, final.hb_base),
                    (s.hb, s.asl, s.alive, s.hb_base)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(carry, c))
    assert all(torch.equal(a, b) for a, b in zip(per_round, m))
    assert rep["n"] == 256 and rep["fanout"] == 8


def test_sdfs_cosim_raises_naming_queue_1_items_6_7():
    """Config 5 no longer raises on one process (Queue 1 items 6-7 are
    ported: the report equals the JAX one, below); its sharded form
    raises, naming the ROADMAP item that lifts it, before any rank
    starts."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        run.run_scenario("sim-100k-sdfs", devices=2, device="cpu", **CUT)


@pytest.mark.parametrize("n,rounds", [(256, 30), (128, 17)])
def test_sdfs_cosim_report_matches_jax(n, rounds):
    kw = dict(n_override=n, rounds_override=rounds)
    want = jax_run.run_scenario("sim-100k-sdfs", **kw)
    got = run.run_scenario("sim-100k-sdfs", device="cpu", **kw)
    assert set(got) - set(want) == PORT_ONLY | {"cosim_launches"}
    assert {k: v for k, v in got["cosim"].items() if k not in TIMING} == \
        {k: v for k, v in want["cosim"].items() if k not in TIMING}
    assert {k: got[k] for k in want if k not in TIMING | {"cosim"}} == \
        {k: v for k, v in want.items() if k not in TIMING | {"cosim"}}
    cos = got["cosim"]
    assert cos["rounds"] == -(-rounds // 8) * 8 and cos["files"] == 1000
    assert cos["repair_plans"] > 0 and cos["files_readable"] > 0
    assert got["cosim_launches"] == {}      # the plain versions ran


def test_cli(tmp_path, capsys):
    out = tmp_path / "r.json"
    doc = run.main(["--scenario", "parity-10", "--rounds", "24",
                    "--device", "cpu", "--out", str(out)])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(doc)) == \
        json.loads(out.read_text())
    assert doc["scenario"] == "parity-10" and doc["rounds"] == 24
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA device"):
            run.main(["--scenario", "parity-10"])


def test_sharded_report_equals_single_process():
    kw = dict(n_override=128, rounds_override=20, device="cpu")
    one = run.run_scenario("sim-10k-crash", **kw)
    two = run.run_scenario("sim-10k-crash", devices=2, **kw)
    assert two["devices"] == 2
    assert two["detection"] == one["detection"]
    assert {k: v for k, v in two.items() if k not in TIMING | {"devices"}} \
        == {k: v for k, v in one.items() if k not in TIMING | {"devices"}}


def test_launches_since_counts_only_what_moved():
    merge.reset_launch_counts()
    with merge.counted_launch("arc_merge_update", None):
        pass
    before = merge.launch_snapshot()
    form = merge.FORMS[0]
    for _ in range(2):
        with merge.counted_launch("resident_round", None, form):
            pass
    with merge.counted_launch("fused_merge_update", None):
        pass
    assert merge.launches_since(before) == (
        {"resident_round": 2, "fused_merge_update": 1}, {form: 2})
    assert merge.launches_since(merge.launch_snapshot()) == ({}, {})
    merge.reset_launch_counts()
