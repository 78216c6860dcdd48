"""Config 5 over rank processes (``run.run_scenario("sim-100k-sdfs",
devices=2)``, ``run.run_cosim_job``) on 2 gloo CPU ranks, against the
port's one-process run and the JAX package's ``bench/run.py``, exact.

* at (N, rounds) = (128, 17) and (256, 30) the sharded report's ``cosim``
  dict, detection report and every other field equal the one-process
  run's and the JAX package's, timing aside; ``cosim_launches`` is rank
  0's (none: the plain versions ran), and ``cosim_ranks`` gives each
  rank's figures;
* on a cluster that empties, every rank stops after the same chunk (the
  chunk the pipelined reference had already run counted), as the
  one-process run does;
* ``plain=True`` with ``devices=2`` raises; a ring configuration still
  runs in one process.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from gossipfs_tpu.bench import run as jax_run
from gossipfs_tpu_torch import run
from gossipfs_tpu_torch.models import presets
from gossipfs_tpu_torch.parallel import distributed

torch.set_num_threads(1)

TIMING = {"elapsed_s", "rounds_per_sec", "speedup_vs_realtime"}
SIZES = [(128, 17), (256, 30)]


def untimed(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k not in TIMING}


def port_report(n: int, rounds: int, devices: int) -> dict:
    return run.run_scenario("sim-100k-sdfs", n_override=n,
                            rounds_override=rounds, devices=devices,
                            device="cpu")


@pytest.fixture(scope="module")
def sharded():
    """Both sizes' 2-rank runs, their launches side by side."""
    with ThreadPoolExecutor(len(SIZES)) as pool:
        reports = pool.map(lambda s: port_report(*s, 2), SIZES)
    return dict(zip(SIZES, reports))


@pytest.mark.parametrize("n,rounds", SIZES)
def test_sharded_report_equals_one_process_and_jax(sharded, n, rounds):
    two = sharded[n, rounds]
    one = port_report(n, rounds, 1)
    want = jax_run.run_scenario("sim-100k-sdfs", n_override=n,
                                rounds_override=rounds)
    assert two["devices"] == 2
    assert set(two) - set(one) == {"cosim_ranks"}
    assert untimed(two["cosim"]) == untimed(one["cosim"]) == \
        untimed(want["cosim"])
    assert two["detection"] == one["detection"] == want["detection"]
    skip = TIMING | {"cosim", "cosim_ranks", "devices"}
    assert {k: v for k, v in two.items() if k not in skip} == \
        {k: v for k, v in one.items() if k not in skip - {"cosim_ranks"}}
    assert {k: two[k] for k in want if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
    assert two["cosim_launches"] == one["cosim_launches"] == {}
    ranks = two["cosim_ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["nloc"] == n // 2 and r["backend"] == "gloo"
               and r["rounds"] == two["cosim"]["rounds"] for r in ranks)
    # the same collectives on every rank: each chunk's all-reduces, one
    # broadcast and one gather
    assert ranks[0]["collectives"]["calls"] == ranks[1]["collectives"]["calls"]


def test_empty_cluster_stops_every_rank_after_the_same_chunk():
    """Churn that may kill the introducer too empties the cluster: both
    runners stop after the chunk that emptied it plus the one the
    pipelined reference had dispatched, and report the same."""
    sc = dataclasses.replace(presets.ALL["sim-100k-sdfs"], crash_rate=0.3,
                             rejoin_rate=0.0, n_files=100)
    cfg = run.scenario_config(sc, 64)
    churn = torch.ones(64, dtype=torch.bool)
    one = run.run_cosim(sc, cfg, 80, 0, device="cpu", churn_ok=churn)
    job = dict(scenario=sc, config=cfg, rounds=80, seed=0, churn_ok=churn)
    ranks = distributed.launch(run.run_cosim_job, 2, (job,), device="cpu",
                               threads=1, timeout=300)
    assert one["final_alive"] == 0 and one["rounds"] < 80
    assert untimed(ranks[0]["cosim"]) == untimed(one)
    assert ranks[0]["rounds"] == ranks[1]["rounds"] == one["rounds"]
    assert "cosim" not in ranks[1]


def test_plain_sharded_raises_and_ring_runs_in_one_process():
    with pytest.raises(ValueError, match="one process"):
        run.run_scenario("sim-100k-sdfs", devices=2, device="cpu",
                         plain=True, n_override=64, rounds_override=8)
    sc = dataclasses.replace(presets.ALL["sim-100k-sdfs"],
                             config=presets.ALL["sim-1k"].config,
                             n_files=20)
    kw = dict(n_override=16, rounds_override=16, device="cpu")
    ring = run.run_scenario(sc, devices=2, **kw)
    one = run.run_scenario(sc, **kw)
    assert ring["topology"] == "ring" and "cosim_ranks" not in ring
    assert untimed(ring["cosim"]) == untimed(one["cosim"])
    assert ring["detection"] == one["detection"]
