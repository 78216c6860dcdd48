"""The port's TTD/FPR curves sweep and the ``--trace``/``--monitor`` flags
of its bench entry points.

* ``curves.sweep`` (random edges and windowed arcs, one N and two) equals
  the JAX package's rows, and each row's trace file equals the JAX
  package's byte for byte; the analyzer re-derives the row from it;
* the CLI writes what it prints and refuses the sweeps not ported yet;
* ``bench --trace --monitor`` on the CPU: the trace's FPR and detection
  counts equal ``summarize`` of the same run, the verdict is ok, and the
  flags change no launch count;
* ``frontier --trace`` on a padded N: no pad subject exports a row, and
  the analyzer gives the frontier JSON's TTD and FPR.
"""

from __future__ import annotations

import json

import pytest
import torch

from gossipfs_tpu.bench.curves import sweep as jax_sweep
from gossipfs_tpu_torch import bench, curves
from gossipfs_tpu_torch.frontier import run as run_frontier
from gossipfs_tpu_torch.metrics.detection import summarize
from gossipfs_tpu_torch.obs import timeline

torch.set_num_threads(1)

# keys of the port's rows that the JAX rows lack: the run's launches by
# kernel, and the trace's event count and decode ms
PORT_ONLY = {"launches", "trace_events", "trace_ms"}


@pytest.mark.parametrize("ns,topology", [((256,), "random"),
                                         ((256,), "random_arc"),
                                         ((128, 256), "random")])
def test_sweep_matches_jax(tmp_path, ns, topology):
    kw = dict(ns=ns, rounds=30, topology=topology, monitor=True)
    want = jax_sweep(trace=str(tmp_path / "jax.jsonl"), **kw)
    got = curves.sweep(trace=str(tmp_path / "port.jsonl"), device="cpu",
                       **kw)
    assert got["metric"] == want["metric"]
    assert got["protocol"] == want["protocol"]
    assert got["crash_churn"] == want["crash_churn"]
    for grow, wrow in zip(got["rows"], want["rows"], strict=True):
        assert set(grow) - set(wrow) == PORT_ONLY
        assert grow["launches"] == {}       # the plain versions ran
        port_trace, jax_trace = grow.pop("trace"), wrow.pop("trace")
        assert {k: grow[k] for k in wrow} == wrow
        with open(port_trace, "rb") as a, open(jax_trace, "rb") as b:
            assert a.read() == b.read()
        doc = timeline.analyze(*timeline.merge([port_trace]))
        for key in ("ttd_first_median", "false_positive_rate", "detected",
                    "tracked_crashes"):
            assert doc[key] == grow[key], key
        assert doc["events"] == grow["trace_events"]
        assert grow["monitor"]["ok"] and grow["detected"] == 8


def test_curves_cli_sweep(tmp_path, capsys):
    out = tmp_path / "c.json"
    trace = tmp_path / "c.jsonl"
    curves.main(["--ns", "128", "--rounds", "24", "--device", "cpu",
                 "--trace", str(trace), "--monitor", "--out", str(out)])
    doc = json.loads(capsys.readouterr().out)
    assert doc == json.loads(out.read_text())
    (row,) = doc["rows"]
    assert row["n"] == 128 and row["trace"] == str(trace)
    assert row["monitor"]["ok"]
    for flag in ("--suspicion", "--t-fail-sweep"):
        with pytest.raises(SystemExit, match="Queue 1, item 4"):
            curves.main([flag, "--device", "cpu"])


def test_bench_trace_and_monitor_on_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--n", "256", "--rounds", "30",
            "--attempts", "2"]
    plain = bench.main(args)
    trace = tmp_path / "b.jsonl"
    doc = bench.main(args + ["--trace", str(trace), "--monitor"])
    capsys.readouterr()
    assert doc["launches"] == plain["launches"]
    assert doc["form_launches"] == plain["form_launches"]
    assert doc["monitor"]["ok"] and doc["trace"] == str(trace)
    assert doc["kernel"] == "resident_round_plain"
    headers, events = timeline.merge([str(trace)])
    assert len(events) == doc["trace_events"]
    got = timeline.analyze(headers, events)
    # every attempt runs the same key from a fresh state: the trace is of
    # this run's outputs
    cfg = bench.headline_config(256, False)
    _, (state, carry, per_round) = bench.timed_run(cfg, 30, device="cpu")
    rep = summarize(carry, per_round)
    assert got["false_positive_rate"] == rep.false_positive_rate
    assert got["true_detections"] == rep.true_detections
    assert got["false_positives"] == rep.false_positives
    assert got["rounds"] == 30 and rep.true_detections > 0


def test_frontier_trace_masks_pads(tmp_path):
    trace = tmp_path / "f.jsonl"
    doc = run_frontier(n=250, rounds=14, block_c=128, seed=4, device="cpu",
                       trace=str(trace))
    assert doc["n_padded"] == 256 and doc["trace"] == str(trace)
    headers, events = timeline.merge([str(trace)])
    assert len(events) == doc["trace_events"]
    assert headers[0]["n_effective"] == 250
    assert all(e.subject < 250 for e in events)
    assert sum(e.kind == "remove" for e in events) <= 250
    got = timeline.analyze(headers, events)
    for key in ("ttd_first_median", "false_positive_rate", "detected",
                "tracked_crashes"):
        assert got[key] == doc[key], key
