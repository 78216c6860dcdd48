"""The port's profiler seam: ``utils/profiling.py`` (``trace``,
``op_breakdown``, ``time_rounds``), ``obs/profile.py`` (``maybe_xprof``,
``xprof_summary``) and ``bench --xprof``, on the CPU.

* ``time_rounds`` gives a positive slope and leaves the given state as it
  was: every run starts from a fresh copy (the lanes move in place);
* ``op_breakdown`` reads a hand-made trace in ``torch.profiler``'s Chrome
  layout: the device rows (a process labelled ``GPU 0``, the ``kernel``
  / ``gpu_memcpy`` categories) summed by name, the host rows left out;
* ``trace`` writes such a trace on the CPU, and ``op_breakdown`` finds no
  device rows in it;
* ``maybe_xprof(None)`` is a no-op; ``xprof_summary`` of a missing trace
  is empty;
* ``bench --device cpu --xprof DIR`` names DIR in its JSON and writes one
  trace there; its sampled attempts' launches are those without the flag.
"""

from __future__ import annotations

import json

import pytest
import torch

from gossipfs_tpu_torch import bench
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core.state import init_state
from gossipfs_tpu_torch.obs.profile import maybe_xprof, xprof_summary
from gossipfs_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_time_rounds_is_positive_and_reinits_its_state():
    cfg = SimConfig(n=64, topology="random", fanout=6)
    state = init_state(cfg, device="cpu")
    before = [t.clone() for t in (state.hb, state.asl, state.alive,
                                  state.hb_base)]
    out = profiling.time_rounds(state, cfg, trandom.PRNGKey(0, device="cpu"),
                                short=1, long=3, crash_rate=0.05)
    assert out["seconds_per_round"] > 0 and out["rounds_per_sec"] > 0
    assert out["rounds_per_sec"] == pytest.approx(
        1 / out["seconds_per_round"])
    assert out["dispatch_overhead_s"] >= 0
    after = (state.hb, state.asl, state.alive, state.hb_base)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert state.round == 0
    # no state: a fresh init_state on the key's device each run
    out = profiling.time_rounds(None, cfg, trandom.PRNGKey(0, device="cpu"),
                                short=1, long=2)
    assert out["seconds_per_round"] > 0


def chrome_trace() -> dict:
    """A trace in torch.profiler's layout: host pid 7, device pid 0."""
    meta = [
        {"ph": "M", "name": "process_name", "pid": 7, "tid": 0,
         "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 7, "tid": 0,
         "args": {"labels": "CPU"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0,
         "args": {"labels": "GPU 0"}},
    ]
    ev = [
        {"ph": "X", "cat": "kernel", "name": "resident_round_onepass",
         "pid": 0, "tid": 7, "ts": 0, "dur": 1500.0},
        {"ph": "X", "cat": "kernel", "name": "resident_round_onepass",
         "pid": 0, "tid": 7, "ts": 2000, "dur": 1500.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "pid": 0, "tid": 7, "ts": 1600, "dur": 2.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "pid": 0, "tid": 8, "ts": 4000, "dur": 250.0},
        # host rows: an op and the runtime call, never device time
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "pid": 7,
         "tid": 1, "ts": 0, "dur": 9000.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 7, "tid": 1, "ts": 0, "dur": 8000.0},
        {"ph": "i", "name": "marker", "pid": 0, "tid": 7, "ts": 5},
    ]
    return {"schemaVersion": 1, "traceEvents": meta + ev}


def test_op_breakdown_reads_a_torch_profiler_trace(tmp_path):
    (tmp_path / f"0000{profiling.TRACE_SUFFIX}").write_text(
        json.dumps(chrome_trace()))
    rows = profiling.op_breakdown(tmp_path)
    assert rows == [
        {"name": "resident_round_onepass", "total_ms": 3.0, "count": 2},
        {"name": "Memcpy DtoH", "total_ms": 0.25, "count": 1},
        {"name": "Memset (Device)", "total_ms": 0.002, "count": 1},
    ]
    assert profiling.op_breakdown(tmp_path, top=1) == rows[:1]
    assert xprof_summary(tmp_path, top=2) == rows[:2]
    # the device rows are found by category even where no process says
    # "GPU" (a trace whose labels are missing)
    tr = chrome_trace()
    tr["traceEvents"] = [e for e in tr["traceEvents"] if e["ph"] != "M"]
    (tmp_path / f"0001{profiling.TRACE_SUFFIX}").write_text(json.dumps(tr))
    assert profiling.op_breakdown(tmp_path) == rows


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    cfg = SimConfig(n=32, topology="random", fanout=5)
    with profiling.trace(tmp_path) as prof:
        bench.timed_run(cfg, 2, device="cpu")
    assert prof is not None
    path = profiling.latest_trace(tmp_path)
    doc = json.loads(path.read_text())
    assert any(e.get("ph") == "X" for e in doc["traceEvents"])
    # the CPU run has host rows only
    assert profiling.op_breakdown(tmp_path) == []
    with profiling.trace(tmp_path):
        pass
    assert profiling.latest_trace(tmp_path).name == \
        f"0001{profiling.TRACE_SUFFIX}"


def test_maybe_xprof_without_a_directory_is_a_no_op(tmp_path):
    with maybe_xprof(None):
        x = 1
    with maybe_xprof(""):
        x += 1
    assert x == 2
    assert list(tmp_path.iterdir()) == []
    assert xprof_summary(tmp_path / "missing") == []
    with pytest.raises(FileNotFoundError):
        profiling.op_breakdown(tmp_path)


def test_bench_xprof_names_the_directory(tmp_path, capsys):
    argv = ["--device", "cpu", "--n", "64", "--rounds", "3",
            "--attempts", "1"]
    plain = bench.main(argv)
    capsys.readouterr()
    doc = bench.main(argv + ["--xprof", str(tmp_path / "xp")])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["xprof"] == doc["xprof"] == str(tmp_path / "xp")
    assert doc["xprof_top"] == []           # no device rows on the CPU
    assert len(list((tmp_path / "xp").glob("*.pt.trace.json"))) == 1
    assert doc["launches"] == plain["launches"] == 0
    assert "xprof" not in plain
