"""The port's round profiler (``gossipfs_tpu_torch/roundprof.py``) and
merge sweep (``sweep_merge.py``) against the JAX package's
``bench/roundprof.py`` and ``bench/sweep_merge.py``, on the CPU.

* ``variants`` and ``suspicion_variants`` give the JAX package's names, in
  its order, and equal ``SimConfig`` fields at N = 2,048 and 16,384 (the
  port admits its stripe and rr rows by its own limits);
* ``round_bytes`` keeps the protocol floor (4 N^2) and the JAX package's
  phase keys per loop; the lean rows' one-pass form reads the lanes once,
  its two-launch twin twice;
* ``main(["--device", "cpu", ...])`` prints a ``ROUNDPROF_SCHEMA`` header
  and one row per configuration, with its route, launches and bandwidth
  block (a lean row with its two-launch twin), which the port's
  ``obs.timeline`` CLI summarizes;
* ``summarize_roundprof`` equals ``tools/timeline.summarize_roundprof`` on
  the committed ``ROUNDPROF_r05.jsonl`` and ``ROUNDPROF_r11.jsonl``;
* the ``sweep_merge`` CLI prints one row per elementwise form and a
  ``best:`` line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

import pytest
import torch

from gossipfs_tpu.bench import roundprof as jrp
from gossipfs_tpu_torch import roundprof, sweep_merge
from gossipfs_tpu_torch.core import rounds as R
from gossipfs_tpu_torch.obs import schema, timeline

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def jax_timeline():
    spec = importlib.util.spec_from_file_location(
        "timeline_tool", REPO / "tools" / "timeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("n", [2048, 16_384])
def test_variants_match_jax(n):
    want, got = jrp.variants(n), roundprof.variants(n)
    assert list(got) == list(want)
    for name in want:
        assert fields(got[name]) == fields(want[name]), name
    assert ("rr" in got) == (n == 16_384)


@pytest.mark.parametrize("interpret", [True, False])
@pytest.mark.parametrize("n", [2048, 16_384])
def test_suspicion_variants_match_jax(n, interpret):
    want = jrp.suspicion_variants(n, interpret=interpret)
    got = roundprof.suspicion_variants(n, interpret=interpret)
    assert list(got) == list(want)
    for name in want:
        assert fields(got[name]) == fields(want[name]), name


@pytest.mark.parametrize("n", [2048, 16_384])
def test_round_bytes_floor_and_phases(n):
    table = {**roundprof.variants(n), **roundprof.suspicion_variants(n)}
    for name, cfg in table.items():
        got = roundprof.round_bytes(cfg)
        assert got["floor"] == jrp.round_bytes(cfg)["floor"] == 4 * n * n
        assert got["total"] == sum(got["phases"].values())
        loop, form = R.route(cfg)
        if loop == "lean":
            assert set(got["phases"]) == {"view_build_read", "receiver_read",
                                          "lane_write", "recv_count_side"}
            assert got["phases"]["view_build_read"] == 2 * n * n
            assert got["phases"]["receiver_read"] == 0
            assert form.endswith("/onepass")
            off = roundprof.round_bytes(
                dataclasses.replace(cfg, rr_resident="off"))
            assert off["phases"]["receiver_read"] == 2 * n * n
        else:
            assert set(got["phases"]) == {"tick_view_pass", "merge_kernel",
                                          "member_count_pass"}


def test_cpu_run_prints_header_and_rows(tmp_path, capsys):
    rows = roundprof.main(["--device", "cpu", "--n", "256", "--rounds", "2",
                           "--suspicion", "--only", "xla_swar", "rr_swar"])
    lines = capsys.readouterr().out.strip().splitlines()
    head = json.loads(lines[0])
    assert schema.is_header(head)
    assert head["schema"] == schema.ROUNDPROF_SCHEMA
    assert head["backend"] == "cpu" and head["device"] == "cpu"
    assert head["mode"] == "suspicion_ab" and head["n"] == 256
    printed = [json.loads(x) for x in lines[1:]]
    assert [r["config"] for r in printed] == ["xla_swar", "rr_swar"]
    assert printed == json.loads(json.dumps(rows))
    sep, lean = printed
    assert sep["route"] == ["separate", "fused_merge_update"]
    assert lean["route"] == ["lean", "aligned_group/swar/onepass"]
    assert lean["two_launch"]["route"] == ["lean", "aligned_group/swar"]
    for r in (sep, lean, lean["two_launch"]):
        assert r["ms_per_round"] > 0 and r["launches"] == {}
    assert sep["floor_bytes_per_round"] == 4 * 256 * 256
    assert lean["pct_of_peak_hbm"] > 0
    # the artifact reads back through the port's timeline CLI
    path = tmp_path / "ROUNDPROF.jsonl"
    path.write_text("\n".join(lines) + "\n")
    assert timeline.main([str(path)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["rows"] == 2 and doc["header"] == head
    assert doc["fastest"]["ms_per_round"] == min(
        r["ms_per_round"] for r in printed)


@pytest.mark.parametrize("name", ["ROUNDPROF_r05.jsonl",
                                  "ROUNDPROF_r11.jsonl"])
def test_summarize_roundprof_matches_the_tool(name):
    path = str(REPO / name)
    assert timeline.summarize_roundprof(path) == \
        jax_timeline().summarize_roundprof(path)


def test_sweep_merge_cli(capsys):
    res = sweep_merge.main(["--device", "cpu", "--n", "128", "--hb-dtype",
                            "int8", "--elementwise", "lanes", "swar"])
    out = capsys.readouterr().out.strip().splitlines()
    assert "no counterpart in the port" in out[0]
    assert [x.split(":")[0] for x in out[1:3]] == ["hb=int8 ew=lanes",
                                                   "hb=int8 ew=swar"]
    assert len(res) == 2 and all(r > 0 for r, _ in res)
    rps, tag = max(res)
    assert out[-1] == f"best: {rps:.1f} rounds/s at {tag}"
    # swar without int8 lanes fails its row, as the JAX sweep's rows do
    sweep_merge.main(["--device", "cpu", "--n", "128", "--elementwise",
                      "swar"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[1].startswith("hb=int32 ew=swar: FAIL")
    assert out[-1] == "no configuration succeeded"
