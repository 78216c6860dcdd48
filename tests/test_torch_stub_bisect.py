"""The port's stub_bisect: its stub lists, its header row, its CPU row.

``python -m gossipfs_tpu_torch.stub_bisect`` times K3's one-pass form
with stages compiled out (variant builds of csrc/rr_onepass.cu).  Here,
on the CPU: its default stub lists and fanout equal the JAX tool's
(``tools/stub_bisect.py`` loaded by path, its timing replaced by a
recorder), the stubs the launched form lacks are named in the header and
not run, the header row carries ``ROUNDPROF_SCHEMA`` and reads back
through ``obs.timeline.summarize_roundprof``, the ``--device cpu``
``(full)`` row runs the plain version and every stub row says it needs
the card, and the variant builds' names and defines.  The variants
themselves run in tests/test_torch_stub_host.py (host build) and
chip_smoke.py phase 50 (the card).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import pytest
import torch

from gossipfs_tpu_torch import stub_bisect as sb
from gossipfs_tpu_torch.obs import schema as obs_schema
from gossipfs_tpu_torch.obs.timeline import summarize_roundprof
from gossipfs_tpu_torch.ops import _build, merge

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
# (arc_align, suspicion, scenario) at the JAX tool's default --rr-rotate
# auto (the port builds no ring, so it has no --rr-rotate)
CASES = [(align, sus, scn) for align in (1, 8) for sus in (False, True)
         for scn in (False, True) if not (scn and align == 1)]


def run(argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert sb.main(argv) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.fixture(scope="module")
def jax_lists():
    """The JAX tool's stub list and fanout for each case, recorded from
    its main with time_stub replaced."""
    spec = importlib.util.spec_from_file_location(
        "jax_stub_bisect", ROOT / "tools" / "stub_bisect.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = {}
    for case in CASES:
        align, sus, scn = case
        seen = []
        mod.time_stub = lambda n, c, r, fanout, stub, *a, **k: (
            seen.append((stub, fanout)) or 1.0)
        argv = ["stub_bisect", "--n", "16384", "--arc-align", str(align)] \
            + (["--suspicion"] if sus else []) \
            + (["--scenario"] if scn else [])
        old = sys.argv
        sys.argv = argv
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                mod.main()
        finally:
            sys.argv = old
        out[case] = seen
    return out


@pytest.mark.parametrize("case", CASES, ids=str)
def test_stub_lists_and_fanout_are_the_jax_tools(jax_lists, case):
    align, sus, scn = case
    seen = jax_lists[case]
    assert sb.default_stubs(align, scn, sus) == [s for s, _ in seen]
    assert {f for _, f in seen} == {sb.bisect_fanout(16_384, align)}


def test_stub_refusals():
    assert "ring" in merge.stub_refusal("wring", "aligned_group", False)
    assert "arc" in merge.stub_refusal("wmax,gather", "arc", False)
    assert merge.stub_refusal("wmax,gather", "aligned_group", False) is None
    assert merge.stub_refusal("wmax", "filter_group", True) is None
    assert "crash-only" in merge.stub_refusal("sus", "aligned_group", False)
    assert merge.stub_refusal("", "edges", False) is None
    with pytest.raises(ValueError, match="unknown stage"):
        merge.stub_refusal("park", "aligned_group", False)


def test_variant_defines_and_library_names(monkeypatch):
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    assert merge.onepass_defines("arc", False, False, "lanes", False,
                                 "") == ()
    d = merge.onepass_defines("filter_group", True, True, "swar", True,
                              "epi,rcnt")
    assert d == ("RR_STUB=24", "RR_ONLY_FORM=3", "RR_ONLY_MODE=2",
                 "RR_ONLY_SWAR=1", "RR_ONLY_BLOCK=1")
    with pytest.raises(ValueError, match="no such stage"):
        merge.onepass_defines("edges", False, False, "lanes", False, "wmax")
    base = _build.lib_path("rr_onepass")
    assert _build.lib_path("rr_onepass", d) != base
    assert _build.lib_path("rr_onepass", d).parent == base.parent
    # the default library's command carries no define
    cmd = _build._command("rr_onepass", base, False)
    assert not any(a.startswith("-D") for a in cmd)
    assert [a for a in _build._command("rr_onepass", base, False, d)
            if a.startswith("-D")] == [f"-D{x}" for x in d]


def test_the_plain_version_takes_no_stub():
    x = sb.build_inputs(64, 8, 8, device="cpu")
    kw = sb.round_kwargs(8, 8, "lanes", False, False)
    with pytest.raises(ValueError, match="stage stub"):
        sb.stub_round(x, kw, "rcnt")


def test_cpu_run_header_full_row_and_card_rows(tmp_path):
    rows = run(["--device", "cpu", "--n", "1024", "--arc-align", "8",
                "--suspicion", "--rounds", "2", "--reps", "1"])
    head, body = rows[0], rows[1:]
    assert head["schema"] == obs_schema.ROUNDPROF_SCHEMA
    assert head["tool"] == "stub_bisect" and head["form"] == "aligned_group"
    assert head["fanout"] == 16 and head["rr_rotate"] is None
    assert list(head["not_run"]) == ["wring"]
    assert [r["stub"] for r in body] == head["stubs"] == [
        s or "(full)" for s in sb.default_stubs(8, False, True)
        if s != "wring"]
    full, stubs = body[0], body[1:]
    assert full["ms_per_round"] > 0 and full["library"] is None
    assert all(r["skipped"] == sb.CPU_SKIP and "ms_per_round" not in r
               for r in stubs)
    path = tmp_path / "bisect.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    doc = summarize_roundprof(str(path))
    assert doc["schema"] == obs_schema.ROUNDPROF_SCHEMA
    assert doc["rows"] == 1 and doc["fastest"]["stub"] == "(full)"
    assert doc["header"]["tool"] == "stub_bisect"


def test_plain_arcs_leave_out_their_missing_stage():
    rows = run(["--device", "cpu", "--n", "512", "--rounds", "1", "--reps",
                "1"])
    head = rows[0]
    assert head["form"] == "arc" and head["fanout"] == 9
    assert sorted(head["not_run"]) == ["vtick,wmax,gather,epi,rcnt",
                                       "wmax,gather"]
    assert "wmax" not in "".join(head["stubs"])


def test_scenario_needs_aligned_arcs_and_the_card_is_the_default(
        monkeypatch):
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            sb.main(["--device", "cpu", "--scenario"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        sb.main(["--n", "512"])


@pytest.mark.parametrize("n, align, blocking, source", [
    (16_384, 8, "8x32", "rr_onepass"),
    (16_384, 1, "8x32", "rr_onepass"),
    (65_536, 8, "16x16", "rr_onepass_wide"),
    (65_536, 1, "16x16", "rr_onepass_wide"),
    (98_304, 8, "16x16", "rr_onepass_wide"),
])
def test_variants_build_against_the_blocking_the_round_takes(monkeypatch, n,
                                                             align, blocking,
                                                             source):
    """A stub row's library is the variant of the library of the blocking
    ops/merge.onepass_blocking picks for the shape: the 8 x 32 one to N =
    19,264, the 16 x 16 one past it; (full) is that library undefined."""
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    kw = sb.round_kwargs(sb.bisect_fanout(n, align), align, "lanes", False,
                         False)
    assert sb.stub_blocking(n, kw) == blocking
    assert sb.stub_variant(kw, "", blocking) == (source, ())
    name, defines = sb.stub_variant(kw, "epi,rcnt", blocking)
    assert name == source and defines[0] == "RR_STUB=24"
    assert sb.stub_library(kw, "epi,rcnt", blocking) == _build.lib_path(
        source, defines).name


def test_edges_rows_and_the_blocking_in_the_header():
    rows = run(["--device", "cpu", "--n", "1024", "--edges", "--rounds",
                "1", "--reps", "1"])
    head, full = rows[0], rows[1]
    assert head["form"] == "edges" and head["edges"] is True
    assert head["blocking"] == "8x32" and head["source"] == "rr_onepass.cu"
    assert sorted(head["not_run"]) == ["vtick,wmax,gather,epi,rcnt",
                                       "wmax,gather"]
    assert full["stub"] == "(full)" and full["ms_per_round"] > 0
    assert "timeline_us" not in full
    kw = sb.round_kwargs(10, 1, "lanes", False, False, edges=True)
    x = sb.build_inputs(1024, 10, device="cpu", edges=True)
    assert kw["fanout"] is None and tuple(x["senders"].shape) == (1024, 10)
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            sb.main(["--device", "cpu", "--edges", "--arc-align", "8"])
