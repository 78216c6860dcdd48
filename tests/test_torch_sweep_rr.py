"""The port's sweep_rr: its points, its refusal row, one digest on the CPU.

``python -m gossipfs_tpu_torch.sweep_rr`` runs the JAX tool's program
(``tools/sweep_rr.py``) over the port's run-time choices, rr_resident on /
off x lanes / SWAR.  Here, on the CPU (the plain versions): the
configuration equals the JAX tool's field for field, the point list, the
N = 65,536 one-pass refusal row, and every point's digest equal at a small
N.  The card run is chip_smoke.py's phase 50.
"""

from __future__ import annotations

import contextlib
import io
import json

import pytest
import torch

from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu_torch import sweep_rr
from gossipfs_tpu_torch.ops import merge

torch.set_num_threads(1)


def run(argv) -> tuple[int, list]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = sweep_rr.main(argv)
    return rc, [json.loads(line) for line in buf.getvalue().splitlines()]


def test_points_are_resident_by_elementwise():
    assert sweep_rr.points() == [("on", "lanes"), ("on", "swar"),
                                 ("off", "lanes"), ("off", "swar")]


@pytest.mark.parametrize("field", [
    "n", "topology", "fanout", "arc_align", "remove_broadcast",
    "fresh_cooldown", "t_cooldown", "merge_kernel", "merge_block_r",
    "merge_block_c", "view_dtype", "hb_dtype", "rr_resident"])
def test_config_is_the_jax_tools(field):
    """tools/sweep_rr.py time_point's SimConfig, field for field, at its
    default point (N = 16,384, block_c 2,048, block_r 512)."""
    want = JaxConfig(
        n=16_384, topology="random_arc", fanout=16, arc_align=8,
        remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
        merge_kernel="pallas_rr", merge_block_r=512, view_dtype="int8",
        merge_block_c=2048, rr_resident="on", hb_dtype="int8")
    got = sweep_rr.sweep_config(16_384, "on", "lanes")
    assert getattr(got, field) == getattr(want, field)


def test_refusal_row_at_65536():
    """The one-pass points past the wide blocking (N = 131,072: N =
    65,536 runs one-pass since the 16 x 16 blocking) print the route's
    refusal, as the JAX tool printed "no resident VMEM fit", and run
    nothing."""
    rc, rows = run(["--device", "cpu", "--n", "131072", "--rounds", "1",
                    "--reps", "1", "--rr-resident", "on"])
    assert rc == 0
    assert sweep_rr.refusal(65_536, "on", "lanes") is None
    want = merge.onepass_refusal(131_072, 131_072, "aligned_group")
    assert [r["skipped"] for r in rows[:2]] == [want, want]
    assert [r["elementwise"] for r in rows[:2]] == ["lanes", "swar"]
    assert rows[0]["block_c"] == 2048 and rows[0]["block_r"] == 512
    assert rows[-1] == {"digests_equal": True, "points_run": 0,
                        "points_skipped": 2}
    assert sweep_rr.refusal(16_384, "on", "lanes") is None
    assert sweep_rr.refusal(65_536, "off", "lanes") is None


def test_every_point_gives_one_digest_on_cpu():
    rc, rows = run(["--device", "cpu", "--n", "512", "--rounds", "3",
                    "--reps", "2"])
    points, summary = rows[:-1], rows[-1]
    assert rc == 0 and summary == {"digests_equal": True, "points_run": 4,
                                   "points_skipped": 0}
    assert len({r["digest"] for r in points}) == 1
    assert [r["route"] for r in points] == [
        "aligned_group/onepass", "aligned_group/swar/onepass",
        "aligned_group", "aligned_group/swar"]
    assert all(r["ms_per_round"] > 0 and r["device"] == "cpu"
               for r in points)


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        sweep_rr.main(["--n", "512"])
