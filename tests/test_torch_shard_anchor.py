"""The port's shard_anchor: its ladder, its byte formula and its round.

``python -m gossipfs_tpu_torch.shard_anchor`` times one card's share of
the sharded resident round (K3's column-shard form, one-pass where it
holds the block, as the route takes it) and
sweeps the JAX tool's capacity ladder with the port's own admission,
``shard_bytes`` against the card's memory.  Here, on the CPU: the ladder
equals the JAX tool's (``tools/shard_anchor.py``, loaded by path: it
imports JAX only inside its functions), the formula equals the bytes a
small ``measure`` holds, ``--ladder --budget-only`` refuses (786,432, 16)
alone, and a small ``measure`` runs the round ``resident_round_plain``
runs.  On the card (chip_smoke.py phase 50) the formula is held against
the growth of ``torch.cuda.max_memory_allocated``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import pytest
import torch

from gossipfs_tpu_torch import shard_anchor as sa
from gossipfs_tpu_torch.config import AGE_CLAMP
from gossipfs_tpu_torch.ops import merge

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_shard_anchor", ROOT / "tools" / "shard_anchor.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert sa.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_ladder_is_the_jax_tools():
    assert sa.LADDER == jax_tool().LADDER


@pytest.mark.parametrize("row", sa.LADDER, ids=lambda r: f"{r[0]}x{r[1]}")
def test_shard_bytes_formula(row):
    """Both int8 lanes, the N / 8-row view where the shard runs K3's
    two-launch form (the one-pass form holds (65,536, 8) and (98,304, 8):
    no view in device memory), [3, N/s] and [1, N] int32 counts, flags,
    the 11-row stack, int32 bases."""
    n, shards = row[0], row[1]
    nloc = n // shards
    onepass = merge.onepass_fits(n, nloc, "aligned_group")
    assert sa.shard_onepass(n, shards) == onepass == (n <= 98_304)
    want = (2 * n * nloc + (0 if onepass else n // 8 * nloc)
            + 3 * nloc * 4 + n * 4 + n + merge.N_VEC * nloc + 4 * n)
    assert sa.shard_bytes(n, shards) == want


def test_shard_bytes_at_the_named_rows():
    # (524,288, 16) ~36.5 GB is admitted; (786,432, 16) needs 2 x 38.65 GB
    # of lanes and 4.8 GB of view, past the stated 80 GB
    assert round(sa.shard_bytes(524_288, 16) / 1e9, 1) == 36.5
    assert sa.shard_bytes(786_432, 16) == 82_149_457_920
    assert sa.BUDGET_BYTES == 80 * 10**9


def test_shard_bytes_equal_what_measure_holds_on_cpu():
    row = sa.measure(512, 4, 512, 512, 24, 8, rounds=1, reps=1,
                     device="cpu")
    assert row["alloc_bytes"] == row["shard_bytes"] == sa.shard_bytes(512, 4)
    assert row["alloc_matches"] and row["admissible"]
    x = sa.shard_inputs(512, 4, device="cpu")
    shapes = {k: (tuple(t.shape), t.dtype) for k, t in x.items()}
    want = sa.shard_tensors(512, 4)
    assert all(shapes[k] == want[k] for k in shapes)
    # [512 x 128] runs one-pass: no view between launches
    assert "view" not in want and "view" in sa.shard_tensors(131_072, 8)


def test_budget_only_ladder_refuses_786432_alone():
    doc = run(["--ladder", "--budget-only", "--device", "cpu"])
    rows = {(r["n_global"], r["shards"]): r for r in doc["ladder"]}
    assert len(rows) == len(sa.LADDER)
    top = rows.pop((786_432, 16))
    assert not top["admissible"] and str(top["shard_bytes"]) in top["refused"]
    assert all(r["admissible"] and not r["measured"] for r in rows.values())
    assert rows[(524_288, 16)]["shard_bytes"] <= sa.BUDGET_BYTES
    assert all(r["budget_limit_bytes"] == sa.BUDGET_BYTES
               for r in doc["ladder"])
    assert not doc["measured"]
    cut = run(["--ladder", "--budget-only", "--device", "cpu",
               "--ladder-rows", "2"])
    assert [r["n_global"] for r in cut["ladder"]] == [65_536, 98_304]


def test_measure_runs_the_plain_round():
    """Two carried rounds of shard 1 of 4 at N = 512 through the tool's
    round equal two of resident_round_plain on the same inputs."""
    n, shards, shard = 512, 4, 1
    nloc = n // shards
    x = sa.shard_inputs(n, shards, 8, seed=3, device="cpu")
    y = {k: t.clone() for k, t in x.items()}
    for _ in range(2):
        got = sa.shard_round(x, 24, 8, shard * nloc)
        want = merge.resident_round_plain(
            y["hb"], y["asl"], y["flags"], y["vecs"], y["bases"], fanout=24,
            arc_align=8, t_fail=5, t_cooldown=12, age_clamp=AGE_CLAMP,
            col_offset=shard * nloc)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert int(got[3].sum()) > 0 or int(got[2].sum()) > 0
    assert x["bases"].remainder(8).eq(0).all()
    row = run(["--device", "cpu", "--n", "512", "--shards", "4", "--shard",
               "1", "--rounds", "2", "--reps", "1"])
    assert row["local_cols"] == nloc and row["launches"] == {}
    assert row["implied_rounds_per_sec"] == pytest.approx(
        1e3 / row["ms_per_round_per_chip"])


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        sa.main(["--ladder", "--budget-only"])
