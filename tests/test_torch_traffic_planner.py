"""The port's tensor replica planner (``traffic/planner.py``) against the
JAX package's, bit for bit, on the CPU.

* ``plan_repairs_tensor`` (every plan field), ``commit_repairs`` and
  ``replication_stats`` equal the JAX functions on the same tables, masks
  and keys, budgets below and above the deficient count (the scores are
  small integers, so the top-k order of ties is exercised);
* ``ReplicaTable`` drives ``traffic_bench.scale_lane`` cut to N = 4,096,
  256 placements a round, 12 rounds: every row, the final histogram and
  the drain equal the JAX lane's, timing fields aside;
* the table lives on the device it was given and refuses overflow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.bench import traffic_bench as jbench
from gossipfs_tpu.traffic import planner as jplan
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch import traffic_bench as tbench
from gossipfs_tpu_torch.traffic import planner as tplan

torch.set_num_threads(1)

TIMING = {"planner_ms", "planner_ms_median", "placements_per_sec"}


def strip(doc):
    if isinstance(doc, dict):
        return {k: strip(v) for k, v in doc.items() if k not in TIMING}
    if isinstance(doc, list):
        return [strip(v) for v in doc]
    return doc


def table(seed: int, n: int, cap: int, used: int) -> np.ndarray:
    """A replica table with placed, partial and unplaced rows."""
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.permutation(n)[:4] for _ in range(cap)])
    rows = rows.astype(np.int32)
    rows[used:] = -1
    rows[rng.random(cap) < 0.1, 3] = -1      # a few 3-replica files
    rows[5] = -1                             # an unplaced row in range
    return rows


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("budget", [3, 16, 500])
def test_plan_commit_stats_match_jax(seed, budget):
    n, cap, used = 200, 300, 260
    rep = table(seed, n, cap, used)
    rng = np.random.default_rng(50 + seed)
    alive = rng.random(n) < 0.85
    alive[:8] = False                        # a correlated group
    reach = alive & (rng.random(n) < 0.9)
    jargs = (jnp.asarray(rep), jnp.int32(used), jnp.asarray(alive),
             jnp.asarray(reach))
    targs = (torch.from_numpy(rep), used, torch.from_numpy(alive),
             torch.from_numpy(reach))
    want = jplan.plan_repairs_tensor(jax.random.PRNGKey(seed), *jargs,
                                     budget)
    got = tplan.plan_repairs_tensor(trandom.PRNGKey(seed, device="cpu"),
                                    *targs, budget)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.deficient) > 0
    jt = jplan.commit_repairs(jargs[0], want.idx, want.valid, want.picks,
                              jargs[2])
    tt = tplan.commit_repairs(targs[0], got.idx, got.valid, got.picks,
                              targs[2])
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tt.dtype == torch.int32
    # the input table is left as it was (the JAX function is pure)
    np.testing.assert_array_equal(targs[0].numpy(), rep)
    for tab_j, tab_t in ((jargs[0], targs[0]), (jt, tt)):
        for count in (0, 5, used, cap):
            want_s = jplan.replication_stats(tab_j, jnp.int32(count),
                                             jargs[2], jargs[3])
            got_s = tplan.replication_stats(tab_t, count, targs[2],
                                            targs[3])
            np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_scale_lane_cut_matches_jax_row_for_row():
    kw = dict(files_per_round=256, rounds=12, budget=512, seed=3)
    want = jbench.scale_lane(4096, **kw)
    got = tbench.scale_lane(4096, device="cpu", **kw)
    assert strip(got) == strip(want)
    assert got["final"]["files"] == 12 * 256
    assert {row["phase"] for row in got["rows"]} == {
        "steady", "churn", "partition", "rack_storm"}
    assert sum(row["repairs_executed"] for row in got["rows"]) > 0
    assert got["planner_ms_median"] > 0


def test_replica_table_device_and_capacity():
    t = tplan.ReplicaTable(10, 50, seed=1, device="cpu")
    assert t.replicas.device.type == "cpu"
    alive = torch.ones(50, dtype=torch.bool)
    rows = t.place(alive, 6, method="gumbel")
    assert rows.shape == (6, 4) and t.n_files == 6
    with pytest.raises(ValueError, match="capacity exceeded"):
        t.place(alive, 5)
    stats = t.stats(alive, alive)
    assert stats["replica_histogram"] == [0, 0, 0, 0, 6]
    assert stats["write_quorum_reachable"] == 6
