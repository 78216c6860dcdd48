"""The port's entry points (``gossipfs_tpu_torch/entry.py``) against the
JAX package's ``__graft_entry__.py``, on the CPU.

* ``entry()``'s step equals the JAX step over 5 rounds: lanes, and the
  round metrics;
* ``dryrun_multichip(2, device="cpu")`` runs its three checks over two
  gloo rank processes, each check's gathered lanes, carry and metrics
  equal to a single-process ``run_rounds``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from gossipfs_tpu_torch import entry
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.convert import to_numpy
from gossipfs_tpu_torch.core.rounds import run_rounds
from gossipfs_tpu_torch.core.state import init_state
from gossipfs_tpu_torch.ops import merge

torch.set_num_threads(1)


def test_flagship_config_matches_jax():
    from gossipfs_tpu.config import SimConfig as JaxConfig

    want = JaxConfig(n=256, topology="random",
                     fanout=JaxConfig.log_fanout(256),
                     remove_broadcast=False, fresh_cooldown=True,
                     merge_kernel="pallas", view_dtype="int8",
                     hb_dtype="int16")
    got = entry.flagship_config()
    for f in ("n", "topology", "fanout", "remove_broadcast",
              "fresh_cooldown", "merge_kernel", "view_dtype", "hb_dtype",
              "t_fail", "t_cooldown", "min_group", "merge_block_c"):
        assert getattr(got, f) == getattr(want, f), f


def test_step_matches_jax():
    jstep, (js, jev, jedges) = jax_entry.entry()
    step, (state, events, edges) = entry.entry(device="cpu")
    np.testing.assert_array_equal(edges.numpy(), np.asarray(jedges))
    merge.reset_launch_counts()
    for _ in range(5):
        js, jm = jstep(js, jev, jedges)
        state, m = step(state, events, edges)
        got = to_numpy(state)
        for k in ("hb", "age", "status", "alive", "hb_base"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                          err_msg=k)
        for k in jm._fields:
            assert int(getattr(m, k)) == int(getattr(jm, k)), k
    assert int(state.round) == 5
    assert not any(merge.LAUNCH_COUNTS.values())    # plain on the CPU


def test_entry_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()


def test_dryrun_multichip_on_cpu_ranks(capsys):
    out = entry.dryrun_multichip(2, device="cpu")
    printed = capsys.readouterr().out
    crash = {"sharded": 0.02, "shard_map": 0.02, "sharded-rr": 0.01}
    for name, cfg, rounds, world in entry.dryrun_configs(2):
        assert f"dryrun {name} ok: {world} ranks" in printed
        head = out[name]
        assert head["world"] == world and head["backend"] == "gloo"
        s, c, m = run_rounds(init_state(cfg, device="cpu"), cfg, rounds,
                             trandom.PRNGKey(0, device="cpu"),
                             crash_rate=crash[name])
        for f in ("hb", "asl", "alive", "hb_base"):
            assert torch.equal(getattr(head["state"], f), getattr(s, f)), f
        assert all(torch.equal(a, b) for a, b in zip(head["carry"], c))
        assert all(torch.equal(a, b) for a, b in zip(head["metrics"], m))
    assert out["sharded-rr"]["route"] == ("lean", "aligned_group/onepass")
