"""The lean loop's explicit-edge and plain-arc forms, bit for bit against
the JAX rr scan running its resident-round kernel in interpret mode.

``SimConfig.packed_rr`` (random edges, F = log2 N) and its plain-arc
variant (``random_arc``, F = 16, align 1) at N = 1,024 with
``merge_block_c = 512`` for 20 rounds under 1 % crash churn: the port's
lean loop (each round one resident round, here its plain version, with the
explicit ``[N, F]`` edges drawn per round or the arc bases) against the
JAX package's ``_scan_rounds_rr_packed`` over ``resident_round_blocked``.
Lanes, carry and all six metrics are equal.  The suspicion forms are in
tests/test_torch_rr_edges_sus.py, the XLA oracle, the reports and the
routing rule in tests/test_torch_rr_routes.py.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core.rounds import _use_rr
from gossipfs_tpu.core.rounds import run_rounds as jax_run_rounds
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.convert import to_numpy
from gossipfs_tpu_torch.core.rounds import route, run_rounds
from gossipfs_tpu_torch.core.state import init_state
from gossipfs_tpu_torch.ops import merge

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

N, BLOCK_C, ROUNDS = 1024, 512, 20
PROFILES = {
    "packed_rr": ({}, "edges/onepass"),
    "plain arcs": (dict(topology="random_arc", fanout=16), "arc/onepass"),
}


@pytest.mark.parametrize("profile", list(PROFILES))
def test_lean_loop_matches_jax_rr_scan_interpret(profile):
    over, form = PROFILES[profile]
    jcfg = JaxConfig.packed_rr(N, BLOCK_C, interpret=True, **over)
    tcfg = SimConfig.packed_rr(N, BLOCK_C, **over)
    assert _use_rr(jcfg, N, N)                  # JAX runs its rr kernel
    assert route(tcfg) == ("lean", form)        # the port its lean loop
    js, jc, jm = jax_run_rounds(jax_init_state(jcfg), jcfg, ROUNDS,
                                jax.random.PRNGKey(11), crash_rate=0.01)
    merge.reset_launch_counts()
    ts, tc, tm = run_rounds(init_state(tcfg, device="cpu"), tcfg, ROUNDS,
                            trandom.PRNGKey(11, device="cpu"),
                            crash_rate=0.01)
    assert merge.LAUNCH_COUNTS["resident_round"] == 0   # plain on CPU
    got = to_numpy(ts, tc)
    for k in ("hb", "age", "status", "alive", "hb_base", *jc._fields):
        want = getattr(js, k) if hasattr(js, k) else getattr(jc, k)
        np.testing.assert_array_equal(got[k], np.asarray(want), err_msg=k)
    for k in jm._fields:
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    assert int(np.asarray(jm.true_detections).sum()) > 0
