"""The lean loop's explicit-edge form under SWIM suspicion, Lifeguard off
and on, bit for bit against the JAX rr scan in interpret mode.

``SimConfig.suspicion_rr`` (random edges, t_fail 3 + t_suspect) at
N = 1,024 with ``merge_block_c = 512`` for 20 rounds under 1 % crash
churn: the port's lean loop (the resident round's plain version, with the
carried per-receiver suspect counts and flags bit 4 on the Lifeguard lane)
against the JAX package's rr scan.  Lanes, carry (``first_suspect``
included) and all six metrics are equal.
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
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.convert import to_numpy
from gossipfs_tpu_torch.core.rounds import route, run_rounds
from gossipfs_tpu_torch.core.state import init_state
from gossipfs_tpu_torch.suspicion import SuspicionParams

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

N, BLOCK_C, ROUNDS = 1024, 512, 20
# Lifeguard off, and on at a threshold (1/32 of the list) that 1 % crash
# churn at N = 1,024 crosses on some rows and rounds
LH = {"off": dict(t_suspect=3),
      "on": dict(t_suspect=3, lh_multiplier=4, lh_frac=0.03125)}


@pytest.mark.parametrize("lh", list(LH))
def test_suspicion_rr_lean_loop_matches_jax_rr_scan_interpret(lh):
    jcfg = JaxConfig.suspicion_rr(N, BLOCK_C, interpret=True,
                                  suspicion=JaxSus(**LH[lh]))
    tcfg = SimConfig.suspicion_rr(N, BLOCK_C,
                                  suspicion=SuspicionParams(**LH[lh]))
    assert _use_rr(jcfg, N, N)
    assert route(tcfg) == ("lean", "edges/onepass")
    js, jc, jm = jax_run_rounds(jax_init_state(jcfg), jcfg, ROUNDS,
                                jax.random.PRNGKey(13), crash_rate=0.01)
    ts, tc, tm = run_rounds(init_state(tcfg, device="cpu"), tcfg, ROUNDS,
                            trandom.PRNGKey(13, device="cpu"),
                            crash_rate=0.01)
    got = to_numpy(ts, tc)
    for k in ("hb", "age", "status", "alive", "hb_base", *jc._fields):
        want = getattr(js, k) if hasattr(js, k) else getattr(jc, k)
        np.testing.assert_array_equal(got[k], np.asarray(want), err_msg=k)
    for k in jm._fields:
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    assert int(np.asarray(jm.suspects_entered).sum()) > 0
    assert int(np.asarray(jm.true_detections).sum()) > 0
