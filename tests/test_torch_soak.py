"""The port's narrow-heartbeat soak (``gossipfs_tpu_torch/soak_hb16.py``)
against the JAX package's ``bench/soak_hb16.py``, on the CPU, exact.

``run_mode`` at N = 64, 2 chunks of 150 rounds (counters up to 300: past
the int8 storage window of 126 rounds, short of int16's 16,384), for each
storage dtype: every chunk's ``first_detect``, ``converged`` and
detection counts, and the final status, age, alive, true counters and
storage bases, equal the JAX package's run of the same soak at the same
size (its ``run_mode`` loop, on its XLA merge, which its own tests pin
to the Pallas kernel).  The port's int8 and int16 comparisons against its int32
run pass, and ``main`` at the cut size prints ``SOAK PASS``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.bench import soak_hb16 as jsoak
from gossipfs_tpu.core.rounds import run_rounds as jax_run_rounds
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu_torch import soak_hb16
from gossipfs_tpu_torch.config import SimConfig

torch.set_num_threads(1)

N, CHUNKS, ROUNDS = 64, 2, 150
KW = dict(n=N, chunks=CHUNKS, chunk_rounds=ROUNDS, device="cpu")


@functools.lru_cache(maxsize=None)
def port_mode(dtype: str):
    return soak_hb16.run_mode(dtype, **KW)


@functools.lru_cache(maxsize=None)
def jax_mode(dtype: str):
    """The JAX package's ``run_mode`` loop at the cut size."""
    cfg = dataclasses.replace(jsoak.base_cfg, n=N,
                              fanout=SimConfig.log_fanout(N),
                              hb_dtype=dtype, merge_kernel="xla")
    state = jax_init_state(cfg)
    churn_ok = jnp.arange(N) >= N // 2
    outs = []
    for _ in range(CHUNKS):
        state, mc, pr = jax_run_rounds(state, cfg, ROUNDS, jsoak.key,
                                       crash_rate=soak_hb16.CRASH_RATE,
                                       rejoin_rate=soak_hb16.REJOIN_RATE,
                                       churn_ok=churn_ok)
        outs.append((np.asarray(mc.first_detect), np.asarray(mc.converged),
                     int(np.asarray(pr.true_detections).sum()),
                     int(np.asarray(pr.false_positives).sum())))
    return state, outs


def test_config_matches_jax():
    got = soak_hb16.base_config(jsoak.N)
    assert dataclasses.asdict(got) == dataclasses.asdict(jsoak.base_cfg)
    assert (soak_hb16.CRASH_RATE, soak_hb16.REJOIN_RATE) == (0.004, 0.004)
    assert (soak_hb16.N, soak_hb16.CHUNKS, soak_hb16.CHUNK_ROUNDS) == \
        (jsoak.N, 10, 5000)
    np.testing.assert_array_equal(
        soak_hb16.churn_ok(jsoak.N, "cpu").numpy(),
        np.asarray(jsoak.CHURN_OK))


@pytest.mark.parametrize("dtype", ["int32", "int16", "int8"])
def test_run_mode_matches_jax(dtype):
    st, outs = port_mode(dtype)
    jst, jouts = jax_mode(dtype)
    assert len(outs) == len(jouts) == CHUNKS
    for c, (a, b) in enumerate(zip(outs, jouts)):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"chunk {c}")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"chunk {c}")
        assert a[2:] == b[2:], c
    assert sum(o[2] for o in outs) > 0      # the churn detected crashes
    lanes = soak_hb16.host_lanes(st)
    np.testing.assert_array_equal(lanes["status"], np.asarray(jst.status))
    np.testing.assert_array_equal(lanes["age"], np.asarray(jst.age))
    np.testing.assert_array_equal(lanes["alive"], np.asarray(jst.alive))
    np.testing.assert_array_equal(lanes["hb_true"],
                                  np.asarray(jst.hb_true()))
    np.testing.assert_array_equal(lanes["hb_base"], np.asarray(jst.hb_base))
    assert st.round == int(jst.round) == CHUNKS * ROUNDS


@pytest.mark.parametrize("dtype", ["int16", "int8"])
def test_narrow_modes_pass_against_int32(dtype, capsys):
    st32, o32 = port_mode("int32")
    st, o = port_mode(dtype)
    assert soak_hb16.compare(dtype, st32, o32, st, o)
    line = capsys.readouterr().out
    assert "live MEMBER hb_true equal: True" in line
    if dtype == "int8":
        # the run crossed the int8 storage window: the base moved
        assert int(st.hb_base.max()) > 0


def test_main_at_the_cut_size(capsys):
    doc = soak_hb16.main(["--n", str(N), "--chunks", "1", "--chunk-rounds",
                          "130", "--device", "cpu", "--dtypes", "int8"])
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == "SOAK PASS"
    assert doc["ok"] and doc["pass"] == {"int8": True}
    assert doc["rounds"] == 130 and doc["store_base"]["int8"] > 0
