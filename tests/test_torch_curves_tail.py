"""The port's (t_fail, t_suspect) surface, suspicion A/B and kernel knobs
against the JAX package's ``bench/curves.py`` (on the CPU: the plain
versions).

* ``sweep_t_fail`` and ``suspicion_sweep`` (default kernel) rows equal the
  JAX rows field for field; the port's rows add the launches by kernel
  and by resident-round form (none on the CPU);
* ``suspicion_sweep``'s ``modes``/``faults`` filters re-run one row as it
  ran in the whole sweep;
* the kernel knobs are in ``test_torch_curves_knobs.py``, the CLI's
  dispatch in ``test_torch_curves_sweep.py``.
"""

from __future__ import annotations

import json

import torch

from gossipfs_tpu.bench import curves as jax_curves
from gossipfs_tpu_torch import curves

torch.set_num_threads(1)

# keys of the port's rows that the JAX rows lack
PORT_ONLY = {"launches", "forms"}


def assert_rows_equal(got: dict, want: dict) -> None:
    assert {k: v for k, v in got.items() if k != "rows"} == \
        {k: v for k, v in want.items() if k != "rows"}
    for grow, wrow in zip(got["rows"], want["rows"], strict=True):
        assert set(grow) - set(wrow) == PORT_ONLY
        assert grow["launches"] == {} and grow["forms"] == {}
        assert {k: grow[k] for k in wrow} == wrow


def test_sweep_t_fail_matches_jax():
    kw = dict(n=256, t_fails=(3, 5), t_suspects=(0, 2), rounds=30)
    got = curves.sweep_t_fail(device="cpu", **kw)
    assert_rows_equal(got, jax_curves.sweep_t_fail(**kw))
    by = {(r["t_fail"], r["t_suspect"]): r for r in got["rows"]}
    assert by[3, 2]["refutations"] > 0 and by[3, 0]["refutations"] == 0
    assert by[3, 2]["false_positive_rate"] < by[3, 0]["false_positive_rate"]


def test_suspicion_sweep_matches_jax():
    kw = dict(ns=(256,), rounds=30)
    got = curves.suspicion_sweep(device="cpu", **kw)
    assert_rows_equal(got, jax_curves.suspicion_sweep(**kw))
    assert [(r["fault"], r["mode"]) for r in got["rows"]] == [
        (f, m) for f in ("churn", "loss")
        for m in ("baseline-t5", "raw-t3", "suspect-t3")]
    (one,) = curves.suspicion_sweep(device="cpu", only=("loss", "suspect-t3"),
                                    **kw)["rows"]
    assert one == got["rows"][-1]
