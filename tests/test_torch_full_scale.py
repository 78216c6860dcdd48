"""The port's sharded entry point against the JAX package's.

``gossipfs_tpu_torch.full_scale.run`` (4 rank processes on the CPU,
gloo) against ``gossipfs_tpu.bench.full_scale.run`` (the same program
over a 4-device virtual mesh) at a small N: every field of the JSON
document but the timings and ``backend`` is equal, detections included
(the run goes past crash + t_fail).  Then ``main``'s ``--out`` artifact
keeps the newest run as ``current`` and the older ones in ``history``.
"""

from __future__ import annotations

import json

import pytest
import torch

from gossipfs_tpu.bench import full_scale as jax_full_scale
from gossipfs_tpu_torch import full_scale

torch.set_num_threads(1)

ARGS = dict(n=512, rounds=10, crash_at=3, track=8, crash_rate=0.01,
            devices=4, seed=0)
TIMING = ("wall_seconds", "rounds_per_sec", "backend")


@pytest.fixture(scope="module")
def port_doc():
    return full_scale.run(**ARGS, device="cpu")


def test_full_scale_matches_jax(port_doc):
    want = jax_full_scale.run(*ARGS.values())
    assert set(port_doc) == set(want)
    for k in want:
        if k not in TIMING:
            assert port_doc[k] == want[k], k
    assert port_doc["detected"] == 8 and port_doc["ttd_first_median"] == 5
    assert port_doc["backend"] == "4 rank processes on CPU, gloo"


def test_full_scale_main_writes_the_artifact(tmp_path, capsys):
    out = tmp_path / "FULLSCALE.json"
    argv = ["--n", "256", "--rounds", "4", "--devices", "2", "--device",
            "cpu", "--out", str(out)]
    full_scale.main(argv)
    full_scale.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    doc = json.loads(out.read_text())
    assert doc["current"] == line
    assert len(doc["history"]) == 1
    assert doc["history"][0]["n"] == 256 and line["shards"] == 2
