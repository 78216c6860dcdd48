"""The kernel knobs of the port's curves (``--merge-kernel``,
``--elementwise``) against the JAX package's ``bench/curves.py``.

* ``_kernel_overrides`` equals the JAX function over a table of (n,
  kernel, elementwise), its ``SystemExit`` included;
* ``--partition`` accepts ``--merge-kernel``/``--elementwise`` with its
  rows unchanged, equal to the JAX rows under the same knobs.
"""

from __future__ import annotations

import json

import pytest
import torch

from gossipfs_tpu.bench import curves as jax_curves
from gossipfs_tpu_torch import curves

torch.set_num_threads(1)


@pytest.mark.parametrize("n,kernel,elementwise", [
    (1024, "xla", "lanes"), (1024, "xla", "swar"), (1024, "pallas", "lanes"),
    (1024, "pallas_interpret", "lanes"), (1024, "pallas_stripe", "lanes"),
    (512, "pallas_rr", "lanes"), (1024, "pallas_rr", "swar"),
    (2048, "pallas_rr_interpret", "swar"), (16_384, "pallas_rr", "swar"),
    (3072, "pallas_rr", "lanes"), (256, "pallas_rr", "swar"),
    (1000, "pallas_rr_interpret", "lanes"),
])
def test_kernel_overrides_match_jax(n, kernel, elementwise):
    try:
        want = jax_curves._kernel_overrides(n, kernel, elementwise)
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            curves._kernel_overrides(n, kernel, elementwise)
        assert str(got.value) == str(e)
        return
    assert curves._kernel_overrides(n, kernel, elementwise) == want


def test_partition_accepts_kernel_knobs(capsys):
    args = ["--partition", "--ns", "512", "--device", "cpu"]
    curves.main(args)
    plain = json.loads(capsys.readouterr().out)
    curves.main(args + ["--merge-kernel", "pallas_rr", "--elementwise",
                        "swar"])
    knobbed = json.loads(capsys.readouterr().out)
    assert knobbed == plain
    want = jax_curves.partition_sweep(ns=(512,),
                                      merge_kernel="pallas_rr_interpret",
                                      elementwise="swar")
    assert knobbed == json.loads(json.dumps(want))
    assert knobbed["rows"][0]["cross_hb_advances"] == 0
