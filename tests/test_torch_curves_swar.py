"""The suspicion A/B on the port's fused path: ``suspicion_sweep(
merge_kernel="pallas_rr", elementwise="swar")`` runs every row on the lean
loop's resident round (the ``edges`` SWAR form, the loss rows with their
edges rewritten by the scenario), here through its plain version on the
CPU.  Its rows equal the JAX package's rows of the same configuration on
its XLA SWAR oracle form (``merge_kernel="xla"``), which its own tests pin
its resident-round kernel to.
"""

from __future__ import annotations

import torch

from gossipfs_tpu.bench import curves as jax_curves
from gossipfs_tpu_torch import curves
from gossipfs_tpu_torch.core import rounds
from gossipfs_tpu_torch.ops import merge

torch.set_num_threads(1)


def test_fused_swar_rows_match_jax():
    kw = dict(ns=(512,), rounds=20, elementwise="swar")
    merge.reset_launch_counts()
    got = curves.suspicion_sweep(merge_kernel="pallas_rr", device="cpu",
                                 **kw)
    assert not any(merge.LAUNCH_COUNTS.values())    # plain on the CPU
    want = jax_curves.suspicion_sweep(merge_kernel="xla", **kw)
    assert got["protocol"] == want["protocol"]
    for grow, wrow in zip(got["rows"], want["rows"], strict=True):
        assert {k: grow[k] for k in wrow} == wrow
    cfg = curves.SimConfig(
        n=512, topology="random", fanout=9, remove_broadcast=False,
        fresh_cooldown=True, t_cooldown=12,
        **curves._kernel_overrides(512, "pallas_rr", "swar"))
    assert rounds.route(cfg) == ("lean", "edges/swar/onepass")
    assert rounds.route(cfg, scenario=object()) == \
        ("lean", "edges/swar/onepass")
    assert sum(r["detected"] for r in got["rows"]) > 0
