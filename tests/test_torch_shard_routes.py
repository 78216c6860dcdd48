"""Which loop and kernel each configuration takes on a column shard.

A gate that reads N where a kernel's limit is on the shard's width would
send a shard to a CUDA wrapper that raises, which the CPU tests cannot
see (the class of fault ROADMAP records for PR 4).  So the route of
every configuration the port runs sharded is pinned per rank count here
(``core.rounds.route(config, matrix_events, scenario, nloc)``), and every
lean route is one the CUDA resident round launches on that shard
(``nloc % 4 == 0``); every separate-pass route names a kernel that admits
the shape.  The ``cuda`` twin launches each route's kernel on a shard on
the card.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.bench import headline_config
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core import rounds as R
from gossipfs_tpu_torch.core.state import init_shard
from gossipfs_tpu_torch.full_scale import full_scale_config
from gossipfs_tpu_torch.models.presets import sim_100k
from gossipfs_tpu_torch.ops import merge, merge_update
from gossipfs_tpu_torch.scenarios import FaultScenario, Partition
from gossipfs_tpu_torch.scenarios.tensor import compile_tensor

torch.set_num_threads(1)


def config4(n: int) -> SimConfig:
    """Config 4's fault model (``sim_100k``) at ``n`` nodes."""
    cfg = sim_100k().config
    return dataclasses.replace(cfg, n=n, fanout=SimConfig.log_fanout(n))


def split(n: int):
    return compile_tensor(FaultScenario(
        name="split", n=n, partitions=(Partition(
            start=2, end=9, groups=(tuple(range(n // 2)),)),)), 0,
        device="cpu")


# name -> (config, matrix events, scenario, {ranks: route})
ROUTES = {
    "headline": (SimConfig.headline(16_384), False, None,
                 {1: ("lean", "aligned_group/onepass"),
                  2: ("lean", "aligned_group/onepass"),
                  4: ("lean", "aligned_group/onepass"),
                  8: ("lean", "aligned_group/onepass")}),
    "headline swar (main path F')": (
        SimConfig.headline(16_384, elementwise="swar"), False, None,
        {2: ("lean", "aligned_group/swar/onepass"),
         8: ("lean", "aligned_group/swar/onepass")}),
    "bench --suspicion": (headline_config(16_384, True), False, None,
                          {2: ("lean", "aligned_group/onepass")}),
    "headline align 4": (SimConfig.headline(16_384, arc_align=4), False,
                         None, {4: ("lean", "arc/onepass")}),
    "packed_rr": (SimConfig.packed_rr(16_384), False, None,
                  {2: ("lean", "edges/onepass"),
                   4: ("lean", "edges/onepass")}),
    "suspicion_rr": (SimConfig.suspicion_rr(16_384), False, None,
                     {2: ("lean", "edges/onepass")}),
    "suspicion_rr, rejoins": (SimConfig.suspicion_rr(16_384), True, None,
                              {2: ("separate", "stripe_merge_update"),
                               4: ("separate", "stripe_merge_update")}),
    "headline under a split": (SimConfig.headline(1024), False, split(1024),
                               {2: ("lean", "filter_group/onepass")}),
    "headline N=1032": (SimConfig.headline(1032), False, None,
                        {1: ("lean", "aligned_group"),
                         2: ("lean", "aligned_group"),
                         4: ("separate", "arc_merge_update")}),
    "full_scale N=65536": (full_scale_config(65_536), False, None,
                           {4: ("separate", "arc_merge_update"),
                            8: ("separate", "arc_merge_update")}),
    "config 4 N=32768 (main path G)": (
        config4(32_768), True, None,
        {1: ("separate", "fused_merge_update"),
         2: ("separate", "fused_merge_update")}),
    "config 4 N=131072": (config4(131_072), True, None,
                          {8: ("separate", "fused_merge_update")}),
}
PARAMS = [(k, w) for k in ROUTES for w in ROUTES[k][3]]


@pytest.mark.parametrize("name,ranks", PARAMS,
                         ids=[f"{k}-{w}" for k, w in PARAMS])
def test_route_per_rank_count(name, ranks):
    cfg, matrix, scenario, want = ROUTES[name]
    nloc = None if ranks == 1 else cfg.n // ranks
    assert R.route(cfg, matrix, scenario, nloc) == want[ranks]


@pytest.mark.parametrize("name,ranks", PARAMS,
                         ids=[f"{k}-{w}" for k, w in PARAMS])
def test_route_is_launchable_on_the_shard(name, ranks):
    """A lean route's shard packs 4 subjects a vector and names a form of
    the resident round; a separate-pass route's kernel admits the
    shard (K5: the rows' strip fits shared memory, whatever the width)."""
    cfg, matrix, scenario, _ = ROUTES[name]
    nloc = cfg.n // ranks
    loop, kernel = R.route(cfg, matrix, scenario, None if ranks == 1
                           else nloc)
    if loop == "lean":
        assert nloc % merge.KERNEL_VEC == 0
        assert kernel in merge.FORM_LAUNCHES
        if kernel in merge.ONEPASS_FORMS:
            assert merge.onepass_fits(cfg.n, nloc, kernel.split("/")[0],
                                      cfg.elementwise)
    else:
        assert kernel in merge.LAUNCH_COUNTS
        if kernel == "stripe_merge_update":
            assert merge_update.stripe_admits(cfg.n, cfg.view_dtype)


# small shards of each route for the card: (config, run kwargs, kernel)
CUDA_CASES = {
    "aligned_group": (SimConfig.headline(1024), dict(crash_rate=0.02),
                      "resident_round"),
    "aligned_group/swar": (SimConfig.headline(1024, elementwise="swar"),
                           dict(crash_rate=0.02), "resident_round"),
    "edges": (SimConfig.packed_rr(1024, 512), dict(crash_rate=0.02),
              "resident_round"),
    "arc_merge_update": (SimConfig.headline(1032),
                         dict(crash_rate=0.02), "arc_merge_update"),
    "stripe_merge_update": (SimConfig.suspicion_rr(1024, 512),
                            dict(crash_rate=0.02, rejoin_rate=0.02),
                            "stripe_merge_update"),
    "fused_merge_update": (config4(1024), dict(crash_rate=0.05,
                                               rejoin_rate=0.05),
                           "fused_merge_update"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_cuda_shard_routes_launch(name):
    """On the card, the last of 4 shards of each route runs 2 rounds
    through its kernel (one process: no sums across shards, so only the
    launches are checked here; the sharded outputs are checked by
    chip_smoke.py phases 37-39)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, kw, kernel = CUDA_CASES[name]
    nloc = cfg.n // 4
    ctx = R.ShardCtx(offset=3 * nloc, nloc=nloc)
    merge.reset_launch_counts()
    R.run_rounds(init_shard(cfg, ctx, device="cuda"), cfg, 2,
                 trandom.PRNGKey(0, device="cuda"), ctx=ctx, **kw)
    torch.cuda.synchronize()
    assert merge.LAUNCH_COUNTS[kernel] == 2
