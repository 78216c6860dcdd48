"""Where ``elementwise="swar"`` goes, and the entry points that take it.

* ``route()`` and ``ops.merge.kernel_form`` name the SWAR form of every
  configuration the lean gate admits with ``elementwise="swar"``: each has
  a SWAR instantiation of the CUDA resident round (5 merge forms x
  crash-only / suspicion / + Lifeguard, the mute on the edge_filter
  forms), and every SWAR name counts its launches on its own;
* ``SimConfig(elementwise="swar")`` still needs int8 lanes;
* ``frontier.run(elementwise="swar")`` and ``bench --elementwise`` run;
  the frontier's report equals the lanes run's;
* ``SimDetector`` and ``PackedDetector`` sessions under a SWAR
  configuration equal the lanes configuration's;
* on the card (``cuda`` marker; skipped without one): the SWAR kernel
  against the SWAR plain version and the lanes kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from gossipfs_tpu_torch import bench
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core import rounds as R
from gossipfs_tpu_torch.detector.sim import PackedDetector, SimDetector
from gossipfs_tpu_torch.frontier import run as run_frontier
from gossipfs_tpu_torch.ops import merge
from gossipfs_tpu_torch.scenarios import split_halves
from gossipfs_tpu_torch.scenarios.tensor import compile_tensor
from gossipfs_tpu_torch.suspicion import SuspicionParams

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

SW = dict(elementwise="swar")
SUS = dict(t_fail=3, suspicion=SuspicionParams(t_suspect=2))
LH = dict(t_fail=3, suspicion=SuspicionParams(t_suspect=2, lh_multiplier=3,
                                              lh_frac=0.03125))
# every lean configuration family, crash-only / suspicion / + Lifeguard
LEAN = [
    (SimConfig.headline(16_384, **SW), "aligned_group"),
    (SimConfig.packed_rr(16_384, **SW), "edges"),
    (SimConfig.headline(16_384, arc_align=4, **SW), "arc"),
    (SimConfig.packed_rr(16_384, topology="random_arc", fanout=16, **SW),
     "arc"),
]


@pytest.mark.parametrize("mode", [{}, SUS, LH],
                         ids=["crash-only", "suspicion", "lh"])
@pytest.mark.parametrize("cfg,form", LEAN + [(c, f) for c, f in LEAN[:1]],
                         ids=["aligned", "edges", "align4", "plain-arc",
                              "armed"])
def test_route_names_the_swar_form(cfg, form, mode, request):
    cfg = dataclasses.replace(cfg, **mode)
    armed = request.node.callspec.id.endswith("armed")
    scenario = None
    if armed:
        # a scenario turns aligned arcs into the edge_filter forms
        scenario = compile_tensor(split_halves(cfg.n, 2, 5), device="cpu")
        form = "filter_group"
    got = R.route(cfg, scenario=scenario)
    # N = 16,384: the one-pass form holds every form
    assert got == ("lean", form + "/swar/onepass")
    # the form the kernel is launched in, and its own launch counter
    arc = cfg.topology == "random_arc"
    assert merge.kernel_form(cfg.fanout if arc else None, cfg.arc_align,
                             armed, cfg.elementwise) + "/onepass" == got[1]
    assert got[1] in merge.FORM_LAUNCHES and got[1] in merge.ONEPASS_FORMS
    assert got[1].removesuffix("/onepass") in merge.SWAR_FORMS
    assert cfg.n % merge.KERNEL_VEC == 0
    # the same configuration in the lanes form routes to the lanes name
    lanes = R.route(dataclasses.replace(cfg, elementwise="lanes"),
                    scenario=scenario)
    assert lanes == ("lean", form + "/onepass")


def test_swar_filter_rows_and_separate_routes():
    cfg = SimConfig.headline(4_096, arc_align=4, **SW)
    tsc = compile_tensor(split_halves(cfg.n, 2, 5), device="cpu")
    assert R.route(cfg, scenario=tsc) == ("lean", "filter_rows/swar/onepass")
    # matrix events and ragged N keep the separate-pass round's kernels
    assert R.route(cfg, True) == ("separate", "arc_merge_update")
    assert R.route(SimConfig.packed_rr(1_030, **SW)) == (
        "separate", "stripe_merge_update")
    assert set(merge.SWAR_FORMS) == {f + "/swar" for f in merge.FORMS}


def test_swar_config_needs_int8_lanes():
    with pytest.raises(ValueError, match="int8"):
        SimConfig(n=64, topology="random", fanout=4, view_dtype="int8",
                  hb_dtype="int16", elementwise="swar")
    with pytest.raises(ValueError, match="elementwise"):
        SimConfig(n=64, elementwise="words")
    assert SimConfig.headline(1024, **SW).elementwise == "swar"


def test_frontier_swar_equals_lanes_on_cpu(tmp_path):
    kw = dict(n=256, rounds=14, block_c=128, seed=4, device="cpu")
    lanes = run_frontier(**kw)
    swar = run_frontier(elementwise="swar", **kw)
    assert swar["elementwise"] == "swar" and lanes["elementwise"] == "lanes"
    timing = {"seconds_per_round", "rounds_per_sec", "elementwise"}
    assert ({k: v for k, v in swar.items() if k not in timing}
            == {k: v for k, v in lanes.items() if k not in timing})
    assert swar["detected"] > 0
    # --trace is ported: the SWAR run's trace is the lanes run's
    traces = [tmp_path / "lanes.jsonl", tmp_path / "swar.jsonl"]
    run_frontier(trace=str(traces[0]), **kw)
    run_frontier(elementwise="swar", trace=str(traces[1]), **kw)
    lanes_rows, swar_rows = (p.read_text().splitlines() for p in traces)
    assert swar_rows[1:] == lanes_rows[1:] and len(lanes_rows) > 20


def test_bench_takes_elementwise():
    cfg = bench.headline_config(1024, True, "swar")
    assert cfg.elementwise == "swar" and cfg.suspicion is not None
    assert bench.headline_config(1024, False).elementwise == "lanes"
    with pytest.raises(SystemExit):
        bench.main(["--elementwise", "words"])


def test_detector_sessions_swar_equal_lanes():
    """One ``SimDetector`` session (interactive rounds, a crash, a join,
    a bulk advance) and one ``PackedDetector`` session, each under the
    SWAR configuration and under the lanes one: equal lanes and events."""
    def sim(cfg):
        d = SimDetector(cfg, seed=2, device="cpu")
        d.advance(3)
        d.crash(5)
        d.advance(7)
        d.join(5)
        d.advance(2)
        d.advance_bulk(6)
        return d.state, d.drain_events()

    def packed(cfg):
        d = PackedDetector(cfg, seed=3, device="cpu")
        d.advance(2)
        d.crash(9)
        d.advance(8)
        return d.lanes(), d.drain_events()

    for run, cfg in ((sim, SimConfig(n=128, topology="random", fanout=6,
                                     view_dtype="int8", hb_dtype="int8")),
                     (packed, SimConfig.packed_rr(256))):
        (sl, el), (ss, es) = (run(dataclasses.replace(cfg, elementwise=e))
                              for e in merge.ELEMENTWISE)
        for k in ("hb", "asl", "alive", "hb_base"):
            assert torch.equal(getattr(sl, k), getattr(ss, k)), k
        assert el == es and any(e.subject in (5, 9) for e in es)


@pytest.mark.cuda
def test_cuda_swar_kernel_matches_plain_and_lanes():
    """The SWAR kernel on the card against the SWAR plain version and the
    lanes kernel, every merge form, suspicion + Lifeguard (chip_smoke.py
    phase 30 runs all 15 instantiations at N = 16,384)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    n = 1024
    rng = np.random.default_rng(5)
    st = rng.integers(0, 4, (n, n))
    age = np.where(st == 3, rng.integers(2, 14, (n, n)),
                   rng.integers(0, 64, (n, n)))
    c = lambda a, dt: torch.from_numpy(np.asarray(a)).to("cuda", dt)  # noqa: E731
    hb = c(rng.integers(-128, 128, (n, n)), torch.int8)
    asl = c((age << 2 | st) - 128, torch.int8)
    flags = c(rng.integers(0, 32, n), torch.int8)
    sa = c(rng.integers(-260, 60, n), torch.int32)
    vecs = merge.threshold_stack(sa, sa, sa * 0, 126)
    bases = c(rng.integers(0, n // 8, n) * 8, torch.int32)
    masks = c(np.stack([rng.integers(0, n // 8, n) * 8,
                        rng.integers(0, 4, n)], 1), torch.int32)
    forms = [(bases, dict(fanout=16, arc_align=8)),
             (c(rng.integers(0, n, (n, 10)), torch.int32), {}),
             (bases, dict(fanout=16, arc_align=1)),
             (masks, dict(fanout=16, arc_align=8, edge_filter=True)),
             (masks, dict(fanout=16, arc_align=4, edge_filter=True))]
    for senders, fkw in forms:
        kw = dict(fkw, t_fail=3, t_cooldown=12, suspect=True, t_suspect=2,
                  lh_multiplier=3)
        got = merge.resident_round(hb.clone(), asl.clone(), flags, vecs,
                                   senders, elementwise="swar", **kw)
        for fn, ew in ((merge.resident_round_plain, "swar"),
                       (merge.resident_round, "lanes")):
            want = fn(hb.clone(), asl.clone(), flags, vecs, senders,
                      elementwise=ew, **kw)
            for x, y in zip(got, want):
                assert torch.equal(x, y)
