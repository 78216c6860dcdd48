"""K3's one-pass form (f) on the route: ``onepass_fits``, the
``rr_resident`` knob, and the lean loop under it against the JAX package.

* ``ops.merge.onepass_fits`` admits the reference bench's shape
  (``headline(16_384)``, every form), ``packed_rr`` / ``suspicion_rr`` at
  16,384 and the ``[16,384 x 8,192]`` column blocks of the sharded
  headline on the narrow blocking (8 CTAs x 32 columns), N = 65,536 and
  its ``[65,536 x 8,192]`` block on the wide one (16 x 16), and refuses
  the first N past each blocking's shared memory and widths neither
  cluster can split;
* every configuration the JAX package's ``SimConfig`` validates with
  ``rr_resident="on"`` (explicit edges to N = 69,632, arcs to 104,448 at
  ``merge_block_c`` 512) validates in the port and routes
  ``<form>/onepass``, on the blocking ``onepass_blocking`` names;
* ``route()`` under ``rr_resident`` ``auto`` / ``on`` / ``off`` on each
  lean configuration, one device and sharded widths: ``auto`` takes (f)
  wherever it fits and the two-launch form elsewhere, ``on`` raises where
  it does not fit, ``off`` never takes it;
* ``SimConfig(rr_resident="on")`` raises where the lean loop cannot run
  (f), and the wrapper raises on a shape (f) refuses and on lanes that
  start off a 16-byte boundary;
* ``run_rounds`` with ``rr_resident`` ``on`` and ``off`` equals the JAX
  package's ``rr_resident="on"`` run (its Pallas resident round in
  interpret mode) in lanes, carry and every metric: aligned arcs in the
  lanes and SWAR forms, suspicion + Lifeguard, explicit edges, and one
  2-rank gloo sharded run.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core.rounds import run_rounds as jax_run_rounds
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu.ops.merge_pallas import rr_resident_supported
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.convert import to_numpy
from gossipfs_tpu_torch.core import rounds as R
from gossipfs_tpu_torch.core.state import init_state
from gossipfs_tpu_torch.ops import merge
from gossipfs_tpu_torch.parallel import distributed, mesh
from gossipfs_tpu_torch.suspicion import SuspicionParams

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)


@pytest.mark.parametrize("form", merge.FORMS)
@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
def test_onepass_fits_the_main_shapes(form, elementwise):
    # the headline and the rr profiles at N = 16,384, square and the two
    # column blocks of the sharded headline (main paths F and F')
    for c in (16_384, 8_192, 4_096):
        assert merge.onepass_fits(16_384, c, form, elementwise)
    # the frontier and capacity N and config 4's column block: the wide
    # blocking, as the TPU runs them resident at merge_block_c 512
    for c in (65_536, 8_192):
        assert merge.onepass_fits(65_536, c, form, elementwise)
        assert merge.onepass_blocking(65_536, c, form, elementwise) == (
            "16x16")
    assert merge.onepass_blocking(16_384, 16_384, form) == "8x32"
    # the narrow cluster splits rows 8 ways into 8-row groups and the wide
    # one 16 ways; a stripe is 32 or 16 columns
    assert not merge.onepass_fits(16_384 + 8, 16_384 + 8, form, elementwise)
    assert not merge.onepass_fits(16_384, 16_384 - 4, form, elementwise)
    assert not merge.onepass_fits(16_384, 0, form, elementwise)


@pytest.mark.parametrize("form", merge.FORMS)
def test_onepass_fits_stops_at_the_shared_memory(form):
    # the narrow blocking to N = 19,264, the wide one past it
    assert merge.onepass_blocking(19_264, 19_264, form) == "8x32"
    assert merge.onepass_smem(19_264, form) <= merge.ONEPASS_SMEM
    assert merge.onepass_smem(19_328, form) > merge.ONEPASS_SMEM
    assert merge.onepass_blocking(19_328, 19_328, form) == "16x16"
    assert merge.onepass_smem(16_384, form) == 197_888
    # the wide blocking's last N: 115,712 in the full-view forms (2N + 896
    # B a CTA), 109,056 in the aligned ones (17N/8 + 640)
    last = 115_712 if form in merge.FULL_VIEW_FORMS else 109_056
    assert merge.onepass_fits(last, last, form)
    assert merge.onepass_smem(last, form, "16x16") <= merge.ONEPASS_SMEM
    assert not merge.onepass_fits(last + 128, 128, form)
    assert merge.onepass_smem(last + 128, form, "16x16") > (
        merge.ONEPASS_SMEM)


def test_onepass_fits_checks_its_arguments():
    with pytest.raises(ValueError, match="form"):
        merge.onepass_fits(1024, 1024, "aligned_group/swar")
    with pytest.raises(ValueError, match="elementwise"):
        merge.onepass_fits(1024, 1024, "edges", "words")


def lean_configs():
    """(label, config, scenario armed, base form) of every lean family."""
    return [
        ("headline", SimConfig.headline(16_384), False, "aligned_group"),
        ("headline swar", SimConfig.headline(16_384, elementwise="swar"),
         False, "aligned_group/swar"),
        ("headline armed", SimConfig.headline(16_384), True, "filter_group"),
        ("headline align 4", SimConfig.headline(16_384, arc_align=4), False,
         "arc"),
        ("align 4 armed", SimConfig.headline(16_384, arc_align=4), True,
         "filter_rows"),
        ("packed_rr", SimConfig.packed_rr(16_384), False, "edges"),
        ("suspicion_rr", SimConfig.suspicion_rr(16_384), False, "edges"),
        ("suspicion_rr swar", SimConfig.suspicion_rr(
            16_384, elementwise="swar"), True, "edges/swar"),
    ]


@pytest.mark.parametrize("nloc", [None, 8_192, 2_048],
                         ids=["one device", "2 shards", "8 shards"])
@pytest.mark.parametrize("label,cfg,armed,form", lean_configs(),
                         ids=[c[0] for c in lean_configs()])
def test_route_under_rr_resident(label, cfg, armed, form, nloc):
    scenario = object() if armed else None
    assert R.route(cfg, scenario=scenario, nloc=nloc) == (
        "lean", form + "/onepass")
    on = dataclasses.replace(cfg, rr_resident="on")
    assert R.route(on, scenario=scenario, nloc=nloc) == (
        "lean", form + "/onepass")
    off = dataclasses.replace(cfg, rr_resident="off")
    assert R.route(off, scenario=scenario, nloc=nloc) == ("lean", form)
    assert R.onepass(cfg, scenario, nloc) and not R.onepass(off, scenario,
                                                            nloc)


@pytest.mark.parametrize("label,cfg,armed,form", lean_configs(),
                         ids=[c[0] for c in lean_configs()])
def test_shard_width_the_cluster_cannot_split(label, cfg, armed, form):
    """A shard of 2,052 columns (a lean width, not a stripe multiple):
    ``auto`` runs the two-launch form there, ``on`` raises."""
    scenario = object() if armed else None
    assert R.route(cfg, scenario=scenario, nloc=2_052) == ("lean", form)
    with pytest.raises(ValueError, match="does not hold"):
        R.route(dataclasses.replace(cfg, rr_resident="on"),
                scenario=scenario, nloc=2_052)


@pytest.mark.parametrize("make,want", [
    (lambda **kw: SimConfig.headline(109_184, **kw), "aligned_group"),
    (lambda **kw: SimConfig.packed_rr(115_840, **kw), "edges"),
    (lambda **kw: SimConfig.packed_rr(65_600, **kw), "edges"),
    (lambda **kw: SimConfig.headline(115_840, arc_align=4, **kw), "arc"),
    (lambda **kw: SimConfig.headline(1_032, **kw), "aligned_group"),
], ids=["headline past the wide blocking", "packed_rr past the wide "
        "blocking", "packed_rr N % 128 != 0", "align 4 past the wide "
        "blocking", "N % 64 != 0"])
def test_rr_resident_on_raises_where_it_cannot_fit(make, want):
    assert R.route(make()) == ("lean", want)           # auto: two-launch
    assert R.route(make(rr_resident="off")) == ("lean", want)
    with pytest.raises(ValueError, match="rr_resident='on'"):
        make(rr_resident="on")


# the JAX package's families at the N and merge_block_c its rr_resident="on"
# validates (gossipfs_tpu/config.py:319-335, rr_resident_supported): the
# port's form and blocking there
JAX_ARC = dict(topology="random_arc", fanout=16, remove_broadcast=False,
               fresh_cooldown=True, t_cooldown=12, merge_kernel="pallas_rr",
               view_dtype="int8", hb_dtype="int8")
FAMILIES = {
    "packed_rr": (lambda n, bc, **kw: JaxConfig.packed_rr(n, bc, **kw),
                  lambda n, **kw: SimConfig.packed_rr(n, **kw), "edges"),
    "suspicion_rr": (
        lambda n, bc, **kw: JaxConfig.suspicion_rr(n, bc, **kw),
        lambda n, **kw: SimConfig.suspicion_rr(n, **kw), "edges"),
    "aligned arcs": (
        lambda n, bc, **kw: JaxConfig(n=n, arc_align=8, merge_block_c=bc,
                                      **JAX_ARC, **kw),
        lambda n, **kw: SimConfig.headline(n, **kw), "aligned_group"),
    "arcs align 4": (
        lambda n, bc, **kw: JaxConfig(n=n, arc_align=4, merge_block_c=bc,
                                      **JAX_ARC, **kw),
        lambda n, **kw: SimConfig.headline(n, arc_align=4, **kw), "arc"),
}
ENVELOPE = [(f, n, bc) for f in ("packed_rr", "suspicion_rr")
            for n, bc in ((24_576, 512), (24_576, 1_024), (32_768, 512),
                          (32_768, 1_024), (49_152, 512), (65_536, 512),
                          (69_632, 512))] + [
    ("aligned arcs", n, bc) for n, bc in (
        (24_576, 1_024), (32_768, 512), (32_768, 1_024), (49_152, 512),
        (49_152, 1_024), (65_536, 512), (98_304, 512), (104_448, 512))] + [
    ("arcs align 4", n, 512) for n in (65_536, 98_304, 104_448)]


@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
@pytest.mark.parametrize("family,n,block_c", ENVELOPE,
                         ids=[f"{f} {n} c{bc}" for f, n, bc in ENVELOPE])
def test_rr_resident_on_runs_where_the_reference_runs_resident(
        family, n, block_c, elementwise):
    """The JAX package validates ``rr_resident="on"`` here, so the port
    validates it and routes ``<form>/onepass`` (``auto`` too), on the wide
    blocking (every such N is past the narrow one's 19,264)."""
    jmake, tmake, form = FAMILIES[family]
    jmake(n, block_c, rr_resident="on", elementwise=elementwise)
    cfg = tmake(n, rr_resident="on", elementwise=elementwise)
    name = form + ("/swar" if elementwise == "swar" else "")
    assert R.route(cfg) == ("lean", name + "/onepass")
    assert R.route(dataclasses.replace(cfg, rr_resident="auto")) == (
        "lean", name + "/onepass")
    assert merge.onepass_blocking(n, n, form, elementwise) == "16x16"


def test_column_block_of_the_reference_runs_one_pass():
    """Config 4's ``[65,536 x 8,192]`` column block (the headline over 8
    shards): the JAX gate admits it (``rr_resident_supported`` with
    ``n_cols`` 8,192), and the port routes each shard one-pass."""
    assert rr_resident_supported(65_536, 16, 512, 8_192, arc_align=8)
    cfg = SimConfig.headline(65_536, rr_resident="on")
    assert R.route(cfg, nloc=8_192) == ("lean", "aligned_group/onepass")
    assert merge.onepass_blocking(65_536, 8_192, "aligned_group") == "16x16"


def test_port_admits_every_jax_resident_configuration():
    """Over N = 512 .. 131,072 (every multiple of 512) and merge_block_c
    512 and 1,024: wherever the JAX package's SimConfig validates
    ``rr_resident="on"``, the port's validates and ``onepass_fits`` holds
    the square round (the port may admit more)."""
    admitted = 0
    for family, (jmake, tmake, form) in FAMILIES.items():
        for block_c in (512, 1_024):
            for n in range(block_c, 131_072 + 1, block_c):
                try:
                    jmake(n, block_c, rr_resident="on")
                except ValueError:
                    continue
                admitted += 1
                assert merge.onepass_fits(n, n, form), (family, n)
                tmake(n, rr_resident="on")
    # up to 69,632 on explicit edges and 104,448 on arcs at block_c 512
    assert admitted == 2 * (136 + 34) + 2 * (204 + 51)


def test_rr_resident_on_where_no_lean_round_runs():
    # a ring runs the separate-pass loop, whose rounds no resident round
    # runs: nothing to refuse (the JAX package checks only pallas_rr)
    cfg = SimConfig(n=1_030, rr_resident="on")
    assert R.route(cfg) == ("separate", "fused_merge_update")
    assert R.route(SimConfig.headline(16_384, rr_resident="on"), True) == (
        "separate", "arc_merge_update")
    with pytest.raises(ValueError, match="unknown rr_resident"):
        SimConfig(rr_resident="yes")


def test_onepass_timeline_split():
    """Stamps of 4 stripes: each step's median microseconds, the
    stripe's, and the launch's span from the first start to the last
    end."""
    steps = torch.tensor([0, 14_000, 17_000, 35_000, 37_000])   # ns
    tl = torch.zeros((4, 8, merge.ONEPASS_STAMPS),
                     dtype=torch.int64)
    for i, start in enumerate((0, 300, 41_000, 41_200)):
        tl[i, :] = start + steps
    split = merge.onepass_timeline_split(tl)
    assert split == dict(step1=14.0, sync=3.0, step2=18.0, tail=2.0,
                         stripe=37.0, span=78.2)


def test_wrapper_raises_on_a_shape_onepass_refuses():
    rng = np.random.default_rng(0)
    n = 1_032
    hb = torch.from_numpy(rng.integers(-128, 128, (n, n), dtype=np.int8))
    asl = torch.full((n, n), -127, dtype=torch.int8)
    flags = torch.full((n,), 7, dtype=torch.int8)
    vecs = torch.zeros((merge.N_VEC, n), dtype=torch.int8)
    bases = torch.zeros(n, dtype=torch.int32)
    kw = dict(fanout=16, arc_align=8, t_fail=5, t_cooldown=12)
    with pytest.raises(ValueError, match="does not hold"):
        merge.resident_round(hb, asl, flags, vecs, bases, onepass=True, **kw)
    tl = torch.zeros((n // 32, 8, merge.ONEPASS_STAMPS),
                     dtype=torch.int64)
    with pytest.raises(ValueError, match="one-pass option"):
        merge.resident_round(hb, asl, flags, vecs, bases, timeline=tl, **kw)
    # a shape (f) takes, on the CPU: no kernel steps to record
    m = 1_024
    with pytest.raises(ValueError, match="CUDA kernel's steps"):
        merge.resident_round(hb[:m, :m].contiguous(), asl[:m, :m].contiguous(),
                             flags[:m], vecs[:, :m].contiguous(), bases[:m],
                             onepass=True, timeline=tl[:m // 32], **kw)
    # the two-launch form's plain version takes it
    merge.resident_round(hb, asl, flags, vecs, bases, **kw)


@pytest.mark.parametrize("name", ["hb", "asl", "vecs"])
@pytest.mark.parametrize("offset", [1, 8])
def test_wrapper_raises_on_lanes_off_a_16_byte_boundary(name, offset):
    """(f) moves 16-byte row segments: a contiguous view whose data starts
    off a 16-byte boundary is refused by name on any device (the CUDA
    launcher would refuse it with a bare invalid-value code); the two-launch
    form's plain version takes the same view."""
    rng = np.random.default_rng(0)
    n = 1_024
    args = dict(
        hb=torch.from_numpy(rng.integers(-128, 128, (n, n), dtype=np.int8)),
        asl=torch.full((n, n), -127, dtype=torch.int8),
        vecs=torch.zeros((merge.N_VEC, n), dtype=torch.int8))
    t = args[name]
    buf = torch.empty(t.numel() + offset, dtype=torch.int8)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset
    args[name] = view
    flags = torch.full((n,), 7, dtype=torch.int8)
    bases = torch.zeros(n, dtype=torch.int32)
    kw = dict(fanout=16, arc_align=8, t_fail=5, t_cooldown=12)
    with pytest.raises(ValueError, match=f"moves {name} in 16-byte"):
        merge.resident_round(args["hb"], args["asl"], flags, args["vecs"],
                             bases, onepass=True, **kw)
    want = merge.resident_round(args["hb"].clone(), args["asl"].clone(),
                                flags, args["vecs"].clone(), bases, **kw)
    got = merge.resident_round(args["hb"], args["asl"], flags, args["vecs"],
                               bases, **kw)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


N, ROUNDS = 512, 10
GOSSIP = dict(remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
              view_dtype="int8", hb_dtype="int8")
ARC = dict(topology="random_arc", fanout=16, arc_align=8, **GOSSIP)
RR = dict(topology="random", fanout=9, fused_tick="auto", **GOSSIP)
LH = dict(t_suspect=2, lh_multiplier=3, lh_frac=0.03125)
# tests/test_merge_pallas.py's resident (rr_resident="on") configurations
# at a small N: aligned arcs, lanes and SWAR, suspicion + Lifeguard, and
# explicit edges
CASES = {
    "aligned lanes": (ARC, None, "aligned_group"),
    "aligned swar": (dict(ARC, elementwise="swar"), None,
                     "aligned_group/swar"),
    "aligned suspicion + lh": (ARC, LH, "aligned_group"),
    "explicit edges": (RR, None, "edges"),
}


def configs(name: str):
    shape, sus, _ = CASES[name]
    jkw, tkw = dict(shape), dict(shape)
    if sus is not None:
        jkw.update(t_fail=3, suspicion=JaxSus(**sus))
        tkw.update(t_fail=3, suspicion=SuspicionParams(**sus))
    jcfg = JaxConfig(n=N, merge_kernel="pallas_rr_interpret",
                     merge_block_c=N, rr_resident="on", **jkw)
    tcfg = SimConfig(n=N, merge_kernel="pallas_rr", **tkw)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def jax_run(name: str):
    jcfg, _ = configs(name)
    align = jcfg.arc_align if jcfg.topology == "random_arc" else 1
    assert rr_resident_supported(N, jcfg.fanout, N, arc_align=align)
    return jax_run_rounds(jax_init_state(jcfg), jcfg, ROUNDS,
                          jax.random.PRNGKey(9), crash_rate=0.02)


def compare(jout, state, carry, metrics):
    js, jc, jm = jout
    got = to_numpy(state, carry)
    for k in ("hb", "age", "status", "alive", "hb_base", *jc._fields):
        want = getattr(js, k) if hasattr(js, k) else getattr(jc, k)
        np.testing.assert_array_equal(got[k], np.asarray(want), err_msg=k)
    for k in jm._fields:
        np.testing.assert_array_equal(getattr(metrics, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)


@pytest.mark.parametrize("resident", ["on", "off"])
@pytest.mark.parametrize("name", list(CASES))
def test_run_rounds_matches_jax_resident_interpret(name, resident):
    _, tcfg = configs(name)
    tcfg = dataclasses.replace(tcfg, rr_resident=resident)
    form = CASES[name][2] + ("/onepass" if resident == "on" else "")
    assert R.route(tcfg) == ("lean", form)
    merge.reset_launch_counts()
    out = R.run_rounds(init_state(tcfg, device="cpu"), tcfg, ROUNDS,
                       trandom.PRNGKey(9, device="cpu"), crash_rate=0.02)
    assert not any(merge.LAUNCH_COUNTS.values())     # plain on the CPU
    compare(jax_run(name), *out)
    assert int(np.asarray(jax_run(name)[2].true_detections).sum()) > 0


def test_sharded_run_matches_jax_resident_interpret():
    """The aligned headline over 2 gloo ranks with ``rr_resident="on"``:
    each rank routes its [512 x 256] shard to the one-pass form, and the
    gathered shards equal the JAX package's resident run."""
    _, tcfg = configs("aligned suspicion + lh")
    tcfg = dataclasses.replace(tcfg, rr_resident="on")
    job = dict(config=tcfg, rounds=ROUNDS, seed=9, crash_rate=0.02)
    ranks = distributed.launch(mesh.run_jobs, 2, ([job],), device="cpu",
                               threads=1, timeout=300)
    for r in ranks:
        assert r[0]["route"] == ("lean", "aligned_group/onepass")
        assert r[0]["nloc"] == N // 2
    head = ranks[0][0]
    compare(jax_run("aligned suspicion + lh"), head["state"], head["carry"],
            head["metrics"])
