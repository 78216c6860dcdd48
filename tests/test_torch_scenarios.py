"""The port's scenario engine against the JAX package's.

* ``FaultScenario``: the port's own copy gives the reference's JSON text
  for every rule kind and round-trips; queries agree.
* ``compile_tensor``: equal leaves (names, dtypes, values), also through
  ``convert.scenario_from_jax``.
* ``filter_edges``, ``sends_mask``, ``arc_match_edges``: equal to the JAX
  functions on the same key for every rule kind together, two loss rules,
  ring ``[N, 3]`` edges, ``round0 > 0``, rounds before / inside / after
  each window, and in the batched form the round loops use.
* the tensor filter against the per-message runtime, per (src, dst,
  round).
* ``require_scenario_config`` raises where and as the reference does.

Tolerance: exact (integers and bools; the loss draw is the same threefry
bits compared against the same float32 rate).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu import scenarios as jscn
from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.scenarios import tensor as jtensor
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch import scenarios as tscn
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.convert import scenario_from_jax
from gossipfs_tpu_torch.scenarios import tensor as ttensor

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

N = 64


def kitchen_sink(mod, n=N):
    """Every rule kind at once, two loss rules, windows that start after
    round 0 and end at different rounds."""
    rng = np.random.default_rng(5)
    flappers = tuple(sorted(rng.choice(n, 6, replace=False).tolist()))
    return mod.FaultScenario(
        name="kitchen-sink", n=n, seed=3,
        partitions=(
            mod.Partition(start=2, end=9, groups=(tuple(range(16)),
                                                  tuple(range(16, 32)))),
            mod.Partition(start=6, end=12, groups=(tuple(range(0, n, 2)),)),
        ),
        link_faults=(
            mod.LinkFault(start=1, end=7, rate=0.25, src=tuple(range(n)),
                          dst=(7, 9, 33)),
            mod.LinkFault(start=4, end=14, rate=0.6,
                          src=tuple(range(8, 40)), dst=tuple(range(n))),
        ),
        slow_nodes=(mod.SlowNode(start=1, end=13, stride=3,
                                 nodes=tuple(range(8, 16))),),
        flapping=(mod.Flapping(start=3, end=15, up=2, down=3,
                               nodes=flappers),),
        outages=(mod.CorrelatedOutage(start=5, end=10,
                                      nodes=(40, 41, 42, 43)),),
    )


def arc_scenario(mod, n, align):
    """The aligned-arc capable rules: group-closed partition sides, slow
    and flapping senders, an outage."""
    return mod.FaultScenario(
        name="arc", n=n,
        partitions=(
            mod.Partition(start=2, end=9, groups=(tuple(range(n // 2)),)),
            mod.Partition(start=5, end=11,
                          groups=(tuple(range(align * 3, align * 7)),)),
        ),
        slow_nodes=(mod.SlowNode(start=0, end=12, stride=3,
                                 nodes=tuple(range(10))),),
        flapping=(mod.Flapping(start=1, end=14, up=2, down=2,
                               nodes=(20, 21, 50)),),
        outages=(mod.CorrelatedOutage(start=4, end=8,
                                      nodes=(n - 3, n - 2, 17)),),
    )


def leaves_equal(t_tsc, j_tsc):
    assert t_tsc._fields == j_tsc._fields
    for name in j_tsc._fields:
        got = getattr(t_tsc, name).numpy()
        want = np.asarray(getattr(j_tsc, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# --- schedule and runtime (the port's own copies) ---------------------------


def test_json_text_equals_reference_and_roundtrips():
    t, j = kitchen_sink(tscn), kitchen_sink(jscn)
    assert t.to_json() == j.to_json()
    assert tscn.FaultScenario.from_json(j.to_json()) == t
    assert t.horizon == j.horizon == 15
    for rnd in range(17):
        assert t.status(rnd) == j.status(rnd)
        assert t.unreachable_at(rnd) == j.unreachable_at(rnd)
        a, b = t.pid_at(rnd), j.pid_at(rnd)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    halves = tscn.split_halves(N, 5, 40)
    assert halves.to_json() == jscn.split_halves(N, 5, 40).to_json()
    assert tscn.expand_selector({"range": [2, 5]}, 8) == (2, 3, 4)


def test_schedule_validation_as_reference():
    for mod in (tscn, jscn):
        with pytest.raises(ValueError, match="overlap"):
            mod.FaultScenario(name="x", n=8, partitions=(
                mod.Partition(start=0, end=2, groups=((0, 1), (1, 2))),))
        with pytest.raises(ValueError, match="stride"):
            mod.FaultScenario(name="x", n=8, slow_nodes=(
                mod.SlowNode(start=0, end=2, stride=1, nodes=(0,)),))
        with pytest.raises(ValueError, match="down >= 1"):
            mod.FaultScenario(name="x", n=8, flapping=(
                mod.Flapping(start=0, end=4, up=2, down=0, nodes=(1,)),))
        with pytest.raises(ValueError, match="empty outage"):
            mod.FaultScenario(name="x", n=8, outages=(
                mod.CorrelatedOutage(start=0, end=4, nodes=()),))


def test_package_exports_as_reference():
    want = set(jscn.__all__) - {"xla_fallback_config"}
    assert set(tscn.__all__) == want
    for name in want:
        assert getattr(tscn, name) is not None
    with pytest.raises(AttributeError):
        tscn.xla_fallback_config


# --- the compiled table -----------------------------------------------------


@pytest.mark.parametrize("round0", [0, 7])
def test_compile_tensor_leaves_equal(round0):
    t_tsc = ttensor.compile_tensor(kitchen_sink(tscn), round0, device="cpu")
    j_tsc = jtensor.compile_tensor(kitchen_sink(jscn), round0)
    leaves_equal(t_tsc, j_tsc)
    # an empty scenario compiles to zero-length rule axes in both
    leaves_equal(
        ttensor.compile_tensor(tscn.FaultScenario(name="e", n=N),
                               device="cpu"),
        jtensor.compile_tensor(jscn.FaultScenario(name="e", n=N)))


def test_convert_scenario_from_jax():
    j_tsc = jtensor.compile_tensor(kitchen_sink(jscn), 4)
    t_tsc = scenario_from_jax(
        {k: np.asarray(v) for k, v in j_tsc._asdict().items()}, device="cpu")
    leaves_equal(t_tsc, j_tsc)
    assert isinstance(t_tsc, ttensor.TensorScenario)
    with pytest.raises(ValueError, match="leaves"):
        scenario_from_jax({"round0": np.int32(0)}, device="cpu")


# --- the filters ------------------------------------------------------------


@pytest.mark.parametrize("shape,round0", [("random", 0), ("random", 5),
                                          ("ring", 3)])
def test_filter_edges_equals_jax(shape, round0):
    rng = np.random.default_rng(11)
    f = 3 if shape == "ring" else 6
    edges = rng.integers(0, N, (N, f)).astype(np.int32)
    t_tsc = ttensor.compile_tensor(kitchen_sink(tscn), round0, device="cpu")
    j_tsc = jtensor.compile_tensor(kitchen_sink(jscn), round0)
    tkey = trandom.PRNGKey(9, device="cpu")
    jkey = jax.random.PRNGKey(9)
    dropped = 0
    # absolute rounds from before arming to past the horizon (rel < 0 too)
    rnds = list(range(max(round0 - 2, 0), round0 + 18))
    for rnd in rnds:
        got = ttensor.filter_edges(t_tsc, torch.from_numpy(edges), rnd,
                                   trandom.fold_in(tkey, rnd)).numpy()
        want = np.asarray(jtensor.filter_edges(
            j_tsc, jnp.asarray(edges), jnp.int32(rnd),
            jax.random.fold_in(jkey, rnd)))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"round {rnd}")
        dropped += int((want != edges).sum())
    assert dropped > 0
    # the batched form: every round in one call
    r = torch.tensor(rnds)
    batch = ttensor.filter_edges(
        t_tsc, torch.from_numpy(edges).expand(len(rnds), N, f), r,
        trandom.fold_in(tkey, r))
    for i, rnd in enumerate(rnds):
        one = ttensor.filter_edges(t_tsc, torch.from_numpy(edges), rnd,
                                   trandom.fold_in(tkey, rnd))
        assert torch.equal(batch[i], one)


@pytest.mark.parametrize("round0", [0, 6])
def test_sends_mask_equals_jax(round0):
    t_tsc = ttensor.compile_tensor(kitchen_sink(tscn), round0, device="cpu")
    j_tsc = jtensor.compile_tensor(kitchen_sink(jscn), round0)
    rnds = list(range(max(round0 - 3, 0), round0 + 18))
    batch = ttensor.sends_mask(t_tsc, N, torch.tensor(rnds))
    muted = 0
    for i, rnd in enumerate(rnds):
        want = np.asarray(jtensor.sends_mask(j_tsc, N, jnp.int32(rnd)))
        np.testing.assert_array_equal(
            ttensor.sends_mask(t_tsc, N, rnd).numpy(), want)
        np.testing.assert_array_equal(batch[i].numpy(), want)
        muted += int((~want).sum())
    assert muted > 0


@pytest.mark.parametrize("n,fanout,align,round0", [
    (256, 16, 8, 0), (256, 16, 4, 0), (128, 16, 8, 4), (512, 124, 4, 0)])
def test_arc_match_edges_equals_jax(n, fanout, align, round0):
    """nw = 2 and 4 window groups, and 31 (the mask's top bit); outages
    zero a receiver's whole mask."""
    rng = np.random.default_rng(n + align)
    t_tsc = ttensor.compile_tensor(arc_scenario(tscn, n, align), round0,
                                   device="cpu")
    j_tsc = jtensor.compile_tensor(arc_scenario(jscn, n, align), round0)
    rnds = list(range(round0, round0 + 16))
    bases = (rng.integers(0, n // align, (len(rnds), n)) * align).astype(
        np.int32)
    batch = ttensor.arc_match_edges(t_tsc, torch.from_numpy(bases),
                                    torch.tensor(rnds), fanout, align)
    full = (1 << (fanout // align)) - 1
    zeroed = partial = 0
    for i, rnd in enumerate(rnds):
        want = np.asarray(jtensor.arc_match_edges(
            j_tsc, jnp.asarray(bases[i]), jnp.int32(rnd), fanout, align))
        got = ttensor.arc_match_edges(t_tsc, torch.from_numpy(bases[i]), rnd,
                                      fanout, align).numpy()
        assert got.dtype == np.int32 and got.shape == (n, 2)
        np.testing.assert_array_equal(got, want, err_msg=f"round {rnd}")
        np.testing.assert_array_equal(batch[i].numpy(), want)
        zeroed += int((want[:, 1] == 0).sum())
        partial += int(((want[:, 1] != 0) & (want[:, 1] != full)).sum())
    assert zeroed > 0 and partial > 0


def test_tensor_matches_runtime_per_message():
    """The compiled table drops exactly the (src, dst, round) triples the
    per-message runtime drops (deterministic rules; a rate-1.0 loss rule
    stands for the link faults)."""
    n = 16
    sc = tscn.FaultScenario(
        name="gray", n=n,
        partitions=(tscn.Partition(start=2, end=6, groups=((0, 1, 2, 3),)),),
        link_faults=(tscn.LinkFault(start=0, end=10, rate=1.0, src=(4,),
                                    dst=(5,)),),
        slow_nodes=(tscn.SlowNode(start=0, end=10, stride=3, nodes=(6,)),),
        flapping=(tscn.Flapping(start=2, end=20, up=3, down=4,
                                nodes=(1, 2)),),
        outages=(tscn.CorrelatedOutage(start=5, end=9, nodes=(8, 9, 10)),),
    )
    rt = tscn.ScenarioRuntime(sc)
    tsc = ttensor.compile_tensor(sc, device="cpu")
    key = trandom.PRNGKey(0, device="cpu")
    edges = torch.arange(n, dtype=torch.int32)[None, :].repeat(n, 1)
    for rnd in range(22):
        out = ttensor.filter_edges(tsc, edges, rnd, key).numpy()
        sends = ttensor.sends_mask(tsc, n, rnd).numpy()
        for i in range(n):
            for j in range(n):
                if i != j:
                    assert (out[i, j] == i) == rt.drops(j, i, rnd), (i, j,
                                                                    rnd)
        # the sender mute is the sender-global part of the same rules
        for j in range(n):
            dark = (any(j in f.nodes and f.down_at(rnd) for f in sc.flapping)
                    or (6 == j and rnd < 10 and rnd % 3 != 0)
                    or (5 <= rnd < 9 and j in (8, 9, 10)))
            assert sends[j] == (not dark), (j, rnd)


# --- the capability matrix --------------------------------------------------


def both(fn):
    """Run ``fn(config class, scenarios module, require)`` on both
    packages and return the two error messages (None where none
    raised)."""
    msgs = []
    for cfg_cls, mod, req in ((SimConfig, tscn, ttensor), (JaxConfig, jscn,
                                                           jtensor)):
        try:
            fn(cfg_cls, mod, req.require_scenario_config)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


ARC = dict(n=1024, topology="random_arc", fanout=16, arc_align=8,
           remove_broadcast=False, fresh_cooldown=True)


@pytest.mark.parametrize("case,match", [
    ("remove_broadcast", "remove_broadcast"),
    ("stale_cooldown", "fresh_cooldown=True"),
    ("unaligned_arcs", "arc_align > 1"),
    ("loss_on_arcs", "no group form"),
    ("open_sides", "align-group-closed"),
    ("too_many_groups", "must be <= 31"),
    ("arc_ok", None),
    ("random_ok", None),
])
def test_require_scenario_config_as_reference(case, match):
    def run(cfg_cls, mod, require):
        n = 1024
        loss = mod.FaultScenario(name="l", n=n, link_faults=(
            mod.LinkFault(start=0, end=8, rate=0.5, src=tuple(range(8)),
                          dst=tuple(range(n))),))
        if case == "remove_broadcast":
            require(cfg_cls(n=16))
        elif case == "stale_cooldown":
            require(cfg_cls(n=16, remove_broadcast=False))
        elif case == "unaligned_arcs":
            require(cfg_cls(**dict(ARC, fanout=10, arc_align=1)))
        elif case == "loss_on_arcs":
            require(cfg_cls(**ARC), loss)
        elif case == "open_sides":
            require(cfg_cls(**ARC), mod.FaultScenario(
                name="p", n=n, partitions=(mod.Partition(
                    start=0, end=4, groups=(tuple(range(12)),)),)))
        elif case == "too_many_groups":
            require(cfg_cls(**dict(ARC, fanout=128, arc_align=4)),
                    mod.split_halves(n, 0, 4))
        elif case == "arc_ok":
            require(cfg_cls(**ARC), arc_scenario(mod, n, 8))
        else:
            require(cfg_cls(n=n, topology="random", fanout=10,
                            remove_broadcast=False, fresh_cooldown=True),
                    loss)

    got, want = both(run)
    assert got == want
    if match is None:
        assert got is None
    else:
        assert match in got


def test_require_takes_the_compiled_table_too():
    cfg = SimConfig(**ARC)
    loss = tscn.FaultScenario(name="l", n=1024, link_faults=(
        tscn.LinkFault(start=0, end=8, rate=0.5, src=(1,), dst=(2,)),))
    with pytest.raises(ValueError, match="no group form"):
        ttensor.require_scenario_config(
            cfg, ttensor.compile_tensor(loss, device="cpu"))
    open_sides = tscn.FaultScenario(name="p", n=1024, partitions=(
        tscn.Partition(start=0, end=4, groups=(tuple(range(12)),)),))
    with pytest.raises(ValueError, match="align-group-closed"):
        ttensor.require_scenario_config(
            cfg, ttensor.compile_tensor(open_sides, device="cpu"))
    ttensor.require_scenario_config(
        cfg, ttensor.compile_tensor(arc_scenario(tscn, 1024, 8),
                                    device="cpu"))
