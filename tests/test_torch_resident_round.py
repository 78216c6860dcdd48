"""The port's resident round and round loop, bit for bit against JAX.

(a) one round of ``resident_round_plain`` against the JAX package's
    ``resident_round_blocked`` in interpret mode, on numpy-made inputs
    relaid to its stripe-major layout;
(b) the port's ``run_rounds`` against JAX ``run_rounds`` (XLA merge) on
    the aligned-arc headline profile at N=2048 for 8 rounds;
(c) the same at N=512 for 300 rounds, across the 126-round int8 rebase
    window (hb_base grows past it), small-group refresh and cooldown
    expiry;
(d) a tracked crash schedule (crash_only_events) giving an equal
    ``summarize`` report.
Every comparison is exact equality: the protocol arithmetic is integer.
The CUDA kernel itself is held against the plain version on the card
(chip_smoke.py; ``test_cuda_kernel_matches_plain`` below).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.bench.run import tracked_crash_events as jax_tracked
from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core.rounds import run_rounds as jax_run_rounds
from gossipfs_tpu.core.state import RoundEvents as JaxEvents
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu.metrics.detection import summarize as jax_summarize
from gossipfs_tpu.ops import merge_pallas as mp
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.bench import tracked_crash_events
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core.rounds import run_rounds
from gossipfs_tpu_torch.core.state import RoundEvents, init_state
from gossipfs_tpu_torch.metrics.detection import summarize
from gossipfs_tpu_torch.ops import merge
from gossipfs_tpu_torch.scenarios import (
    FaultScenario, LinkFault, compile_tensor)

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

HEADLINE = dict(topology="random_arc", fanout=16, arc_align=8,
                remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
                view_dtype="int8", hb_dtype="int8")
ROUND_KW = dict(fanout=16, arc_align=8, t_fail=5, t_cooldown=12)


def random_round(n: int, seed: int, min_age: int = 0):
    """Numpy pre-tick lanes + per-subject vectors covering every corner:
    all three statuses, ages to the clamp, never-sent (-128) entries,
    mixed flags and shifts below -128."""
    rng = np.random.default_rng(seed)
    hb = rng.integers(-128, 128, (n, n), dtype=np.int8)
    hb[rng.random((n, n)) < 0.05] = -128
    age = rng.integers(min_age, 64, (n, n)).astype(np.int32)
    st = rng.integers(0, 3, (n, n)).astype(np.int32)
    asl = ((age << 2 | st) - 128).astype(np.int8)
    flags = rng.integers(0, 8, n).astype(np.int8)
    sa = rng.integers(-260, 60, n).astype(np.int32)
    sb = np.where(rng.random(n) < 0.5, sa,
                  rng.integers(-260, 60, n)).astype(np.int32)
    g = rng.integers(-200, 60, n).astype(np.int32)
    bases = (rng.integers(0, n // 8, n) * 8).astype(np.int32)
    return hb, asl, flags, sa, sb, g, bases


def torch_round(fn, hb, asl, flags, sa, sb, g, bases):
    t = torch.from_numpy
    vecs = merge.threshold_stack(t(sa), t(sb), t(g), 126)
    out = fn(t(hb.copy()), t(asl.copy()), t(flags), vecs, t(bases),
             **ROUND_KW)
    return [o.numpy() for o in out]


def test_resident_round_plain_matches_jax_kernel_interpret():
    """(a) One round: plain PyTorch == the Pallas kernel (interpret mode)
    in both lanes and all four reductions.  Ages start at 1: the JAX
    kernel's resident form reads detections back as (FAILED, age 0)
    post-tick entries, which a pre-tick age of 0 would imitate."""
    n, c_blk = 2048, 1024
    nc, cs = n // c_blk, c_blk // mp.LANE
    hb, asl, flags, sa, sb, g, bases = random_round(n, 3, min_age=1)
    to4 = lambda a: jnp.asarray(  # noqa: E731
        a.reshape(n, nc, cs, mp.LANE).transpose(1, 0, 2, 3))
    vec4 = lambda a: jnp.asarray(a.reshape(nc, cs, mp.LANE))  # noqa: E731
    out = mp.resident_round_blocked(
        jnp.asarray(bases).reshape(n, 1), to4(hb), to4(asl),
        jnp.asarray(np.broadcast_to(flags[:, None], (n, mp.LANE)).copy()),
        vec4(sa), vec4(sb), vec4(g), member=1, unknown=0, failed=2,
        age_clamp=63, window=126, block_r=128, interpret=True,
        resident=True, **ROUND_KW)
    from4 = lambda a: np.asarray(a).transpose(1, 0, 2, 3).reshape(n, n)  # noqa: E731
    want = [from4(out[0]), from4(out[1])]
    want += [np.asarray(o).reshape(n) for o in out[2:5]]
    want.append(np.asarray(out[5]).astype(np.int32).reshape(n, -1).sum(1)
                // mp.LANE)
    got = torch_round(merge.resident_round_plain, hb, asl, flags, sa, sb, g,
                      bases)
    names = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt")
    for name, w, o in zip(names, want, got):
        np.testing.assert_array_equal(o, w, err_msg=name)
    assert got[3].sum() > 0 and (got[4] < n).any()   # detections fired


def test_resident_round_wrapper_runs_plain_on_cpu():
    """On CPU tensors the wrapper IS the plain version (no kernel, no
    count); wrong dtypes, shapes and layouts raise."""
    n = 256
    args = random_round(n, 11)
    merge.reset_launch_counts()
    got = torch_round(merge.resident_round, *args)
    want = torch_round(merge.resident_round_plain, *args)
    for o, w in zip(got, want):
        np.testing.assert_array_equal(o, w)
    assert merge.LAUNCH_COUNTS["resident_round"] == 0
    hb, asl, flags, sa, sb, g, bases = (torch.from_numpy(a) for a in args)
    vecs = merge.threshold_stack(sa, sb, g, 126)
    with pytest.raises(ValueError, match="bases"):
        merge.resident_round(hb, asl, flags, vecs, bases.long(), **ROUND_KW)
    with pytest.raises(ValueError, match="contiguous"):
        merge.resident_round(hb.t(), asl, flags, vecs, bases, **ROUND_KW)
    with pytest.raises(ValueError, match="asl"):
        merge.resident_round(hb, asl[:8], flags, vecs, bases, **ROUND_KW)


def _compare_scans(n: int, rounds: int, crash_rate: float, seed: int):
    jcfg = JaxConfig(n=n, merge_kernel="xla", **HEADLINE)
    tcfg = SimConfig(n=n, **HEADLINE)
    js, jc, jm = jax_run_rounds(jax_init_state(jcfg), jcfg, rounds,
                                jax.random.PRNGKey(seed),
                                crash_rate=crash_rate)
    ts, tc, tm = run_rounds(init_state(tcfg, device="cpu"), tcfg, rounds,
                            trandom.PRNGKey(seed, device="cpu"),
                            crash_rate=crash_rate)
    pairs = [("hb", js.hb, ts.hb), ("age", js.age, ts.age),
             ("status", js.status, ts.status), ("alive", js.alive, ts.alive),
             ("hb_base", js.hb_base, ts.hb_base)]
    pairs += [(f, getattr(jc, f), getattr(tc, f)) for f in jc._fields]
    pairs += [(f, getattr(jm, f), getattr(tm, f)) for f in jm._fields]
    for name, a, b in pairs:
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert ts.round == int(js.round) == rounds
    return js, jm


def test_run_rounds_matches_jax_n2048():
    """(b) N=2048, 8 rounds, 2% churn, PRNGKey(17): the whole scan."""
    _, jm = _compare_scans(2048, 8, 0.02, 17)
    assert int(jnp.sum(jm.true_detections)) > 0


def test_run_rounds_matches_jax_across_rebase_window():
    """(c) N=512, 300 rounds, 1% churn: past the 126-round int8 window
    (the per-subject base rebases), through small-group refresh once the
    cohort thins, and through cooldown expiry."""
    js, jm = _compare_scans(512, 300, 0.01, 17)
    assert int(jnp.max(js.hb_base)) > 126
    assert int(jm.n_alive[-1]) < 512 // 8


def test_tracked_crash_report_matches_jax():
    """(d) Tracked crashes (crash_only_events=True) on top of churn: the
    same schedule, the same run and an equal DetectionReport."""
    n, rounds = 512, 40
    jcfg = JaxConfig(n=n, merge_kernel="xla", **HEADLINE)
    tcfg = SimConfig(n=n, **HEADLINE)
    jev, jcr, jok = jax_tracked(jcfg, rounds, 6, 10)
    tev, tcr, tok = tracked_crash_events(tcfg, rounds, 6, 10, device="cpu")
    assert jcr == tcr
    np.testing.assert_array_equal(tev.crash.numpy(), np.asarray(jev.crash))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    _, jc, jm = jax_run_rounds(jax_init_state(jcfg), jcfg, rounds,
                               jax.random.PRNGKey(4), events=jev,
                               crash_rate=0.01, churn_ok=jok,
                               crash_only_events=True)
    _, tc, tm = run_rounds(init_state(tcfg, device="cpu"), tcfg, rounds,
                           trandom.PRNGKey(4, device="cpu"), events=tev,
                           crash_rate=0.01,
                           churn_ok=tok, crash_only_events=True)
    want = jax_summarize(jc, jm, jcr).as_dict()
    got = summarize(tc, tm, tcr).as_dict()
    assert got == want
    assert all(v >= 0 for v in got["ttd_first"].values())


@pytest.mark.parametrize("change", [
    dict(topology="random", arc_align=1), dict(arc_align=1),
    dict(remove_broadcast=True),
], ids=["explicit edges", "plain arcs", "remove_broadcast"])
def test_run_rounds_off_the_lean_slice_matches_jax(change):
    """Profiles the resident round does not take run the separate-pass
    loop (K2 for explicit edges, K4 for arcs), still bit for bit."""
    kw = {**dict(n=64, **HEADLINE), **change}
    jcfg, tcfg = JaxConfig(merge_kernel="xla", **kw), SimConfig(**kw)
    js, jc, jm = jax_run_rounds(jax_init_state(jcfg), jcfg, 30,
                                jax.random.PRNGKey(2), crash_rate=0.03)
    ts, tc, tm = run_rounds(init_state(tcfg, device="cpu"), tcfg, 30,
                            trandom.PRNGKey(2, device="cpu"), crash_rate=0.03)
    pairs = [("hb", js.hb, ts.hb), ("age", js.age, ts.age),
             ("status", js.status, ts.status), ("alive", js.alive, ts.alive)]
    pairs += [(f, getattr(jc, f), getattr(tc, f)) for f in jc._fields]
    pairs += [(f, getattr(jm, f), getattr(tm, f)) for f in jm._fields]
    for name, a, b in pairs:
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert int(jnp.sum(jm.true_detections)) > 0


@pytest.mark.parametrize("change,scenario,error,match", [
    (dict(suspicion="swim"), None, ValueError, "SuspicionParams"),
    ({}, "loss", ValueError, "no group form"),
], ids=["suspicion", "scenario"])
def test_run_rounds_rejects_outside_the_slice(change, scenario, error,
                                              match):
    """Suspicion and scenarios run on both loops now: what stays outside
    is a suspicion value that is not a ``SuspicionParams`` (rejected when
    the configuration is built) and a scenario the topology cannot honor
    (Bernoulli loss on aligned arcs, rejected by ``run_rounds`` as the JAX
    package rejects it)."""
    if scenario == "loss":
        scenario = compile_tensor(FaultScenario(name="l", n=64, link_faults=(
            LinkFault(start=0, end=4, rate=0.5, src=(1,), dst=(2,)),)),
            device="cpu")
    with pytest.raises(error, match=match):
        cfg = SimConfig(**{**dict(n=64, **HEADLINE), **change})
        st = init_state(cfg, device="cpu")
        run_rounds(st, cfg, 2, trandom.PRNGKey(0, device="cpu"),
                   scenario=scenario)


def test_run_rounds_rejects_join_events():
    """Joins are matrix events: a join-carrying schedule under the
    crash-only promise raises, as in the JAX package; without it, and
    with random rejoins, the scan runs and matches JAX."""
    n, rounds = 64, 30
    cfg = SimConfig(n=n, **HEADLINE)
    ev = RoundEvents.none(rounds, n, device="cpu")
    ev = ev._replace(join=ev.join.clone(), crash=ev.crash.clone())
    ev.crash[2, 3] = True
    ev.join[20, 3] = True
    with pytest.raises(ValueError, match="join"):
        run_rounds(init_state(cfg, device="cpu"), cfg, rounds,
                   trandom.PRNGKey(0, device="cpu"), events=ev,
                   crash_only_events=True)
    jcfg = JaxConfig(n=n, merge_kernel="xla", **HEADLINE)
    jev = JaxEvents(*(jnp.asarray(m.numpy()) for m in ev))
    js, jc, jm = jax_run_rounds(jax_init_state(jcfg), jcfg, rounds,
                                jax.random.PRNGKey(0), events=jev,
                                crash_rate=0.02, rejoin_rate=0.1)
    ts, tc, tm = run_rounds(init_state(cfg, device="cpu"), cfg, rounds,
                            trandom.PRNGKey(0, device="cpu"), events=ev,
                            crash_rate=0.02,
                            rejoin_rate=0.1)
    for a, b in ((js.hb, ts.hb), (js.status, ts.status),
                 (js.alive, ts.alive), *zip(jc, tc), *zip(jm, tm)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(jnp.sum(jm.true_detections)) > 0


def test_run_rounds_plain_flag_is_the_same_loop_on_cpu():
    """``plain=True`` (what the card's checks compare the kernel against)
    and the wrapper path agree on CPU, where both run the plain round."""
    cfg = SimConfig(n=128, **HEADLINE)
    a = run_rounds(init_state(cfg, device="cpu"), cfg, 12,
                   trandom.PRNGKey(9, device="cpu"),
                   crash_rate=0.05)
    b = run_rounds(init_state(cfg, device="cpu"), cfg, 12,
                   trandom.PRNGKey(9, device="cpu"),
                   crash_rate=0.05, plain=True)
    for x, y in zip((a[0].hb, a[0].asl, *a[1], *a[2]),
                    (b[0].hb, b[0].asl, *b[1], *b[2])):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against the plain version on the card (skips
    without one; chip_smoke.py runs the same check at N=16,384)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    n = 1024
    hb, asl, flags, sa, sb, g, bases = (
        torch.from_numpy(a).cuda() for a in random_round(n, 5))
    vecs = merge.threshold_stack(sa, sb, g, 126)
    got = merge.resident_round(hb.clone(), asl.clone(), flags, vecs, bases,
                               **ROUND_KW)
    want = merge.resident_round_plain(hb.clone(), asl.clone(), flags, vecs,
                                      bases, **ROUND_KW)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
