"""The suspect forms of the port's merge kernels, and K5, bit for bit
against the JAX package.

(a) K2's suspect form: ``fused_merge_update_plain(suspect=True)`` == the
    JAX package's ``fused_merge_update_blocked(suspect=3)`` in interpret
    mode, every (view, hb) dtype pair, on lanes holding SUSPECT entries;
    the two extra reductions (refuted, held) against their definition over
    the kernel's lanes;
(b) K5: ``stripe_merge_update_plain`` == the JAX package's K2/K5 oracle
    (``_membership_update`` over ``fanout_max_merge_xla``, the narrow or
    int32 epilogue by hb dtype) and == ``fused_merge_update_plain``, for
    every (hb dtype, detection stats, suspect) combination, dead receivers
    included;
(c) K4's suspect form against the XLA arc oracle;
(d) K3's suspicion + Lifeguard form: one round of
    ``resident_round_plain(suspect=True, lh_multiplier=3)`` == the JAX
    package's ``resident_round_blocked`` in interpret mode, flags bit 4
    mixed, SUSPECT entries on both sides of both confirm thresholds;
(e) the K5 wrapper runs the plain version on CPU and checks its inputs.
Every comparison is exact equality.  The CUDA kernels are held against
their plain versions on the card (chip_smoke.py phases 13-14;
``test_cuda_suspect_kernels_match_plain`` below).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core.rounds import _membership_update
from gossipfs_tpu.core.state import SimState as JaxState
from gossipfs_tpu.ops import merge_pallas as mp
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core.rounds import _rebase_shifts_vec
from gossipfs_tpu_torch.ops import merge, merge_update as mu
from gossipfs_tpu_torch.ops.merge import pack_age_status, unpack_age_status

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

PAIRS = [(np.int8, np.int8), (np.int8, np.int16), (np.int8, np.int32),
         (np.int16, np.int16), (np.int16, np.int32)]
PAIR_IDS = [f"{v.__name__}-{h.__name__}" for v, h in PAIRS]
TORCH = {np.int8: torch.int8, np.int16: torch.int16, np.int32: torch.int32}
HB_NAME = {np.int8: "int8", np.int16: "int16", np.int32: "int32"}
OUT_NAMES = ("hb", "age", "status", "cnt_incl", "n_det", "first_obs",
             "refuted", "held")
SUSPECT = 3


def sus_lanes(n: int, vd, hd, seed: int):
    """Post-tick lanes over every status, SUSPECT included, ages 0..63
    (many at 0: fresh detections), floor sentinels, dead receivers whose
    view rows are absent."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(hd)
    hb = rng.integers(max(info.min, -300), min(info.max, 300) + 1,
                      (n, n)).astype(hd)
    hb[rng.random((n, n)) < 0.05] = info.min
    age = rng.integers(0, 64, (n, n)).astype(np.int8)
    age[rng.random((n, n)) < 0.2] = 0
    status = rng.integers(0, 4, (n, n)).astype(np.int8)
    alive = rng.random(n) < 0.8
    view = rng.integers(-1, 120, (n, n)).astype(vd)
    view[~alive] = -1
    return rng, view, hb, age, status, alive


def torch_merge(fn, view, senders, hb, age, status, sa, sb, alive, **kw):
    t = torch.from_numpy
    out = fn(t(view), t(senders), t(hb.copy()),
             pack_age_status(t(age), t(status)), t(sa), t(sb), t(alive), **kw)
    a, s = unpack_age_status(out[1])
    return [out[0].numpy(), a.numpy(), s.numpy(),
            *(o.numpy() for o in out[2:])]


def sus_reductions(status, w_st, alive):
    """refuted and held per subject, by definition: a SUSPECT entry the
    merge turned MEMBER (only an advance does), and entries still
    SUSPECT after the merge over all rows."""
    refuted = ((status == SUSPECT) & (w_st == 1)).sum(0).astype(np.int32)
    held = (w_st == SUSPECT).sum(0).astype(np.int32)
    return refuted, held


@pytest.mark.parametrize("vd,hd", PAIRS, ids=PAIR_IDS)
def test_k2_suspect_form_matches_jax_kernel_interpret(vd, hd):
    """(a) K2 with suspect: all six kernel outputs equal the Pallas
    kernel's, and refuted/held their definition."""
    n, fanout = 256, 3
    rng, view, hb, age, status, alive = sus_lanes(n, vd, hd, 7)
    edges = rng.integers(0, n, (n, fanout)).astype(np.int32)
    sa = rng.integers(-200, 200, n).astype(np.int32)
    sb = rng.integers(-200, 200, n).astype(np.int32)
    shp = mp.blocked_shape(n, 8192)
    blk = lambda a: jnp.asarray(a).reshape(shp)  # noqa: E731
    out = mp.fused_merge_update_blocked(
        blk(view), jnp.asarray(edges), blk(hb), blk(age), blk(status),
        jnp.asarray(sa).reshape(shp[1:]), jnp.asarray(sb).reshape(shp[1:]),
        jnp.asarray(alive.astype(np.int32)), member=1, unknown=0,
        age_clamp=63, failed=2, detect_stats=True, interpret=True,
        suspect=SUSPECT)
    want = [np.asarray(o).reshape(n, -1) for o in out[:3]]
    want += [np.asarray(o).reshape(n) for o in out[3:]]
    want += sus_reductions(status, want[2], alive)
    got = torch_merge(mu.fused_merge_update_plain, view, edges, hb, age,
                      status, sa, sb, alive, detect_stats=True, suspect=True)
    for name, g, w in zip(OUT_NAMES, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[6].sum() > 0 and got[7].sum() > 0


def invariant_shifts(n: int, hd, rng):
    """Shifts as the round derives them (the narrow oracle's invariants),
    about one subject in five with a base far above its counter."""
    cfg = SimConfig(n=n, topology="random", fanout=3, view_dtype="int8",
                    hb_dtype=HB_NAME[hd])
    colmax = rng.integers(1, 40_000, n)
    window = {np.int8: 126, np.int16: 16_384, np.int32: 0}[hd]
    prev = colmax - rng.integers(0, 2, n)
    rejoin = rng.random(n) < 0.2
    colmax = np.where(rejoin, rng.integers(1, 50, n), colmax)
    basec = np.maximum(prev - window, 0) if window else np.zeros(n, np.int64)
    sa, sb, _ = _rebase_shifts_vec(
        TORCH[hd], torch.from_numpy(basec.astype(np.int32)), cfg,
        torch.from_numpy(colmax.astype(np.int32)))
    return cfg, sa.numpy(), sb.numpy(), rejoin


def oracle(cfg, best, hb, age, status, alive, sa, sb, suspect: bool):
    """The JAX package's XLA membership update over ``best``, with the
    per-subject reductions by definition."""
    n = hb.shape[0]
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in
                        ("n", "topology", "fanout", "view_dtype",
                         "hb_dtype")},
                     remove_broadcast=False, fresh_cooldown=True,
                     suspicion=JaxSus() if suspect else None)
    state = JaxState(hb=jnp.asarray(hb), age=jnp.asarray(age),
                     status=jnp.asarray(status), alive=jnp.asarray(alive),
                     round=jnp.int32(0), hb_base=jnp.zeros(n, jnp.int32))
    w_hb, w_age, w_st = (np.asarray(a) for a in _membership_update(
        state, best, jnp.asarray(sa), jnp.asarray(sb), jcfg))
    lst = (w_st & 1) == 1 if suspect else w_st == 1
    fresh = alive[:, None] & (status == 2) & (age == 0)
    rows = np.arange(n)[:, None]
    out = [w_hb, w_age, w_st,
           (alive[:, None] & lst).sum(0).astype(np.int32),
           fresh.sum(0).astype(np.int32),
           np.where(fresh, rows, n).min(0).astype(np.int32)]
    if suspect:
        out += sus_reductions(status, w_st, alive)
    return out


def oracle_inputs(n: int, hd, seed: int, suspect: bool):
    rng = np.random.default_rng(seed)
    cfg, sa, sb, rejoin = invariant_shifts(n, hd, rng)
    _, view, hb, age, status, alive = sus_lanes(n, np.int8, hd, seed)
    if not suspect:
        status = np.where(status == SUSPECT, 1, status).astype(np.int8)
    if hd == np.int32:
        hb = rng.integers(0, 50_000, (n, n)).astype(np.int32)
    # floor sentinels under a negative shift_b: the one corner where the
    # reference's two epilogue forms part (test_torch_merge_update.py)
    lo = np.iinfo(hd).min
    hb[:, rejoin] = np.where(hb[:, rejoin] == lo, lo + 1, hb[:, rejoin])
    view = np.where(view >= 0, rng.integers(0, cfg.rebase_window + 1,
                                            (n, n)), -1).astype(np.int8)
    return rng, cfg, view, hb, age, status, alive, sa, sb


@pytest.mark.parametrize("suspect", [False, True], ids=["off", "suspect"])
@pytest.mark.parametrize("detect_stats", [False, True],
                         ids=["nostats", "stats"])
@pytest.mark.parametrize("hd", [np.int8, np.int16, np.int32],
                         ids=["int8", "int16", "int32"])
def test_k5_plain_matches_the_oracle_and_k2(hd, detect_stats, suspect):
    """(b) K5 plain == ``_membership_update`` over
    ``fanout_max_merge_xla`` (the oracle of the JAX package's K2 and K5)
    and == K2 plain, dead receivers included."""
    n, fanout = 256, 7
    rng, cfg, view, hb, age, status, alive, sa, sb = oracle_inputs(
        n, hd, fanout + int(suspect), suspect)
    edges = rng.integers(0, n, (n, fanout)).astype(np.int32)
    best = mp.fanout_max_merge_xla(jnp.asarray(view), jnp.asarray(edges))
    want = oracle(cfg, best, hb, age, status, alive, sa, sb, suspect)
    if not detect_stats:
        want[4] = np.zeros(n, np.int32)
        want[5] = np.zeros(n, np.int32)
    kw = dict(detect_stats=detect_stats, suspect=suspect)
    got = torch_merge(mu.stripe_merge_update_plain, view, edges, hb, age,
                      status, sa, sb, alive, **kw)
    k2 = torch_merge(mu.fused_merge_update_plain, view, edges, hb, age,
                     status, sa, sb, alive, **kw)
    assert len(got) == len(want) == (8 if suspect else 6)
    for name, g, w, k in zip(OUT_NAMES, got, want, k2):
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(k, g, err_msg=f"K2 {name}")
    assert (got[0] != hb).any() and (~alive).any()


@pytest.mark.parametrize("fanout", [16, 11])
def test_k4_suspect_form_matches_the_xla_arc_oracle(fanout):
    """(c) K4 with suspect over int8 lanes against the arc window max +
    the narrow suspicion epilogue."""
    n = 256
    rng, cfg, view, hb, age, status, alive, sa, sb = oracle_inputs(
        n, np.int8, fanout, True)
    bases = rng.integers(0, n, n).astype(np.int32)
    best = mp.arc_window_max_xla(jnp.asarray(view), jnp.asarray(bases),
                                 fanout)
    want = oracle(cfg, best, hb, age, status, alive, sa, sb, True)
    got = torch_merge(mu.arc_merge_update_plain, view, bases, hb, age,
                      status, sa, sb, alive, fanout=fanout,
                      detect_stats=True, suspect=True)
    for name, g, w in zip(OUT_NAMES, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[6].sum() > 0


K3_KW = dict(fanout=16, arc_align=8, t_fail=3, t_cooldown=12)


def k3_inputs(n: int, seed: int):
    """Pre-tick lanes for one suspicion round: MEMBER ages up to
    t_fail + 1, SUSPECT ages from t_fail + 2 to 15 (both sides of the
    confirm ages 5 and 11), every status, never-sent entries, flags with
    bit 4 on half the rows, deep shifts; numpy (hb, asl, flags, sa, g,
    bases)."""
    t_fail = K3_KW["t_fail"]
    rng = np.random.default_rng(seed)
    hb = rng.integers(-128, 128, (n, n), dtype=np.int8)
    hb[rng.random((n, n)) < 0.05] = -128
    st = rng.integers(0, 4, (n, n)).astype(np.int32)
    age = np.where(st == 1, rng.integers(1, t_fail + 2, (n, n)),
                   np.where(st == 3, rng.integers(t_fail + 2, 16, (n, n)),
                            rng.integers(1, 64, (n, n)))).astype(np.int32)
    asl = ((age << 2 | st) - 128).astype(np.int8)
    flags = rng.choice(np.array([0, 1, 2, 4, 5, 6], np.int8), n)
    flags = (flags + 16 * (rng.random(n) < 0.5)).astype(np.int8)
    sa = rng.integers(-260, 60, n).astype(np.int32)
    g = rng.integers(-200, 60, n).astype(np.int32)
    bases = (rng.integers(0, n // 8, n) * 8).astype(np.int32)
    return hb, asl, flags, sa, g, bases


def test_k3_suspicion_lh_round_matches_jax_kernel_interpret():
    """(d) One resident round with the SWIM lifecycle and the Lifeguard
    lane.  The JAX kernel counts a round's new suspects as post-tick
    (SUSPECT, age t_fail + 1) entries, the port (like the XLA round) as
    the stale MEMBER entries; the two agree on every state a run reaches
    (a listed entry ages past t_fail + 1 only through its stale round), so
    the lanes here keep MEMBER ages <= t_fail + 1 and SUSPECT ages above
    it, over both confirm thresholds (5 and 11)."""
    n, c_blk = 1024, 512
    nc, cs = n // c_blk, c_blk // mp.LANE
    t_suspect, lh = 2, 3
    hb, asl, flags, sa, g, bases = k3_inputs(n, 29)
    to4 = lambda a: jnp.asarray(  # noqa: E731
        a.reshape(n, nc, cs, mp.LANE).transpose(1, 0, 2, 3))
    vec4 = lambda a: jnp.asarray(a.reshape(nc, cs, mp.LANE))  # noqa: E731
    kw = K3_KW
    out = mp.resident_round_blocked(
        jnp.asarray(bases).reshape(n, 1), to4(hb), to4(asl),
        jnp.asarray(np.broadcast_to(flags[:, None], (n, mp.LANE)).copy()),
        vec4(sa), vec4(sa), vec4(g), member=1, unknown=0, failed=2,
        age_clamp=63, window=126, block_r=128, interpret=True,
        resident=True, suspect=SUSPECT, t_suspect=t_suspect,
        lh_multiplier=lh, rcnt_acc=True, **kw)
    from4 = lambda a: np.asarray(a).transpose(1, 0, 2, 3).reshape(n, n)  # noqa: E731
    want = [from4(out[0]), from4(out[1])]
    want += [np.asarray(o).astype(np.int32).reshape(n) for o in out[2:]]
    t = torch.from_numpy
    vecs = merge.threshold_stack(t(sa), t(sa), t(g), 126)
    got = merge.resident_round_plain(
        t(hb.copy()), t(asl.copy()), t(flags), vecs, t(bases),
        suspect=True, t_suspect=t_suspect, lh_multiplier=lh, **kw)
    names = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt",
             "entered", "refuted", "held", "suspect_cnt")
    assert len(got) == len(want) == len(names)
    for name, w, o in zip(names, want, got):
        np.testing.assert_array_equal(o.numpy(), w, err_msg=name)
    for i in (3, 6, 7, 8, 9):
        assert got[i].sum() > 0, names[i]
    # the stretch acts: without bit 4 more entries confirm
    flat = merge.resident_round_plain(
        t(hb.copy()), t(asl.copy()), t(flags & 15), vecs, t(bases),
        suspect=True, t_suspect=t_suspect, lh_multiplier=lh, **kw)
    assert int(flat[3].sum()) > int(got[3].sum())


def test_k3_suspicion_arguments_checked():
    n = 64
    t = torch.zeros
    args = (t((n, n), dtype=torch.int8), t((n, n), dtype=torch.int8),
            t(n, dtype=torch.int8), t((merge.N_VEC, n), dtype=torch.int8),
            t(n, dtype=torch.int32))
    kw = dict(fanout=16, arc_align=8, t_fail=3, t_cooldown=12)
    with pytest.raises(ValueError, match="lh_multiplier"):
        merge.resident_round(*args, lh_multiplier=2, **kw)
    with pytest.raises(ValueError, match="t_suspect"):
        merge.resident_round(*args, suspect=True, t_suspect=0, **kw)
    with pytest.raises(ValueError, match="age_clamp"):
        merge.resident_round(*args, suspect=True, t_suspect=20,
                             lh_multiplier=2, **kw)
    out = merge.resident_round(*args, suspect=True, t_suspect=2, **kw)
    assert len(out) == 9


def test_stripe_wrapper_runs_plain_on_cpu_and_checks_inputs():
    """(e) On CPU tensors the K5 wrapper IS the plain version (no count);
    it takes an int8 view only."""
    n = 64
    rng, view, hb, age, status, alive = sus_lanes(n, np.int8, np.int16, 3)
    edges = rng.integers(0, n, (n, 4)).astype(np.int32)
    sa = rng.integers(-50, 50, n).astype(np.int32)
    merge.reset_launch_counts()
    for suspect in (False, True):
        got = torch_merge(mu.stripe_merge_update, view, edges, hb, age,
                          status, sa, sa, alive, detect_stats=True,
                          suspect=suspect)
        want = torch_merge(mu.stripe_merge_update_plain, view, edges, hb,
                           age, status, sa, sa, alive, detect_stats=True,
                           suspect=suspect)
        assert len(got) == (8 if suspect else 6)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert merge.LAUNCH_COUNTS["stripe_merge_update"] == 0
    t = torch.from_numpy
    args = [t(view).to(torch.int16), t(edges), t(hb),
            pack_age_status(t(age), t(status)), t(sa), t(sa), t(alive)]
    with pytest.raises(ValueError, match="int8"):
        mu.stripe_merge_update(*args)
    args[0] = t(view)
    args[1] = t(edges).long()
    with pytest.raises(ValueError, match="edges"):
        mu.stripe_merge_update(*args)
    assert mu.stripe_admits(mu.STRIPE_MAX_N, "int8")
    assert not mu.stripe_admits(mu.STRIPE_MAX_N + 1, "int8")
    assert not mu.stripe_admits(1024, "int16")


@pytest.mark.cuda
def test_cuda_suspect_kernels_match_plain():
    """K5 and the suspect forms of K2, K4 and K3 against their plain
    versions on the card (skips without one; chip_smoke.py phases 13-14
    run the same checks at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    for n in (1024, 1030):
        for hd in (np.int8, np.int16, np.int32):
            rng, view, hb, age, status, alive = sus_lanes(n, np.int8, hd, n)
            edges = rng.integers(0, n, (n, 14)).astype(np.int32)
            bases = rng.integers(0, n, n).astype(np.int32)
            sa = rng.integers(-200, 200, n).astype(np.int32)
            c = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
            for det in (False, True):
                for sus in (False, True):
                    for fn, plain, senders, kw in (
                            (mu.stripe_merge_update,
                             mu.stripe_merge_update_plain, edges, {}),
                            (mu.fused_merge_update,
                             mu.fused_merge_update_plain, edges, {}),
                            (mu.arc_merge_update, mu.arc_merge_update_plain,
                             bases, dict(fanout=16))):
                        asl = pack_age_status(c(age), c(status))
                        a = [c(view), c(senders), c(hb), asl, c(sa), c(sa),
                             c(alive)]
                        got = fn(a[0], a[1], a[2].clone(), a[3].clone(),
                                 *a[4:], detect_stats=det, suspect=sus, **kw)
                        want = plain(a[0], a[1], a[2].clone(), a[3].clone(),
                                     *a[4:], detect_stats=det, suspect=sus,
                                     **kw)
                        for x, y in zip(got, want):
                            assert torch.equal(x, y)
    hb, asl, flags, sa, g, bases = (torch.from_numpy(a).cuda()
                                    for a in k3_inputs(1024, 5))
    vecs = merge.threshold_stack(sa, sa, g, 126)
    kw = dict(K3_KW, suspect=True, t_suspect=2)
    for lh in (0, 3):
        got = merge.resident_round(hb.clone(), asl.clone(), flags, vecs,
                                   bases, lh_multiplier=lh, **kw)
        want = merge.resident_round_plain(hb.clone(), asl.clone(), flags,
                                          vecs, bases, lh_multiplier=lh,
                                          **kw)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
