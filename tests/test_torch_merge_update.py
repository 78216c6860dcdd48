"""The port's merge kernels K2 and K4 (ops/merge_update.py), bit for bit
against the JAX package.

(a) ``fused_merge_update_plain`` == the JAX package's
    ``fused_merge_update_blocked`` in interpret mode, at N=256 for every
    (view, hb) dtype pair the configuration admits, detection stats on and
    off;
(b) ``arc_merge_update_plain`` == the JAX package's XLA arc oracle
    (``arc_window_max_xla`` + ``_membership_update``, the pair its K4 is
    pinned to), on lanes and shifts that keep the rebase invariants the
    narrow oracle relies on;
(c) the window max alone against ``arc_window_max_xla`` for power-of-two
    and other fanouts, including windows wrapping more than half the rows;
(d) the wrappers run the plain versions on CPU tensors (no launch count)
    and reject malformed inputs.
Every comparison is exact equality: the protocol arithmetic is integer.
The CUDA kernels are held against the plain versions on the card
(chip_smoke.py; ``test_cuda_kernels_match_plain`` below).
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
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core.rounds import _rebase_shifts_vec
from gossipfs_tpu_torch.ops import merge, merge_update as mu
from gossipfs_tpu_torch.ops.merge import pack_age_status, unpack_age_status

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

# every (view, hb) lane pair SimConfig admits
PAIRS = [(np.int8, np.int8), (np.int8, np.int16), (np.int8, np.int32),
         (np.int16, np.int16), (np.int16, np.int32)]
PAIR_IDS = [f"{v.__name__}-{h.__name__}" for v, h in PAIRS]
TORCH = {np.int8: torch.int8, np.int16: torch.int16, np.int32: torch.int32}
OUT_NAMES = ("hb", "age", "status", "cnt_incl", "n_det", "first_obs")


def corner_lanes(n: int, vd, hd, seed: int):
    """Post-tick lanes over every corner: all statuses, ages 0..63 (many
    at 0: fresh detections), floor sentinels, dead receivers whose view
    rows are absent (a dead node never sends)."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(hd)
    hb = rng.integers(max(info.min, -300), min(info.max, 300) + 1,
                      (n, n)).astype(hd)
    hb[rng.random((n, n)) < 0.05] = info.min
    age = rng.integers(0, 64, (n, n)).astype(np.int8)
    age[rng.random((n, n)) < 0.2] = 0
    status = rng.integers(0, 3, (n, n)).astype(np.int8)
    alive = rng.random(n) < 0.8
    view = rng.integers(-1, 120, (n, n)).astype(vd)
    view[~alive] = -1
    return view, hb, age, status, alive


def torch_merge(fn, view, senders, hb, age, status, sa, sb, alive, **kw):
    t = torch.from_numpy
    hb_t, asl, cnt, n_det, fobs = fn(
        t(view), t(senders), t(hb.copy()), pack_age_status(t(age), t(status)),
        t(sa), t(sb), t(alive), **kw)
    a, s = unpack_age_status(asl)
    return [hb_t.numpy(), a.numpy(), s.numpy(), cnt.numpy(), n_det.numpy(),
            fobs.numpy()]


@pytest.mark.parametrize("detect_stats", [False, True])
@pytest.mark.parametrize("vd,hd", PAIRS, ids=PAIR_IDS)
def test_fused_plain_matches_jax_kernel_interpret(vd, hd, detect_stats):
    """(a) K2: all six outputs equal the Pallas kernel's."""
    n, fanout = 256, 3
    view, hb, age, status, alive = corner_lanes(n, vd, hd, 7)
    rng = np.random.default_rng(8)
    edges = rng.integers(0, n, (n, fanout)).astype(np.int32)
    sa = rng.integers(-200, 200, n).astype(np.int32)
    sb = rng.integers(-200, 200, n).astype(np.int32)
    shp = mp.blocked_shape(n, 8192)
    blk = lambda a: jnp.asarray(a).reshape(shp)  # noqa: E731
    out = mp.fused_merge_update_blocked(
        blk(view), jnp.asarray(edges), blk(hb), blk(age), blk(status),
        jnp.asarray(sa).reshape(shp[1:]), jnp.asarray(sb).reshape(shp[1:]),
        jnp.asarray(alive.astype(np.int32)), member=1, unknown=0,
        age_clamp=63, failed=2, detect_stats=detect_stats, interpret=True)
    want = [np.asarray(o).reshape(n, -1) for o in out[:3]]
    want += [np.asarray(o).reshape(n) for o in out[3:]]
    got = torch_merge(mu.fused_merge_update_plain, view, edges, hb, age,
                      status, sa, sb, alive, detect_stats=detect_stats)
    for name, g, w in zip(OUT_NAMES, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got[4].sum() > 0) == detect_stats


def invariant_shifts(n: int, hd, view_dtype: str, rng):
    """Shifts as the round derives them: each subject's base follows its
    own counter, and about one in five has a base far above its counter
    (a carried state whose counter restarted: deep negative ``shift_b``).
    Returns (config, shift_a, shift_b, that mask)."""
    cfg = SimConfig(n=n, topology="random", fanout=3, view_dtype=view_dtype,
                    hb_dtype={np.int8: "int8", np.int16: "int16",
                              np.int32: "int32"}[hd])
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


@pytest.mark.parametrize("fanout", [16, 11])
@pytest.mark.parametrize("vd,hd", PAIRS, ids=PAIR_IDS)
def test_arc_plain_matches_xla_oracle(vd, hd, fanout):
    """(b) K4 (detection stats on): lanes against the JAX package's arc
    window max + narrow/int32 membership update, reductions against their
    definition over the oracle's lanes."""
    n = 256
    rng = np.random.default_rng(fanout)
    view_dtype = "int8" if vd == np.int8 else "int16"
    cfg, sa, sb, rejoin = invariant_shifts(n, hd, view_dtype, rng)
    view, hb, age, status, alive = corner_lanes(n, vd, hd, fanout)
    if hd == np.int32:
        hb = rng.integers(0, 50_000, (n, n)).astype(np.int32)
    # floor sentinels under a negative shift_b are the one corner where
    # the two epilogue forms differ (test_sentinel_under_negative_shift_b)
    lo = np.iinfo(hd).min
    hb[:, rejoin] = np.where(hb[:, rejoin] == lo, lo + 1, hb[:, rejoin])
    view = np.where(view >= 0, rng.integers(0, cfg.rebase_window + 1, (n, n)),
                    -1).astype(vd)
    bases = rng.integers(0, n, n).astype(np.int32)
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in
                        ("n", "topology", "fanout", "view_dtype",
                         "hb_dtype")})
    best = mp.arc_window_max_xla(jnp.asarray(view), jnp.asarray(bases),
                                 fanout)
    state = JaxState(hb=jnp.asarray(hb), age=jnp.asarray(age),
                     status=jnp.asarray(status), alive=jnp.asarray(alive),
                     round=jnp.int32(0), hb_base=jnp.zeros(n, jnp.int32))
    w_hb, w_age, w_st = (np.asarray(a) for a in _membership_update(
        state, best, jnp.asarray(sa), jnp.asarray(sb), jcfg))
    fresh = alive[:, None] & (status == 2) & (age == 0)
    rows = np.arange(n)[:, None]
    want = [w_hb, w_age, w_st,
            (alive[:, None] & (w_st == 1)).sum(0).astype(np.int32),
            fresh.sum(0).astype(np.int32),
            np.where(fresh, rows, n).min(0).astype(np.int32)]
    got = torch_merge(mu.arc_merge_update_plain, view, bases, hb, age,
                      status, sa, sb, alive, fanout=fanout,
                      detect_stats=True)
    for name, g, w in zip(OUT_NAMES, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got[0] != hb).any()
    assert (sb < 0).any() == (hd != np.int32)   # rejoins move narrow bases


@pytest.mark.parametrize("hd", [np.int8, np.int16])
def test_sentinel_under_negative_shift_b(hd):
    """The corner where the JAX package's two epilogue forms part: a floor
    sentinel kept (not updated) while its subject's store base drops
    (``shift_b < 0``).  The narrow XLA form keeps the sentinel; the
    int32 + clip form of the JAX kernels, which K2 and K4 port, renormalises
    it like any value.  A run never reaches it: the base drops only at a
    join, and the join moves it to 0 itself, so ``shift_b`` >= 0 at every
    merge; only a hand-made or carried state whose base runs ahead of its
    subject's counter has ``shift_b < 0``."""
    n = 128
    lo = np.iinfo(hd).min
    hb = np.full((n, n), lo, hd)
    age = np.full((n, n), 3, np.int8)
    status = np.ones((n, n), np.int8)
    alive = np.ones(n, bool)
    view = np.full((n, n), -1, np.int8)
    sa = sb = np.full(n, -40, np.int32)
    jcfg = JaxConfig(n=n, topology="random", fanout=3, view_dtype="int8",
                     hb_dtype={np.int8: "int8", np.int16: "int16"}[hd])
    state = JaxState(hb=jnp.asarray(hb), age=jnp.asarray(age),
                     status=jnp.asarray(status), alive=jnp.asarray(alive),
                     round=jnp.int32(0), hb_base=jnp.zeros(n, jnp.int32))
    narrow = np.asarray(_membership_update(
        state, jnp.asarray(view), jnp.asarray(sa), jnp.asarray(sb), jcfg)[0])
    edges = np.zeros((n, 1), np.int32)
    got = torch_merge(mu.fused_merge_update_plain, view, edges, hb, age,
                      status, sa, sb, alive)[0]
    assert (narrow == lo).all()
    assert (got == lo + 40).all()


@pytest.mark.parametrize("n,fanout", [(64, 16), (64, 13), (64, 40),
                                      (100, 1), (37, 36)])
def test_window_max_matches_xla(n, fanout):
    """(c) The window max alone, against the XLA arc oracle."""
    rng = np.random.default_rng(n + fanout)
    view = rng.integers(-1, 127, (n, n)).astype(np.int8)
    bases = rng.integers(0, n, n).astype(np.int32)
    want = np.asarray(mp.arc_window_max_xla(jnp.asarray(view),
                                            jnp.asarray(bases), fanout))
    got = mu.arc_window_max_plain(torch.from_numpy(view),
                                  torch.from_numpy(bases), fanout)
    np.testing.assert_array_equal(got.numpy(), want)
    full = mu.window_max_plain(torch.from_numpy(view), fanout).numpy()
    ext = np.concatenate([view, view], axis=0)
    direct = np.stack([ext[r:r + fanout].max(0) for r in range(n)])
    np.testing.assert_array_equal(full, direct)


def test_wrappers_run_plain_on_cpu_and_check_inputs():
    """(d) On CPU tensors the wrappers ARE the plain versions (no kernel,
    no count); wrong dtypes, shapes and layouts raise."""
    n = 64
    view, hb, age, status, alive = corner_lanes(n, np.int8, np.int16, 3)
    rng = np.random.default_rng(3)
    edges = rng.integers(0, n, (n, 4)).astype(np.int32)
    bases = rng.integers(0, n, n).astype(np.int32)
    sa = rng.integers(-50, 50, n).astype(np.int32)
    merge.reset_launch_counts()
    for fn, plain, senders, kw in (
            (mu.fused_merge_update, mu.fused_merge_update_plain, edges, {}),
            (mu.arc_merge_update, mu.arc_merge_update_plain, bases,
             dict(fanout=5))):
        got = torch_merge(fn, view, senders, hb, age, status, sa, sa, alive,
                          detect_stats=True, **kw)
        want = torch_merge(plain, view, senders, hb, age, status, sa, sa,
                           alive, detect_stats=True, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert merge.LAUNCH_COUNTS["fused_merge_update"] == 0
    assert merge.LAUNCH_COUNTS["arc_merge_update"] == 0
    t = torch.from_numpy
    args = [t(view), t(edges), t(hb), pack_age_status(t(age), t(status)),
            t(sa), t(sa), t(alive)]
    bad = [(1, t(edges).long(), "edges"), (2, t(hb).t(), "contiguous"),
           (0, t(view).to(torch.int32), "view"),
           (6, t(alive).to(torch.int32), "alive")]
    for pos, val, match in bad:
        a = list(args)
        a[pos] = val
        with pytest.raises(ValueError, match=match):
            mu.fused_merge_update(*a)
    with pytest.raises(ValueError, match="fanout"):
        mu.arc_merge_update(args[0], t(bases), *args[2:], fanout=n)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """K2 and K4 against their plain versions on the card, every dtype
    pair, stats on and off, a ragged N (element loads) beside an aligned
    one (skips without a card; chip_smoke.py runs the same checks at the
    main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    rng = np.random.default_rng(0)
    for n in (1024, 1030):
        for vd, hd in PAIRS:
            view, hb, age, status, alive = corner_lanes(n, vd, hd, n)
            edges = rng.integers(0, n, (n, 7)).astype(np.int32)
            bases = rng.integers(0, n, n).astype(np.int32)
            sa = rng.integers(-200, 200, n).astype(np.int32)
            sb = rng.integers(-200, 200, n).astype(np.int32)
            c = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
            for det in (False, True):
                for fn, plain, senders, kw in (
                        (mu.fused_merge_update, mu.fused_merge_update_plain,
                         edges, {}),
                        (mu.arc_merge_update, mu.arc_merge_update_plain,
                         bases, dict(fanout=16))):
                    asl = pack_age_status(c(age), c(status))
                    a = [c(view), c(senders), c(hb), asl, c(sa), c(sb),
                         c(alive)]
                    got = fn(a[0], a[1], a[2].clone(), a[3].clone(), *a[4:],
                             detect_stats=det, **kw)
                    want = plain(a[0], a[1], a[2].clone(), a[3].clone(),
                                 *a[4:], detect_stats=det, **kw)
                    for x, y in zip(got, want):
                        assert torch.equal(x, y)
