"""The resident round's ``edge_filter`` form (the scenario engine on
aligned arcs), bit for bit against the JAX package.

(a) ``ops.merge.arc_group_window_max`` against the JAX package's
    ``arc_group_window_max_xla`` (the oracle of the masked gather);
(b) one round of ``resident_round_plain(edge_filter=True)`` against the
    Pallas kernel ``resident_round_blocked(edge_filter=True)`` in
    interpret mode: crash-only, suspicion, suspicion + Lifeguard, arc
    alignments 8 and 4, random match masks (zero masks among them) and
    muted rows (flags bit 3), every output;
(c) the wrapper's checks of the form's inputs, as the JAX wrapper's;
(d) the separate-pass round's torch form ``arc_group_merge_update``
    against K4's plain version on an all-ones mask and against a gather
    over explicit edges with the dropped groups rewritten to the receiver.
Every comparison is exact equality.  The CUDA kernel's form is held
against the plain version on the card (chip_smoke.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.ops import merge_pallas as mp
from gossipfs_tpu_torch.core.state import SUSPECT
from gossipfs_tpu_torch.ops import merge
from gossipfs_tpu_torch.ops import merge_update as mu

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)


def match_edges(rng, n: int, fanout: int, align: int) -> np.ndarray:
    """int32 [n, 2] (aligned arc base, group-match bitmask): a third of
    the masks full, a tenth zero, the rest random."""
    nw = fanout // align
    bases = rng.integers(0, n // align, n) * align
    mask = rng.integers(0, 1 << nw, n)
    u = rng.random(n)
    mask = np.where(u < 0.33, (1 << nw) - 1, np.where(u < 0.43, 0, mask))
    return np.stack([bases, mask], axis=1).astype(np.int32)


@pytest.mark.parametrize("n,fanout,align,dtype", [
    (256, 16, 8, np.int8), (256, 16, 4, np.int8), (128, 24, 8, np.int16),
    (256, 124, 4, np.int8)])
def test_arc_group_window_max_equals_jax(n, fanout, align, dtype):
    rng = np.random.default_rng(n + fanout + align)
    view = rng.integers(-1, 127, (n, n)).astype(dtype)
    e2 = match_edges(rng, n, fanout, align)
    want = np.asarray(mp.arc_group_window_max_xla(
        jnp.asarray(view), jnp.asarray(e2), fanout, align))
    got = merge.arc_group_window_max(torch.from_numpy(view),
                                     torch.from_numpy(e2), fanout, align)
    assert got.dtype == torch.from_numpy(view).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # a zero mask gives the absent encoding everywhere
    assert (got.numpy()[e2[:, 1] == 0] == -1).all() and (e2[:, 1] == 0).any()


def round_inputs(n: int, seed: int, suspicion: bool, t_fail: int):
    """Pre-tick lanes as tests/test_torch_suspect_kernels.k3_inputs makes
    them (MEMBER ages up to t_fail + 1 and SUSPECT ages above it, where the
    JAX kernel's and the port's counts of new suspects agree), flags with
    bit 3 (muted) on a fifth of the rows and bit 4 on half."""
    rng = np.random.default_rng(seed)
    hb = rng.integers(-128, 128, (n, n), dtype=np.int8)
    hb[rng.random((n, n)) < 0.05] = -128
    st = rng.integers(0, 4 if suspicion else 3, (n, n)).astype(np.int32)
    age = np.where(st == 1, rng.integers(1, t_fail + 2, (n, n)),
                   np.where(st == 3, rng.integers(t_fail + 2, 16, (n, n)),
                            rng.integers(1, 64, (n, n)))).astype(np.int32)
    asl = ((age << 2 | st) - 128).astype(np.int8)
    flags = rng.choice(np.array([0, 1, 2, 4, 5, 5, 5, 6], np.int8), n)
    flags = flags + 8 * (rng.random(n) < 0.2)
    if suspicion:
        flags = flags + 16 * (rng.random(n) < 0.5)
    sa = rng.integers(-260, 60, n).astype(np.int32)
    g = rng.integers(-200, 60, n).astype(np.int32)
    return hb, asl, flags.astype(np.int8), sa, g


MODES = {"crash-only": dict(t_fail=5),
         "suspicion": dict(t_fail=3, suspect=True, t_suspect=2),
         "suspicion+lh": dict(t_fail=3, suspect=True, t_suspect=2,
                              lh_multiplier=3)}
NAMES = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt",
         "entered", "refuted", "held", "suspect_cnt")


@pytest.mark.parametrize("align", [8, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_edge_filter_round_matches_jax_kernel_interpret(mode, align):
    n, c_blk, fanout = 1024, 512, 16
    nc, cs = n // c_blk, c_blk // mp.LANE
    mkw = MODES[mode]
    sus = mkw.get("suspect", False)
    hb, asl, flags, sa, g = round_inputs(n, 31 + align, sus, mkw["t_fail"])
    e2 = match_edges(np.random.default_rng(align), n, fanout, align)
    to4 = lambda a: jnp.asarray(  # noqa: E731
        a.reshape(n, nc, cs, mp.LANE).transpose(1, 0, 2, 3))
    vec4 = lambda a: jnp.asarray(a.reshape(nc, cs, mp.LANE))  # noqa: E731
    jkw = dict(mkw)
    if jkw.pop("suspect", False):
        jkw["suspect"] = SUSPECT
    out = mp.resident_round_blocked(
        jnp.asarray(e2), to4(hb), to4(asl),
        jnp.asarray(np.broadcast_to(flags[:, None], (n, mp.LANE)).copy()),
        vec4(sa), vec4(sa), vec4(g), member=1, unknown=0, failed=2,
        age_clamp=63, window=126, block_r=128, interpret=True,
        resident=True, rcnt_acc=True, fanout=fanout, arc_align=align,
        t_cooldown=12, edge_filter=True, **jkw)
    from4 = lambda a: np.asarray(a).transpose(1, 0, 2, 3).reshape(n, n)  # noqa: E731
    want = [from4(out[0]), from4(out[1])]
    want += [np.asarray(o).astype(np.int32).reshape(n) for o in out[2:]]
    t = torch.from_numpy
    vecs = merge.threshold_stack(t(sa), t(sa), t(g), 126)
    kw = dict(fanout=fanout, arc_align=align, t_cooldown=12,
              edge_filter=True, **mkw)
    got = merge.resident_round_plain(t(hb.copy()), t(asl.copy()), t(flags),
                                     vecs, t(e2), **kw)
    # the JAX kernel returns its three suspicion counters in every mode
    # (zeros with suspicion off); the port only under ``suspect``
    assert len(got) == (6 + 3 * sus + int("lh_multiplier" in mkw))
    for name, w, o in zip(NAMES, want, got):
        np.testing.assert_array_equal(o.numpy(), w, err_msg=name)
    assert got[3].sum() > 0
    if sus:
        assert all(got[i].sum() > 0 for i in (6, 7, 8))
    # the mute acts: without bit 3 the muted rows' views reach receivers
    unmuted = merge.resident_round_plain(
        t(hb.copy()), t(asl.copy()), t(flags & ~8), vecs, t(e2), **kw)
    assert not torch.equal(unmuted[0], got[0])
    # and outside the form bit 3 is not read at all
    plain_kw = dict(kw, edge_filter=False)
    a = merge.resident_round_plain(t(hb.copy()), t(asl.copy()), t(flags),
                                   vecs, t(e2[:, 0].copy()), **plain_kw)
    b = merge.resident_round_plain(t(hb.copy()), t(asl.copy()),
                                   t(flags & ~8), vecs, t(e2[:, 0].copy()),
                                   **plain_kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_full_mask_without_mutes_is_the_unfiltered_round():
    n, fanout, align = 256, 16, 8
    hb, asl, flags, sa, g = round_inputs(n, 5, False, 5)
    flags = flags & ~8
    rng = np.random.default_rng(1)
    bases = (rng.integers(0, n // align, n) * align).astype(np.int32)
    e2 = np.stack([bases, np.full(n, 3)], axis=1).astype(np.int32)
    t = torch.from_numpy
    vecs = merge.threshold_stack(t(sa), t(sa), t(g), 126)
    kw = dict(fanout=fanout, arc_align=align, t_fail=5, t_cooldown=12)
    a = merge.resident_round(t(hb.copy()), t(asl.copy()), t(flags), vecs,
                             t(e2), edge_filter=True, **kw)
    b = merge.resident_round(t(hb.copy()), t(asl.copy()), t(flags), vecs,
                             t(bases), **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_edge_filter_arguments_checked():
    n = 64
    z = torch.zeros
    lanes = (z((n, n), dtype=torch.int8), z((n, n), dtype=torch.int8),
             z(n, dtype=torch.int8), z((merge.N_VEC, n), dtype=torch.int8))
    wide_lanes = (z((256, 256), dtype=torch.int8),
                  z((256, 256), dtype=torch.int8), z(256, dtype=torch.int8),
                  z((merge.N_VEC, 256), dtype=torch.int8))
    e2 = z((n, 2), dtype=torch.int32)
    kw = dict(t_fail=5, t_cooldown=12, edge_filter=True)
    merge.resident_round(*lanes, e2, fanout=16, arc_align=8, **kw)
    with pytest.raises(ValueError, match="aligned-arc topology"):
        merge.resident_round(*lanes, e2, fanout=16, arc_align=1, **kw)
    with pytest.raises(ValueError, match="aligned-arc topology"):
        merge.resident_round(*lanes, e2, **kw)
    with pytest.raises(ValueError, match="must be <= 31"):
        merge.resident_round(*wide_lanes, z((256, 2), dtype=torch.int32),
                             fanout=128, arc_align=4, **kw)
    with pytest.raises(ValueError, match=r"\(64, 2\)"):
        merge.resident_round(*lanes, z(n, dtype=torch.int32), fanout=16,
                             arc_align=8, **kw)
    assert merge.kernel_form(16, 8, True) == "filter_group"
    assert merge.kernel_form(16, 4, True) == "filter_rows"
    assert merge.kernel_form(16, 16, True) == "filter_rows"
    assert merge.kernel_form(16, 8) == "aligned_group"
    assert merge.FORMS.index("filter_group") == 3


@pytest.mark.parametrize("suspect", [False, True])
def test_arc_group_merge_update_against_k4_and_explicit_edges(suspect):
    """(d) With every group kept the masked form is K4's function; with
    random masks it equals K2's plain version over the arc's explicit
    edges where a dropped group's edges point at an all-absent row."""
    n, fanout, align = 256, 16, 8
    rng = np.random.default_rng(3)
    view = rng.integers(-1, 127, (n, n)).astype(np.int8)
    hb = rng.integers(-128, 128, (n, n)).astype(np.int8)
    st = rng.integers(0, 4 if suspect else 3, (n, n))
    age = rng.integers(0, 64, (n, n))
    asl = merge.pack_age_status(torch.from_numpy(age), torch.from_numpy(st))
    sa = torch.from_numpy(rng.integers(-200, 60, n).astype(np.int32))
    alive = torch.from_numpy(rng.random(n) < 0.8)
    e2 = match_edges(rng, n, fanout, align)
    t = torch.from_numpy
    kw = dict(detect_stats=True, suspect=suspect)

    def run(fn, view_, senders, **extra):
        return fn(view_, senders, t(hb.copy()), asl.clone(), sa, sa, alive,
                  **kw, **extra)

    full = e2.copy()
    full[:, 1] = 3
    a = run(mu.arc_group_merge_update, t(view), t(full), fanout=fanout,
            align=align)
    b = run(mu.arc_merge_update_plain, t(view), t(full[:, 0].copy()),
            fanout=fanout)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # explicit edges over a view with one extra all-absent row n
    edges = (e2[:, :1] + np.arange(fanout)[None, :]) % n
    keep = (e2[:, 1:2] >> (np.arange(fanout)[None, :] // align)) & 1
    edges = np.where(keep != 0, edges, n).astype(np.int32)
    view_x = np.concatenate([view, np.full((1, n), -1, np.int8)])
    best = mu.fanout_max_merge_plain(t(view_x), t(edges))
    want = merge.arc_group_window_max(t(view), t(e2), fanout, align)
    np.testing.assert_array_equal(want.numpy(), best.numpy())
    c = run(mu.arc_group_merge_update, t(view), t(e2), fanout=fanout,
            align=align)
    d = mu._merge_rows_plain(lambda r0, r1: best[r0:r1], t(hb.copy()),
                             asl.clone(), sa, sa, alive, True, suspect, 63)
    assert all(torch.equal(x, y) for x, y in zip(c, d))


@pytest.mark.cuda
@pytest.mark.parametrize("align", [8, 4])
def test_cuda_edge_filter_forms_match_plain(align):
    """The CUDA kernel's ``edge_filter`` forms against the plain version on
    the card (skips without one; chip_smoke.py runs the same check at
    N = 16,384)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    n, fanout = 1024, 16
    hb, asl, flags, sa, g = (torch.from_numpy(a).cuda()
                             for a in round_inputs(n, 7, True, 3))
    e2 = torch.from_numpy(
        match_edges(np.random.default_rng(2), n, fanout, align)).cuda()
    vecs = merge.threshold_stack(sa, sa, g, 126)
    kw = dict(fanout=fanout, arc_align=align, t_cooldown=12,
              edge_filter=True, **MODES["suspicion+lh"])
    got = merge.resident_round(hb.clone(), asl.clone(), flags, vecs, e2, **kw)
    want = merge.resident_round_plain(hb.clone(), asl.clone(), flags, vecs,
                                      e2, **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
