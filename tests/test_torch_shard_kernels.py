"""The column-shard forms of the port's kernels, bit for bit.

Under subject-axis sharding (``gossipfs_tpu_torch/parallel/mesh.py``) a
rank runs each kernel on a tall-skinny ``[N, N / D]`` column block of the
lanes: rows global, columns local.  Here, on the CPU, through the plain
versions (the CUDA kernels are held against them on the card,
``chip_smoke.py`` phases 35-36):

(a) K3, the resident round's column-shard form (``col_offset``), in every
    merge form x crash-only / suspicion / + Lifeguard x lanes / SWAR: each
    of the D shards equals the square round's column slice in lanes and
    per-subject outputs, and the shards' per-receiver partials
    (``recv_cnt``, ``suspect_cnt``) sum to the square round's counts;
(b) the diagonal at a shard's edges: the first and last rows of a shard
    (and the SWAR words they cross) bump there and nowhere else;
(c) K3's plain shard against the JAX package's ``resident_round_blocked(
    ..., col_offset=, interpret=True)`` on the same shard, aligned arcs
    and explicit edges, shards 0 and D-1;
(d) K2, K4 and K5 (and the scenario-armed ``arc_group_merge_update``) over
    column blocks: each block equals the square call's column slice, and
    the wrappers run the plain versions on CPU tensors of that shape.
Every comparison is exact equality: the arithmetic is integer.
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.ops import merge_pallas as mp
from gossipfs_tpu_torch.ops import merge, merge_update as mu

# one intra-op thread: tier-1 runs several test workers side by side
torch.set_num_threads(1)

N, D = 256, 4
C = N // D
MODES = {
    "crash-only": {},
    "suspicion": dict(suspect=True, t_suspect=2),
    "lh": dict(suspect=True, t_suspect=2, lh_multiplier=2),
}


def round_inputs(n: int, seed: int, min_age: int = 0):
    """Random pre-tick lanes and per-round vectors over every corner: all
    four statuses, ages to the clamp, never-sent entries, flags with the
    mute (bit 3) and Lifeguard (bit 4) bits, shifts below -128."""
    rng = np.random.default_rng(seed)
    hb = rng.integers(-128, 128, (n, n), dtype=np.int8)
    hb[rng.random((n, n)) < 0.05] = -128
    age = rng.integers(min_age, 64, (n, n)).astype(np.int32)
    st = rng.integers(0, 4, (n, n)).astype(np.int32)
    asl = ((age << 2 | st) - 128).astype(np.int8)
    flags = rng.choice(np.array([0, 4, 5, 6, 1, 7, 21, 23, 13, 15], np.int8),
                       n)
    sa = rng.integers(-260, 60, n).astype(np.int32)
    sb = np.where(rng.random(n) < 0.5, sa,
                  rng.integers(-260, 60, n)).astype(np.int32)
    g = rng.integers(-200, 60, n).astype(np.int32)
    return rng, hb, asl, flags, sa, sb, g


def form_senders(form: str, n: int, rng):
    """The round's senders and form arguments for each merge form."""
    bases8 = (rng.integers(0, n // 8, n) * 8).astype(np.int32)
    bases4 = (rng.integers(0, n // 4, n) * 4).astype(np.int32)
    if form == "aligned_group":
        return torch.from_numpy(bases8), dict(fanout=16, arc_align=8)
    if form == "edges":
        e = rng.integers(0, n, (n, 9)).astype(np.int32)
        return torch.from_numpy(e), {}
    if form == "arc":
        return torch.from_numpy(bases4), dict(fanout=16, arc_align=4)
    mask = rng.integers(0, 1 << 4, n).astype(np.int32)
    mask[rng.random(n) < 0.1] = 0
    base = bases8 if form == "filter_group" else bases4
    align = 8 if form == "filter_group" else 4
    e2 = torch.from_numpy(np.stack([base, mask], 1).astype(np.int32))
    return e2, dict(fanout=16 if align == 4 else 32, arc_align=align,
                    edge_filter=True)


def k3(fn, hb, asl, flags, vecs, senders, **kw):
    t = torch.from_numpy
    # copies: the round updates its lanes in place
    return fn(t(np.array(hb)), t(np.array(asl)), t(flags), vecs.contiguous(),
              senders, **kw)


@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("form", merge.FORMS)
def test_k3_shard_equals_square_slice(form, mode, elementwise):
    """(a) D shards of one round == the square round, column by column;
    the per-receiver partials sum to the square counts."""
    rng, hb, asl, flags, sa, sb, g = round_inputs(N, 5)
    senders, fkw = form_senders(form, N, rng)
    t = torch.from_numpy
    vecs = merge.threshold_stack(t(sa), t(sb), t(g), 126)
    kw = dict(t_fail=3, t_cooldown=12, elementwise=elementwise, **fkw,
              **MODES[mode])
    full = k3(merge.resident_round_plain, hb, asl, flags, vecs, senders,
              **kw)
    per_subject = [2, 3, 4] + ([6, 7, 8] if mode != "crash-only" else [])
    per_receiver = [5] + ([9] if mode == "lh" else [])
    assert len(full) == 6 + (3 if mode != "crash-only" else 0) + (
        mode == "lh")
    sums = [torch.zeros(N, dtype=torch.int32) for _ in per_receiver]
    for s in range(D):
        sl = slice(s * C, (s + 1) * C)
        out = k3(merge.resident_round_plain, hb[:, sl], asl[:, sl], flags,
                 vecs[:, sl], senders, col_offset=s * C, **kw)
        assert torch.equal(out[0], full[0][:, sl]), ("hb", s)
        assert torch.equal(out[1], full[1][:, sl]), ("asl", s)
        for i in per_subject:
            assert out[i].shape == (C,)
            assert torch.equal(out[i], full[i][sl]), (i, s)
        for k, i in enumerate(per_receiver):
            assert out[i].shape == (N,)
            sums[k] += out[i]
    for k, i in enumerate(per_receiver):
        assert torch.equal(sums[k], full[i]), i
    assert int(full[3].sum()) > 0     # detections fired


@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
def test_k3_shard_edge_diagonal(elementwise):
    """(b) Shard s holds the diagonal for rows [s C, (s + 1) C) only: with
    every entry MEMBER and fresh, every row an active sender and no
    receiver alive (so the merge moves no heartbeat), the bump lands on
    each of the shard's rows [s C, (s + 1) C) at its own column, the
    first and last rows (the SWAR words at the shard's two edges)
    included, and on no other entry."""
    hb = np.zeros((N, N), np.int8)
    asl = np.full((N, N), 1 - 128, np.int8)          # MEMBER, age 0
    flags = np.full(N, 1, np.int8)                    # active, not alive
    z = torch.zeros(N, dtype=torch.int32)
    vecs = merge.threshold_stack(z, z, torch.full((N,), 100), 126)
    bases = torch.zeros(N, dtype=torch.int32)
    for s in (0, D - 1):
        sl = slice(s * C, (s + 1) * C)
        out = k3(merge.resident_round_plain, hb[:, sl], asl[:, sl], flags,
                 vecs[:, sl], bases, col_offset=s * C, fanout=8,
                 arc_align=8, t_fail=3, t_cooldown=12,
                 elementwise=elementwise)
        bumped = (out[0] == 1).nonzero().tolist()
        assert bumped == [[s * C + j, j] for j in range(C)]
        for row in (s * C, s * C + C - 1):
            assert int(out[0][row, row - s * C]) == 1


def jax_shard(form: str, n: int, shards: int, s: int, seed: int):
    """The JAX kernel's shard ``s`` and the port's plain shard on the same
    inputs (stripe-major relayout for the JAX side)."""
    c_blk = n // shards
    nc, cs = n // c_blk, c_blk // mp.LANE
    rng, hb, asl, flags, sa, sb, g = round_inputs(n, seed, min_age=1)
    st = (asl.astype(np.int32) + 128) & 3
    asl = np.where(st == 3, asl - 1, asl).astype(np.int8)  # no SUSPECT
    flags = flags & 7
    senders, fkw = form_senders(form, n, rng)
    to4 = lambda a: jnp.asarray(  # noqa: E731
        a.reshape(n, nc, cs, mp.LANE).transpose(1, 0, 2, 3))
    vec4 = lambda a: jnp.asarray(a.reshape(nc, cs, mp.LANE))  # noqa: E731
    edges = senders.numpy()
    if form == "aligned_group":
        edges = edges.reshape(n, 1)
    out = mp.resident_round_blocked(
        jnp.asarray(edges), to4(hb)[s:s + 1], to4(asl)[s:s + 1],
        jnp.asarray(np.broadcast_to(flags[:, None], (n, mp.LANE)).copy()),
        vec4(sa)[s:s + 1], vec4(sb)[s:s + 1], vec4(g)[s:s + 1], member=1,
        unknown=0, failed=2, age_clamp=63, window=126, t_fail=5,
        t_cooldown=12, block_r=128, interpret=True, resident=True,
        col_offset=s * c_blk, fanout=fkw.get("fanout"),
        arc_align=fkw.get("arc_align", 1))
    from4 = lambda a: np.asarray(a).transpose(1, 0, 2, 3).reshape(  # noqa: E731
        n, c_blk)
    want = [from4(out[0]), from4(out[1])]
    want += [np.asarray(o).reshape(c_blk) for o in out[2:5]]
    want.append(np.asarray(out[5]).astype(np.int32).reshape(n, -1).sum(1)
                // mp.LANE)
    t = torch.from_numpy
    sl = slice(s * c_blk, (s + 1) * c_blk)
    vecs = merge.threshold_stack(t(sa), t(sb), t(g), 126)
    got = k3(merge.resident_round_plain, hb[:, sl], asl[:, sl], flags,
             vecs[:, sl], senders, col_offset=s * c_blk, t_fail=5,
             t_cooldown=12, **fkw)
    return want, [o.numpy() for o in got[:6]]


@pytest.mark.parametrize("s", [0, 3], ids=["shard0", "shard3"])
@pytest.mark.parametrize("form", ["aligned_group", "edges"])
def test_k3_plain_shard_matches_jax_kernel(form, s):
    """(c) One tall-skinny shard [2048 x 512] of the round: the port's
    plain version == the Pallas kernel's column-shard form (interpret
    mode), in both lanes, the per-subject reductions and the partial
    per-receiver count."""
    want, got = jax_shard(form, 2048, 4, s, 7)
    names = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt")
    for name, w, o in zip(names, want, got):
        np.testing.assert_array_equal(o, w, err_msg=name)
    assert got[3].sum() > 0


def merge_inputs(n: int, vd, hd, fanout: int, seed: int):
    """Post-tick lanes over every corner (all statuses, ages 0..63, floor
    sentinels, dead receivers) and the round's senders."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(hd)
    hb = rng.integers(max(info.min, -300), min(info.max, 300) + 1,
                      (n, n)).astype(hd)
    hb[rng.random((n, n)) < 0.05] = info.min
    age = rng.integers(0, 64, (n, n))
    age[rng.random((n, n)) < 0.2] = 0
    st = rng.integers(0, 4, (n, n))
    st[:, n - 3] = 1        # a subject no receiver detects this round
    asl = ((age << 2 | st) - 128).astype(np.int8)
    alive = rng.random(n) < 0.8
    view = rng.integers(-1, 120, (n, n)).astype(vd)
    view[~alive] = -1
    sa = rng.integers(-40, 40, n).astype(np.int32)
    sb = rng.integers(-40, 40, n).astype(np.int32)
    edges = rng.integers(0, n, (n, fanout)).astype(np.int32)
    bases = rng.integers(0, n, n).astype(np.int32)
    return view, hb, asl, alive, sa, sb, edges, bases


MERGES = {
    # name -> (function, view dtype, hb dtype, senders, extra kwargs)
    "K2 int8/int16": (mu.fused_merge_update, np.int8, np.int16, "edges", {}),
    "K2 int16/int32": (mu.fused_merge_update, np.int16, np.int32, "edges",
                       {}),
    "K4 int8/int8": (mu.arc_merge_update, np.int8, np.int8, "bases",
                     dict(fanout=13)),
    "K4 int16/int16": (mu.arc_merge_update, np.int16, np.int16, "bases",
                       dict(fanout=16)),
    "K5 int8/int8": (mu.stripe_merge_update, np.int8, np.int8, "edges", {}),
    "K5 int8/int16": (mu.stripe_merge_update, np.int8, np.int16, "edges",
                      {}),
}


@pytest.mark.parametrize("detect,suspect",
                         list(itertools.product([False, True], repeat=2)),
                         ids=["plain", "suspect", "stats", "stats-suspect"])
@pytest.mark.parametrize("name", list(MERGES))
def test_merge_kernels_over_column_blocks(name, detect, suspect):
    """(d) K2 / K4 / K5 on D column blocks [N, N/D] (the wrapper, which on
    CPU tensors is the plain version, and the plain version itself) ==
    the square call's column slices, in both lanes and every per-subject
    output; an unset first_obs stays N, the global row count."""
    fn, vd, hd, which, extra = MERGES[name]
    plain = getattr(mu, fn.__name__ + "_plain")
    view, hb, asl, alive, sa, sb, edges, bases = merge_inputs(N, vd, hd, 7,
                                                              11)
    t = torch.from_numpy
    senders = t(edges if which == "edges" else bases)
    kw = dict(detect_stats=detect, suspect=suspect, **extra)

    def call(f, cols):
        c = lambda a: t(np.array(a[..., cols]))  # noqa: E731  (copies)
        return f(c(view), senders, c(hb), c(asl), c(sa), c(sb), t(alive),
                 **kw)

    full = call(plain, slice(None))
    merge.reset_launch_counts()
    for s in range(D):
        sl = slice(s * C, (s + 1) * C)
        for f in (fn, plain):
            out = call(f, sl)
            assert torch.equal(out[0], full[0][:, sl])
            assert torch.equal(out[1], full[1][:, sl])
            for o, w in zip(out[2:], full[2:]):
                assert o.shape == (C,)
                assert torch.equal(o, w[sl])
    assert sum(merge.LAUNCH_COUNTS.values()) == 0
    if detect:
        assert int(full[3].sum()) > 0 and int(full[4][N - 3]) == N


@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
def test_arc_group_merge_over_column_blocks(elementwise):
    """(d) The scenario-armed aligned-arc merge (torch ops on any device)
    over column blocks == the square call's column slices, lanes and SWAR
    (int8 lanes, C % 4 == 0)."""
    view, hb, asl, alive, sa, sb, _, _ = merge_inputs(N, np.int8, np.int8,
                                                      1, 13)
    rng = np.random.default_rng(3)
    e2 = torch.from_numpy(np.stack(
        [rng.integers(0, N // 8, N) * 8, rng.integers(0, 4, N)],
        1).astype(np.int32))
    t = torch.from_numpy
    kw = dict(fanout=16, align=8, detect_stats=True, suspect=True,
              elementwise=elementwise)

    def call(cols):
        c = lambda a: t(np.array(a[..., cols]))  # noqa: E731  (copies)
        return mu.arc_group_merge_update(c(view), e2, c(hb), c(asl), c(sa),
                                         c(sb), t(alive), **kw)

    full = call(slice(None))
    for s in range(D):
        sl = slice(s * C, (s + 1) * C)
        out = call(sl)
        assert torch.equal(out[0], full[0][:, sl])
        assert torch.equal(out[1], full[1][:, sl])
        for o, w in zip(out[2:], full[2:]):
            assert torch.equal(o, w[sl])


def test_column_block_shapes_are_checked():
    """The wrappers name a malformed block: per-subject vectors of the
    wrong width, more columns than rows, a shard past the last column."""
    view, hb, asl, alive, sa, sb, edges, _ = merge_inputs(N, np.int8,
                                                          np.int8, 3, 2)
    t = torch.from_numpy
    blk = lambda a: t(np.ascontiguousarray(a[:, :C]))  # noqa: E731
    with pytest.raises(ValueError, match="shift_a"):
        mu.fused_merge_update(blk(view), t(edges), blk(hb), blk(asl), t(sa),
                              t(sb[:C]), t(alive))
    with pytest.raises(ValueError, match="C <= N"):
        mu.fused_merge_update(t(view[:C]), t(edges[:C]), t(hb[:C]),
                              t(asl[:C]), t(sa), t(sb), t(alive[:C]))
    rng, hb8, asl8, flags, sa, sb, g = round_inputs(N, 1)
    vecs = merge.threshold_stack(t(sa), t(sb), t(g), 126)
    with pytest.raises(ValueError, match="col_offset"):
        merge.resident_round(blk(hb8), blk(asl8), t(flags),
                             vecs[:, :C].contiguous(),
                             torch.zeros(N, dtype=torch.int32), fanout=8,
                             arc_align=8, t_fail=3, t_cooldown=12,
                             col_offset=N - C + 4)


@pytest.mark.cuda
def test_cuda_shard_kernels_match_plain():
    """On the card: K3's column-shard form (every merge form, lanes and
    SWAR) and K2/K4/K5 over a column block == their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for form, (mode, mkw), ew in itertools.product(
            merge.FORMS, MODES.items(), merge.ELEMENTWISE):
        rng, hb, asl, flags, sa, sb, g = round_inputs(N, 5)
        senders, fkw = form_senders(form, N, rng)
        t = torch.from_numpy
        vecs = merge.threshold_stack(t(sa), t(sb), t(g), 126)
        kw = dict(t_fail=3, t_cooldown=12, elementwise=ew, **fkw, **mkw)
        s = D - 1
        sl = slice(s * C, (s + 1) * C)
        want = k3(merge.resident_round_plain, hb[:, sl], asl[:, sl], flags,
                  vecs[:, sl], senders, col_offset=s * C, **kw)
        c = lambda a: t(np.ascontiguousarray(a)).cuda()  # noqa: E731
        got = merge.resident_round(
            c(hb[:, sl]), c(asl[:, sl]), c(flags),
            vecs[:, sl].contiguous().cuda(), senders.cuda(),
            col_offset=s * C, **kw)
        for o, w in zip(got, want):
            assert torch.equal(o.cpu(), w), (form, mode, ew)
    for name, (fn, vd, hd, which, extra) in MERGES.items():
        view, hb, asl, alive, sa, sb, edges, bases = merge_inputs(
            N, vd, hd, 7, 11)
        sl = slice(C, 2 * C)
        args = [np.ascontiguousarray(a[..., sl])
                for a in (view, hb, asl, sa, sb)]
        snd = edges if which == "edges" else bases
        plain = getattr(mu, fn.__name__ + "_plain")
        t = torch.from_numpy
        want = plain(t(args[0]), t(snd), t(args[1]), t(args[2]), t(args[3]),
                     t(args[4]), t(alive), detect_stats=True, **extra)
        got = fn(*(t(a).cuda() for a in (args[0], snd, args[1], args[2],
                                         args[3], args[4], alive)),
                 detect_stats=True, **extra)
        for o, w in zip(got, want):
            assert torch.equal(o.cpu(), w), name
