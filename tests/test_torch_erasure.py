"""The port's erasure plane (``erasure/codec.py``, ``erasure/planner.py``)
against the JAX package's, bit for bit, on the CPU.

* ``gf_matmul``, ``encode`` and ``decode`` (tensor twins) equal the JAX
  package's jitted twins and the numpy twins, over every erasure pattern
  of small (k, m) shapes and a ragged payload; the tables, scalars and
  blob helpers are copies;
* ``first_k_group_distinct``, ``place_stripes``,
  ``plan_stripe_repairs_tensor``, ``commit_stripe_repairs`` and
  ``stripe_stats`` equal the JAX functions for the same keys and tables,
  through a rack kill and repair passes (ties in the deficit scores are
  the rule: the stable order is pinned by the equality);
* the host planners (``place_stripe``, ``pick_repair_targets``) equal the
  JAX package's under the same generators.
"""

from __future__ import annotations

import itertools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.erasure import codec as jcodec
from gossipfs_tpu.erasure import planner as jplan
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.erasure import codec as tcodec
from gossipfs_tpu_torch.erasure import planner as tplan

torch.set_num_threads(1)


def tkey(seed: int) -> torch.Tensor:
    return trandom.PRNGKey(seed, device="cpu")


def test_tables_and_scalars_are_copies():
    np.testing.assert_array_equal(tcodec.EXP, jcodec.EXP)
    np.testing.assert_array_equal(tcodec.LOG, jcodec.LOG)
    for a in (0, 1, 2, 7, 128, 255):
        for b in (1, 3, 29, 255):
            assert tcodec.gf_mul(a, b) == jcodec.gf_mul(a, b)
            assert tcodec.gf_div(a, b) == jcodec.gf_div(a, b)
        if a:
            assert tcodec.gf_inv(a) == jcodec.gf_inv(a)
    np.testing.assert_array_equal(tcodec.parity_matrix(5, 3),
                                  jcodec.parity_matrix(5, 3))


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 4, 257), (6, 4, 1000),
                                   (4, 6, 33)])
def test_gf_matmul_matches_jax_and_numpy(shape):
    r, c, length = shape
    rng = np.random.default_rng(r * 100 + c)
    a = rng.integers(0, 256, size=(r, c), dtype=np.uint8)
    b = rng.integers(0, 256, size=(c, length), dtype=np.uint8)
    a[0, 0] = 0                 # zero coefficients and zero bytes
    b[:, :3] = 0
    want = np.asarray(jcodec.gf_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = tcodec.gf_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tcodec.gf_matmul_np(a, b))
    # a numpy coefficient matrix is accepted as well
    np.testing.assert_array_equal(
        tcodec.gf_matmul(a, torch.from_numpy(b)).numpy(), want)


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (3, 3)])
def test_encode_decode_every_pattern_matches_jax(k, m):
    rng = np.random.default_rng(k * 10 + m)
    data = rng.integers(0, 256, size=(k, 301), dtype=np.uint8)
    frags = tcodec.encode(torch.from_numpy(data), m)
    np.testing.assert_array_equal(
        frags.numpy(), np.asarray(jcodec.encode(jnp.asarray(data), m)))
    np.testing.assert_array_equal(frags.numpy(), tcodec.encode_np(data, m))
    for slots in itertools.combinations(range(k + m), k):
        rows = frags[list(slots)]
        got = tcodec.decode(rows, slots, k, m)
        want = np.asarray(jcodec.decode(jnp.asarray(rows.numpy()), slots,
                                        k, m))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), data)


def test_blob_helpers_are_copies():
    payload = bytes(range(256)) * 13 + b"tail"
    for k, m in ((4, 2), (3, 1)):
        frags = tcodec.encode_blob(payload, k, m)
        assert frags == jcodec.encode_blob(payload, k, m)
        keep = {s: frags[s] for s in range(k + m)[m:]}
        assert tcodec.decode_blob(keep, k, m, len(payload)) == payload
        rebuilt = tcodec.repair_fragments(keep, list(range(m)), k, m,
                                          len(payload))
        assert rebuilt == jcodec.repair_fragments(keep, list(range(m)), k,
                                                  m, len(payload))
    assert tcodec.frag_key("a.txt", 3) == jcodec.frag_key("a.txt", 3)
    assert tcodec.parse_frag_key("a.txt#s3") == ("a.txt", 3)
    assert tcodec.unpack_fragment(tcodec.pack_fragment(b"xy", 9)) == \
        (9, b"xy")


def test_first_k_group_distinct_matches_jax():
    rng = np.random.default_rng(7)
    groups = rng.integers(0, 9, size=50).astype(np.int32)
    nodes = rng.integers(-1, 50, size=(30, 36)).astype(np.int32)
    for k in (1, 6, 9):
        want = np.asarray(jplan.first_k_group_distinct(
            jnp.asarray(nodes), jnp.asarray(groups), k))
        got = tplan.first_k_group_distinct(torch.from_numpy(nodes),
                                           torch.from_numpy(groups), k)
        np.testing.assert_array_equal(got.numpy(), want)


def _both(fn_j, fn_t, seed, *arrays, **kw):
    """Call the JAX and the torch function on the same host arrays."""
    jout = fn_j(jax.random.PRNGKey(seed),
                *[jnp.asarray(a) for a in arrays], **kw)
    tout = fn_t(tkey(seed), *[torch.from_numpy(np.asarray(a))
                              for a in arrays], **kw)
    return jout, tout


@pytest.mark.parametrize("seed", range(3))
def test_stripe_planner_rack_kill_matches_jax(seed):
    """place_stripes, then a rack kill, then budgeted plan + commit passes
    with stats after each: every plan field, table and stats vector equals
    the JAX package's."""
    n, cap, n_stripes, k, m = 96, 80, 70, 4, 2
    racks = (np.arange(n) // 8).astype(np.int32)
    alive = np.ones(n, dtype=bool)
    jh, th = _both(jplan.place_stripes, tplan.place_stripes, seed, alive,
                   racks, n_stripes=n_stripes)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    holders = np.full((cap, k + m), -1, dtype=np.int32)
    holders[:n_stripes] = th.numpy()
    alive[16:24] = False                     # a whole rack dies
    alive[[3, 40, 77]] = False               # and three strays
    reach = alive.copy()
    reach[90:] = False                       # some live nodes unreachable
    jt = jnp.asarray(holders)
    tt = torch.from_numpy(holders.copy())
    full0 = int(tplan.stripe_stats(tt, n_stripes, torch.from_numpy(alive),
                                   torch.from_numpy(alive))[k + m])
    for p in range(4):
        for budget in (5, 64):
            jplanx = jplan.plan_stripe_repairs_tensor(
                jax.random.PRNGKey(100 * seed + p), jt, jnp.int32(n_stripes),
                jnp.asarray(alive), jnp.asarray(reach), budget)
            tplanx = tplan.plan_stripe_repairs_tensor(
                tkey(100 * seed + p), tt, n_stripes,
                torch.from_numpy(alive), torch.from_numpy(reach), budget)
            for name in tplanx._fields:
                np.testing.assert_array_equal(
                    getattr(tplanx, name).numpy(),
                    np.asarray(getattr(jplanx, name)), err_msg=name)
        jt = jplan.commit_stripe_repairs(jt, jplanx.idx, jplanx.valid,
                                         jplanx.picks)
        tt = tplan.commit_stripe_repairs(tt, tplanx.idx, tplanx.valid,
                                         tplanx.picks)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        for slack in (0, 1):
            want = jplan.stripe_stats(jt, jnp.int32(n_stripes),
                                      jnp.asarray(alive),
                                      jnp.asarray(reach), slack=slack)
            got = tplan.stripe_stats(tt, n_stripes, torch.from_numpy(alive),
                                     torch.from_numpy(reach), slack=slack)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert got.dtype == torch.int32
    # the passes repaired: more stripes back at full strength (k + m)
    full = int(tplan.stripe_stats(tt, n_stripes, torch.from_numpy(alive),
                                  torch.from_numpy(alive))[k + m])
    assert full0 < n_stripes - 8 and full > full0 + 8


def test_stripe_stats_counts_lost_and_unplaced_rows():
    holders = np.array([[0, 1, 2, 3, 4, 5], [-1] * 6, [6, 7, -1, -1, -1, -1],
                        [0, 1, 2, 3, 4, 5]], dtype=np.int32)
    alive = np.ones(8, dtype=bool)
    alive[[0, 1, 2]] = False
    for used in (0, 2, 3, 4):
        want = jplan.stripe_stats(jnp.asarray(holders), jnp.int32(used),
                                  jnp.asarray(alive), jnp.asarray(alive))
        got = tplan.stripe_stats(torch.from_numpy(holders), used,
                                 torch.from_numpy(alive),
                                 torch.from_numpy(alive))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_host_stripe_planners_are_copies():
    members = list(range(40))
    racks = {x: x // 4 for x in members}
    for seed in range(5):
        assert tplan.place_stripe(members, racks, random.Random(seed)) == \
            jplan.place_stripe(members, racks, random.Random(seed))
        load = {0: 2, 3: 1}
        assert tplan.pick_repair_targets(
            members[8:], racks, load, 3, random.Random(seed)) == \
            jplan.pick_repair_targets(members[8:], racks, load, 3,
                                      random.Random(seed))
