"""Checkpoint/resume of the port (``gossipfs_tpu_torch/utils/checkpoint.py``)
against the JAX package's ``utils/checkpoint.py``, on the CPU, exact.

The six cases of ``tests/test_checkpoint.py``, each also held against the
JAX package's ``restore_checkpoint`` of the same state (the same numpy
arrays, carried into the port through ``convert.from_jax_arrays`` and
saved by each package in its own format):

* a restored run continues the uninterrupted trajectory;
* a restore onto 2 gloo ranks resumes the sharded run
  (``parallel/mesh.run_job`` with ``restore=``);
* a legacy payload's wide int32 ages are clipped into the packed lane;
* absolute int32 counters past the int16 range re-encode against a fresh
  base, and back;
* an int16 state survives save/restore and continues identically;
* a narrow-era floor sentinel is quarantined at 2**30 on an int32 restore.

Beside them: a lean (``packed_rr``) run resumes on the resident-round
loop, and restores into int16 storage as the JAX package does; a payload
that says int32 storage under a positive base raises in both packages.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core.state import SimState as JaxState
from gossipfs_tpu.utils import checkpoint as jck
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import AGE_CLAMP, SimConfig
from gossipfs_tpu_torch.convert import from_jax_arrays, to_numpy
from gossipfs_tpu_torch.core import rounds as R
from gossipfs_tpu_torch.core.state import init_state
from gossipfs_tpu_torch.parallel import distributed, mesh
from gossipfs_tpu_torch.utils.checkpoint import (
    PAYLOAD, restore_checkpoint, save_checkpoint)

torch.set_num_threads(1)

FIELDS = ("hb", "age", "status", "alive", "hb_base", "round")
CHURN = dict(crash_rate=0.05, rejoin_rate=0.02)


def key(seed: int) -> torch.Tensor:
    return trandom.PRNGKey(seed, device="cpu")


def run(state, cfg, rounds, k, **kw):
    return R.run_rounds(state, cfg, rounds, k, **kw)[0]


def jax_restore(path, arrays: dict, kw: dict, seed: int = 0,
                restore_kw: dict | None = None):
    """Save the arrays as a JAX ``SimState`` with the JAX package, restore
    them under ``JaxConfig(**restore_kw or kw)``; numpy fields and key."""
    st = JaxState(**{k: jnp.asarray(arrays[k]) for k in FIELDS})
    jck.save_checkpoint(path.resolve(), st, jax.random.PRNGKey(seed))
    out, k = jck.restore_checkpoint(path.resolve(),
                                    JaxConfig(**(restore_kw or kw)))
    return {f: np.asarray(getattr(out, f)) for f in FIELDS}, np.asarray(k)


def port_restore(path, arrays: dict, kw: dict, seed: int = 0,
                 restore_kw: dict | None = None):
    """The same through the port: numpy fields and key."""
    st, _ = from_jax_arrays(**arrays, device="cpu")
    save_checkpoint(path, st, key(seed))
    out, k = restore_checkpoint(path, SimConfig(**(restore_kw or kw)),
                                device="cpu")
    return to_numpy(out), k.numpy()


def assert_same(got: dict, want: dict) -> None:
    for f in FIELDS:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        assert g.dtype == w.dtype, (f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f)


def assert_restores_equal(tmp_path, arrays, kw, seed=0, restore_kw=None):
    """Both packages restore the same arrays to the same fields and key;
    returns the port's."""
    got, gk = port_restore(tmp_path / "port", arrays, kw, seed, restore_kw)
    want, wk = jax_restore(tmp_path / "jax", arrays, kw, seed, restore_kw)
    assert_same(got, want)
    np.testing.assert_array_equal(gk, wk.astype(np.int64))
    return got


def assert_states_equal(a, b) -> None:
    for x, y in zip((a.hb, a.asl, a.alive, a.hb_base),
                    (b.hb, b.asl, b.alive, b.hb_base)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert a.round == b.round


def test_resume_matches_uninterrupted(tmp_path):
    kw = dict(n=64, topology="random", fanout=4, remove_broadcast=False,
              fresh_cooldown=True)
    cfg = SimConfig(**kw)
    k = key(11)
    full = run(init_state(cfg, device="cpu"), cfg, 20, k, **CHURN)
    half = run(init_state(cfg, device="cpu"), cfg, 10, k, **CHURN)
    save_checkpoint(tmp_path / "ckpt", half, k)
    restored, rkey = restore_checkpoint(tmp_path / "ckpt", cfg, device="cpu")
    assert restored.round == 10 and torch.equal(rkey, k)
    resumed = run(restored, cfg, 10, rkey, **CHURN)
    assert_states_equal(full, resumed)
    assert full.round == resumed.round == 20
    assert_restores_equal(tmp_path, to_numpy(half), kw, seed=11)


def test_restore_onto_ranks_resumes_sharded_run(tmp_path):
    """2 gloo ranks resume from one checkpoint, each its column block,
    and save their result through rank 0 (``run_job(save=)``):
    the same state as the resume in one process."""
    kw = dict(n=32, topology="random", fanout=3, remove_broadcast=False,
              fresh_cooldown=True)
    cfg = SimConfig(**kw)
    k = key(0)
    state = run(init_state(cfg, device="cpu"), cfg, 5, k, crash_rate=0.05)
    save_checkpoint(tmp_path / "ckpt", state, k)
    whole = assert_restores_equal(tmp_path, to_numpy(state), kw)
    job = dict(config=cfg, rounds=3, restore=str(tmp_path / "ckpt"),
               save=str(tmp_path / "ranks"), crash_rate=0.05)
    ranks = distributed.launch(mesh.run_job, 2, (job,), device="cpu",
                               threads=1, timeout=300)
    # each rank resumed its own column block, from the checkpoint's round
    assert [r["nloc"] for r in ranks] == [16, 16]
    head = ranks[0]
    one, _ = restore_checkpoint(tmp_path / "ckpt", cfg, device="cpu")
    np.testing.assert_array_equal(to_numpy(one)["hb"], whole["hb"])
    cont = run(one, cfg, 3, k, crash_rate=0.05)
    assert head["state"].round == 8
    assert_states_equal(head["state"], cont)
    saved, skey = restore_checkpoint(tmp_path / "ranks", cfg, device="cpu")
    assert_states_equal(saved, cont)
    assert torch.equal(skey, k)


def test_restore_block_equals_whole_restore_sliced(tmp_path):
    """``restore_checkpoint(ctx=...)`` is the whole restore's column
    block, narrow re-encoding included (each block anchors on its own
    subjects' diagonal)."""
    cfg32 = SimConfig(n=64, topology="random", fanout=6, hb_dtype="int32")
    st = init_state(cfg32, device="cpu")
    st = st._replace(hb=st.hb + torch.arange(64, dtype=torch.int32) * 600)
    save_checkpoint(tmp_path / "ck", st, key(1))
    cfg8 = dataclasses.replace(cfg32, hb_dtype="int8", view_dtype="int8")
    whole, _ = restore_checkpoint(tmp_path / "ck", cfg8, device="cpu")
    for off in (0, 16, 48):
        ctx = R.ShardCtx(offset=off, nloc=16)
        blk, _ = restore_checkpoint(tmp_path / "ck", cfg8, ctx=ctx,
                                    device="cpu")
        assert torch.equal(blk.hb, whole.hb[:, off:off + 16])
        assert torch.equal(blk.asl, whole.asl[:, off:off + 16])
        assert torch.equal(blk.hb_base, whole.hb_base[off:off + 16])
        assert torch.equal(blk.alive, whole.alive)


def test_legacy_int32_age_checkpoint_restores_clamped(tmp_path):
    """A payload from before the packed lane (wide int32 ages, no
    ``hb_base``, no ``hb_floor``): ages clip to AGE_CLAMP into ``asl``,
    the base is zero; the JAX package restores its orbax twin alike."""
    import orbax.checkpoint as ocp

    kw = dict(n=16, topology="random", fanout=3, remove_broadcast=False,
              fresh_cooldown=True)
    cfg = SimConfig(**kw)
    arrays = to_numpy(init_state(cfg, device="cpu"))
    arrays["age"] = np.full((16, 16), 200, np.int32)
    legacy = {k: torch.from_numpy(np.asarray(arrays[k]))
              for k in ("hb", "age", "status", "alive")}
    legacy["round"] = 0
    (tmp_path / "port").mkdir()
    torch.save({"state": legacy, "key": key(3)},
               tmp_path / "port" / PAYLOAD)
    got_state, _ = restore_checkpoint(tmp_path / "port", cfg, device="cpu")
    got = to_numpy(got_state)
    assert np.all(got["age"] == AGE_CLAMP)
    assert np.all(got["hb_base"] == 0)

    jleg = {k: jnp.asarray(arrays[k]) for k in ("hb", "age", "status",
                                                "alive", "round")}
    path = (tmp_path / "jax").resolve()
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, {"state": jleg, "key": jax.random.PRNGKey(3)},
                   force=True)
    want, _ = jck.restore_checkpoint(path, JaxConfig(**kw))
    assert_same(got, {f: np.asarray(getattr(want, f)) for f in FIELDS})


def test_int32_checkpoint_migrates_to_int16_without_wrapping(tmp_path):
    kw32 = dict(n=128, topology="random", fanout=6, hb_dtype="int32")
    arrays = to_numpy(init_state(SimConfig(**kw32), device="cpu"))
    # a >32k-round run: counters far past the int16 range
    arrays["hb"] = arrays["hb"] + 100_000
    kw16 = dict(kw32, hb_dtype="int16")
    got = assert_restores_equal(tmp_path / "a", arrays, kw32,
                                restore_kw=kw16)
    assert got["hb"].dtype == np.int16
    # true counters survive exactly (100_000 would wrap to -31072)
    np.testing.assert_array_equal(
        got["hb"].astype(np.int32) + got["hb_base"][None, :], arrays["hb"])
    # and the reverse migration recovers the absolute encoding
    back = assert_restores_equal(tmp_path / "b", got, kw16, restore_kw=kw32)
    assert back["hb"].dtype == np.int32
    np.testing.assert_array_equal(back["hb"], arrays["hb"])
    assert np.all(back["hb_base"] == 0)


def test_int16_hb_checkpoint_roundtrip(tmp_path):
    kw = dict(n=128, topology="random", fanout=6, hb_dtype="int16")
    cfg = SimConfig(**kw)
    k = key(7)
    state = run(init_state(cfg, device="cpu"), cfg, 6, k, crash_rate=0.05)
    arrays = to_numpy(state)
    save_checkpoint(tmp_path / "ck16", state, k)
    restored, rkey = restore_checkpoint(tmp_path / "ck16", cfg, device="cpu")
    assert restored.hb.dtype == torch.int16
    assert_restores_equal(tmp_path, arrays, kw, seed=7)
    cont_a = R.run_rounds(state, cfg, 5, k)
    cont_b = R.run_rounds(restored, cfg, 5, rkey)
    assert_states_equal(cont_a[0], cont_b[0])
    for a, b in zip(cont_a[1:], cont_b[1:]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_narrow_checkpoint_sentinels_quarantined_on_int32_restore(tmp_path):
    kw8 = dict(n=128, topology="random", fanout=6, view_dtype="int8",
               hb_dtype="int8")
    arrays = to_numpy(init_state(SimConfig(**kw8), device="cpu"))
    # a narrow-era state: a positive base with one stored floor sentinel
    # and one ordinary relative counter
    arrays["hb"][3, 5] = -128
    arrays["hb"][4, 5] = 7
    arrays["hb_base"][5] = 1000
    kw32 = dict(kw8, view_dtype="int16", hb_dtype="int32")
    got = assert_restores_equal(tmp_path, arrays, kw8, restore_kw=kw32)
    assert got["hb"].dtype == np.int32
    assert got["hb"][4, 5] == 1007
    assert got["hb"][3, 5] == 2 ** 30


def test_packed_rr_resumes_on_the_lean_loop(tmp_path):
    cfg = SimConfig.packed_rr(128)
    assert R.route(cfg)[0] == "lean"
    k = key(5)
    full = run(init_state(cfg, device="cpu"), cfg, 20, k, crash_rate=0.02)
    half = run(init_state(cfg, device="cpu"), cfg, 10, k, crash_rate=0.02)
    save_checkpoint(tmp_path / "ck", half, k)
    restored, rkey = restore_checkpoint(tmp_path / "ck", cfg, device="cpu")
    assert_states_equal(full, run(restored, cfg, 10, rkey, crash_rate=0.02))
    # into int16 storage (the separate-pass loop, whose merge kernels take
    # it), as the JAX package does
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw16 = dict(kw, hb_dtype="int16", merge_kernel="pallas")
    assert_restores_equal(tmp_path, to_numpy(half), kw, seed=5,
                          restore_kw=kw16)


def test_int32_payload_with_a_positive_base_raises(tmp_path):
    kw = dict(n=16, topology="random", fanout=3)
    arrays = to_numpy(init_state(SimConfig(**kw), device="cpu"))
    arrays["hb_base"][2] = 500
    with pytest.raises(ValueError, match="fabricate"):
        port_restore(tmp_path / "port", arrays, kw)
    with pytest.raises(ValueError, match="fabricate"):
        jax_restore(tmp_path / "jax", arrays, kw)
    with pytest.raises(ValueError, match="N=16"):
        restore_checkpoint(tmp_path / "port", SimConfig(n=32), device="cpu")
