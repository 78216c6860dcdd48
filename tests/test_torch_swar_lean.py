"""The lean loop's SWAR form, bit for bit against the JAX rr scan.

``elementwise="swar"`` on the lean loop: each round is the resident
round's SWAR plain version (ops/merge.resident_round_plain with
``elementwise="swar"``: the tick, the view encode, the group max and the
merge epilogue on 4 packed subjects per int32 word, the words the
diagonal crosses in the lanes form).  Its counterpart is the JAX
package's rr scan running its Pallas resident round in interpret mode
(``merge_kernel="pallas_rr_interpret", elementwise="swar"``):

* the aligned-group form (the headline), crash-only and suspicion +
  Lifeguard;
* the explicit-edge form (``suspicion_rr``), crash-only and suspicion +
  Lifeguard;
* the ``filter_group`` form (aligned arcs under a scenario), suspicion +
  Lifeguard;

lanes, carry and every per-round metric exact.  Then the SWAR plain round
against the lanes plain round on random pre-tick lanes, every merge form,
exact.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gossipfs_tpu import scenarios as jscn
from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core import rounds as JR
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu.scenarios import tensor as jtensor
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch import scenarios as tscn
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.convert import to_numpy
from gossipfs_tpu_torch.core import rounds as R
from gossipfs_tpu_torch.core.state import init_state
from gossipfs_tpu_torch.ops import merge
from gossipfs_tpu_torch.scenarios import tensor as ttensor
from gossipfs_tpu_torch.suspicion import SuspicionParams

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

N, BLOCK_C, ROUNDS = 512, 512, 12
KERNEL = "pallas_rr_interpret"
GOSSIP = dict(remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
              view_dtype="int8", hb_dtype="int8", elementwise="swar")
ARC = dict(topology="random_arc", fanout=16, arc_align=8, **GOSSIP)
RR = dict(topology="random", fanout=9, fused_tick="auto", **GOSSIP)
# suspicion with the Lifeguard lane at a threshold 2 % crash churn at
# N = 512 crosses on some rows and rounds
LH = dict(t_suspect=2, lh_multiplier=3, lh_frac=0.03125)


def configs(shape: dict, sus: dict | None, **kw):
    """(JAX config on its interpret-mode rr kernel, port config)."""
    jkw, tkw = dict(shape, **kw), dict(shape, **kw)
    if sus is not None:
        jkw.update(t_fail=3, suspicion=JaxSus(**sus))
        tkw.update(t_fail=3, suspicion=SuspicionParams(**sus))
    jcfg = JaxConfig(n=N, merge_kernel=KERNEL, merge_block_c=BLOCK_C,
                     rr_resident="on", **jkw)
    tcfg = SimConfig(n=N, merge_kernel="pallas_rr", **tkw)
    return jcfg, tcfg


def compare(jout, tout):
    (js, jc, jm), (ts, tc, tm) = jout, tout
    got = to_numpy(ts, tc)
    for k in ("hb", "age", "status", "alive", "hb_base", *jc._fields):
        want = getattr(js, k) if hasattr(js, k) else getattr(jc, k)
        np.testing.assert_array_equal(got[k], np.asarray(want), err_msg=k)
    for k in jm._fields:
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)


def run_pair(jcfg, tcfg, form: str, scenario=None):
    jsc = tsc = None
    if scenario is not None:
        jsc = jtensor.compile_tensor(scenario(jscn))
        tsc = ttensor.compile_tensor(scenario(tscn), device="cpu")
    assert R.route(tcfg, scenario=tsc) == ("lean", form)
    jout = JR.run_rounds(jax_init_state(jcfg), jcfg, ROUNDS,
                         jax.random.PRNGKey(5), crash_rate=0.02,
                         scenario=jsc)
    merge.reset_launch_counts()
    tout = R.run_rounds(init_state(tcfg, device="cpu"), tcfg, ROUNDS,
                        trandom.PRNGKey(5, device="cpu"), crash_rate=0.02,
                        scenario=tsc)
    assert not any(merge.LAUNCH_COUNTS.values())     # plain on the CPU
    compare(jout, tout)
    return jout[2]


@pytest.mark.parametrize("sus", [None, LH], ids=["crash-only", "sus+lh"])
@pytest.mark.parametrize("shape,form", [(ARC, "aligned_group/swar/onepass"),
                                        (RR, "edges/swar/onepass")],
                         ids=["aligned_group", "edges"])
def test_swar_lean_loop_matches_jax_rr_scan_interpret(shape, form, sus):
    jcfg, tcfg = configs(shape, sus)
    jm = run_pair(jcfg, tcfg, form)
    assert int(np.asarray(jm.true_detections).sum()) > 0
    if sus is not None:
        assert int(np.asarray(jm.suspects_entered).sum()) > 0


def split_and_flaps(mod):
    return mod.FaultScenario(
        name="split+flap", n=N,
        partitions=(mod.Partition(start=2, end=9,
                                  groups=(tuple(range(N // 2)),)),),
        flapping=(mod.Flapping(start=1, end=11, up=2, down=2,
                               nodes=tuple(range(N // 2, N // 2 + 12))),))


def test_swar_filter_group_matches_jax_rr_scan_interpret():
    """Aligned arcs under a split and flapping senders: the SWAR form of
    the ``edge_filter`` gather (masked group max, the mute on flags bit
    3) on both sides."""
    jcfg, tcfg = configs(ARC, LH)
    jm = run_pair(jcfg, tcfg, "filter_group/swar/onepass", split_and_flaps)
    assert int(np.asarray(jm.refutations).sum()) > 0


def random_round(n: int, seed: int, sus: bool):
    """Pre-tick lanes with every status (SUSPECT under ``sus``), ages to
    the clamp, never-sent entries, all flag bits, deep shifts."""
    rng = np.random.default_rng(seed)
    hb = rng.integers(-128, 128, (n, n), dtype=np.int8)
    hb[rng.random((n, n)) < 0.05] = -128
    st = rng.integers(0, 4 if sus else 3, (n, n))
    age = np.where(st == 3, rng.integers(3, 14, (n, n)),
                   rng.integers(0, 64, (n, n)))
    asl = ((age << 2 | st) - 128).astype(np.int8)
    flags = rng.integers(0, 32, n).astype(np.int8)
    sa = rng.integers(-260, 60, n).astype(np.int32)
    sb = np.where(rng.random(n) < 0.5, sa, rng.integers(-260, 60, n))
    g = rng.integers(-200, 60, n).astype(np.int32)
    t = torch.from_numpy
    vecs = merge.threshold_stack(t(sa), t(sb.astype(np.int32)), t(g), 126)
    return t(hb), t(asl), t(flags), vecs, rng


def form_senders(form: str, n: int, rng):
    """(senders, kwargs) of each merge form."""
    if form == "edges":
        return torch.from_numpy(rng.integers(0, n, (n, 7)).astype(np.int32)), {}
    if form == "arc":
        return (torch.from_numpy(rng.integers(0, n, n).astype(np.int32)),
                dict(fanout=16, arc_align=1))
    if form == "aligned_group":
        return (torch.from_numpy((rng.integers(0, n // 8, n) * 8)
                                 .astype(np.int32)),
                dict(fanout=16, arc_align=8))
    align = 8 if form == "filter_group" else 4
    nw = 16 // align
    mask = rng.integers(0, 1 << nw, n)
    mask[:8] = 0
    bases = rng.integers(0, n // align, n) * align
    return (torch.from_numpy(np.stack([bases, mask], 1).astype(np.int32)),
            dict(fanout=16, arc_align=align, edge_filter=True))


MODES = {"crash-only": dict(t_fail=5),
         "suspicion": dict(t_fail=3, suspect=True, t_suspect=2),
         "suspicion+lh": dict(t_fail=3, suspect=True, t_suspect=2,
                              lh_multiplier=3)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("form", merge.FORMS)
def test_swar_plain_equals_lanes_plain(form, mode):
    """One round of every merge form and mode: the SWAR plain version and
    the lanes plain version give the same bytes and counts."""
    n = 256
    hb, asl, flags, vecs, rng = random_round(n, 11, mode != "crash-only")
    senders, fkw = form_senders(form, n, rng)
    kw = dict(fkw, t_cooldown=12, **MODES[mode])
    lanes = merge.resident_round_plain(hb.clone(), asl.clone(), flags, vecs,
                                       senders, **kw)
    swar = merge.resident_round_plain(hb.clone(), asl.clone(), flags, vecs,
                                      senders, elementwise="swar", **kw)
    assert len(lanes) == len(swar)
    for i, (a, b) in enumerate(zip(lanes, swar)):
        assert torch.equal(a, b), i
    assert int(lanes[3].sum()) > 0
    # the diagonal words were bumped (the lanes part of the SWAR form)
    d = torch.arange(n)
    assert (swar[0][d, d] != hb[d, d]).any()


def test_swar_wrapper_on_cpu_runs_the_plain_version():
    """On CPU tensors ``resident_round(elementwise="swar")`` is the SWAR
    plain version (no launch); an unknown form and a ragged N raise."""
    n = 64
    hb, asl, flags, vecs, rng = random_round(n, 3, False)
    senders, fkw = form_senders("aligned_group", n, rng)
    kw = dict(fkw, t_fail=5, t_cooldown=12, elementwise="swar")
    merge.reset_launch_counts()
    got = merge.resident_round(hb.clone(), asl.clone(), flags, vecs, senders,
                               **kw)
    want = merge.resident_round_plain(hb.clone(), asl.clone(), flags, vecs,
                                      senders, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert merge.LAUNCH_COUNTS["resident_round"] == 0
    with pytest.raises(ValueError, match="elementwise"):
        merge.resident_round(hb, asl, flags, vecs, senders,
                             **dict(kw, elementwise="words"))
    m = 62
    hb, asl, flags, vecs, rng = random_round(m, 3, False)
    edges = torch.from_numpy(rng.integers(0, m, (m, 5)).astype(np.int32))
    with pytest.raises(ValueError, match="N % 4"):
        merge.resident_round_plain(hb, asl, flags, vecs, edges, t_fail=5,
                                   t_cooldown=12, elementwise="swar")


def test_swar_lean_loop_equals_lanes_lean_loop():
    """The whole lean loop, SWAR against lanes, over a horizon past the
    int8 rebase window (N = 256, 300 rounds, 0.4 % churn)."""
    base = SimConfig.headline(256)
    outs = {}
    for ew in ("lanes", "swar"):
        cfg = dataclasses.replace(base, elementwise=ew)
        outs[ew] = R.run_rounds(init_state(cfg, device="cpu"), cfg, 300,
                                trandom.PRNGKey(2, device="cpu"),
                                crash_rate=0.004)
    (sl, cl, ml), (ss, cs, ms) = outs["lanes"], outs["swar"]
    for a, b in ((sl.hb, ss.hb), (sl.asl, ss.asl), (sl.hb_base, ss.hb_base),
                 *zip(cl, cs), *zip(ml, ms)):
        assert torch.equal(a, b)
    assert int(ss.hb_base.max()) > 126
