"""Host build of K3 (f)'s wide blocking: 16 CTAs a cluster, 16 columns a
stripe (csrc/rr_onepass.cuh ``Cluster16x16``, the kernel of
csrc/rr_onepass_wide.cu), which runs the one-pass round past the narrow
blocking's N = 19,264.

The harness of tests/test_torch_onepass_host.py replays the stripe walk
with the cluster's CTAs as host arrays: the full-view forms park asl alone
and read hb again in step 2 (the diagonal's ticked segments parked on the
side), the aligned forms split the group-max table over the CTAs (each
gathers the others' rows).  Here, at N = 1,024 and 2,048:

* every merge form, lanes and SWAR, crash-only and suspicion + Lifeguard,
  square and over a column block: bit-equal to ``resident_round_plain``
  and to the narrow blocking's replay;
* clusters walking many stripes (7 or 2 clusters over 64 stripes) and
  few threads a CTA, so
  that a step-2 thread's rows past the 8 it holds across stripes (their
  metadata and per-receiver counts, added once after the cluster's last
  stripe) are loaded and counted a stripe at a time, and the full-view
  forms gather 1 to 3 chunks of 8 view rows a receiver;
* at N = 1,024 every form and mode bit-equal to the JAX package's kernel
  run as its tests run it (``resident_round_blocked(..., interpret=True,
  resident=True)``, ``merge_block_c`` 512), on lanes where its resident
  form and the port agree (ages from 1; MEMBER ages up to t_fail + 1 and
  SUSPECT ages above it under suspicion, as tests/test_torch_edge_filter.py
  makes them);
* the shared memory a CTA: the header's ``smem_bytes`` equal to
  ``ops/merge.onepass_smem`` at the wide blocking's edges; the lockstep's
  turns zeroed before each launch.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.ops import merge_pallas as mp
from gossipfs_tpu_torch.core.state import SUSPECT
from gossipfs_tpu_torch.ops import merge
from test_torch_onepass_host import (CSRC, HARNESS, MODES, plain_outputs,
                                     round_inputs, run_host)

torch.set_num_threads(1)

NAMES = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt",
         "entered", "refuted", "held", "suspect_cnt")
WIDE_MODES = ("crash-only", "suspicion+lh")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("rr_onepass_wide")
    src, so = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.host_smem_bytes.restype = ctypes.c_long
    lib.host_smem_bytes.argtypes = [ctypes.c_long, ctypes.c_int,
                                    ctypes.c_int]
    return lib


def assert_equal(got, want):
    for name, x, y in zip(NAMES, got, want):
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("mode", WIDE_MODES)
@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
@pytest.mark.parametrize("form", merge.FORMS)
@pytest.mark.parametrize("n", [1_024, 2_048])
def test_wide_blocking_matches_plain(lib, n, form, elementwise, mode):
    """The square round: 64 or 128 stripes walked by 7 persistent clusters
    (as many as an H100 holds at once), every CTA holding n / 16 rows."""
    inputs = round_inputs(n, n, form, 100 + n, mode != "crash-only")
    got = run_host(lib, n, n, 0, form, mode, elementwise, inputs,
                   clusters=7, wide=True)
    want = plain_outputs(mode, elementwise, 0, inputs)
    assert len(got) == len(want)
    assert_equal(got, want)
    assert want[3].sum() > 0 and (want[4] < n).any()
    if mode != "crash-only":
        assert want[6].sum() > 0 and want[7].sum() > 0


@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
@pytest.mark.parametrize("form", merge.FORMS)
def test_wide_blocking_column_block_equals_narrow(lib, form, elementwise):
    """A [1,024 x 256] block from column 512, whose columns hold part of
    the diagonal: the wide and the narrow blocking's replays and the
    plain version agree."""
    n, c, off, mode = 1_024, 256, 512, "suspicion+lh"
    inputs = round_inputs(n, c, form, 7, True)
    wide = run_host(lib, n, c, off, form, mode, elementwise, inputs,
                    wide=True)
    narrow = run_host(lib, n, c, off, form, mode, elementwise, inputs)
    assert_equal(wide, narrow)
    assert_equal(wide, plain_outputs(mode, elementwise, off, inputs))


def jax_inputs(n: int, form: str, seed: int, mode: str):
    """Lanes on which the JAX kernel's resident form and the port agree,
    with the form's senders: (hb, asl, flags, vecs, senders, form kw) as
    :func:`round_inputs` gives them, and (sa, g) for the JAX call."""
    sus = mode != "crash-only"
    t_fail = MODES[mode]["t_fail"]
    rng = np.random.default_rng(seed)
    hb = rng.integers(-128, 128, (n, n), dtype=np.int8)
    hb[rng.random((n, n)) < 0.05] = -128
    st = rng.integers(0, 4 if sus else 3, (n, n)).astype(np.int32)
    age = np.where(st == 1, rng.integers(1, t_fail + 2, (n, n)),
                   np.where(st == 3, rng.integers(t_fail + 2, 16, (n, n)),
                            rng.integers(1, 64, (n, n)))).astype(np.int32)
    asl = ((age << 2 | st) - 128).astype(np.int8)
    flags = rng.choice(np.array([0, 1, 2, 4, 5, 5, 5, 6], np.int8), n)
    flags = flags + 8 * (rng.random(n) < 0.2)
    if sus:
        flags = flags + 16 * (rng.random(n) < 0.5)
    sa = rng.integers(-260, 60, n).astype(np.int32)
    g = rng.integers(-200, 60, n).astype(np.int32)
    t = torch.from_numpy
    vecs = merge.threshold_stack(t(sa), t(sa), t(g), 126).numpy()
    if form == "edges":
        senders, kw = rng.integers(0, n, (n, 9)), {}
    elif form == "arc":
        senders, kw = rng.integers(0, n, n), dict(fanout=16, arc_align=1)
    elif form == "aligned_group":
        senders = rng.integers(0, n // 8, n) * 8
        kw = dict(fanout=16, arc_align=8)
    else:
        align = 8 if form == "filter_group" else 4
        mask = rng.integers(0, 1 << (16 // align), n)
        mask[:6] = 0
        senders = np.stack([rng.integers(0, n // align, n) * align, mask], 1)
        kw = dict(fanout=16, arc_align=align, edge_filter=True)
    lanes = (hb, asl, flags.astype(np.int8), vecs,
             senders.astype(np.int32), kw)
    return lanes, sa, g


def jax_round(n: int, mode: str, elementwise: str, lanes, sa, g):
    """The JAX package's kernel, interpret mode, resident, 512-column
    blocks: its outputs in the port's order (its three suspicion counters
    come in every mode)."""
    hb, asl, flags, _, senders, fkw = lanes
    c_blk = 512
    nc, cs = n // c_blk, c_blk // mp.LANE
    to4 = lambda a: jnp.asarray(  # noqa: E731
        a.reshape(n, nc, cs, mp.LANE).transpose(1, 0, 2, 3))
    vec4 = lambda a: jnp.asarray(a.reshape(nc, cs, mp.LANE))  # noqa: E731
    jkw = dict(MODES[mode], **fkw)
    if jkw.pop("suspect", False):
        jkw["suspect"] = SUSPECT
    edges = senders if senders.ndim == 2 else senders.reshape(n, 1)
    out = mp.resident_round_blocked(
        jnp.asarray(edges), to4(hb), to4(asl),
        jnp.asarray(np.broadcast_to(flags[:, None], (n, mp.LANE)).copy()),
        vec4(sa), vec4(sa), vec4(g), member=1, unknown=0, failed=2,
        age_clamp=63, window=126, block_r=128, interpret=True,
        resident=True, rcnt_acc=True, t_cooldown=12,
        elementwise=elementwise, **jkw)
    from4 = lambda a: np.asarray(a).transpose(1, 0, 2, 3).reshape(n, n)  # noqa: E731
    return [from4(out[0]), from4(out[1])] + [
        np.asarray(o).astype(np.int32).reshape(n) for o in out[2:]]


@pytest.mark.parametrize("mode", WIDE_MODES)
@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
@pytest.mark.parametrize("form", merge.FORMS)
def test_wide_blocking_matches_jax_kernel_interpret(lib, form, elementwise,
                                                    mode):
    n = 1_024
    lanes, sa, g = jax_inputs(n, form, 40 + merge.FORMS.index(form), mode)
    got = run_host(lib, n, n, 0, form, mode, elementwise, lanes,
                   fanout=16, clusters=7, wide=True)
    want = jax_round(n, mode, elementwise, lanes, sa, g)
    assert len(got) == 6 + 4 * (mode != "crash-only")
    assert_equal(got, want)
    assert_equal(got, plain_outputs(mode, elementwise, 0, lanes))
    assert want[3].sum() > 0


@pytest.mark.parametrize("threads", [4, 8])
@pytest.mark.parametrize("mode", WIDE_MODES)
@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
@pytest.mark.parametrize("form", merge.FORMS)
def test_wide_walk_holds_rows_across_stripes(lib, form, elementwise, mode,
                                             threads):
    """2 clusters over N = 1,024's 64 stripes (32 each: c, c + 2, ...)
    and 4 or 8 threads a CTA, so that each step-2
    thread merges 16 or 8 rows a stripe: the first 8 (Cluster16x16::kHeld)
    with their metadata and per-receiver counts held across the cluster's
    32 stripes and added once after them, any past those loaded and
    counted a stripe at a time.  Bit-equal to the plain version, to the
    narrow blocking's replay and (4 threads) to the JAX kernel in
    interpret mode."""
    n = 1_024
    lanes, sa, g = jax_inputs(n, form, 60 + merge.FORMS.index(form), mode)
    got = run_host(lib, n, n, 0, form, mode, elementwise, lanes, fanout=16,
                   clusters=2, threads=threads, wide=True)
    assert_equal(got, plain_outputs(mode, elementwise, 0, lanes))
    assert_equal(got, run_host(lib, n, n, 0, form, mode, elementwise, lanes,
                               fanout=16))
    if threads == 4:
        assert_equal(got, jax_round(n, mode, elementwise, lanes, sa, g))
    assert got[5].sum() > 0


@pytest.mark.parametrize("width", [8, 20])
@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
@pytest.mark.parametrize("form", ["edges", "arc"])
def test_wide_walk_full_view_gathers_by_chunks(lib, form, elementwise,
                                               width):
    """The full-view forms' step 2 over many rows a thread: 4 threads a
    CTA over N = 1,024 (16 rows a thread a stripe, 2 clusters), each
    receiver gathering 8 view rows (one chunk of kChunk) or 20 (three
    chunks, the last part empty), live and dead receivers mixed, each
    row's flags and senders loaded while the row before it merges and
    hb read again from device memory; bit-equal to the plain version and
    to the narrow blocking's replay."""
    n, mode = 1_024, "suspicion+lh"
    fanout = width + 7 if form == "edges" else width
    inputs = round_inputs(n, n, form, 80 + width, True, fanout=fanout)
    assert inputs[4].shape[-1] == width or form == "arc"
    got = run_host(lib, n, n, 0, form, mode, elementwise, inputs,
                   fanout=fanout, clusters=2, threads=4, wide=True)
    assert_equal(got, plain_outputs(mode, elementwise, 0, inputs))
    assert_equal(got, run_host(lib, n, n, 0, form, mode, elementwise, inputs,
                               fanout=fanout))
    assert got[5].sum() > 0


@pytest.mark.parametrize("form", merge.FORMS)
@pytest.mark.parametrize("n", [19_328, 65_536, 69_632, 104_448, 109_056,
                               115_712, 115_840])
def test_wide_smem_bytes_agree_with_onepass_smem(lib, n, form):
    """The header's bytes a CTA equal ops/merge's at the wide blocking's
    edges: 2N + 896 B in the full-view forms (to N = 115,712), 17N/8 +
    640 B in the aligned ones (to 109,056)."""
    full = form in merge.FULL_VIEW_FORMS
    got = merge.onepass_smem(n, form, "16x16")
    assert lib.host_smem_bytes(n, int(full), 1) == got
    assert got == (2 * n + 896 if full else 17 * n // 8 + 640)
    assert (got <= merge.ONEPASS_SMEM) == (n <= (115_712 if full
                                                 else 109_056))


def test_lockstep_turns_are_zeroed_before_each_launch():
    """The wide kernel's clusters' turns (csrc/rr_onepass.cu lockstep) are
    a __device__ array of its library, one word a cluster it may wait
    for, which the launcher zeroes before every launch beside the
    per-receiver counts: no state passes from one launch to the next,
    the wrapper allocates nothing for them, and both blockings' libraries
    keep one C signature."""
    import re

    from gossipfs_tpu_torch.ops import _build

    src = (CSRC / "rr_onepass.cu").read_text()
    assert re.search(r"constexpr int kMaxTurns = \d+;", src)
    assert "__device__ unsigned g_turns[kMaxTurns];" in src
    assert "volatile unsigned* turns = g_turns;" in src
    assert "cudaGetSymbolAddress(&turns, g_turns)" in src
    assert "cudaMemsetAsync(turns, 0, sizeof g_turns, s)" in src
    assert "clusters <= kMaxTurns" in src
    sig = _build.SIGNATURES
    assert sig["rr_onepass_wide"] == sig["rr_onepass"]
    assert len(sig["rr_onepass"]["rr_onepass"][1]) == 23
