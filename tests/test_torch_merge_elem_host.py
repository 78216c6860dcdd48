"""Host build of the merge kernels' per-entry arithmetic (csrc/merge_elem.cuh).

K2 and K4 keep their epilogue in a header of ``__host__ __device__``
functions with no CUDA-only intrinsics.  Here g++ compiles a small harness
from that same header; ``ctypes`` runs it over numpy inputs:

* the epilogue over a corner grid (every age|status byte, both receiver
  states, the lane types' extremes and floor sentinels, view values up to
  both windows, shifts deep negative to far positive) must equal
  ``epilogue_plain`` exactly, for each heartbeat lane type;
* host replays of the kernels' loops (K2's receiver-row pass, K4's
  van Herk/Gil-Werman window segments followed by the row pass) must
  equal the plain versions on whole merges, fanouts that do and do not
  divide N.
This catches arithmetic slips before the card runs the kernels.
"""

from __future__ import annotations

import ctypes
import itertools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from gossipfs_tpu_torch.ops import merge_update as mu
from gossipfs_tpu_torch.ops.merge import pack_age_status

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "gossipfs_tpu_torch" / "csrc"

HARNESS = r"""
#include <cstdint>
#include <climits>
#include <algorithm>
#include "merge_elem.cuh"

extern "C" void host_epilogue(int m, const int32_t* best, const int32_t* hb,
                              const int8_t* asl, const uint8_t* recv,
                              const int32_t* sa, const int32_t* sb, int lo,
                              int hi, int age_clamp, int32_t* hb_out,
                              int8_t* asl_out, uint8_t* listed,
                              uint8_t* fresh) {
  for (int i = 0; i < m; ++i) {
    MeOut o = merge_elem(best[i], hb[i], asl[i], recv[i], sa[i], sb[i], lo,
                         hi, age_clamp);
    hb_out[i] = o.hb; asl_out[i] = (int8_t)o.asl;
    listed[i] = o.listed; fresh[i] = o.fresh;
  }
}

// merge_rows.cuh's receiver-row pass, replayed: int8 view, int16 lanes.
// out = [3, n] int32, initialised by the caller.
extern "C" void host_rows(int n, int fanout, const int8_t* view,
                          const int32_t* senders, int16_t* hb, int8_t* asl,
                          const int32_t* sa, const int32_t* sb,
                          const uint8_t* alive, int detect, int age_clamp,
                          int32_t* out) {
  for (int row = 0; row < n; ++row) {
    const bool recv = alive[row] != 0;
    for (int c = 0; c < n; ++c) {
      int best = -1;
      if (recv)
        for (int f = 0; f < fanout; ++f) {
          const int s = senders[(size_t)row * fanout + f];
          if ((unsigned)s >= (unsigned)n) continue;
          best = std::max(best, (int)view[(size_t)s * n + c]);
        }
      const size_t o = (size_t)row * n + c;
      MeOut m = merge_elem(best, hb[o], asl[o], recv, sa[c], sb[c],
                           MeLim<int16_t>::lo, MeLim<int16_t>::hi,
                           age_clamp);
      hb[o] = (int16_t)m.hb; asl[o] = (int8_t)m.asl;
      out[c] += (recv && m.listed) ? 1 : 0;
      if (detect && m.fresh) {
        out[n + c] += 1;
        out[2 * n + c] = std::min(out[2 * n + c], row);
      }
    }
  }
}

// arc_merge.cu's window_max_kernel, replayed block by block: segment m
// of F rows (extended index space), a backward suffix pass writing W and
// a forward prefix pass folding into it.
extern "C" void host_window(int n, int fanout, const int8_t* view,
                            int8_t* w) {
  for (int s0 = 0; s0 < n; s0 += fanout) {
    const int end = std::min(s0 + fanout, n);
    for (int c = 0; c < n; ++c) {
      int run = INT_MIN;
      for (int x = s0 + fanout - 1; x >= s0; --x) {
        const int row = x < n ? x : x - n;
        run = std::max(run, (int)view[(size_t)row * n + c]);
        if (x < end) w[(size_t)x * n + c] = (int8_t)run;
      }
      run = INT_MIN;
      for (int x = s0 + fanout; x <= end + fanout - 2; ++x) {
        const int row = x < n ? x : x - n;
        run = std::max(run, (int)view[(size_t)row * n + c]);
        int8_t* wr = w + (size_t)(x - fanout + 1) * n + c;
        *wr = (int8_t)std::max((int)*wr, run);
      }
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("merge_elem")
    src, lib = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def call(fn, *args):
    fn(*[a.ctypes.data_as(ctypes.c_void_p) if isinstance(a, np.ndarray)
         else ctypes.c_int(a) for a in args])


LANES = {"int8": (-128, 127), "int16": (-32768, 32767),
         "int32": (-2**30, 2**30)}


@pytest.mark.parametrize("age_clamp", [63, 10])
@pytest.mark.parametrize("lane", list(LANES))
def test_epilogue_matches_plain_over_corner_grid(host_lib, lane, age_clamp):
    info = torch.iinfo(getattr(torch, lane))
    lo, hi = info.min, info.max
    glo, ghi = LANES[lane]
    best = [-1, 0, 1, 63, 126, 127, 16_384]
    hb = sorted({glo, glo + 1, -1, 0, 1, 100, 126, ghi - 1, ghi,
                 min(ghi, 16_383)})
    asl = list(range(-128, 128))          # every age|status byte
    sa = [-70_000, -200, -1, 0, 1, 200, 16_258]
    sb = [-16_300, -1, 0, 1, 126, 16_384]
    grid = np.array(list(itertools.product(best, hb, asl, (0, 1), sa, sb)),
                    dtype=np.int64).T
    m = grid.shape[1]
    b, h, a, r, s_a, s_b = (np.ascontiguousarray(g) for g in grid)
    b, h, s_a, s_b = (x.astype(np.int32) for x in (b, h, s_a, s_b))
    a, r = a.astype(np.int8), r.astype(np.uint8)
    outs = [np.empty(m, np.int32), np.empty(m, np.int8),
            np.empty(m, np.uint8), np.empty(m, np.uint8)]
    call(host_lib.host_epilogue, m, b, h, a, r, s_a, s_b, lo, hi, age_clamp,
         *outs)
    t = lambda x: torch.from_numpy(x).to(torch.int32)  # noqa: E731
    want = mu.epilogue_plain(t(b), t(h), t(a), torch.from_numpy(r != 0),
                             t(s_a), t(s_b), lo, hi, age_clamp)
    for name, o, w in zip(("hb", "asl", "listed", "fresh"), outs, want):
        np.testing.assert_array_equal(o.astype(np.int64),
                                      w.numpy().astype(np.int64),
                                      err_msg=name)
    assert outs[3].any()
    assert (outs[0] == lo).any() == (lane != "int32")   # narrow lanes clip


def merge_inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    view = rng.integers(-1, 127, (n, n)).astype(np.int8)
    alive = rng.random(n) < 0.8
    view[~alive] = -1
    hb = rng.integers(-32768, 32768, (n, n)).astype(np.int16)
    hb[rng.random((n, n)) < 0.05] = -32768
    age = rng.integers(0, 64, (n, n))
    age[rng.random((n, n)) < 0.2] = 0
    status = rng.integers(0, 3, (n, n))
    asl = pack_age_status(torch.from_numpy(age),
                          torch.from_numpy(status)).numpy()
    sa = rng.integers(-300, 300, n).astype(np.int32)
    sb = rng.integers(-300, 300, n).astype(np.int32)
    return rng, view, hb, asl, sa, sb, alive


def plain_out(fn, view, senders, hb, asl, sa, sb, alive, **kw):
    t = torch.from_numpy
    out = fn(t(view), t(senders), t(hb.copy()), t(asl.copy()), t(sa), t(sb),
             t(alive), detect_stats=True, **kw)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("n,fanout", [(96, 5), (70, 14)])
def test_host_rows_match_fused_plain(host_lib, n, fanout):
    rng, view, hb, asl, sa, sb, alive = merge_inputs(n, fanout)
    edges = rng.integers(0, n, (n, fanout)).astype(np.int32)
    want = plain_out(mu.fused_merge_update_plain, view, edges, hb, asl, sa,
                     sb, alive)
    h, a = hb.copy(), asl.copy()
    out = np.zeros((3, n), np.int32)
    out[2] = n
    call(host_lib.host_rows, n, fanout, view, edges, h, a, sa, sb,
         alive.astype(np.uint8), 1, 63, out)
    for name, o, w in zip(("hb", "asl", "cnt", "n_det", "first_obs"),
                          [h, a, *out], want):
        np.testing.assert_array_equal(o, w, err_msg=name)


@pytest.mark.parametrize("n,fanout", [(96, 16), (70, 11), (50, 49), (64, 1)])
def test_host_window_then_rows_match_arc_plain(host_lib, n, fanout):
    """K4's two launches replayed: the window max equals the plain one,
    and the row pass over it (F = 1, senders = bases) equals the whole
    plain K4."""
    rng, view, hb, asl, sa, sb, alive = merge_inputs(n, n + fanout)
    bases = rng.integers(0, n, n).astype(np.int32)
    w = np.full((n, n), 99, np.int8)
    call(host_lib.host_window, n, fanout, view, w)
    np.testing.assert_array_equal(
        w, mu.window_max_plain(torch.from_numpy(view), fanout).numpy())
    want = plain_out(mu.arc_merge_update_plain, view, bases, hb, asl, sa, sb,
                     alive, fanout=fanout)
    h, a = hb.copy(), asl.copy()
    out = np.zeros((3, n), np.int32)
    out[2] = n
    call(host_lib.host_rows, n, 1, w, bases[:, None].copy(), h, a, sa, sb,
         alive.astype(np.uint8), 1, 63, out)
    for name, o, x in zip(("hb", "asl", "cnt", "n_det", "first_obs"),
                          [h, a, *out], want):
        np.testing.assert_array_equal(o, x, err_msg=name)
