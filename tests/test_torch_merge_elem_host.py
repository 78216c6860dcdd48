"""Host build of the merge kernels' per-entry arithmetic (csrc/merge_elem.cuh).

K2 and K4 keep their epilogue in a header of ``__host__ __device__``
functions with no CUDA-only intrinsics.  Here g++ compiles a small harness
from that same header; ``ctypes`` runs it over numpy inputs:

* the epilogue over a corner grid (every age|status byte, both receiver
  states, the lane types' extremes and floor sentinels, view values up to
  both windows, shifts deep negative to far positive) must equal
  ``epilogue_plain`` exactly, for each heartbeat lane type;
* host replays must equal the plain versions on whole merges: K2's
  function as a loop over receivers, senders and subjects around the
  epilogue (K2's own per-thread bodies are replayed in
  tests/test_torch_fused_merge_host.py); K4's one launch through its own
  per-thread bodies (csrc/merge_stripe.cuh: the cluster's parks as host
  arrays, the window max by shift doubling in the park, the receivers'
  reads of it, the counts), over every view and lane type pair, ragged N,
  column blocks, fanouts 1 to N - 1 and windows crossing CTA ranges and
  the wrap; and its two launches for shapes whose halo outgrows a park
  (van Herk/Gil-Werman window segments followed by the row pass).
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
#include <vector>
#include "merge_elem.cuh"
#include "merge_stripe.cuh"

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

// K2's function around the epilogue, receiver by receiver: int8 view,
// int16 lanes.  out = [3, n] int32, initialised by the caller.
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

static void copy16(int8_t* d, const int8_t* s) { std::memcpy(d, s, 16); }

extern "C" int host_tile_fits(int fanout) {
  return mstripe::tile_fits(fanout);
}

// arc_merge.cu's window_tile_kernel replayed block by block: a tile of
// kTileRows rows and its F - 1 halo rows staged (stage_seg), doubled chunk
// by chunk (every thread's window_read, then every thread's window_write),
// then W = max(M_p[x], M_p[x + F - p]) written (tile_window).
template <typename V, bool kVec>
static void host_tiles_t(int n, int nc, int fanout, const V* view, V* w) {
  using namespace mstripe;
  constexpr int kE = kSegBytes / sizeof(V), lanes = kMaxRowBytes / kSegBytes;
  constexpr int cols = lanes * kE;
  const int pw = pow2_floor(fanout);
  std::vector<int8_t> park(tile_smem_bytes(fanout));
  std::vector<Seg> buf((size_t)kThreads * kWinItems);
  auto* v = reinterpret_cast<Seg(*)[kWinItems]>(buf.data());
  for (int r0 = 0; r0 < n; r0 += kTileRows)
    for (int col0 = 0; col0 < nc; col0 += cols) {
      const int rows = std::min(kTileRows, n - r0), len = rows + fanout - 1;
      for (int i = 0; i < len * lanes; ++i) {
        int g = r0 + i / lanes;
        if (g >= n) g -= n;
        stage_seg<V, kVec>(view, nc, col0, g, i % lanes,
                           &park[(size_t)i * kSegBytes], copy16);
      }
      for (int s = 1; s < pw; s *= window_radix(s, pw)) {
        const int r = window_radix(s, pw);
        for (int c = 0; c < window_chunks(len, s, r, lanes, kThreads); ++c) {
          for (int t = 0; t < kThreads; ++t)
            window_read<V>(park.data(), kMaxRowBytes, len, s, r, c, t,
                           kThreads, v[t]);
          for (int t = 0; t < kThreads; ++t)
            window_write(park.data(), kMaxRowBytes, len, s, r, c, t,
                         kThreads, v[t]);
        }
      }
      for (int i = 0; i < rows * lanes; ++i) {
        const int h = i % lanes, col = col0 + h * kE;
        union {
          V x[kE];
          Seg s;
        } u;
        u.s = tile_window<V>(park.data(), i / lanes, h, fanout, pw);
        for (int k = 0; k < kE && col + k < nc; ++k)
          w[(size_t)(r0 + i / lanes) * nc + col + k] = u.x[k];
      }
    }
}

extern "C" void host_tiles(int view_bytes, int vec, int n, int nc,
                           int fanout, const void* view, void* w) {
  if (view_bytes == 1)
    vec ? host_tiles_t<int8_t, true>(n, nc, fanout, (const int8_t*)view,
                                     (int8_t*)w)
        : host_tiles_t<int8_t, false>(n, nc, fanout, (const int8_t*)view,
                                      (int8_t*)w);
  else
    vec ? host_tiles_t<int16_t, true>(n, nc, fanout, (const int16_t*)view,
                                      (int16_t*)w)
        : host_tiles_t<int16_t, false>(n, nc, fanout, (const int16_t*)view,
                                       (int16_t*)w);
}

// arc_merge.cu's arc_rows_kernel replayed block by block: each block's
// threads sweep up to kRowsPerBlock rows of
// a 128-byte stripe, one W row a receiver (load_row_seg), merge_seg, their
// counter bytes summed into the block's counts, which go into the
// initialised ``out`` as the kernel's atomics do.
template <typename V, typename H, bool kVec, bool kSus, bool kDet>
static void host_rows_t(int n, int nc, const V* w, const int32_t* bases,
                        H* hb, int8_t* asl, const int32_t* sa,
                        const int32_t* sb, const uint8_t* alive,
                        int32_t* out) {
  using namespace mstripe;
  constexpr int kE = kSegBytes / sizeof(V), lanes = kMaxRowBytes / kSegBytes;
  constexpr int cols = lanes * kE, step_rows = kRowThreads / lanes;
  for (int r0 = 0; r0 < n; r0 += kRowsPerBlock)
    for (int col0 = 0; col0 < nc; col0 += cols) {
      const int rows = std::min(kRowsPerBlock, n - r0);
      int32_t cnt[kBlockInts];
      for (int i = 0; i < kBlockInts; ++i) cnt[i] = blank_count(i, n);
      for (int t = 0; t < kRowThreads; ++t) {
        const int h = t % lanes, col = col0 + h * kE;
        const int valid = kVec ? (col < nc ? kE : 0)
                               : std::max(0, std::min(kE, nc - col));
        Counts<kE> cn;
        clear(cn);
        int step = 0;
        for (int li = t / lanes; valid > 0 && li < rows;
             li += step_rows, ++step) {
          const int row = r0 + li, b = bases[row];
          const bool recv = alive[row] != 0;
          const size_t off = (size_t)row * nc + col;
          Lanes<H, kE> ld;
          load_lanes<H, kE, kVec>(hb + off, asl + off, valid, ld);
          const Seg best = recv && (unsigned)b < (unsigned)n
                               ? load_row_seg<V, kVec>(w, nc, b, col, valid)
                               : onepass::splat(0xFFFFFFFFu);
          merge_seg<V, H, kSus, kDet, kVec, kE>(best, ld, valid, sa + col,
                                                sb + col, recv, 63, step, cn);
          store_lanes<H, kE, kVec>(hb + off, asl + off, valid, ld);
        }
        for (int j = 0; j < kE; ++j) {
          const int c = h * kE + j;
          cnt[kOutCnt * kMaxCols + c] += count_at(cn.cnt, j);
          cnt[kOutDet * kMaxCols + c] += count_at(cn.det, j);
          cnt[kOutRef * kMaxCols + c] += count_at(cn.ref, j);
          cnt[kOutHeld * kMaxCols + c] += count_at(cn.held, j);
          if (first_step(cn, j) >= 0) {
            const int r = r0 + first_step(cn, j) * step_rows + t / lanes;
            int32_t& fo = cnt[kOutFobs * kMaxCols + c];
            fo = std::min(fo, r);
          }
        }
      }
      for (int s = 0; s < kOuts; ++s)
        for (int c = 0; c < cols && col0 + c < nc; ++c) {
          if ((!kSus && s >= kOutRef) ||
              (!kDet && (s == kOutDet || s == kOutFobs)))
            continue;
          int32_t& o = out[(size_t)s * nc + col0 + c];
          const int v = cnt[s * kMaxCols + c];
          o = s == kOutFobs ? std::min(o, v) : o + v;
        }
    }
}

template <typename V, typename H>
static void host_rows_vh(int vec, int suspect, int detect, int n, int nc,
                         const void* w, const int32_t* bases, void* hb,
                         int8_t* asl, const int32_t* sa, const int32_t* sb,
                         const uint8_t* alive, int32_t* out) {
  const V* x = static_cast<const V*>(w);
  H* h = static_cast<H*>(hb);
#define HR_ARGS n, nc, x, bases, h, asl, sa, sb, alive, out
#define HR_DET(v, s) \
  detect ? host_rows_t<V, H, v, s, true>(HR_ARGS) \
         : host_rows_t<V, H, v, s, false>(HR_ARGS)
  if (vec)
    suspect ? HR_DET(true, true) : HR_DET(true, false);
  else
    suspect ? HR_DET(false, true) : HR_DET(false, false);
#undef HR_DET
#undef HR_ARGS
}

extern "C" void host_arc_rows(int view_bytes, int hb_bytes, int vec,
                              int suspect, int detect, int n, int nc,
                              const void* w, const int32_t* bases, void* hb,
                              int8_t* asl, const int32_t* sa,
                              const int32_t* sb, const uint8_t* alive,
                              int32_t* out) {
#define HR_ARGS vec, suspect, detect, n, nc, w, bases, hb, asl, sa, sb, \
                alive, out
  if (view_bytes == 1 && hb_bytes == 1) host_rows_vh<int8_t, int8_t>(HR_ARGS);
  if (view_bytes == 1 && hb_bytes == 2) host_rows_vh<int8_t, int16_t>(HR_ARGS);
  if (view_bytes == 1 && hb_bytes == 4) host_rows_vh<int8_t, int32_t>(HR_ARGS);
  if (view_bytes == 2 && hb_bytes == 2)
    host_rows_vh<int16_t, int16_t>(HR_ARGS);
  if (view_bytes == 2 && hb_bytes == 4)
    host_rows_vh<int16_t, int32_t>(HR_ARGS);
#undef HR_ARGS
}

// arc_merge.cu's window_max_kernel (the van Herk window, for a fanout
// whose halo outgrows a tile), replayed block by block: segment m of F rows
// (extended index space), a backward suffix pass writing W and a forward
// prefix pass folding into it.
template <typename V>
static void host_window_t(int n, int nc, int fanout, const V* view, V* w) {
  for (int s0 = 0; s0 < n; s0 += fanout) {
    const int end = std::min(s0 + fanout, n);
    for (int c = 0; c < nc; ++c) {
      int run = INT_MIN;
      for (int x = s0 + fanout - 1; x >= s0; --x) {
        const int row = x < n ? x : x - n;
        run = std::max(run, (int)view[(size_t)row * nc + c]);
        if (x < end) w[(size_t)x * nc + c] = (V)run;
      }
      run = INT_MIN;
      for (int x = s0 + fanout; x <= end + fanout - 2; ++x) {
        const int row = x < n ? x : x - n;
        run = std::max(run, (int)view[(size_t)row * nc + c]);
        V* wr = w + (size_t)(x - fanout + 1) * nc + c;
        *wr = (V)std::max((int)*wr, run);
      }
    }
  }
}

extern "C" void host_window(int view_bytes, int n, int nc, int fanout,
                            const void* view, void* w) {
  if (view_bytes == 1)
    host_window_t<int8_t>(n, nc, fanout, (const int8_t*)view, (int8_t*)w);
  else
    host_window_t<int16_t>(n, nc, fanout, (const int16_t*)view,
                           (int16_t*)w);
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


NAMES = ("hb", "asl", "cnt", "n_det", "first_obs", "refuted", "held")


def check_arc(host_lib, view, bases, hb, asl, sa, sb, alive, fanout,
              detect: bool = True, suspect: bool = False) -> None:
    """K4 replayed: the window max by tiles (each path, where a tile and
    its halo fit a block) and by van Herk segments equals the plain one,
    and the row pass over it into initialised outputs (each path) equals
    the whole plain K4."""
    n, nc = hb.shape
    t = torch.from_numpy
    want_w = mu.window_max_plain(t(view), fanout).numpy()
    want = mu.arc_merge_update_plain(
        t(view), t(bases), t(hb.copy()), t(asl.copy()), t(sa), t(sb),
        t(alive), fanout=fanout, detect_stats=detect, suspect=suspect)
    vecs = (0, 1) if nc % 16 == 0 else (0,)
    windows = [("segments", None)]
    if host_lib.host_tile_fits(fanout):
        windows += [("tiles", v) for v in vecs]
    for form, vec in windows:
        w = np.full_like(view, 99)
        if form == "tiles":
            call(host_lib.host_tiles, view.itemsize, vec, n, nc, fanout, view,
                 w)
        else:
            call(host_lib.host_window, view.itemsize, n, nc, fanout, view, w)
        np.testing.assert_array_equal(w, want_w, err_msg=f"{form} {vec}")
    for vec in vecs:
        h, a = hb.copy(), asl.copy()
        out = np.zeros((5, nc), np.int32)
        if detect:
            out[2] = n
        call(host_lib.host_arc_rows, view.itemsize, hb.itemsize, vec,
             int(suspect), int(detect), n, nc, want_w, bases, h, a, sa, sb,
             alive.astype(np.uint8), out)
        got = [h, a, *out[:5 if suspect else 3]]
        assert len(got) == len(want)
        for name, o, x in zip(NAMES, got, want):
            np.testing.assert_array_equal(o, x.numpy(),
                                          err_msg=f"{name}, vec={vec}")


@pytest.mark.parametrize("n,fanout", [(96, 16), (70, 11), (50, 49), (64, 1)])
def test_host_window_then_rows_match_arc_plain(host_lib, n, fanout):
    """K4's two launches replayed: the window max by tiles and by van Herk
    segments equals the plain one, and the row pass over it (one W row a
    receiver, at its arc base) equals the whole plain K4."""
    rng, view, hb, asl, sa, sb, alive = merge_inputs(n, n + fanout)
    bases = rng.integers(0, n, n).astype(np.int32)
    check_arc(host_lib, view, bases, hb, asl, sa, sb, alive, fanout)


def arc_inputs(n: int, nc: int, vd, hd, suspect: bool, seed: int):
    """One K4 call's inputs over an [n, nc] block, made with numpy."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(hd)
    top = 126 if vd == np.int8 else 16_384
    view = rng.integers(-1, top + 1, (n, nc)).astype(vd)
    alive = rng.random(n) < 0.8
    view[~alive] = -1
    hb = rng.integers(max(info.min, -2**20), min(info.max, 2**20) + 1,
                      (n, nc)).astype(hd)
    hb[rng.random((n, nc)) < 0.05] = info.min
    age = rng.integers(0, 64, (n, nc))
    age[rng.random((n, nc)) < 0.2] = 0
    status = rng.integers(0, 4 if suspect else 3, (n, nc))
    asl = pack_age_status(torch.from_numpy(age),
                          torch.from_numpy(status)).numpy()
    sa = rng.integers(-70_000, 70_000, nc).astype(np.int32)
    sb = np.where(rng.random(nc) < 0.5, sa,
                  rng.integers(-70_000, 70_000, nc)).astype(np.int32)
    bases = rng.integers(0, n, n).astype(np.int32)
    return view, bases, hb, asl, sa, sb, alive


@pytest.mark.parametrize("suspect", [False, True], ids=["off", "suspect"])
@pytest.mark.parametrize("detect", [False, True], ids=["nostats", "stats"])
@pytest.mark.parametrize("n,nc,fanout,vd,hd", [
    (70, 70, 9, np.int8, np.int8),       # N % 8 != 0, F not a power of 2
    (100, 36, 7, np.int8, np.int16),     # C < N, C % 16 != 0
    (130, 48, 5, np.int16, np.int32),    # int16 view, 16-byte path
    (90, 90, 13, np.int16, np.int16),    # int16 view, ragged
    (40, 40, 1, np.int8, np.int32),      # fanout 1: W = view
    (33, 33, 32, np.int8, np.int32),     # fanout N - 1
    (1_100, 32, 30, np.int8, np.int8),   # windows cross tiles, wrap at N
    (3_000, 20, 16, np.int8, np.int8),   # several row-pass blocks
    (2_500, 32, 9, np.int16, np.int32),  # int16 view, several blocks
    (3_000, 64, 2_000, np.int8, np.int8),       # van Herk: past a tile
    (6_000, 40, 5_000, np.int16, np.int16),
    (8_000, 16, 7_000, np.int8, np.int16),
], ids=["ragged", "block36", "view16", "view16ragged", "f1", "fNm1",
        "cross", "blocks8", "blocks16", "seg64", "seg40", "seg16"])
def test_host_arc_matches_plain(host_lib, n, nc, fanout, vd, hd, detect,
                                suspect):
    """K4 over every view/lane type pair it takes, suspicion and detection
    stats on and off: ragged N, column blocks (C % 16 != 0: the element
    path), fanout 1 and N - 1, windows crossing window tiles and the wrap
    at N, several row-pass blocks a stripe, and halos past a tile (the van
    Herk window)."""
    view, bases, hb, asl, sa, sb, alive = arc_inputs(n, nc, vd, hd, suspect,
                                                     n * nc + fanout)
    if fanout == 30:
        # receivers whose windows start at a tile's end or wrap at N
        bases[:40] = np.r_[np.arange(490, 510), n - np.arange(1, 21)]
    check_arc(host_lib, view, bases, hb, asl, sa, sb, alive, fanout, detect,
              suspect)


@pytest.mark.parametrize("fanout,fits", [(1, True), (16, True), (1_305, True),
                                         (1_306, False), (15_000, False)])
def test_arc_window_tile_rule(host_lib, fanout, fits):
    """The window tile (512 rows and the F - 1 halo rows, 128 bytes each)
    fits one block's shared memory up to F = 1,305; the main paths' F = 16
    takes tiles, phase 8's F = 15,000 the van Herk window."""
    assert bool(host_lib.host_tile_fits(fanout)) == fits
