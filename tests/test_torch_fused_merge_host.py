"""Host build of K2's per-thread bodies (csrc/gather_ring.cuh).

K2 (csrc/fused_merge.cu) keeps its gather ring, its row merge and its
count bookkeeping in ``__host__ __device__`` functions; here g++ compiles a
small harness from that header and ``ctypes`` runs it over numpy inputs.
The harness replays the kernel item by item (a 128-byte stripe of columns
by a range of receiver rows), its 256 threads one after another, each
through ``fm_thread`` with the ring in a host array and the asynchronous
copies as ``memcpy``; each thread's counter bytes go into the item's
counts as the kernel's warp and block sums do, and the item's counts into
the initialised outputs as its atomics do.  The replay must equal
``fused_merge_update_plain`` for every view/lane type pair, suspicion and
detection stats on and off, column blocks, the 16-byte and the element
path, ragged N, senders outside [0, N), dead receivers, fanout 1, fanouts
that take several ring stages a row, the largest fanout, and items of a
few rows, so that the count flush and the first observer cross items.
The ring's plan and the items' row rules (item_rows, staged_rows) are
checked at the main paths' shapes.
"""

from __future__ import annotations

import ctypes
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
#include <cstring>
#include <algorithm>
#include <vector>
#include "gather_ring.cuh"

using namespace mstripe;

static void copy16(int8_t* d, const int8_t* s) { std::memcpy(d, s, 16); }

// fused_merge.cu's fused_kernel replayed item by item: the item's shifts
// and sender ids staged (stage_ids, by each thread), every thread's
// fm_thread, their counter bytes summed into the
// item's counts (flush_counts: sums, and the min over the rows that fired
// of r0 + step * 32 + t / 8), the counts into the initialised ``out`` as
// add_block_counts does.
template <typename V, typename H, bool kVec, bool kSus, bool kDet>
static void fm_t(int n, int nc, int fanout, int rows_per_item, int age_clamp,
                 const V* view, const int32_t* edges, H* hb, int8_t* asl,
                 const int32_t* sa, const int32_t* sb, const uint8_t* alive,
                 int32_t* out) {
  constexpr int kE = kSegBytes / sizeof(V), cols = gring::kLanes * kE;
  std::vector<int8_t> ring(gring::ring_bytes(gring::plan(fanout).chunk));
  std::vector<int32_t> ids((size_t)rows_per_item * fanout);
  const gring::FmArgs<V, H> a{view, ids.data(), hb,     asl,      alive,
                              n,    nc,         fanout, age_clamp};
  for (int col0 = 0; col0 < nc; col0 += cols)
    for (int r0 = 0; r0 < n; r0 += rows_per_item) {
      const int rows = std::min(rows_per_item, n - r0);
      for (int t = 0; t < gring::kThreads; ++t)
        gring::stage_ids(edges, ids.data(), r0, rows, fanout, t,
                         gring::kThreads);
      int32_t cnt[kBlockInts], sh[2][kMaxCols];
      for (int i = 0; i < kBlockInts; ++i) cnt[i] = blank_count(i, n);
      for (int c = 0; c < kMaxCols; ++c) {
        sh[0][c] = c < cols && col0 + c < nc ? sa[col0 + c] : 0;
        sh[1][c] = c < cols && col0 + c < nc ? sb[col0 + c] : 0;
      }
      for (int t = 0; t < gring::kThreads; ++t) {
        Counts<kE> cn;
        clear(cn);
        gring::fm_thread<V, H, kSus, kDet, kVec>(
            a, r0, rows, col0, t, ring.data(), sh[0], sh[1], copy16, [] {},
            [] {}, cn);
        const int h = t % gring::kLanes;
        for (int j = 0; j < kE; ++j) {
          const int c = h * kE + j;
          cnt[kOutCnt * kMaxCols + c] += count_at(cn.cnt, j);
          cnt[kOutDet * kMaxCols + c] += count_at(cn.det, j);
          cnt[kOutRef * kMaxCols + c] += count_at(cn.ref, j);
          cnt[kOutHeld * kMaxCols + c] += count_at(cn.held, j);
          if (first_step(cn, j) >= 0) {
            const int r = r0 + first_step(cn, j) * gring::kStepRows +
                          t / gring::kLanes;
            cnt[kOutFobs * kMaxCols + c] =
                std::min(cnt[kOutFobs * kMaxCols + c], r);
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
static void fm_vh(int vec, int suspect, int detect, int n, int nc,
                  int fanout, int rows, int age_clamp, const void* view,
                  const int32_t* edges, void* hb, int8_t* asl,
                  const int32_t* sa, const int32_t* sb, const uint8_t* alive,
                  int32_t* out) {
  const V* v = static_cast<const V*>(view);
  H* h = static_cast<H*>(hb);
#define FM_ARGS n, nc, fanout, rows, age_clamp, v, edges, h, asl, sa, sb, \
                alive, out
#define FM_DET(x, s) \
  detect ? fm_t<V, H, x, s, true>(FM_ARGS) : fm_t<V, H, x, s, false>(FM_ARGS)
  if (vec)
    suspect ? FM_DET(true, true) : FM_DET(true, false);
  else
    suspect ? FM_DET(false, true) : FM_DET(false, false);
#undef FM_DET
#undef FM_ARGS
}

extern "C" void host_fm(int view_bytes, int hb_bytes, int vec, int suspect,
                        int detect, int n, int nc, int fanout, int rows,
                        int age_clamp, const void* view,
                        const int32_t* edges, void* hb, int8_t* asl,
                        const int32_t* sa, const int32_t* sb,
                        const uint8_t* alive, int32_t* out) {
#define FM_ARGS vec, suspect, detect, n, nc, fanout, rows, age_clamp, view, \
                edges, hb, asl, sa, sb, alive, out
  if (view_bytes == 1 && hb_bytes == 1) fm_vh<int8_t, int8_t>(FM_ARGS);
  if (view_bytes == 1 && hb_bytes == 2) fm_vh<int8_t, int16_t>(FM_ARGS);
  if (view_bytes == 1 && hb_bytes == 4) fm_vh<int8_t, int32_t>(FM_ARGS);
  if (view_bytes == 2 && hb_bytes == 2) fm_vh<int16_t, int16_t>(FM_ARGS);
  if (view_bytes == 2 && hb_bytes == 4) fm_vh<int16_t, int32_t>(FM_ARGS);
#undef FM_ARGS
}

extern "C" int host_item_rows(long n, long held) {
  return gring::item_rows(n, held);
}

extern "C" int host_staged_rows(int rows, int fanout) {
  return gring::staged_rows(rows, fanout);
}

extern "C" void host_plan(int fanout, int* out) {
  const gring::Plan p = gring::plan(fanout);
  out[0] = p.chunk;
  out[1] = p.chunks;
}
"""

# the blocks an H100 holds at once: 2 of 256 threads an SM, 132 SMs
HELD = 2 * 132


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("fused_merge")
    src, lib = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    lib.host_item_rows.argtypes = [ctypes.c_long, ctypes.c_long]
    return lib


def call(fn, *args):
    fn(*[a.ctypes.data_as(ctypes.c_void_p) if isinstance(a, np.ndarray)
         else ctypes.c_int(a) for a in args])


def fm_inputs(n: int, nc: int, fanout: int, vd, hd, suspect: bool,
              seed: int):
    """One K2 call's inputs over an [n, nc] block, made with numpy: every
    status (SUSPECT under ``suspect``), ages up to 63 with a fifth at 0,
    floor sentinels, deep and far shifts, a fifth of the receivers dead
    (their view rows absent), and a third of the senders outside [0, n)
    (``edges``) beside the same edges naming a dead node in their place
    (``ref``, what the plain version takes)."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(hd)
    top = 126 if vd == np.int8 else 16_384
    view = rng.integers(-1, top + 1, (n, nc)).astype(vd)
    alive = rng.random(n) < 0.8
    alive[1] = False
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
    ref = rng.integers(0, n, (n, fanout)).astype(np.int32)
    edges = ref.copy()
    bad = rng.random(edges.shape) < 0.3
    edges[bad] = rng.choice(np.array([-1, n, n + 7, 2**31 - 1], np.int32),
                            int(bad.sum()))
    edges[0] = -1                     # a receiver with no sender at all
    ref[edges != ref] = int(np.flatnonzero(~alive)[0])
    return view, edges, ref, hb, asl, sa, sb, alive


NAMES = ("hb", "asl", "cnt", "n_det", "first_obs", "refuted", "held")


def check_fm(host_lib, view, edges, ref, hb, asl, sa, sb, alive, rows,
             detect: bool, suspect: bool, age_clamp: int = 63) -> None:
    """The replay (each path: the 16-byte one where nc % 16 == 0) equals
    the plain K2 over ``ref``."""
    n, nc = hb.shape
    t = torch.from_numpy
    want = mu.fused_merge_update_plain(
        t(view), t(ref), t(hb.copy()), t(asl.copy()), t(sa), t(sb),
        t(alive), detect_stats=detect, suspect=suspect, age_clamp=age_clamp)
    for vec in ((0, 1) if nc % 16 == 0 else (0,)):
        h, a = hb.copy(), asl.copy()
        out = np.zeros((5, nc), np.int32)
        if detect:
            out[2] = n
        call(host_lib.host_fm, view.itemsize, hb.itemsize, vec, int(suspect),
             int(detect), n, nc, edges.shape[1], rows, age_clamp, view,
             edges, h, a, sa, sb, alive.astype(np.uint8), out)
        got = [h, a, *out[:5 if suspect else 3]]
        assert len(got) == len(want)
        for name, o, x in zip(NAMES, got, want):
            np.testing.assert_array_equal(o, x.numpy(),
                                          err_msg=f"{name}, vec={vec}")


@pytest.mark.parametrize("suspect", [False, True], ids=["off", "suspect"])
@pytest.mark.parametrize("detect", [False, True], ids=["nostats", "stats"])
@pytest.mark.parametrize("n,nc,fanout,vd,hd,rows", [
    (70, 70, 9, np.int8, np.int8, None),      # ragged N: the element path
    (100, 36, 7, np.int8, np.int16, None),    # C < N, C % 16 != 0
    (130, 48, 5, np.int16, np.int32, None),   # int16 view, 16-byte path
    (96, 96, 14, np.int16, np.int16, None),   # config 3's F: two chunks
    (64, 64, 1, np.int8, np.int32, None),     # fanout 1
    (80, 32, 40, np.int8, np.int16, None),    # F = 40: five ring chunks
    (300, 160, 17, np.int8, np.int8, 64),     # items of 64 rows, 2 stripes
    (260, 80, 15, np.int16, np.int32, 32),    # items of one step
    (100, 32, 512, np.int8, np.int16, None),  # F = 512: staged ids cut items
], ids=["ragged", "block36", "view16", "view16f14", "f1", "f40", "items",
        "items16", "f512"])
def test_host_fused_matches_plain(host_lib, n, nc, fanout, vd, hd, rows,
                                  detect, suspect):
    """K2 over every view/lane type pair it takes, suspicion and detection
    stats on and off: ragged N, column blocks (C % 16 != 0: the element
    path), senders outside [0, N) and dead receivers in every case, fanout
    1, fanouts of several ring chunks a row, the largest fanout (its
    staged ids cut the items to one step), and items of a few rows (the
    counts and the first observer summed across items).  Without a given
    item size, the kernel's: item_rows cut by staged_rows."""
    args = fm_inputs(n, nc, fanout, vd, hd, suspect, n * nc + fanout)
    if rows is None:
        rows = host_lib.host_staged_rows(host_lib.host_item_rows(n, HELD),
                                         fanout)
    check_fm(host_lib, *args, rows, detect, suspect)


@pytest.mark.parametrize("age_clamp", [63, 10])
def test_host_fused_age_clamp(host_lib, age_clamp):
    """The age clamp reaches the epilogue: ages saturate at it."""
    args = fm_inputs(120, 64, 6, np.int8, np.int16, True, 120 + age_clamp)
    check_fm(host_lib, *args, 32, True, True, age_clamp)


@pytest.mark.parametrize("fanout,chunk,chunks", [
    (1, 1, 1), (8, 8, 1), (9, 5, 2), (14, 7, 2), (15, 8, 2), (16, 8, 2),
    (17, 6, 3), (40, 8, 5), (512, 8, 64)])
def test_ring_plan(host_lib, fanout, chunk, chunks):
    """A row's senders go through the ring in chunks of at most 8, as even
    as they come: config 3's F = 14 in two of 7, G's 15 in 8 + 7, config
    4's 17 in three."""
    out = np.zeros(2, np.int32)
    call(host_lib.host_plan, fanout, out)
    assert tuple(out) == (chunk, chunks)
    assert (chunks - 1) * chunk < fanout <= chunks * chunk


@pytest.mark.parametrize("n,held,rows", [
    (10_240, HELD, 352), (16_384, HELD, 384), (32_768, HELD, 384),
    (65_536, HELD, 256), (131_072, HELD, 512), (1_024, HELD, 352),
    (64, HELD, 64), (1_000_000, 1, 8_160)])
def test_item_rows_rule(host_lib, n, held, rows):
    """Items at the main paths' N with the 264 blocks an H100 holds of K2:
    the blocks in flight span the 128-byte view strips that ~12 MB holds
    (at least one), and one more where rows rounded up to whole steps of
    32 leave fewer ranges; never more than 255 rows a thread (its counter
    bytes)."""
    got = host_lib.host_item_rows(n, held)
    assert got == rows
    assert got % 32 == 0 and got <= 255 * 32
    splits = -(-n // got)
    strips = max(1, (12 << 20) // (n * 128))
    assert -(-held // splits) <= strips + 1


@pytest.mark.parametrize("rows,fanout,want", [
    (352, 14, 352), (384, 15, 384), (512, 17, 512), (256, 16, 256),
    (8_160, 14, 704), (352, 40, 256), (96, 40, 96), (352, 512, 32),
    (32, 512, 32), (8_160, 1, 8_160)])
def test_staged_rows_rule(host_lib, rows, fanout, want):
    """K2's items keep their staged sender ids within 40 KB of shared
    memory, cut in whole steps of 32 rows and never below one step: the
    main paths' items (F = 14-17) are not cut; F = 512 takes one step."""
    got = host_lib.host_staged_rows(rows, fanout)
    assert got == want
    assert got % 32 == 0 or got == rows
    assert got == 32 or got * fanout * 4 <= 40 << 10
