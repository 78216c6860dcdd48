"""Host builds of the suspect forms and of K5 (csrc/*.cuh).

g++ compiles a small harness from the kernels' own headers, and ``ctypes``
runs it over numpy inputs:

* ``merge_elem<true>`` (the SWIM epilogue of K2, K4 and K5) over a corner
  grid (every age|status byte, SUSPECT included, both receiver states, the
  lane types' extremes and floor sentinels, deep and far shifts) equals
  ``epilogue_plain(suspect=True)``, ``refuted`` and ``held`` included;
* ``rr_tick_sus`` and ``rr_merge_t<true>`` (the resident round's SWIM
  stages) over every int8 value, Lifeguard bit mixed, equal
  ``tick_sus_plain`` and ``merge_plain(suspect=True)``;
* a host replay of K5's stripe walk through its own per-thread bodies
  (csrc/merge_stripe.cuh: the cluster's parks and count blocks as host
  arrays, its threads one after another) equals
  ``stripe_merge_update_plain``: every hb lane type, suspicion and
  detection stats on and off, ragged N, column blocks, senders outside
  [0, N), the 16-byte and the element path;
* a host replay of the resident round's two passes in the suspicion +
  Lifeguard form equals ``resident_round_plain``.
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

from gossipfs_tpu_torch.ops import merge, merge_update as mu
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
#include "merge_elem.cuh"
#include "merge_stripe.cuh"
#include "rr_elem.cuh"

extern "C" void host_epilogue_sus(int m, const int32_t* best,
                                  const int32_t* hb, const int8_t* asl,
                                  const uint8_t* recv, const int32_t* sa,
                                  const int32_t* sb, int lo, int hi,
                                  int age_clamp, int32_t* hb_out,
                                  int8_t* asl_out, uint8_t* flags_out) {
  for (int i = 0; i < m; ++i) {
    MeOut o = merge_elem<true>(best[i], hb[i], asl[i], recv[i], sa[i], sb[i],
                               lo, hi, age_clamp);
    hb_out[i] = o.hb; asl_out[i] = (int8_t)o.asl;
    flags_out[i] = o.listed | o.fresh << 1 | o.refuted << 2 | o.held << 3;
  }
}

extern "C" void host_tick_sus(int m, const int8_t* hb, const int8_t* asl,
                              const uint8_t* bits, const int8_t* thr_g,
                              int t_fail, int t_cooldown, int thr, int thr_hi,
                              int8_t* hb_out, int8_t* asl_out,
                              uint8_t* flags_out) {
  for (int i = 0; i < m; ++i) {
    RrTickSus t = rr_tick_sus(hb[i], asl[i], bits[i] & 1, bits[i] & 2,
                              bits[i] & 4, bits[i] & 8, thr_g[i], t_fail,
                              t_cooldown, thr, thr_hi);
    hb_out[i] = (int8_t)t.hb; asl_out[i] = (int8_t)t.asl;
    flags_out[i] = t.fail | t.elig << 1 | t.entered << 2;
  }
}

extern "C" void host_merge_sus(int m, const int8_t* hb, const int8_t* asl,
                               const int8_t* best, const uint8_t* recv,
                               const int8_t* vecs, int age_clamp,
                               int8_t* hb_out, int8_t* asl_out,
                               uint8_t* refuted) {
  for (int i = 0; i < m; ++i) {
    int v[N_VEC];
    for (int k = 0; k < N_VEC; ++k) v[k] = vecs[i * N_VEC + k];
    RrMerge r = rr_merge_t<true>(hb[i], asl[i], best[i], recv[i], v,
                                 age_clamp);
    hb_out[i] = (int8_t)r.hb; asl_out[i] = (int8_t)r.asl;
    refuted[i] = r.refuted;
  }
}

static void copy16(int8_t* d, const int8_t* s) { std::memcpy(d, s, 16); }

// stripe_merge.cu (K5) replayed stripe by stripe, the cluster's parks and
// count blocks as host arrays and its threads one after another, through
// merge_stripe.cuh's per-thread bodies: each CTA parks its round-robin rows
// of the 32-column stripe (stage_seg), then every thread of every CTA
// sweeps its receiver rows (gather_edges over the parks, merge_seg), its
// counter bytes summed into its CTA's block; finish sums the blocks.
// kVec: the 16-byte path (nc % 16 == 0).  edges are int16 [n, fanout], as
// the kernel reads them.  out = [5, nc] int32, every entry written.
template <typename H, bool kVec, bool kSus, bool kDet>
static void host_stripe_t(int n, int nc, int fanout, const int8_t* view,
                          const int16_t* edges, H* hb, int8_t* asl,
                          const int32_t* sa, const int32_t* sb,
                          const uint8_t* alive, int detect, int32_t* out) {
  using namespace mstripe;
  constexpr int kE = 16;
  const int rb = stripe_row_bytes(n), lanes = rb / kSegBytes;
  const int step_rows = kThreads / lanes;
  const int span = cta_rows(n);
  std::vector<int8_t> park((size_t)kCtas * span * rb);
  int8_t none[kMaxRowBytes];
  std::memset(none, 0xFF, kMaxRowBytes);
  std::vector<int32_t> blocks((size_t)kCtas * kBlockInts);
  for (int col0 = 0; col0 < nc; col0 += rb) {
    int32_t shifts[2][kMaxCols];
    for (int c = 0; c < rb; ++c) {
      shifts[0][c] = col0 + c < nc ? sa[col0 + c] : 0;
      shifts[1][c] = col0 + c < nc ? sb[col0 + c] : 0;
    }
    for (int q = 0; q < kCtas; ++q) {
      int8_t* pk = &park[(size_t)q * span * rb];
      for (int i = 0; i < rr_rows(n, q) * lanes; ++i)
        stage_seg<int8_t, kVec>(view, nc, col0, rr_global(q, i / lanes),
                                i % lanes, pk + (size_t)i * kSegBytes,
                                copy16);
      for (int i = 0; i < kBlockInts; ++i)
        blocks[(size_t)q * kBlockInts + i] = blank_count(i, n);
    }
    for (int q = 0; q < kCtas; ++q)
      for (int t = 0; t < kThreads; ++t) {
        const int h = t % lanes, col = col0 + h * kE;
        const int valid = kVec ? (col < nc ? kE : 0)
                               : std::max(0, std::min(kE, nc - col));
        Counts<kE> cn;
        clear(cn);
        int step = 0;
        for (int li = t / lanes; valid > 0 && li < rr_rows(n, q);
             li += step_rows, ++step) {
          const int row = rr_global(q, li);
          const bool recv = alive[row] != 0;
          const size_t off = (size_t)row * nc + col;
          Lanes<H, kE> ld;
          load_lanes<H, kE, kVec>(hb + off, asl + off, valid, ld);
          auto addr = [&](int s) -> const int8_t* {
            if (s < 0) return none + h * kSegBytes;
            return &park[((size_t)(s & (kCtas - 1)) * span +
                          (s >> kCtasLog)) * rb + h * kSegBytes];
          };
          auto load = [](const int8_t* a) { return onepass::load_seg(a); };
          // the 16-byte path reads odd batches from the view itself
          auto gaddr = [&](int s) -> const int8_t* {
            if (!kVec) return addr(s);
            return s < 0 ? nullptr : view + (size_t)s * nc + col;
          };
          auto gload = [](const int8_t* a) {
            return a ? onepass::load_seg(a) : onepass::splat(0xFFFFFFFFu);
          };
          const Ids ids = load_ids(edges, row, n, fanout, 0);
          const Seg best =
              recv ? gather_edges(ids, edges, row, n, fanout, addr, load,
                                  gaddr, gload)
                   : onepass::splat(0xFFFFFFFFu);
          merge_seg<int8_t, H, kSus, kDet, kVec, kE>(
              best, ld, valid, shifts[0] + h * kE, shifts[1] + h * kE, recv,
              63, step, cn);
          store_lanes<H, kE, kVec>(hb + off, asl + off, valid, ld);
        }
        int32_t* blk = &blocks[(size_t)q * kBlockInts];
        for (int j = 0; j < kE; ++j) {
          const int c = h * kE + j;
          blk[kOutCnt * kMaxCols + c] += count_at(cn.cnt, j);
          blk[kOutDet * kMaxCols + c] += count_at(cn.det, j);
          blk[kOutRef * kMaxCols + c] += count_at(cn.ref, j);
          blk[kOutHeld * kMaxCols + c] += count_at(cn.held, j);
          if (first_step(cn, j) >= 0) {
            const int r =
                rr_global(q, first_step(cn, j) * step_rows + t / lanes);
            int32_t& fo = blk[kOutFobs * kMaxCols + c];
            fo = std::min(fo, r);
          }
        }
      }
    for (int s = 0; s < (kSus ? kOuts : 3); ++s)
      for (int c = 0; c < rb && col0 + c < nc; ++c)
        out[(size_t)s * nc + col0 + c] = output_value(
            s, finish(s, c, [&](int q) { return &blocks[(size_t)q * kBlockInts]; }),
            detect != 0);
  }
}

template <typename H>
static void host_stripe_h(int vec, int suspect, int n, int nc, int fanout,
                          const int8_t* view, const int16_t* edges, void* hb,
                          int8_t* asl, const int32_t* sa, const int32_t* sb,
                          const uint8_t* alive, int detect, int32_t* out) {
  H* h = static_cast<H*>(hb);
#define HS_ARGS n, nc, fanout, view, edges, h, asl, sa, sb, alive, detect, out
#define HS_DET(v, s) \
  detect ? host_stripe_t<H, v, s, true>(HS_ARGS) \
         : host_stripe_t<H, v, s, false>(HS_ARGS)
  if (vec)
    suspect ? HS_DET(true, true) : HS_DET(true, false);
  else
    suspect ? HS_DET(false, true) : HS_DET(false, false);
#undef HS_DET
#undef HS_ARGS
}

extern "C" void host_stripe(int hb_bytes, int vec, int suspect, int n, int nc,
                            int fanout, const int8_t* view,
                            const int16_t* edges, void* hb, int8_t* asl,
                            const int32_t* sa, const int32_t* sb,
                            const uint8_t* alive, int detect, int32_t* out) {
#define HS_ARGS vec, suspect, n, nc, fanout, view, edges, hb, asl, sa, sb, \
                alive, detect, out
  if (hb_bytes == 1) host_stripe_h<int8_t>(HS_ARGS);
  if (hb_bytes == 2) host_stripe_h<int16_t>(HS_ARGS);
  if (hb_bytes == 4) host_stripe_h<int32_t>(HS_ARGS);
#undef HS_ARGS
}

extern "C" int host_stripe_row_bytes(int n) {
  return mstripe::stripe_row_bytes(n);
}

// resident_round.cu's suspicion + Lifeguard form replayed: out = [8, n]
// member_cnt, n_det, first_obs, recv_cnt, entered, refuted, held,
// suspect_cnt.  vecs: [N_VEC, n].
extern "C" void host_round_sus(int n, int fanout, int8_t* hb, int8_t* asl,
                               const int8_t* flags, const int8_t* vecs,
                               const int32_t* bases, int t_fail,
                               int t_cooldown, int thr, int thr_hi,
                               int32_t* out) {
  const int nb = n / 8;
  int8_t* gmax = new int8_t[(size_t)nb * n];
  for (int j = 0; j < 8 * n; ++j) out[j] = 0;
  for (int j = 0; j < n; ++j) out[2 * n + j] = n;
  for (int grp = 0; grp < nb; ++grp)
    for (int c = 0; c < n; ++c) {
      int gm = -128;
      for (int r = grp * 8; r < grp * 8 + 8; ++r) {
        const size_t o = (size_t)r * n + c;
        RrTickSus t = rr_tick_sus(hb[o], asl[o], flags[r] & 1, flags[r] & 2,
                                  r == c, flags[r] & 16,
                                  vecs[V_THR_G * n + c], t_fail, t_cooldown,
                                  thr, thr_hi);
        hb[o] = (int8_t)t.hb; asl[o] = (int8_t)t.asl;
        gm = std::max(gm, rr_view(t.hb, t.elig, flags[r] & 1,
                                  vecs[V_SA_N * n + c],
                                  vecs[V_SA_ALL * n + c],
                                  vecs[V_HI_N * n + c]));
        if (t.fail) {
          out[n + c] += 1;
          out[2 * n + c] = std::min(out[2 * n + c], r);
        }
        out[4 * n + c] += t.entered;
      }
      gmax[(size_t)grp * n + c] = (int8_t)gm;
    }
  for (int r = 0; r < n; ++r) {
    const bool recv = flags[r] & 4;
    const int g0 = bases[r] / 8;
    for (int c = 0; c < n; ++c) {
      int best = gmax[(size_t)g0 * n + c];
      for (int w = 1; w < fanout / 8; ++w)
        best = std::max(best, (int)gmax[(size_t)((g0 + w) % nb) * n + c]);
      int v[N_VEC];
      for (int k = 0; k < N_VEC; ++k) v[k] = vecs[k * n + c];
      const size_t o = (size_t)r * n + c;
      RrMerge m = rr_merge_t<true>(hb[o], asl[o], best, recv, v, 63);
      hb[o] = (int8_t)m.hb; asl[o] = (int8_t)m.asl;
      const int st = m.asl & 3;
      const int listed = st & 1;
      out[c] += recv && listed;
      out[3 * n + r] += listed;
      out[5 * n + c] += m.refuted;
      out[6 * n + c] += st == RR_SUSPECT;
      out[7 * n + r] += st == RR_SUSPECT;
    }
  }
  delete[] gmax;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("suspicion_host")
    src, lib = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def call(fn, *args):
    fn(*[a.ctypes.data_as(ctypes.c_void_p) if isinstance(a, np.ndarray)
         else ctypes.c_int(a) for a in args])


def i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int32))


def bits(flags: np.ndarray, k: int) -> np.ndarray:
    return ((flags >> k) & 1).astype(bool)


@pytest.mark.parametrize("lane", ["int8", "int16", "int32"])
def test_suspect_epilogue_matches_plain_over_corner_grid(host_lib, lane):
    info = torch.iinfo(getattr(torch, lane))
    lo, hi = info.min, info.max
    glo, ghi = {"int8": (-128, 127), "int16": (-32768, 32767),
                "int32": (-2**30, 2**30)}[lane]
    best = [-1, 0, 1, 126, 127, 16_384]
    hb = sorted({glo, glo + 1, -1, 0, 1, 126, ghi - 1, ghi})
    asl = list(range(-128, 128))          # every age|status byte
    sa = [-70_000, -1, 0, 1, 200]
    sb = [-16_300, 0, 1, 126]
    grid = np.array(list(itertools.product(best, hb, asl, (0, 1), sa, sb)),
                    dtype=np.int64).T
    m = grid.shape[1]
    b, h, a, r, s_a, s_b = (np.ascontiguousarray(g) for g in grid)
    b, h, s_a, s_b = (x.astype(np.int32) for x in (b, h, s_a, s_b))
    a, r = a.astype(np.int8), r.astype(np.uint8)
    outs = [np.empty(m, np.int32), np.empty(m, np.int8),
            np.empty(m, np.uint8)]
    call(host_lib.host_epilogue_sus, m, b, h, a, r, s_a, s_b, lo, hi, 63,
         *outs)
    want = mu.epilogue_plain(i32(b), i32(h), i32(a), torch.from_numpy(r != 0),
                             i32(s_a), i32(s_b), lo, hi, 63, suspect=True)
    np.testing.assert_array_equal(outs[0], want[0].numpy(), err_msg="hb")
    np.testing.assert_array_equal(outs[1].astype(np.int32), want[1].numpy(),
                                  err_msg="asl")
    for k, name in enumerate(("listed", "fresh", "refuted", "held")):
        np.testing.assert_array_equal(bits(outs[2], k), want[2 + k].numpy(),
                                      err_msg=name)
    assert bits(outs[2], 2).any() and bits(outs[2], 3).any()


@pytest.mark.parametrize("t_fail,t_suspect,lh", [(3, 2, 4), (5, 1, 0),
                                                 (1, 20, 2)])
def test_suspicion_tick_stage_matches_plain(host_lib, t_fail, t_suspect, lh):
    rng = np.random.default_rng(t_fail * 7 + lh)
    m = 200_000
    hb = rng.integers(-128, 128, m, dtype=np.int8)
    hb[rng.random(m) < 0.1] = -128
    asl = rng.integers(-128, 128, m, dtype=np.int8)   # every age|status byte
    fl = rng.integers(0, 16, m, dtype=np.uint8)       # act, ref, eye, lh
    thr_g = rng.integers(-128, 128, m, dtype=np.int8)
    thr, thr_hi = t_fail + t_suspect, t_fail + t_suspect * (1 + lh)
    outs = [np.empty(m, np.int8), np.empty(m, np.int8), np.empty(m, np.uint8)]
    call(host_lib.host_tick_sus, m, hb, asl, fl, thr_g, t_fail, 12, thr,
         thr_hi, *outs)
    t = torch.from_numpy
    want = merge.tick_sus_plain(
        i32(hb), i32(asl), t(bits(fl, 0)), t(bits(fl, 1)), t(bits(fl, 2)),
        t(bits(fl, 3)), i32(thr_g), t_fail, 12, thr, thr_hi)
    np.testing.assert_array_equal(outs[0].astype(np.int32), want[0].numpy())
    np.testing.assert_array_equal(outs[1].astype(np.int32), want[1].numpy())
    for k, name in enumerate(("fail", "elig", "entered")):
        np.testing.assert_array_equal(bits(outs[2], k), want[2 + k].numpy(),
                                      err_msg=name)
        assert bits(outs[2], k).any(), name


def test_suspicion_merge_stage_matches_plain(host_lib):
    rng = np.random.default_rng(5)
    m = 200_000
    hb = rng.integers(-128, 128, m, dtype=np.int8)
    asl = rng.integers(-128, 128, m, dtype=np.int8)
    best = rng.integers(-128, 128, m, dtype=np.int8)
    recv = rng.integers(0, 2, m, dtype=np.uint8)
    vecs = rng.integers(-128, 128, (m, merge.N_VEC), dtype=np.int8)
    vecs[:, merge.V_HAS_HI] = rng.integers(0, 2, m)
    outs = [np.empty(m, np.int8), np.empty(m, np.int8), np.empty(m, np.uint8)]
    call(host_lib.host_merge_sus, m, hb, asl, best, recv, vecs, 63, *outs)
    want = merge.merge_plain(i32(hb), i32(asl), i32(best),
                             torch.from_numpy(recv != 0),
                             i32(vecs.T.copy()), 63, suspect=True)
    np.testing.assert_array_equal(outs[0].astype(np.int32), want[0].numpy())
    np.testing.assert_array_equal(outs[1].astype(np.int32), want[1].numpy())
    np.testing.assert_array_equal(outs[2] != 0, want[2].numpy())
    assert outs[2].any()


def stripe_inputs(n: int, nc: int, fanout: int, hd, suspect: bool,
                  seed: int):
    """One K5 call's inputs over an [n, nc] block, made with numpy: dead
    receivers (their view rows absent), floor sentinels, fresh detections,
    SUSPECT entries under ``suspect``."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(hd)
    view = rng.integers(-1, 127, (n, nc)).astype(np.int8)
    alive = rng.random(n) < 0.8
    view[~alive] = -1
    hb = rng.integers(info.min, info.max + 1, (n, nc)).astype(hd)
    hb[rng.random((n, nc)) < 0.05] = info.min
    age = rng.integers(0, 64, (n, nc))
    age[rng.random((n, nc)) < 0.2] = 0
    status = rng.integers(0, 4 if suspect else 3, (n, nc))
    asl = pack_age_status(torch.from_numpy(age),
                          torch.from_numpy(status)).numpy()
    sa = rng.integers(-300, 300, nc).astype(np.int32)
    sb = rng.integers(-300, 300, nc).astype(np.int32)
    edges = rng.integers(0, n, (n, fanout)).astype(np.int32)
    return rng, view, edges, hb, asl, sa, sb, alive


def check_stripe(host_lib, view, edges16, ref_edges, hb, asl, sa, sb, alive,
                 detect: bool, suspect: bool) -> None:
    """K5's host replay (the 16-byte path where nc % 16 == 0, and the
    element path) against stripe_merge_update_plain over ``ref_edges``."""
    n, nc = hb.shape
    t = torch.from_numpy
    want = mu.stripe_merge_update_plain(
        t(view), t(ref_edges), t(hb.copy()), t(asl.copy()), t(sa), t(sb),
        t(alive), detect_stats=detect, suspect=suspect)
    names = ("hb", "asl", "cnt", "n_det", "first_obs", "refuted", "held")
    for vec in ((0, 1) if nc % 16 == 0 else (0,)):
        h, a = hb.copy(), asl.copy()
        out = np.full((5, nc), -7, np.int32)
        call(host_lib.host_stripe, hb.itemsize, vec, int(suspect), n, nc,
             edges16.shape[1], view, np.ascontiguousarray(edges16), h, a, sa,
             sb, alive.astype(np.uint8), int(detect), out)
        got = [h, a, *out[:5 if suspect else 3]]
        assert len(got) == len(want)
        for name, o, w in zip(names, got, want):
            np.testing.assert_array_equal(o, w.numpy(),
                                          err_msg=f"{name}, vec={vec}")


@pytest.mark.parametrize("suspect", [False, True], ids=["off", "suspect"])
@pytest.mark.parametrize("detect", [False, True], ids=["nostats", "stats"])
@pytest.mark.parametrize("n,fanout,hd", [(96, 14, np.int8),
                                         (70, 5, np.int16)])
def test_host_stripe_replay_matches_plain(host_lib, n, fanout, hd, detect,
                                          suspect):
    """K5's stripe walk (merge_stripe.cuh, cluster as host arrays), N a
    multiple of 16 (the 16-byte path too) and a ragged N (the last stripe
    part empty), against the plain version."""
    _, view, edges, hb, asl, sa, sb, alive = stripe_inputs(
        n, n, fanout, hd, suspect, n + fanout)
    check_stripe(host_lib, view, edges.astype(np.int16), edges, hb, asl, sa,
                 sb, alive, detect, suspect)


@pytest.mark.parametrize("suspect", [False, True], ids=["off", "suspect"])
@pytest.mark.parametrize("detect", [False, True], ids=["nostats", "stats"])
@pytest.mark.parametrize("hd", [np.int8, np.int16, np.int32],
                         ids=["hb8", "hb16", "hb32"])
@pytest.mark.parametrize("n,nc,fanout", [(83, 83, 6), (130, 36, 9),
                                         (128, 48, 16), (28_000, 20, 5)])
def test_host_stripe_park_matches_plain(host_lib, n, nc, fanout, hd, detect,
                                        suspect):
    """Every hb lane type x suspicion x detection stats: N not a multiple
    of 8 (83, 130), column blocks C < N with C % 16 != 0 (36, 20: the
    element path) and C % 16 == 0 (48: the 16-byte path, a stripe part
    empty), and 64-byte park rows (N = 28,000)."""
    _, view, edges, hb, asl, sa, sb, alive = stripe_inputs(
        n, nc, fanout, hd, suspect, n * nc + fanout)
    check_stripe(host_lib, view, edges.astype(np.int16), edges, hb, asl, sa,
                 sb, alive, detect, suspect)


@pytest.mark.parametrize("suspect", [False, True], ids=["off", "suspect"])
@pytest.mark.parametrize("n,nc", [(75, 75), (96, 40)])
def test_host_stripe_absent_senders(host_lib, n, nc, suspect):
    """Senders outside [0, N) count as absent: the replay over edges with
    -1, N, N + 7 and 32,767 equals the plain version over edges that name
    a dead receiver (its view row all -1) in their place."""
    rng, view, edges, hb, asl, sa, sb, alive = stripe_inputs(
        n, nc, 7, np.int16, suspect, n + nc)
    bad = rng.random(edges.shape) < 0.3
    edges16 = edges.astype(np.int16)
    edges16[bad] = rng.choice(np.array([-1, n, n + 7, 32_767], np.int16),
                              int(bad.sum()))
    edges16[0] = -1                   # a receiver with no sender at all
    ref = edges.copy()
    ref[edges16 != edges] = int(np.flatnonzero(~alive)[0])
    assert (ref != edges).any()
    check_stripe(host_lib, view, edges16, ref, hb, asl, sa, sb, alive, True,
                 suspect)


def test_stripe_fit_rule_matches_header(host_lib):
    """The wrapper's route limit is a shape the kernel's park holds: 128-
    byte park rows at the main paths' N = 16,384, 64 up to the int16
    edges' N (32,767), none past ~104,000 rows."""
    assert host_lib.host_stripe_row_bytes(16_384) == 128
    assert host_lib.host_stripe_row_bytes(mu.STRIPE_MAX_N) == 64
    assert host_lib.host_stripe_row_bytes(32_767) == 64
    assert host_lib.host_stripe_row_bytes(100_000) == 32
    assert host_lib.host_stripe_row_bytes(200_000) == 0


def test_host_suspicion_round_matches_resident_round_plain(host_lib):
    n, fanout, t_fail, t_suspect, lh = 256, 16, 3, 2, 3
    rng = np.random.default_rng(n)
    hb = rng.integers(-128, 128, (n, n), dtype=np.int8)
    hb[rng.random((n, n)) < 0.05] = -128
    age = rng.integers(0, 16, (n, n))
    asl = ((age << 2 | rng.integers(0, 4, (n, n))) - 128).astype(np.int8)
    flags = rng.integers(0, 32, n).astype(np.int8)
    sa = rng.integers(-260, 60, n)
    g = rng.integers(-200, 60, n)
    vecs = merge.threshold_stack(i32(sa), i32(sa), i32(g), 126).numpy()
    bases = (rng.integers(0, n // 8, n) * 8).astype(np.int32)
    want = merge.resident_round_plain(
        torch.from_numpy(hb.copy()), torch.from_numpy(asl.copy()),
        torch.from_numpy(flags), torch.from_numpy(vecs),
        torch.from_numpy(bases), fanout=fanout, arc_align=8, t_fail=t_fail,
        t_cooldown=12, suspect=True, t_suspect=t_suspect, lh_multiplier=lh)
    h, a = hb.copy(), asl.copy()
    out = np.empty((8, n), np.int32)
    call(host_lib.host_round_sus, n, fanout, h, a, flags,
         np.ascontiguousarray(vecs), bases, t_fail, 12, t_fail + t_suspect,
         t_fail + t_suspect * (1 + lh), out)
    names = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt",
             "entered", "refuted", "held", "suspect_cnt")
    for name, o, w in zip(names, [h, a, *out], want):
        np.testing.assert_array_equal(o, w.numpy(), err_msg=name)
    assert all(o.any() for o in out)
