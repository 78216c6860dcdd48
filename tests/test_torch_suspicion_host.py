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
* a host replay of K5's strip loop (the view strip staged as packed words,
  the per-byte signed max over the senders' words, the epilogue, the
  block's reductions) equals ``stripe_merge_update_plain``, suspicion and
  detection stats on and off, a ragged N included;
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
#include "merge_elem.cuh"
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

// per-byte signed max of two packed words (the device's __vmaxs4)
static int vmaxs4(int a, int b) {
  int8_t x[4], y[4];
  std::memcpy(x, &a, 4);
  std::memcpy(y, &b, 4);
  for (int k = 0; k < 4; ++k) x[k] = std::max(x[k], y[k]);
  int r;
  std::memcpy(&r, x, 4);
  return r;
}

// stripe_merge.cu replayed block by block: a strip of 8 columns, staged
// as two packed words per receiver row (absent beyond N), then the sweep
// (two halves of 4 subjects per row) and the strip's reductions.  edges
// are int16 [n, fanout], as the kernel reads them.  out = [5, n] int32,
// every entry written.
template <typename H>
static void host_stripe(int n, int fanout, const int8_t* view,
                        const int16_t* edges, H* hb, int8_t* asl,
                        const int32_t* sa, const int32_t* sb,
                        const uint8_t* alive, int detect, int suspect,
                        int32_t* out) {
  int* strip = new int[(size_t)n * 2];
  for (int c0 = 0; c0 < n; c0 += 8) {
    for (int r = 0; r < n; ++r)
      for (int h = 0; h < 2; ++h) {
        int8_t b[4];
        for (int k = 0; k < 4; ++k) {
          const int col = c0 + 4 * h + k;
          b[k] = col < n ? view[(size_t)r * n + col] : -1;
        }
        std::memcpy(&strip[r * 2 + h], b, 4);
      }
    int cnt[8] = {0}, nd[8] = {0}, fo[8], rf[8] = {0}, hd[8] = {0};
    for (int j = 0; j < 8; ++j) fo[j] = n;
    for (int row = 0; row < n; ++row)
      for (int h = 0; h < 2; ++h) {
        const bool recv = alive[row] != 0;
        int bw = -1;
        if (recv)
          for (int f = 0; f < fanout; ++f) {
            const int s = edges[(size_t)row * fanout + f];
            if ((unsigned)s < (unsigned)n) bw = vmaxs4(bw, strip[s * 2 + h]);
          }
        int8_t best[4];
        std::memcpy(best, &bw, 4);
        for (int k = 0; k < 4; ++k) {
          const int col = c0 + 4 * h + k;
          if (col >= n) continue;
          const size_t o = (size_t)row * n + col;
          MeOut m = suspect
              ? merge_elem<true>(best[k], hb[o], asl[o], recv, sa[col],
                                 sb[col], MeLim<H>::lo, MeLim<H>::hi, 63)
              : merge_elem<false>(best[k], hb[o], asl[o], recv, sa[col],
                                  sb[col], MeLim<H>::lo, MeLim<H>::hi, 63);
          hb[o] = (H)m.hb; asl[o] = (int8_t)m.asl;
          const int j = 4 * h + k;
          cnt[j] += recv && m.listed;
          if (m.fresh) { nd[j] += 1; fo[j] = std::min(fo[j], row); }
          rf[j] += m.refuted;
          hd[j] += m.held;
        }
      }
    for (int j = 0; j < 8 && c0 + j < n; ++j) {
      const int col = c0 + j;
      out[col] = cnt[j];
      out[n + col] = detect ? nd[j] : 0;
      out[2 * n + col] = detect ? fo[j] : 0;
      out[3 * n + col] = rf[j];
      out[4 * n + col] = hd[j];
    }
  }
  delete[] strip;
}

extern "C" void host_stripe_i8(int n, int fanout, const int8_t* view,
                               const int16_t* edges, int8_t* hb, int8_t* asl,
                               const int32_t* sa, const int32_t* sb,
                               const uint8_t* alive, int detect, int suspect,
                               int32_t* out) {
  host_stripe<int8_t>(n, fanout, view, edges, hb, asl, sa, sb, alive, detect,
                      suspect, out);
}

extern "C" void host_stripe_i16(int n, int fanout, const int8_t* view,
                                const int16_t* edges, int16_t* hb,
                                int8_t* asl, const int32_t* sa,
                                const int32_t* sb, const uint8_t* alive,
                                int detect, int suspect, int32_t* out) {
  host_stripe<int16_t>(n, fanout, view, edges, hb, asl, sa, sb, alive,
                       detect, suspect, out);
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


@pytest.mark.parametrize("suspect", [False, True], ids=["off", "suspect"])
@pytest.mark.parametrize("detect", [False, True], ids=["nostats", "stats"])
@pytest.mark.parametrize("n,fanout,hd", [(96, 14, np.int8),
                                         (70, 5, np.int16)])
def test_host_stripe_replay_matches_plain(host_lib, n, fanout, hd, detect,
                                          suspect):
    """K5's strip loop, N a multiple of 8 and a ragged N (the last strip
    half empty), against the plain version."""
    rng = np.random.default_rng(n + fanout)
    info = np.iinfo(hd)
    view = rng.integers(-1, 127, (n, n)).astype(np.int8)
    alive = rng.random(n) < 0.8
    view[~alive] = -1
    hb = rng.integers(info.min, info.max + 1, (n, n)).astype(hd)
    hb[rng.random((n, n)) < 0.05] = info.min
    age = rng.integers(0, 64, (n, n))
    age[rng.random((n, n)) < 0.2] = 0
    status = rng.integers(0, 4 if suspect else 3, (n, n))
    asl = pack_age_status(torch.from_numpy(age),
                          torch.from_numpy(status)).numpy()
    sa = rng.integers(-300, 300, n).astype(np.int32)
    sb = rng.integers(-300, 300, n).astype(np.int32)
    edges = rng.integers(0, n, (n, fanout)).astype(np.int32)
    t = torch.from_numpy
    want = mu.stripe_merge_update_plain(
        t(view), t(edges), t(hb.copy()), t(asl.copy()), t(sa), t(sb),
        t(alive), detect_stats=detect, suspect=suspect)
    h, a = hb.copy(), asl.copy()
    out = np.empty((5, n), np.int32)
    fn = host_lib.host_stripe_i8 if hd == np.int8 else host_lib.host_stripe_i16
    call(fn, n, fanout, view, edges.astype(np.int16), h, a, sa, sb,
         alive.astype(np.uint8), int(detect), int(suspect), out)
    got = [h, a, *out[:5 if suspect else 3]]
    names = ("hb", "asl", "cnt", "n_det", "first_obs", "refuted", "held")
    assert len(got) == len(want)
    for name, o, w in zip(names, got, want):
        np.testing.assert_array_equal(o, w.numpy(), err_msg=name)


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
