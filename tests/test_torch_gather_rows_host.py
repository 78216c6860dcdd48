"""Host build of the F-row gather-maxes (csrc/gather_ring.cuh, rr_onepass.cuh).

K1 (csrc/fanout_max.cu) gathers through ``gather_ring.cuh`` (the ring that
K2 shares: 16 bytes a thread of a 128-byte stripe, a receiver's senders
copied into shared memory ahead of the fold), and the explicit-edge and
plain-arc merge passes of the resident round (both K3 forms,
csrc/resident_round.cu and rr_onepass.cu) through ``rr_onepass.cuh``'s
``gather_rows``, 16 bytes a row; both headers are ``__host__ __device__``
code.  Here g++ compiles a small harness from the same headers; ``ctypes``
runs it over numpy inputs:

* K1 replayed item by item (a stripe of columns by a range of receiver
  rows, its 256 threads one after another through ``fx_thread``, the ring
  in a host array) must equal ``fanout_max_merge_plain`` for every view
  type, on the 16-byte and the element path, over several items a stripe,
  fanouts of several ring chunks and senders outside [0, N);
* a host replay of the resident round's explicit-edge and plain-arc forms
  (pass A writing the whole encoded view, pass B gathering each live
  receiver's F sender rows 16 bytes at a time, the epilogue and the
  reductions) must equal ``resident_round_plain`` on whole rounds.
This catches slips in the gathers and their row indexing before the card
runs the kernels.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from gossipfs_tpu_torch.ops import fanout_max as fx
from gossipfs_tpu_torch.ops import merge

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "gossipfs_tpu_torch" / "csrc"

HARNESS = r"""
#include <cstdint>
#include <algorithm>
#include <cstring>
#include <vector>
#include "gather_ring.cuh"
#include "rr_onepass.cuh"
#include "rr_elem.cuh"

static void copy16(int8_t* d, const int8_t* s) { std::memcpy(d, s, 16); }

// fanout_max.cu's kernel replayed item by item: items of ``rows`` receiver
// rows by a 128-byte stripe, every thread's fx_thread.
template <typename T, bool kVec>
static void k1(const T* view, const int32_t* edges, T* out, int n,
               int fanout, int rows) {
  constexpr int cols = gring::kLanes * (mstripe::kSegBytes / sizeof(T));
  std::vector<int8_t> ring(gring::ring_bytes(gring::plan(fanout).chunk));
  for (int col0 = 0; col0 < n; col0 += cols)
    for (int r0 = 0; r0 < n; r0 += rows)
      for (int t = 0; t < gring::kThreads; ++t)
        gring::fx_thread<T, kVec>(view, edges, out, n, fanout, r0,
                                  std::min(rows, n - r0), col0, t,
                                  ring.data(), copy16, [] {}, [] {});
}

template <typename T>
static void k1_v(int vec, const void* view, const int32_t* edges, void* out,
                 int n, int fanout, int rows) {
  if (vec)
    k1<T, true>((const T*)view, edges, (T*)out, n, fanout, rows);
  else
    k1<T, false>((const T*)view, edges, (T*)out, n, fanout, rows);
}

extern "C" void host_k1(int bytes, int vec, const void* view,
                        const int32_t* edges, void* out, int n, int fanout,
                        int rows) {
  if (bytes == 1)
    k1_v<int8_t>(vec, view, edges, out, n, fanout, rows);
  else if (bytes == 2)
    k1_v<int16_t>(vec, view, edges, out, n, fanout, rows);
  else
    k1_v<int32_t>(vec, view, edges, out, n, fanout, rows);
}

// The resident round's full-view forms, replayed: ``arc`` 0 takes
// senders int32 [n, fanout] (explicit edges), 1 arc bases [n].  out =
// [4, n] int32 member_cnt, n_det, first_obs, recv_cnt (crash-only).
extern "C" void host_round_full(int n, int fanout, int arc, int8_t* hb,
                                int8_t* asl, const int8_t* flags,
                                const int8_t* vecs, const int32_t* senders,
                                int t_fail, int t_cooldown, int age_clamp,
                                int32_t* out) {
  int8_t* view = new int8_t[(size_t)n * n];
  int32_t *cnt = out, *ndet = out + n, *fobs = out + 2 * n,
          *rcnt = out + 3 * n;
  for (int j = 0; j < 4 * n; ++j) out[j] = 0;
  for (int j = 0; j < n; ++j) fobs[j] = n;
  for (int r = 0; r < n; ++r)
    for (int c = 0; c < n; ++c) {
      const size_t o = (size_t)r * n + c;
      const bool act = flags[r] & 1, ref = flags[r] & 2;
      RrTick t = rr_tick(hb[o], asl[o], act, ref, r == c,
                         vecs[V_THR_G * n + c], t_fail, t_cooldown);
      hb[o] = (int8_t)t.hb; asl[o] = (int8_t)t.asl;
      view[o] = (int8_t)rr_view(t.hb, t.elig, act, vecs[V_SA_N * n + c],
                                vecs[V_SA_ALL * n + c], vecs[V_HI_N * n + c]);
      if (t.fail) { ndet[c] += 1; fobs[c] = std::min(fobs[c], r); }
    }
  // pass B: each live receiver's F sender rows gathered 16 bytes at a
  // time as the kernel's merge pass does (rr_onepass.cuh gather_rows)
  const onepass::Knobs kn{t_fail, t_cooldown, 0, 0, age_clamp, fanout, 0};
  const uint32_t none[4] = {0x80808080u, 0x80808080u, 0x80808080u,
                            0x80808080u};
  for (int r = 0; r < n; ++r) {
    const bool recv = flags[r] & 4;
    for (int col0 = 0; col0 < n; col0 += 16) {
      auto addr = [&](int s) -> const int8_t* {
        return s < 0 ? reinterpret_cast<const int8_t*>(none)
                     : view + (size_t)s * n + col0;
      };
      auto load = [](const int8_t* p) { return onepass::load_seg(p); };
      onepass::Seg best = onepass::splat(0xFFFFFFFFu);
      if (recv && arc) {
        const auto m = onepass::load_meta<onepass::kFormArc>(flags, senders,
                                                             r, fanout);
        best = onepass::gather_rows<onepass::kFormArc>(m, senders, r, n, kn,
                                                       addr, load);
      } else if (recv) {
        const auto m = onepass::load_meta<onepass::kFormEdges>(
            flags, senders, r, fanout);
        best = onepass::gather_rows<onepass::kFormEdges>(m, senders, r, n,
                                                         kn, addr, load);
      }
      for (int k = 0; k < 16; ++k) {
        const int c = col0 + k;
        int v[N_VEC];
        for (int i = 0; i < N_VEC; ++i) v[i] = vecs[i * n + c];
        const size_t o = (size_t)r * n + c;
        RrMerge m = rr_merge(hb[o], asl[o],
                             swar::byte_at(best.w[k / 4], k % 4), recv, v,
                             age_clamp);
        hb[o] = (int8_t)m.hb; asl[o] = (int8_t)m.asl;
        const int listed = (m.asl & 3) == RR_MEMBER;
        cnt[c] += recv && listed;
        rcnt[r] += listed;
      }
    }
  }
  delete[] view;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("gather_rows")
    src, lib = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def call(fn, *args):
    fn(*[a.ctypes.data_as(ctypes.c_void_p) if isinstance(a, np.ndarray)
         else ctypes.c_int(a) for a in args])


def check_k1(host_lib, view, edges, want, rows: int) -> None:
    """The replay (each path: the 16-byte one where N % 16 == 0) over
    items of ``rows`` receiver rows equals ``want``."""
    n, fanout = edges.shape
    for vec in ((0, 1) if n % 16 == 0 else (0,)):
        out = np.zeros_like(view)
        call(host_lib.host_k1, view.itemsize, vec, view, edges, out, n,
             fanout, rows)
        np.testing.assert_array_equal(out, want, err_msg=f"vec={vec}")


def k1_view(rng, n: int, dtype):
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, (n, n), endpoint=True,
                        dtype=np.int64).astype(dtype)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("n,fanout", [(256, 8), (130, 5)])
def test_k1_loop_matches_plain(host_lib, n, fanout, dtype):
    """K1 over each view type, one item a stripe: N = 256 on both paths,
    a ragged N = 130 on the element path."""
    rng = np.random.default_rng(n + fanout)
    view = k1_view(rng, n, dtype)
    edges = rng.integers(0, n, (n, fanout)).astype(np.int32)
    want = fx.fanout_max_merge_plain(torch.from_numpy(view),
                                     torch.from_numpy(edges)).numpy()
    check_k1(host_lib, view, edges, want, -(-n // 32) * 32)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("n,fanout,rows", [(200, 40, 96), (320, 14, 32),
                                           (97, 1, 32)],
                         ids=["f40", "items", "f1ragged"])
def test_k1_ring_matches_plain(host_lib, n, fanout, rows, dtype):
    """K1 over each view type through several items a stripe, fanouts of
    one and of five ring chunks, with a fifth of the senders outside
    [0, N): those are skipped, which the plain version reads as a row of
    the type's minimum in their place (row 0, named by no other edge)."""
    rng = np.random.default_rng(n * fanout)
    view = k1_view(rng, n, dtype)
    edges = rng.integers(1, n, (n, fanout)).astype(np.int32)
    ref = edges.copy()
    bad = rng.random(edges.shape) < 0.2
    edges[bad] = rng.choice(np.array([-1, n, n + 7, 2**31 - 1], np.int32),
                            int(bad.sum()))
    ref[bad] = 0
    low = view.copy()
    low[0] = np.iinfo(dtype).min
    want = fx.fanout_max_merge_plain(torch.from_numpy(low),
                                     torch.from_numpy(ref)).numpy()
    check_k1(host_lib, view, edges, want, rows)


@pytest.mark.parametrize("form", ["edges", "arc"])
def test_host_round_matches_resident_round_plain(host_lib, form):
    n, fanout = 256, 12
    rng = np.random.default_rng(7 + len(form))
    hb = rng.integers(-128, 128, (n, n), dtype=np.int8)
    hb[rng.random((n, n)) < 0.05] = -128
    age = rng.integers(0, 64, (n, n))
    asl = ((age << 2 | rng.integers(0, 3, (n, n))) - 128).astype(np.int8)
    flags = rng.integers(0, 8, n).astype(np.int8)
    sa = torch.from_numpy(rng.integers(-260, 60, n).astype(np.int32))
    g = torch.from_numpy(rng.integers(-200, 60, n).astype(np.int32))
    vecs = merge.threshold_stack(sa, sa, g, 126).numpy()
    if form == "edges":
        senders = rng.integers(0, n, (n, fanout)).astype(np.int32)
        kw = {}
    else:
        senders = rng.integers(0, n, n).astype(np.int32)
        kw = dict(fanout=fanout, arc_align=1)
    want = merge.resident_round_plain(
        torch.from_numpy(hb.copy()), torch.from_numpy(asl.copy()),
        torch.from_numpy(flags), torch.from_numpy(vecs),
        torch.from_numpy(senders), t_fail=5, t_cooldown=12, **kw)
    h, a = hb.copy(), asl.copy()
    out = np.empty((4, n), np.int32)
    call(host_lib.host_round_full, n, fanout, int(form == "arc"), h, a,
         flags, np.ascontiguousarray(vecs), senders, 5, 12, 63, out)
    names = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt")
    for name, o, w in zip(names, [h, a, *out], want):
        np.testing.assert_array_equal(o, w.numpy(), err_msg=name)
    assert want[3].sum() > 0
