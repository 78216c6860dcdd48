"""Host build of the resident round's ``edge_filter`` forms.

The masked gathers (csrc/rr_onepass.cuh ``gather_groups`` and
``gather_rows`` under the edge_filter forms, 16 bytes a row) and the muted
view encode (csrc/rr_elem.cuh ``rr_sends``) are ``__host__ __device__``
functions of the headers both CUDA forms of K3 (csrc/resident_round.cu,
rr_onepass.cu) are built from.  Here g++ compiles a harness from those
same headers and replays a whole round the way the two-launch kernel's
passes compute it, in both forms:

* ``filter_group`` (arc_align 8): pass A writes the 8-row group maxes
  ``G[n/8, n]``, pass B takes the masked max over the arc's F/8 groups;
* ``filter_rows`` (any other alignment): pass A writes the whole view,
  pass B the masked max over the arc's F rows, row ``f`` kept iff bit
  ``f / arc_align`` is set.

Each must equal ``resident_round_plain(edge_filter=True)`` on every output,
crash-only and with the SWIM lifecycle, with muted rows and zero masks.
This catches slips in the mask indexing, the wrap-around and the mute
before the card runs the kernel.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from gossipfs_tpu_torch.ops import merge

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "gossipfs_tpu_torch" / "csrc"

HARNESS = r"""
#include <cstdint>
#include <algorithm>
#include <vector>
#include "rr_elem.cuh"
#include "rr_onepass.cuh"

// One edge_filter round.  senders int32 [n, 2] (arc base, match mask);
// ``align`` 8 runs the group form, any other power of two the row form.
// out = [7, n] int32: member_cnt, n_det, first_obs, recv_cnt, entered,
// refuted, held (the last three zeros without ``suspect``).
template <bool kSus>
static void round_filter(int n, int fanout, int align, int8_t* hb,
                         int8_t* asl, const int8_t* flags,
                         const int8_t* vecs, const int32_t* senders,
                         int t_fail, int t_cooldown, int confirm,
                         int confirm_hi, int age_clamp, int32_t* out) {
  const bool group = align == 8;
  const int grows = group ? n / 8 : n;
  std::vector<int8_t> g((size_t)grows * n, (int8_t)-128);
  int32_t *cnt = out, *ndet = out + n, *fobs = out + 2 * n,
          *rcnt = out + 3 * n, *ent = out + 4 * n, *refu = out + 5 * n,
          *held = out + 6 * n;
  for (int j = 0; j < 7 * n; ++j) out[j] = 0;
  for (int j = 0; j < n; ++j) fobs[j] = n;
  // pass A: tick, the muted view encode, group max or whole view
  for (int r = 0; r < n; ++r) {
    const int f = flags[r];
    const bool act = f & 1, ref = f & 2, lh = f & 16;
    const bool sends = rr_sends(f, true);
    for (int c = 0; c < n; ++c) {
      const size_t o = (size_t)r * n + c;
      int th, ta;
      bool fail, elig;
      if (kSus) {
        RrTickSus t = rr_tick_sus(hb[o], asl[o], act, ref, r == c, lh,
                                  vecs[V_THR_G * n + c], t_fail, t_cooldown,
                                  confirm, confirm_hi);
        th = t.hb; ta = t.asl; fail = t.fail; elig = t.elig;
        ent[c] += t.entered;
      } else {
        RrTick t = rr_tick(hb[o], asl[o], act, ref, r == c,
                           vecs[V_THR_G * n + c], t_fail, t_cooldown);
        th = t.hb; ta = t.asl; fail = t.fail; elig = t.elig;
      }
      hb[o] = (int8_t)th; asl[o] = (int8_t)ta;
      const int enc = rr_view(th, elig, sends, vecs[V_SA_N * n + c],
                              vecs[V_SA_ALL * n + c], vecs[V_HI_N * n + c]);
      int8_t& slot = g[(size_t)(group ? r / 8 : r) * n + c];
      slot = (int8_t)std::max((int)slot, enc);
      if (fail) { ndet[c] += 1; fobs[c] = std::min(fobs[c], r); }
    }
  }
  int shift = 0;
  while ((1 << shift) < align) ++shift;
  // pass B: the kernel's masked gathers 16 bytes at a time
  // (rr_onepass.cuh gather_groups for the group form, gather_rows for the
  // row form), the epilogue, the reductions
  const onepass::Knobs kn{t_fail, t_cooldown, confirm, confirm_hi,
                          age_clamp, group ? fanout / 8 : fanout, shift};
  const uint32_t none[4] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                            0xFFFFFFFFu};
  for (int r = 0; r < n; ++r) {
    const bool recv = flags[r] & 4;
    for (int col0 = 0; col0 < n; col0 += 16) {
      auto addr = [&](int s) -> const int8_t* {
        return s < 0 ? reinterpret_cast<const int8_t*>(none)
                     : g.data() + (size_t)s * n + col0;
      };
      auto load = [](const int8_t* p) { return onepass::load_seg(p); };
      onepass::Seg best = onepass::splat(0xFFFFFFFFu);
      if (recv && group) {
        const auto m = onepass::load_meta<onepass::kFormFilterGroup>(
            flags, senders, r, kn.width);
        best = onepass::gather_groups<onepass::kFormFilterGroup>(m, n, kn,
                                                                 addr, load);
      } else if (recv) {
        const auto m = onepass::load_meta<onepass::kFormFilterRows>(
            flags, senders, r, kn.width);
        best = onepass::gather_rows<onepass::kFormFilterRows>(
            m, senders, r, n, kn, addr, load);
      }
      for (int k = 0; k < 16; ++k) {
        const int c = col0 + k;
        int v[N_VEC];
        for (int i = 0; i < N_VEC; ++i) v[i] = vecs[i * n + c];
        const size_t o = (size_t)r * n + c;
        RrMerge m = rr_merge_t<kSus>(hb[o], asl[o],
                                     swar::byte_at(best.w[k / 4], k % 4),
                                     recv, v, age_clamp);
        hb[o] = (int8_t)m.hb; asl[o] = (int8_t)m.asl;
        const int st = m.asl & 3;
        const int listed = kSus ? (st & 1) : st == RR_MEMBER;
        cnt[c] += recv && listed;
        rcnt[r] += listed;
        if (kSus) { refu[c] += m.refuted; held[c] += st == RR_SUSPECT; }
      }
    }
  }
}

extern "C" void host_round_filter(int n, int fanout, int align, int suspect,
                                  int8_t* hb, int8_t* asl,
                                  const int8_t* flags, const int8_t* vecs,
                                  const int32_t* senders, int t_fail,
                                  int t_cooldown, int confirm, int confirm_hi,
                                  int age_clamp, int32_t* out) {
  if (suspect)
    round_filter<true>(n, fanout, align, hb, asl, flags, vecs, senders,
                       t_fail, t_cooldown, confirm, confirm_hi, age_clamp,
                       out);
  else
    round_filter<false>(n, fanout, align, hb, asl, flags, vecs, senders,
                        t_fail, t_cooldown, confirm, confirm_hi, age_clamp,
                        out);
}

extern "C" int host_sends(int flags, int edge_filter) {
  return rr_sends(flags, edge_filter != 0);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("edge_filter")
    src, lib = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def call(fn, *args):
    fn(*[a.ctypes.data_as(ctypes.c_void_p) if isinstance(a, np.ndarray)
         else ctypes.c_int(a) for a in args])


def test_rr_sends_truth_table(host_lib):
    for flags in range(32):
        act, muted = bool(flags & 1), bool(flags & 8)
        assert bool(host_lib.host_sends(flags, 1)) == (act and not muted)
        assert bool(host_lib.host_sends(flags, 0)) == act


@pytest.mark.parametrize("suspect", [False, True],
                         ids=["crash-only", "suspicion+lh"])
@pytest.mark.parametrize("n,fanout,align", [(256, 16, 8), (256, 16, 4),
                                            (128, 124, 4), (256, 32, 16)])
def test_host_round_matches_plain(host_lib, n, fanout, align, suspect):
    rng = np.random.default_rng(n + fanout + align + suspect)
    hb = rng.integers(-128, 128, (n, n), dtype=np.int8)
    hb[rng.random((n, n)) < 0.05] = -128
    st = rng.integers(0, 4 if suspect else 3, (n, n))
    age = np.where(st == 3, rng.integers(3, 14, (n, n)),
                   rng.integers(0, 64, (n, n)))
    asl = ((age << 2 | st) - 128).astype(np.int8)
    flags = rng.choice(np.array([0, 4, 5, 5, 6, 1, 7], np.int8), n)
    flags = (flags + 8 * (rng.random(n) < 0.2)
             + 16 * (rng.random(n) < 0.5) * suspect).astype(np.int8)
    sa = torch.from_numpy(rng.integers(-260, 60, n).astype(np.int32))
    g = torch.from_numpy(rng.integers(-200, 60, n).astype(np.int32))
    vecs = merge.threshold_stack(sa, sa, g, 126).numpy()
    nw = fanout // align
    mask = rng.integers(0, 1 << nw, n)
    u = rng.random(n)
    mask = np.where(u < 0.3, (1 << nw) - 1, np.where(u < 0.4, 0, mask))
    bases = rng.integers(0, n // align, n) * align
    bases[:4] = n - align            # arcs that wrap around
    senders = np.stack([bases, mask], axis=1).astype(np.int32)
    t_fail = 3 if suspect else 5
    kw = dict(suspect=True, t_suspect=2, lh_multiplier=3) if suspect else {}
    want = merge.resident_round_plain(
        torch.from_numpy(hb.copy()), torch.from_numpy(asl.copy()),
        torch.from_numpy(flags), torch.from_numpy(vecs),
        torch.from_numpy(senders), fanout=fanout, arc_align=align,
        t_fail=t_fail, t_cooldown=12, edge_filter=True, **kw)
    h, a = hb.copy(), asl.copy()
    out = np.empty((7, n), np.int32)
    call(host_lib.host_round_filter, n, fanout, align, int(suspect), h, a,
         flags, np.ascontiguousarray(vecs), senders, t_fail, 12, t_fail + 2,
         t_fail + 2 * 4, 63, out)
    names = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt",
             "entered", "refuted", "held")
    for name, o, w in zip(names, [h, a, *out], want):
        np.testing.assert_array_equal(o, w.numpy(), err_msg=name)
    assert want[3].sum() > 0 and (mask == 0).any()
    if suspect:
        assert all(int(want[i].sum()) > 0 for i in (6, 7, 8))
