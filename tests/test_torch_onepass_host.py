"""Host build of K3's one-pass form (f): the stripe walk of csrc/rr_onepass.cu.

The kernel's per-stripe step 1 (tick, park, view slice, detection counts),
step 2 (gather through the cluster, epilogue on the parked lanes, counts)
and the cluster's final reduction live in ``__host__ __device__`` functions
of ``csrc/rr_onepass.cuh``, which g++ compiles here: the very code the card
runs.  The harness replays a round with the thread-block cluster replaced
by ``kCtas`` host arrays of parked lanes, view slices and count blocks:
each persistent cluster walks its stripes (c, c + clusters, ...) as the
card does, with two count blocks a CTA by stripe parity and each row's
lanes staged into the park for the next stripe as step 2 merges it; per
stripe, step 1 for every CTA and thread, then step 2, then the
reduction, with the kernel's thread count and thread map (two threads a
row, 16 bytes each).  Every merge form, lanes and SWAR, crash-only,
suspicion and suspicion + Lifeguard, the square round and a column block
from a global offset, against ``resident_round_plain``; exact equality
throughout.
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
# rr_onepass.cu's threads a CTA, by elementwise form
THREADS = {"lanes": 512, "swar": 512}

HARNESS = r"""
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <vector>
#include "rr_onepass.cuh"

using namespace onepass;

template <class B>
struct TickSink {
  uint32_t* cnt;
  void det(int c, int count, int first_row) {
    cnt[kSumDet * B::kPairs + c / 2] += pair_addend(c, count);
    if (first_row < (int)cnt[B::kFobsAt + c]) cnt[B::kFobsAt + c] = first_row;
  }
  void entered(int c, int count) {
    cnt[kSumEntered * B::kPairs + c / 2] += pair_addend(c, count);
  }
};

template <class B>
struct MergeSink {
  uint32_t* cnt;
  int32_t* recv;   // [n] recv_cnt
  int32_t* held;   // [n] suspect_cnt, or null
  void row(int r, bool valid, int listed, int h) {
    if (!valid) return;
    recv[r] += listed;
    if (held) held[r] += h;
  }
  void add_row(int r, int listed, int h) { row(r, true, listed, h); }
  void add(int sum, int h, const uint32_t (&w)[kSeg]) {
    for (int k = 0; k < kSeg; ++k)
      for (int b = 0; b < 4; ++b) {
        const int c = 4 * (kSeg * h + k) + b;
        cnt[sum * B::kPairs + c / 2] +=
            pair_addend(c, (int)((w[k] >> (8 * b)) & 0xFF));
      }
  }
  void subj(int h, const uint32_t (&member)[kSeg],
            const uint32_t (&refuted)[kSeg], const uint32_t (&held_)[kSeg]) {
    add(kSumMember, h, member);
    add(kSumRefuted, h, refuted);
    add(kSumHeld, h, held_);
  }
};

// One round as the card runs it in blocking B: ``clusters`` persistent
// clusters, each walking stripes c, c + clusters, ... with its kCtas CTAs'
// parks (both lanes, or asl and the diagonal rows), views (view slices,
// whole or split group-max tables), staged threshold stacks and two count
// blocks a CTA by stripe parity, each row staged for the next stripe (its
// lanes copied into its park row) as step 2 merges it, and (the wide
// blocking) each step-2 thread's Hold of its rows' metadata and
// per-receiver counts across the stripes, flushed after the last one; the
// CTAs and threads of a step replayed one after another (the barriers
// between steps).
template <class B, bool kSus, int kForm, bool kSwar>
static void round_t(int n, int nc, int col_offset, Knobs kn, int lh, int nt,
                    int clusters, int8_t* hb, int8_t* asl,
                    const int8_t* flags, const int8_t* vecs,
                    const int32_t* senders, int32_t* subj, int32_t* recv) {
  constexpr bool kFull = full_view(kForm);
  constexpr int kC = B::kC, kCtas = B::kCtas, kLanes = B::kLanes;
  constexpr bool kParkHb = park_hb<B>(kFull);
  const int rows = n / kCtas;
  const int groups = rows / kAlign;
  const int stripes = nc / kC;
  const size_t vrows = view_rows<B>(n, kFull);
  const size_t drows = diag_rows<B>(kFull);
  std::vector<int8_t> ph((size_t)kCtas * rows * kC),
      pa((size_t)kCtas * rows * kC), pv(kCtas * vrows * kC),
      pd(kCtas * drows * kC + 1), vss((size_t)kCtas * N_VEC * kC);
  std::vector<uint32_t> blocks((size_t)kCtas * 2 * B::kBlockWords);
  std::vector<int8_t> none(kC);
  for (int i = 0; i < kC; i += 4) swar::store(&none[i], gather_none(kForm));
  for (int i = 0; i < (lh ? 2 : 1) * n; ++i) recv[i] = 0;
  auto park = [&](int q) {
    Park pk{kParkHb ? ph.data() + (size_t)q * rows * kC : nullptr,
            pa.data() + (size_t)q * rows * kC, pv.data() + q * vrows * kC};
    pk.diag = pd.data() + q * drows * kC;
    return pk;
  };
  auto view_of = [&](int q) { return pv.data() + q * vrows * kC; };
  auto vs_of = [&](int q) { return vss.data() + (size_t)q * N_VEC * kC; };
  auto block = [&](int q, int it) {
    return blocks.data() + ((size_t)q * 2 + (it & 1)) * B::kBlockWords;
  };
  auto load = [](const int8_t* a) { return load_seg(a); };
  auto copy = [](int8_t* dst, const int8_t* src) {
    std::memcpy(dst, src, 16);
  };
  using HoldT = std::conditional_t<(B::kHeld > 0), Hold<B, kForm, kSus>,
                                   NoHold>;
  std::vector<HoldT> holds((size_t)kCtas * nt);
  for (int c = 0; c < clusters && c < stripes; ++c) {
    for (int q = 0; q < kCtas; ++q)
      for (int t = 0; t < nt; ++t) {
        stage<B>(asl, vecs, stripe_at<B>(n, nc, col_offset, c), park(q),
                 vs_of(q), q, rows, t, nt, copy);
        if constexpr (HoldT::kRows > 0)
          holds[(size_t)q * nt + t].load(flags, senders, q, rows, t, nt,
                                         kn.width);
      }
    for (int q = 0; q < kCtas; ++q)
      for (int i = 0; i < B::kBlockWords; ++i)
        block(q, 0)[i] = blank_count<B>(i, n);
    for (int stripe = c, it = 0; stripe < stripes;
         stripe += clusters, ++it) {
      const Stripe sp = stripe_at<B>(n, nc, col_offset, stripe);
      // a group max goes into every CTA's table, or into its own CTA's
      // split table
      auto put_group = [&](int g, int h, const Seg& v) {
        if (B::kSplitTable) {
          const Where w = group_home<B>(g);
          store_seg(view_of(w.cta) + (size_t)w.local * kC + 4 * kSeg * h, v);
          return;
        }
        for (int q = 0; q < kCtas; ++q)
          store_seg(view_of(q) + (size_t)g * kC + 4 * kSeg * h, v);
      };
      for (int q = 0; q < kCtas; ++q) {
        TickSink<B> ts{block(q, it)};
        for (int t = 0; t < nt; ++t) {
          GroupFlags fw{};
          if (t / kLanes < groups)
            fw = group_flags(flags, group_row0<B>(q, t / kLanes));
          step1<B, kSus, kFull, mutes(kForm), kSwar>(
              hb, flags, vs_of(q), sp, kn, park(q), q, groups, t, nt, fw, ts,
              put_group);
        }
      }
      // (the cluster synchronises)
      for (int q = 0; q < kCtas; ++q) {
        for (int i = 0; i < B::kBlockWords; ++i)
          block(q, it + 1)[i] = blank_count<B>(i, n);
        auto gather = [&](const Meta<kForm>& m, int row, int h) -> Seg {
          if constexpr (kFull) {
            return gather_rows<kForm>(
                m, senders, row, n, kn,
                [&](int s) -> const int8_t* {
                  if (s < 0) return none.data() + 4 * kSeg * h;
                  const Where w = row_home<B>(s);
                  return view_of(w.cta) + (size_t)w.local * kC + 4 * kSeg * h;
                },
                load);
          } else {
            return gather_groups<kForm>(
                m, n, kn,
                [&](int g) -> const int8_t* {
                  if (g < 0) return none.data() + 4 * kSeg * h;
                  if (B::kSplitTable) {
                    const Where w = group_home<B>(g);
                    return view_of(w.cta) + (size_t)w.local * kC +
                           4 * kSeg * h;
                  }
                  return view_of(q) + (size_t)g * kC + 4 * kSeg * h;
                },
                load);
          }
        };
        MergeSink<B> ms{block(q, it), recv, lh ? recv + n : nullptr};
        const bool more = stripe + clusters < stripes;
        const Stripe next =
            stripe_at<B>(n, nc, col_offset, stripe + clusters);
        for (int t = 0; t < nt; ++t)
          step2<B, kSus, kForm, kSwar>(
              hb, asl, flags, vs_of(q), senders, sp, kn, park(q), q, rows, t,
              nt, gather, ms, [&](int li, int h) {
                if (more)
                  stage_row<B>(asl, next, park(q), q, li, h, copy);
              }, &holds[(size_t)q * nt + t]);
        // (the CTA synchronises) the next stripe's stack
        if (more)
          for (int t = 0; t < nt; ++t)
            stage_stack<B>(vecs, next, vs_of(q), t, nt, copy);
      }
      // (the cluster synchronises)
      for (int s = 0; s < (kSus ? 6 : 3); ++s)
        for (int cc = 0; cc < kC; ++cc)
          subj[(size_t)s * nc + sp.col0 + cc] = finish<B>(
              s, cc, [&](int q) { return (const uint32_t*)block(q, it); });
    }
    // the held rows' per-receiver counts, once the cluster's stripes end
    if constexpr (HoldT::kRows > 0) {
      MergeSink<B> ms{nullptr, recv, lh ? recv + n : nullptr};
      for (int q = 0; q < kCtas; ++q)
        for (int t = 0; t < nt; ++t)
          holds[(size_t)q * nt + t].flush(ms, q, rows, t, nt);
    }
  }
}

template <class B, bool kSus, bool kSwar>
static void round_form(int form, int n, int nc, int col_offset, Knobs kn,
                       int lh, int nt, int clusters, int8_t* hb, int8_t* asl,
                       const int8_t* flags, const int8_t* vecs,
                       const int32_t* senders, int32_t* subj, int32_t* recv) {
#define ARGS n, nc, col_offset, kn, lh, nt, clusters, hb, asl, flags, vecs, \
      senders, subj, recv
  switch (form) {
    case kFormGroup: return round_t<B, kSus, kFormGroup, kSwar>(ARGS);
    case kFormEdges: return round_t<B, kSus, kFormEdges, kSwar>(ARGS);
    case kFormArc: return round_t<B, kSus, kFormArc, kSwar>(ARGS);
    case kFormFilterGroup:
      return round_t<B, kSus, kFormFilterGroup, kSwar>(ARGS);
    default: return round_t<B, kSus, kFormFilterRows, kSwar>(ARGS);
  }
#undef ARGS
}

template <class B>
static void round_mode(int form, int n, int nc, int col_offset, Knobs kn,
                       int suspect, int lh, int swar_form, int nt,
                       int clusters, int8_t* hb, int8_t* asl,
                       const int8_t* flags, const int8_t* vecs,
                       const int32_t* senders, int32_t* subj, int32_t* recv) {
#define ARGS form, n, nc, col_offset, kn, lh, nt, clusters, hb, asl, flags, \
      vecs, senders, subj, recv
  if (suspect && swar_form) round_form<B, true, true>(ARGS);
  else if (suspect) round_form<B, true, false>(ARGS);
  else if (swar_form) round_form<B, false, true>(ARGS);
  else round_form<B, false, false>(ARGS);
#undef ARGS
}

// One round of the one-pass form over [n, nc] lanes from global column
// col_offset, in the narrow blocking (Cluster8x32) or the wide one
// (Cluster16x16).  subj [3 or 6, nc]; recv [1 or 2, n].
extern "C" void host_onepass(int wide, int n, int nc, int col_offset,
                             int form, int width, int group_shift,
                             int suspect, int lh, int swar_form, int nt,
                             int clusters, int8_t* hb, int8_t* asl,
                             const int8_t* flags, const int8_t* vecs,
                             const int32_t* senders, int t_fail,
                             int t_cooldown, int confirm, int confirm_hi,
                             int age_clamp, int32_t* subj, int32_t* recv) {
  const Knobs kn{t_fail, t_cooldown, confirm, confirm_hi, age_clamp, width,
                 group_shift};
#define ARGS form, n, nc, col_offset, kn, suspect, lh, swar_form, nt, \
      clusters, hb, asl, flags, vecs, senders, subj, recv
  if (wide) round_mode<Cluster16x16>(ARGS);
  else round_mode<Cluster8x32>(ARGS);
#undef ARGS
}

extern "C" long host_smem_bytes(long n, int full, int wide) {
  return wide ? smem_bytes<Cluster16x16>(n, full != 0)
              : smem_bytes<Cluster8x32>(n, full != 0);
}

"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("rr_onepass")
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


def call(fn, *args):
    fn(*[a.ctypes.data_as(ctypes.c_void_p) if isinstance(a, np.ndarray)
         else ctypes.c_int(a) for a in args])


def round_inputs(n: int, c: int, form: str, seed: int, sus: bool,
                 fanout: int = 16):
    """Pre-tick ``[n, c]`` lanes over every status (SUSPECT ages on both
    sides of the confirm ages under ``sus``), ages to the clamp, floor
    sentinels; flags over every bit; deep shifts; the form's senders."""
    rng = np.random.default_rng(seed)
    hb = rng.integers(-128, 128, (n, c), dtype=np.int8)
    hb[rng.random((n, c)) < 0.05] = -128
    st = rng.integers(0, 4 if sus else 3, (n, c))
    age = np.where(st == 3, rng.integers(2, 14, (n, c)),
                   rng.integers(0, 64, (n, c)))
    asl = ((age << 2 | st) - 128).astype(np.int8)
    flags = rng.integers(0, 32, n).astype(np.int8)
    sa = rng.integers(-260, 60, c).astype(np.int32)
    sb = np.where(rng.random(c) < 0.5, sa, rng.integers(-260, 60, c))
    g = rng.integers(-200, 60, c).astype(np.int32)
    t = torch.from_numpy
    vecs = merge.threshold_stack(t(sa), t(sb.astype(np.int32)), t(g),
                                 126).numpy()
    if form == "edges":
        senders, kw = rng.integers(0, n, (n, fanout - 7)), {}
    elif form == "arc":
        senders, kw = rng.integers(0, n, n), dict(fanout=fanout, arc_align=1)
    elif form == "aligned_group":
        senders = rng.integers(0, n // 8, n) * 8
        kw = dict(fanout=16, arc_align=8)
    else:
        align = 8 if form == "filter_group" else 4
        mask = rng.integers(0, 1 << (16 // align), n)
        mask[:6] = 0
        senders = np.stack([rng.integers(0, n // align, n) * align, mask], 1)
        kw = dict(fanout=16, arc_align=align, edge_filter=True)
    return hb, asl, flags, vecs, senders.astype(np.int32), kw


MODES = {"crash-only": dict(t_fail=5),
         "suspicion": dict(t_fail=3, suspect=True, t_suspect=2),
         "suspicion+lh": dict(t_fail=3, suspect=True, t_suspect=2,
                              lh_multiplier=3)}
# (n, columns, col_offset): the square round, and a column block whose
# columns hold part of the diagonal; "wide" has 32 stripes, more than the
# clusters the card holds at once
SHAPES = {"square": (256, 256, 0), "block": (512, 128, 256),
          "wide": (1024, 1024, 0)}
MATRIX_SHAPES = ("square", "block")


def run_host(lib, n, c, off, form, mode, elementwise, inputs, fanout=16,
             clusters=3, threads=None, wide=False):
    """One host round of blocking ``wide`` (Cluster16x16, else
    Cluster8x32) on ``inputs`` (:func:`round_inputs`' tuple): the outputs
    in resident_round_plain's order."""
    hb, asl, flags, vecs, senders, fkw = inputs
    sus = mode != "crash-only"
    kw = dict(fkw, t_cooldown=12, **MODES[mode])
    width = senders.shape[1] if form == "edges" else fanout
    if form in ("aligned_group", "filter_group"):
        width //= 8
    shift = 2 if form == "filter_rows" else 0
    lh = int("lh" in mode)
    thr, thr_hi = merge._sus_thresholds(kw["t_fail"], sus,
                                        kw.get("t_suspect", 0),
                                        kw.get("lh_multiplier", 0), 63)
    h, a = hb.copy(), asl.copy()
    subj = np.empty((6 if sus else 3, c), np.int32)
    recv = np.empty((1 + lh, n), np.int32)
    call(lib.host_onepass, int(wide), n, c, off, merge.FORMS.index(form),
         width, shift, int(sus), lh, int(elementwise == "swar"),
         threads or THREADS[elementwise], clusters, h, a, flags, vecs,
         senders, kw["t_fail"], 12, thr, thr_hi, 63, subj, recv)
    return [h, a, *subj[:3], recv[0], *subj[3:], *recv[1:]]


def plain_outputs(mode, elementwise, off, inputs):
    """resident_round_plain on ``inputs`` (:func:`round_inputs`)."""
    hb, asl, flags, vecs, senders, fkw = inputs
    kw = dict(fkw, t_cooldown=12, **MODES[mode])
    t = torch.from_numpy
    want = merge.resident_round_plain(
        t(hb.copy()), t(asl.copy()), t(flags), t(vecs), t(senders),
        elementwise=elementwise, col_offset=off, **kw)
    return [w.numpy() for w in want]


def host_round(lib, form, mode, elementwise, shape, seed, fanout=16,
               clusters=3, threads=None, wide=False):
    n, c, off = SHAPES[shape]
    inputs = round_inputs(n, c, form, seed, mode != "crash-only", fanout)
    got = run_host(lib, n, c, off, form, mode, elementwise, inputs, fanout,
                   clusters, threads, wide)
    return got, plain_outputs(mode, elementwise, off, inputs)


@pytest.mark.parametrize("shape", MATRIX_SHAPES)
@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("form", merge.FORMS)
def test_stripe_walk_matches_plain(lib, form, mode, elementwise, shape):
    got, want = host_round(lib, form, mode, elementwise, shape, 11)
    assert len(got) == len(want)
    names = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt",
             "entered", "refuted", "held", "suspect_cnt")
    for name, x, y in zip(names, got, want):
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert want[3].sum() > 0 and (want[4] < SHAPES[shape][0]).any()
    if mode != "crash-only":
        assert want[6].sum() > 0 and want[7].sum() > 0


@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
@pytest.mark.parametrize("form", ["edges", "arc"])
def test_stripe_walk_past_one_gather_chunk(lib, form, elementwise):
    """31 in-edges or a 38-row arc: the gather's second and third chunks
    of sender slots (the first chunk's in-edges come loaded a row ahead,
    the later ones are read in the gather)."""
    got, want = host_round(lib, form, "suspicion", elementwise, "square", 3,
                           fanout=38)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
@pytest.mark.parametrize("form", merge.FORMS)
@pytest.mark.parametrize("clusters", [1, 15, 16])
def test_persistent_cluster_walk_matches_plain(lib, clusters, form,
                                               elementwise):
    """32 stripes walked by 1, 15 or 16 persistent clusters (stripes c, c +
    k, ...; the count blocks alternating by stripe, each row's lanes staged
    into its park row for the next stripe as step 2 merges it): the outputs
    of the stripe-by-stripe replay and of the plain version."""
    got, want = host_round(lib, form, "suspicion+lh", elementwise, "wide", 5,
                           clusters=clusters)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
@pytest.mark.parametrize("form", merge.FORMS)
def test_stripe_walk_with_several_groups_a_thread(lib, form, elementwise):
    """8 threads a CTA: each step-1 thread ticks 2 groups (the second's
    flags read in step 1, as at N > 16,384 on the card's 512) and each
    step-2 thread merges and restages 8 rows."""
    got, want = host_round(lib, form, "suspicion", elementwise, "square", 7,
                           threads=8)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("form", merge.FORMS)
@pytest.mark.parametrize("n", [64, 16_384, 19_264, 19_328, 65_536])
def test_smem_bytes_agree_with_onepass_fits(lib, n, form):
    """The narrow blocking's bytes a CTA: the header's and ops/merge's,
    within the card's opt-in up to N = 19,264; the wide blocking's at the
    same N (and past its own edges: test_torch_onepass_wide_host.py)."""
    full = int(form in merge.FULL_VIEW_FORMS)
    narrow = merge.onepass_smem(n, form, "8x32")
    assert lib.host_smem_bytes(n, full, 0) == narrow
    assert (narrow <= merge.ONEPASS_SMEM) == (n <= 19_264)
    assert lib.host_smem_bytes(n, full, 1) == merge.onepass_smem(
        n, form, "16x16") <= merge.ONEPASS_SMEM
