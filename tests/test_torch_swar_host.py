"""Host build of the resident round's SWAR form (csrc/rr_swar.cuh).

The SWAR word arithmetic of the CUDA kernel (csrc/resident_round.cu,
``kSwar``) lives in ``__host__ __device__`` functions of
``csrc/rr_swar.cuh``, which g++ compiles here, the very code the card
runs.  Three checks:

* the word primitives over all 256 x 256 byte pairs against numpy int8
  truth;
* the word tick + view encode (``rr_tick_view_swar``) and the word merge
  epilogue (``rr_merge_swar_t``) against ``rr_elem.cuh``'s lanes functions
  byte by byte, on random words covering every flag bit, every status,
  ages on both sides of every threshold and deep shifts;
* a whole round replayed the way the two-launch kernel's passes walk it
  (rr_twopass.cuh: 16-byte segments, the diagonal words on the lanes
  functions, the group max and the gathers on words, the 0/1-per-byte
  counter words) in every merge form, crash-only, suspicion and suspicion
  + Lifeguard, against the SWAR plain version and the lanes plain
  version.

Exact equality throughout.
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
#include <vector>
#include "rr_swar.cuh"
#include "rr_twopass.cuh"

using namespace swar;

extern "C" void prim(int op, int m, const uint32_t* x, const uint32_t* y,
                     uint32_t* out) {
  for (int i = 0; i < m; ++i) {
    const uint32_t a = x[i], b = y[i];
    uint32_t r = 0;
    switch (op) {
      case 0: r = eq(a, b); break;
      case 1: r = ne(a, b); break;
      case 2: r = ges(a, b); break;
      case 3: r = gts(a, b); break;
      case 4: r = les(a, b); break;
      case 5: r = add(a, b); break;
      case 6: r = sub(a, b); break;
      case 7: r = maxs(a, b); break;
      case 8: r = mins(a, b); break;
      case 9: r = bytes(ges(a, b)); break;
    }
    out[i] = r;
  }
}

static SwVec column(const uint32_t* vec, int m, int i) {
  SwVec v;
  for (int k = 0; k < N_VEC; ++k) v.v[k] = vec[(size_t)k * m + i];
  return v;
}

// Tick + view of m words, each with its row's flags: the word form, or
// (swar_form 0) the lanes functions byte by byte with no diagonal.
// out [5, m]: hb, asl, enc, fail, entered.
extern "C" void tick_view(int m, int sus, int swar_form, const uint32_t* hb,
                          const uint32_t* asl, const int32_t* flags,
                          const uint32_t* vec, int t_fail, int t_cooldown,
                          int confirm, int confirm_hi, uint32_t* out) {
  for (int i = 0; i < m; ++i) {
    const int f = flags[i];
    const bool act = f & 1, ref = f & 2, lh = f & 16;
    const bool sends = rr_sends(f, true);
    const SwVec v = column(vec, m, i);
    SwTickView t;
    if (swar_form && sus)
      t = rr_tick_view_swar<true>(hb[i], asl[i], row(act), row(ref), row(lh),
                                  row(sends), v, t_fail, t_cooldown, confirm,
                                  confirm_hi);
    else if (swar_form)
      t = rr_tick_view_swar<false>(hb[i], asl[i], row(act), row(ref),
                                   row(lh), row(sends), v, t_fail,
                                   t_cooldown, confirm, confirm_hi);
    else if (sus)
      t = rr_tick_view_lanes_word<true>(hb[i], asl[i], act, ref, lh, sends,
                                        -1, v, t_fail, t_cooldown, confirm,
                                        confirm_hi);
    else
      t = rr_tick_view_lanes_word<false>(hb[i], asl[i], act, ref, lh, sends,
                                         -1, v, t_fail, t_cooldown, confirm,
                                         confirm_hi);
    const uint32_t r[5] = {t.hb, t.asl, t.enc, t.fail, t.entered};
    for (int k = 0; k < 5; ++k) out[(size_t)k * m + i] = r[k];
  }
}

// The merge epilogue of m words: the word form, or rr_merge_t byte by
// byte.  out [3, m]: hb, asl, refuted (0xFF per refuted byte).
extern "C" void merge_words(int m, int sus, int swar_form, const uint32_t* hb,
                            const uint32_t* asl, const uint32_t* best,
                            const int32_t* flags, const uint32_t* vec,
                            int age_clamp, uint32_t* out) {
  for (int i = 0; i < m; ++i) {
    const bool recv = flags[i] & 4;
    const SwVec v = column(vec, m, i);
    uint32_t h = 0, a = 0, r = 0;
    if (swar_form) {
      const SwMerge w = sus ? rr_merge_swar_t<true>(hb[i], asl[i], best[i],
                                                    row(recv), v, age_clamp)
                            : rr_merge_swar_t<false>(hb[i], asl[i], best[i],
                                                     row(recv), v, age_clamp);
      h = w.hb; a = w.asl; r = w.refuted;
    } else {
      for (int k = 0; k < 4; ++k) {
        int vv[N_VEC];
        for (int j = 0; j < N_VEC; ++j) vv[j] = byte_at(v.v[j], k);
        const RrMerge e = sus
            ? rr_merge_t<true>(byte_at(hb[i], k), byte_at(asl[i], k),
                               byte_at(best[i], k), recv, vv, age_clamp)
            : rr_merge_t<false>(byte_at(hb[i], k), byte_at(asl[i], k),
                                byte_at(best[i], k), recv, vv, age_clamp);
        h |= (uint32_t)(e.hb & 0xFF) << (8 * k);
        a |= (uint32_t)(e.asl & 0xFF) << (8 * k);
        r |= e.refuted ? 0xFFu << (8 * k) : 0u;
      }
    }
    out[i] = h; out[(size_t)m + i] = a; out[2 * (size_t)m + i] = r;
  }
}

// One SWAR round walked as the two-launch kernel walks it (its per-thread
// bodies in rr_twopass.cuh): pass A, a thread a 16-byte segment of an
// 8-row sender group (the diagonal words on the lanes functions), then
// pass B, one block's persistent walk over the items (16 rows of one
// 128-column tile), a thread a row's segment, counter words flushed at
// each tile.  form: 0 aligned group, 1 edges [n, width], 2 arc bases [n],
// 3 filter_group, 4 filter_rows ([n, 2] base, mask).  out [8, n] int32:
// member_cnt, n_det, first_obs, recv_cnt, entered, refuted, held,
// suspect_cnt.
template <bool kSus, int kForm>
static void round_swar_t(int n, int align, int width, int8_t* hb,
                         int8_t* asl, const int8_t* flags, const int8_t* vecs,
                         const int32_t* senders, int t_fail, int t_cooldown,
                         int confirm, int confirm_hi, int age_clamp,
                         int32_t* out) {
  using namespace twopass;
  constexpr bool kFull = onepass::full_view(kForm);
  int shift = 0;
  while ((1 << shift) < align) ++shift;
  const Knobs kn{t_fail, t_cooldown, confirm, confirm_hi, age_clamp, width,
                 shift};
  int32_t *cnt = out, *ndet = out + n, *fobs = out + 2 * n,
          *rcnt = out + 3 * n, *ent = out + 4 * n, *refu = out + 5 * n,
          *held = out + 6 * n, *scnt = out + 7 * n;
  for (int j = 0; j < 8 * n; ++j) out[j] = 0;
  for (int j = 0; j < n; ++j) fobs[j] = n;
  std::vector<int8_t> g((size_t)(kFull ? n : n / 8) * n);
  struct Sink {
    int32_t *ndet, *fobs, *ent;
    void det(int c, int k, int first) {
      ndet[c] += k;
      if (first < fobs[c]) fobs[c] = first;
    }
    void entered(int c, int k) { ent[c] += k; }
  } sink{ndet, fobs, ent};
  const Geo ga = geometry(n, n, 0, true);
  for (int grp = 0; grp < n / 8; ++grp)
    for (int lane = 0; lane < ga.lanes; ++lane) {
      const SegAt sa = seg_at(ga, 0, lane);
      if (sa.words)
        tick_group<kSus, kFull, onepass::mutes(kForm), true>(
            hb, asl, flags, vecs, g.data(), ga, grp, sa, kn, sink);
    }
  const Geo gb = geometry(n, n, 0, true, 128);
  const Walk w = walk(gb);
  uint32_t none[kSeg];
  for (int k = 0; k < kSeg; ++k) none[k] = onepass::gather_none(kForm);
  std::vector<int8_t> vs((size_t)kStackRows * gb.tile);
  int32_t* outs[3] = {cnt, refu, held};
  for (int tile = 0; tile < gb.tiles; ++tile) {
    for (int i = 0; i < kStackRows * gb.lanes; ++i) {
      const SegAt si = seg_at(gb, tile, i % gb.lanes);
      store_seg(vs.data() + (i / gb.lanes) * gb.tile +
                    (i % gb.lanes) * kSegBytes,
                load_seg(vecs + stack_row(i / gb.lanes) * n + si.col0,
                         si.words, true),
                kSeg, true);
    }
    for (int lane = 0; lane < gb.lanes; ++lane) {
      const SegAt sa = seg_at(gb, tile, lane);
      SwVec vec[kSeg] = {};
      load_stack(vs.data(), gb.tile, lane, vec);
      Counts c;
      clear(c);
      for (int rb = 0; rb < w.row_blocks; ++rb)
        for (int slot = 0; slot < gb.slots; ++slot) {
          const int row = rb * gb.slots + slot;
          if (row >= n || !sa.words) continue;
          const auto m = onepass::load_meta<kForm>(flags, senders, row,
                                                   width);
          auto addr = [&](int s) -> const int8_t* {
            return s < 0 ? reinterpret_cast<const int8_t*>(none)
                         : g.data() + (size_t)s * n + sa.col0;
          };
          auto load = [](const int8_t* p) { return onepass::load_seg(p); };
          auto gather = [&](const Meta<kForm>& mm, int r) -> Seg {
            if constexpr (kFull)
              return onepass::gather_rows<kForm>(mm, senders, r, n, kn,
                                                 addr, load);
            else
              return onepass::gather_groups<kForm>(mm, n, kn, addr, load);
          };
          const RowCounts rc = merge_row<kSus, kForm, true>(
              hb, asl, m, row, gb, sa, kn, vec, gather, c);
          rcnt[row] += rc.listed;
          scnt[row] += rc.held;
        }
      spill_counts<kSus>(c, sa, [&](int col, int q, int v) {
        outs[q][col] += v;
      });
    }
  }
}

template <bool kSus>
static void round_swar(int n, int form, int align, int fanout, int width,
                       int8_t* hb, int8_t* asl, const int8_t* flags,
                       const int8_t* vecs, const int32_t* senders,
                       int t_fail, int t_cooldown, int confirm,
                       int confirm_hi, int age_clamp, int32_t* out) {
  (void)fanout;
#define ARGS n, align, width, hb, asl, flags, vecs, senders, t_fail, \
      t_cooldown, confirm, confirm_hi, age_clamp, out
  switch (form) {
    case 0: return round_swar_t<kSus, onepass::kFormGroup>(ARGS);
    case 1: return round_swar_t<kSus, onepass::kFormEdges>(ARGS);
    case 2: return round_swar_t<kSus, onepass::kFormArc>(ARGS);
    case 3: return round_swar_t<kSus, onepass::kFormFilterGroup>(ARGS);
    default: return round_swar_t<kSus, onepass::kFormFilterRows>(ARGS);
  }
#undef ARGS
}

extern "C" void host_round_swar(int n, int form, int align, int fanout,
                                int width, int suspect, int8_t* hb,
                                int8_t* asl, const int8_t* flags,
                                const int8_t* vecs, const int32_t* senders,
                                int t_fail, int t_cooldown, int confirm,
                                int confirm_hi, int age_clamp, int32_t* out) {
  if (suspect)
    round_swar<true>(n, form, align, fanout, width, hb, asl, flags, vecs,
                     senders, t_fail, t_cooldown, confirm, confirm_hi,
                     age_clamp, out);
  else
    round_swar<false>(n, form, align, fanout, width, hb, asl, flags, vecs,
                      senders, t_fail, t_cooldown, confirm, confirm_hi,
                      age_clamp, out);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("rr_swar")
    src, so = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def call(fn, *args):
    fn(*[a.ctypes.data_as(ctypes.c_void_p) if isinstance(a, np.ndarray)
         else ctypes.c_int(a) for a in args])


def packed(b: np.ndarray) -> np.ndarray:
    """int8 [..., 4k] -> uint32 words [..., k]."""
    return np.ascontiguousarray(b).view(np.uint32)


B = np.arange(-128, 128, dtype=np.int8)
X8, Y8 = np.repeat(B, 256), np.tile(B, 256)
PRIMS = {"eq": lambda x, y: np.where(x == y, 0x80, 0),
         "ne": lambda x, y: np.where(x != y, 0x80, 0),
         "ges": lambda x, y: np.where(x >= y, 0x80, 0),
         "gts": lambda x, y: np.where(x > y, 0x80, 0),
         "les": lambda x, y: np.where(x <= y, 0x80, 0),
         "add": lambda x, y: x + y, "sub": lambda x, y: x - y,
         "maxs": np.maximum, "mins": np.minimum,
         "bytes(ges)": lambda x, y: np.where(x >= y, 0xFF, 0)}


@pytest.mark.parametrize("op", list(PRIMS))
def test_primitives_exhaustive(lib, op):
    m = X8.size // 4
    out = np.empty(m, np.uint32)
    call(lib.prim, list(PRIMS).index(op), m, packed(X8), packed(Y8), out)
    want = PRIMS[op](X8.astype(np.int16), Y8.astype(np.int16))
    np.testing.assert_array_equal(out.view(np.uint8),
                                  want.astype(np.int16).astype(np.uint8))


def random_words(m: int, seed: int, sus: bool):
    """m words of lanes (every status, ages to the clamp, SUSPECT ages on
    both sides of the confirm ages, floor sentinels), one flags byte per
    word (every bit), and the threshold stack's words (deep shifts)."""
    rng = np.random.default_rng(seed)
    n = 4 * m
    hb = rng.integers(-128, 128, n).astype(np.int8)
    hb[rng.random(n) < 0.05] = -128
    st = rng.integers(0, 4 if sus else 3, n)
    age = np.where(st == 3, rng.integers(2, 14, n), rng.integers(0, 64, n))
    asl = ((age << 2 | st) - 128).astype(np.int8)
    flags = rng.integers(0, 32, m).astype(np.int32)
    sa = rng.integers(-260, 60, n).astype(np.int32)
    sb = np.where(rng.random(n) < 0.5, sa, rng.integers(-260, 60, n))
    g = rng.integers(-200, 60, n).astype(np.int32)
    t = torch.from_numpy
    vecs = merge.threshold_stack(t(sa), t(sb.astype(np.int32)), t(g),
                                 126).numpy()
    best = rng.integers(-1, 127, n).astype(np.int8)
    best[rng.random(n) < 0.3] = -1
    return (packed(hb), packed(asl), flags, packed(vecs), packed(best))


@pytest.mark.parametrize("sus", [False, True], ids=["crash-only", "suspicion"])
def test_word_tick_view_equals_lanes_functions(lib, sus):
    m = 1 << 14
    hb, asl, flags, vecs, _ = random_words(m, 3 + sus, sus)
    outs = []
    for swar_form in (1, 0):
        out = np.empty((5, m), np.uint32)
        call(lib.tick_view, m, int(sus), swar_form, hb, asl, flags, vecs,
             3 if sus else 5, 12, 5, 11, out)
        outs.append(out)
    names = ("hb", "asl", "enc", "fail", "entered")
    for name, a, b in zip(names, *outs):
        np.testing.assert_array_equal(a, b, err_msg=name)
    fail = outs[0][3]
    assert fail.any() and (outs[0][2] != 0xFFFFFFFF).any()
    if sus:
        assert outs[0][4].any()


@pytest.mark.parametrize("sus", [False, True], ids=["crash-only", "suspicion"])
def test_word_merge_equals_lanes_functions(lib, sus):
    m = 1 << 14
    hb, asl, flags, vecs, best = random_words(m, 7 + sus, sus)
    outs = []
    for swar_form in (1, 0):
        out = np.empty((3, m), np.uint32)
        call(lib.merge_words, m, int(sus), swar_form, hb, asl, best, flags,
             vecs, 63, out)
        outs.append(out)
    for name, a, b in zip(("hb", "asl", "refuted"), *outs):
        np.testing.assert_array_equal(a, b, err_msg=name)
    if sus:
        assert outs[0][2].any()


def round_inputs(n: int, form: str, seed: int, sus: bool):
    rng = np.random.default_rng(seed)
    hb = rng.integers(-128, 128, (n, n), dtype=np.int8)
    hb[rng.random((n, n)) < 0.05] = -128
    st = rng.integers(0, 4 if sus else 3, (n, n))
    age = np.where(st == 3, rng.integers(2, 14, (n, n)),
                   rng.integers(0, 64, (n, n)))
    asl = ((age << 2 | st) - 128).astype(np.int8)
    flags = rng.integers(0, 32, n).astype(np.int8)
    sa = rng.integers(-260, 60, n).astype(np.int32)
    g = rng.integers(-200, 60, n).astype(np.int32)
    vecs = merge.threshold_stack(torch.from_numpy(sa), torch.from_numpy(sa),
                                 torch.from_numpy(g), 126).numpy()
    if form == "edges":
        senders, kw = rng.integers(0, n, (n, 7)), {}
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
    return hb, asl, flags, vecs, senders.astype(np.int32), kw


MODES = {"crash-only": dict(t_fail=5),
         "suspicion": dict(t_fail=3, suspect=True, t_suspect=2),
         "suspicion+lh": dict(t_fail=3, suspect=True, t_suspect=2,
                              lh_multiplier=3)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("form", merge.FORMS)
def test_host_round_matches_swar_and_lanes_plain(lib, form, mode):
    n = 128
    sus = mode != "crash-only"
    hb, asl, flags, vecs, senders, fkw = round_inputs(n, form, 5, sus)
    kw = dict(fkw, t_cooldown=12, **MODES[mode])
    t = torch.from_numpy
    want = {ew: merge.resident_round_plain(
        t(hb.copy()), t(asl.copy()), t(flags), t(vecs), t(senders),
        elementwise=ew, **kw) for ew in merge.ELEMENTWISE}
    h, a = hb.copy(), asl.copy()
    out = np.empty((8, n), np.int32)
    width = senders.shape[1] if form == "edges" else 16
    if form in ("aligned_group", "filter_group"):
        width //= 8
    thr, thr_hi = merge._sus_thresholds(kw["t_fail"], sus,
                                        kw.get("t_suspect", 0),
                                        kw.get("lh_multiplier", 0), 63)
    call(lib.host_round_swar, n, merge.FORMS.index(form),
         kw.get("arc_align", 1), 16, width, int(sus), h, a, flags, vecs,
         senders, kw["t_fail"], 12, thr, thr_hi, 63, out)
    got = [h, a, *out[:4]]
    if sus:
        got += list(out[4:7]) + ([out[7]] if "lh" in mode else [])
    for ew, w in want.items():
        assert len(w) == len(got)
        for i, (x, y) in enumerate(zip(got, w)):
            np.testing.assert_array_equal(x, y.numpy(), err_msg=f"{ew} {i}")
    assert want["swar"][3].sum() > 0
