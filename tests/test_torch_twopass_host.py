"""Host build of K3's two-launch form: the thread map of csrc/resident_round.cu.

The kernel's per-thread bodies (pass A's walk over one 8-row sender group
at a 16-byte segment, pass B's merge of one receiver row, the counter
words and their flush) and its geometry (the column tiles, the items pass
B's persistent blocks walk) live in ``__host__ __device__`` functions of
``csrc/rr_twopass.cuh``, which g++ compiles here: the very code the card
runs.  The harness replays a round with the kernel's grids: pass A's
blocks of ``256 / lanes`` groups a tile, then pass B's persistent blocks
walking items b, b + blocks, ... tile by tile, each thread one row of an
item, counts flushed through the block's column sums at each tile change
and every 255 rows.  Every merge form, lanes and SWAR, crash-only,
suspicion and suspicion + Lifeguard, square rounds, column blocks from a
global offset, several tiles with a ragged last one (whole words and
part-words), against ``resident_round_plain``; the diagonal at each word
of a 16-byte segment against ``rr_elem.cuh``'s lanes functions.  Exact
equality throughout.
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
#include <cstring>
#include <vector>
#include "rr_twopass.cuh"

using namespace twopass;
using onepass::kFormGroup;
using onepass::kFormEdges;
using onepass::kFormArc;
using onepass::kFormFilterGroup;

struct TickSink {
  int32_t *n_det, *first_obs, *ent;
  void det(int c, int count, int first_row) {
    n_det[c] += count;
    if (first_row < first_obs[c]) first_obs[c] = first_row;
  }
  void entered(int c, int count) { ent[c] += count; }
};

// One round as the card runs it.  subj [3 or 6, nc], recv [1 or 2, n];
// ``blocks`` pass B's persistent blocks, ``tile`` 0 the kernel's tile.
template <bool kSus, int kForm, bool kSwar>
static void round_t(int n, int nc, int col_offset, int tile, int blocks,
                    int al16, Knobs kn, int lh, int8_t* hb, int8_t* asl,
                    const int8_t* flags, const int8_t* vecs,
                    const int32_t* senders, int32_t* subj, int32_t* recv) {
  constexpr bool kFull = onepass::full_view(kForm);
  constexpr bool kMute = onepass::mutes(kForm);
  const Geo g = geometry(n, nc, col_offset, al16 != 0, tile ? tile : kTile);
  const size_t c = (size_t)nc;
  std::vector<int8_t> view((size_t)(kFull ? n : n / kAlign) * c);
  for (size_t i = 0; i < (kSus ? 6 : 3) * c; ++i) subj[i] = 0;
  for (size_t i = 0; i < c; ++i) subj[2 * c + i] = 0x7F7F7F7F;
  for (int i = 0; i < (lh ? 2 : 1) * n; ++i) recv[i] = 0;
  // pass A: blocks of g.slots groups over one tile
  TickSink ts{subj + c, subj + 2 * c, kSus ? subj + 3 * c : nullptr};
  const int groups = (n + kAlign - 1) / kAlign;
  for (int by = 0; by < g.tiles; ++by)
    for (int bx = 0; bx < (groups + g.slots - 1) / g.slots; ++bx)
      for (int t = 0; t < kThreads; ++t) {
        const int grp = bx * g.slots + t / g.lanes;
        if (grp * kAlign >= n) continue;
        const SegAt sa = seg_at(g, by, t % g.lanes);
        if (!sa.words) continue;
        tick_group<kSus, kFull, kMute, kSwar>(hb, asl, flags, vecs,
                                              view.data(), g, grp, sa, kn,
                                              ts);
      }
  // pass B: persistent blocks walking items b, b + blocks, ...
  uint32_t none[kSeg];
  for (int k = 0; k < kSeg; ++k) none[k] = onepass::gather_none(kForm);
  const int8_t* none_p = reinterpret_cast<const int8_t*>(none);
  const Walk w = walk(g);
  const int nb = pass_b_blocks(g, blocks);
  int32_t* outs[3] = {subj, subj + 4 * c, subj + 5 * c};
  std::vector<int8_t> vs((size_t)kStackRows * g.tile);
  std::vector<Counts> cnt(kThreads);
  std::vector<SwVec> vecw((size_t)kThreads * kSeg);
  for (int b = 0; b < nb; ++b) {
    int tile_at = -1, since = 0;
    for (Counts& k : cnt) clear(k);
    auto flush = [&]() {
      for (int t = 0; t < kThreads; ++t) {
        spill_counts<kSus>(cnt[t], seg_at(g, tile_at, t % g.lanes),
                           [&](int col, int q, int v) {
                             outs[q][col] += v;
                           });
        clear(cnt[t]);
      }
      since = 0;
    };
    for (int item = b; item < w.items; item += nb) {
      const int it = item / w.row_blocks, rb = item % w.row_blocks;
      if (it != tile_at) {
        if (tile_at >= 0) flush();
        tile_at = it;
        for (int i = 0; i < kStackRows * g.lanes; ++i) {
          const SegAt si = seg_at(g, it, i % g.lanes);
          const Seg r = load_seg(vecs + stack_row(i / g.lanes) * c + si.col0,
                                 si.words, g.al16);
          store_seg(vs.data() + (i / g.lanes) * g.tile +
                        (i % g.lanes) * kSegBytes,
                    r, kSeg, true);
        }
        for (int t = 0; t < kThreads; ++t) {
          SwVec(&v)[kSeg] =
              *reinterpret_cast<SwVec(*)[kSeg]>(&vecw[(size_t)t * kSeg]);
          for (int k = 0; k < kSeg; ++k) v[k] = SwVec{};
          load_stack(vs.data(), g.tile, t % g.lanes, v);
        }
      } else if (since >= kCountMax) {
        flush();
      }
      for (int t = 0; t < kThreads; ++t) {
        const int lane = t % g.lanes, slot = t / g.lanes;
        const SegAt sa = seg_at(g, tile_at, lane);
        const int row = rb * g.slots + slot;
        if (row >= n || !sa.words) continue;
        const Meta<kForm> m =
            onepass::load_meta<kForm>(flags, senders, row, kn.width);
        auto load = [&](const int8_t* p) {
          return load_seg(p, sa.words, g.al16);
        };
        auto gather = [&](const Meta<kForm>& mm, int r) -> Seg {
          if constexpr (kFull) {
            return onepass::gather_rows<kForm>(
                mm, senders, r, n, kn,
                [&](int s) -> const int8_t* {
                  return s < 0 ? none_p : view.data() + (size_t)s * c +
                                              sa.col0;
                },
                load);
          } else {
            return onepass::gather_groups<kForm>(
                mm, n, kn,
                [&](int gi) -> const int8_t* {
                  return gi < 0 ? none_p : view.data() + (size_t)gi * c +
                                               sa.col0;
                },
                load);
          }
        };
        SwVec(&v)[kSeg] =
            *reinterpret_cast<SwVec(*)[kSeg]>(&vecw[(size_t)t * kSeg]);
        const RowCounts rc = merge_row<kSus, kForm, kSwar>(
            hb, asl, m, row, g, sa, kn, v, gather, cnt[t]);
        recv[row] += rc.listed;
        if (lh) recv[n + row] += rc.held;
        if (rb == 0 && slot == 0)
          for (int col = sa.col0; col < sa.col0 + 4 * sa.words; ++col)
            if (subj[2 * c + col] == 0x7F7F7F7F) subj[2 * c + col] = n;
      }
      ++since;
    }
    if (tile_at >= 0) flush();
  }
}

template <bool kSus, bool kSwar>
static void round_form(int form, int n, int nc, int col_offset, int tile,
                       int blocks, int al16, Knobs kn, int lh, int8_t* hb,
                       int8_t* asl, const int8_t* flags, const int8_t* vecs,
                       const int32_t* senders, int32_t* subj,
                       int32_t* recv) {
#define ARGS n, nc, col_offset, tile, blocks, al16, kn, lh, hb, asl, flags, \
      vecs, senders, subj, recv
  switch (form) {
    case kFormGroup: return round_t<kSus, kFormGroup, kSwar>(ARGS);
    case kFormEdges: return round_t<kSus, kFormEdges, kSwar>(ARGS);
    case kFormArc: return round_t<kSus, kFormArc, kSwar>(ARGS);
    case kFormFilterGroup:
      return round_t<kSus, kFormFilterGroup, kSwar>(ARGS);
    default: return round_t<kSus, onepass::kFormFilterRows, kSwar>(ARGS);
  }
#undef ARGS
}

extern "C" void host_twopass(int n, int nc, int col_offset, int tile,
                             int blocks, int al16, int form, int width,
                             int group_shift, int suspect, int lh,
                             int swar_form, int8_t* hb, int8_t* asl,
                             const int8_t* flags, const int8_t* vecs,
                             const int32_t* senders, int t_fail,
                             int t_cooldown, int confirm, int confirm_hi,
                             int age_clamp, int32_t* subj, int32_t* recv) {
  const Knobs kn{t_fail, t_cooldown, confirm, confirm_hi, age_clamp, width,
                 group_shift};
#define ARGS form, n, nc, col_offset, tile, blocks, al16, kn, lh, hb, asl, \
      flags, vecs, senders, subj, recv
  if (suspect && swar_form) round_form<true, true>(ARGS);
  else if (suspect) round_form<true, false>(ARGS);
  else if (swar_form) round_form<false, true>(ARGS);
  else round_form<false, false>(ARGS);
#undef ARGS
}

// tick_seg on one segment of m rows against rr_elem.cuh's lanes functions
// byte by byte with the eye at byte d0 (any other d0: no eye): out [2, m,
// 5, kSeg] words (hb, asl, enc, fail, entered) of tick_seg, then of the
// byte-by-byte reference.
template <bool kSus, bool kSwar>
static void diag_t(int m, int d0, const uint32_t* hb, const uint32_t* asl,
                   const int32_t* flags, const uint32_t* vec, Knobs kn,
                   uint32_t* out) {
  for (int i = 0; i < m; ++i) {
    Seg h, a;
    SwVec v[kSeg];
    for (int k = 0; k < kSeg; ++k) {
      h.w[k] = hb[i * kSeg + k];
      a.w[k] = asl[i * kSeg + k];
      for (int j = 0; j < N_VEC; ++j)
        v[k].v[j] = vec[((size_t)j * m + i) * kSeg + k];
    }
    SwTickView tv[kSeg];
    tick_seg<kSus, true, kSwar>(h, a, flags[i], d0, v, kn, tv);
    uint32_t* o = out + (size_t)i * 5 * kSeg;
    uint32_t* r = out + ((size_t)m + i) * 5 * kSeg;
    for (int k = 0; k < kSeg; ++k) {
      const uint32_t got[5] = {tv[k].hb, tv[k].asl, tv[k].enc, tv[k].fail,
                               tv[k].entered};
      for (int q = 0; q < 5; ++q) o[q * kSeg + k] = got[q];
      for (int q = 0; q < 5; ++q) r[q * kSeg + k] = 0;
      for (int b = 0; b < 4; ++b) {
        const int f = flags[i];
        const bool act = f & 1, ref = f & 2, lh = f & 16;
        const bool eye = 4 * k + b == d0;
        const int bh = swar::byte_at(h.w[k], b), ba = swar::byte_at(a.w[k], b);
        int th, ta;
        bool fail, elig, entered = false;
        if (kSus) {
          const RrTickSus t = rr_tick_sus(
              bh, ba, act, ref, eye, lh, swar::byte_at(v[k].v[V_THR_G], b),
              kn.t_fail, kn.t_cooldown, kn.confirm, kn.confirm_hi);
          th = t.hb; ta = t.asl; fail = t.fail; elig = t.elig;
          entered = t.entered;
        } else {
          const RrTick t = rr_tick(bh, ba, act, ref, eye,
                                   swar::byte_at(v[k].v[V_THR_G], b),
                                   kn.t_fail, kn.t_cooldown);
          th = t.hb; ta = t.asl; fail = t.fail; elig = t.elig;
        }
        const int enc = rr_view(th, elig, rr_sends(f, true),
                                swar::byte_at(v[k].v[V_SA_N], b),
                                swar::byte_at(v[k].v[V_SA_ALL], b),
                                swar::byte_at(v[k].v[V_HI_N], b));
        const uint32_t bytes[5] = {(uint32_t)(th & 0xFF),
                                   (uint32_t)(ta & 0xFF),
                                   (uint32_t)(enc & 0xFF),
                                   fail ? 0x80u : 0u,
                                   entered ? 0x80u : 0u};
        for (int q = 0; q < 5; ++q) r[q * kSeg + k] |= bytes[q] << (8 * b);
      }
    }
  }
}

extern "C" void host_diag(int m, int d0, int suspect, int swar_form,
                          const uint32_t* hb, const uint32_t* asl,
                          const int32_t* flags, const uint32_t* vec,
                          int t_fail, int t_cooldown, int confirm,
                          int confirm_hi, uint32_t* out) {
  const Knobs kn{t_fail, t_cooldown, confirm, confirm_hi, 63, 0, 0};
  if (suspect && swar_form) diag_t<true, true>(m, d0, hb, asl, flags, vec, kn, out);
  else if (suspect) diag_t<true, false>(m, d0, hb, asl, flags, vec, kn, out);
  else if (swar_form) diag_t<false, true>(m, d0, hb, asl, flags, vec, kn, out);
  else diag_t<false, false>(m, d0, hb, asl, flags, vec, kn, out);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("rr_twopass")
    src, so = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(so))


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
        senders, kw = rng.integers(0, n, (n, fanout - 2)), {}
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
# (n, columns, col_offset, tile, pass B blocks): the square round at the
# kernel's tile (one tile, most lanes past the columns); a column block
# from a global offset holding part of the diagonal, over 3 tiles of 128
# with a ragged last one; a square round over 2 tiles of 256 walked by one
# block (every item in turn, counts flushed at the tile change and every
# 255 rows)
SHAPES = {"square": (256, 256, 0, 0, 5), "block": (512, 320, 128, 128, 7),
          "one-block": (576, 576, 0, 256, 1)}


def host_round(lib, form, mode, elementwise, shape, seed, fanout=16,
               al16=True):
    n, c, off, tile, blocks = SHAPES[shape] if isinstance(shape, str) \
        else shape
    sus = mode != "crash-only"
    hb, asl, flags, vecs, senders, fkw = round_inputs(n, c, form, seed, sus,
                                                      fanout)
    kw = dict(fkw, t_cooldown=12, **MODES[mode])
    t = torch.from_numpy
    want = merge.resident_round_plain(
        t(hb.copy()), t(asl.copy()), t(flags), t(vecs), t(senders),
        elementwise=elementwise, col_offset=off, **kw)
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
    call(lib.host_twopass, n, c, off, tile, blocks, int(al16),
         merge.FORMS.index(form), width, shift, int(sus), lh,
         int(elementwise == "swar"), h, a, flags, vecs, senders,
         kw["t_fail"], 12, thr, thr_hi, 63, subj, recv)
    got = [h, a, *subj[:3], recv[0], *subj[3:], *recv[1:]]
    return got, [w.numpy() for w in want]


NAMES = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt",
         "entered", "refuted", "held", "suspect_cnt")


def assert_equal(got, want):
    assert len(got) == len(want)
    for name, x, y in zip(NAMES, got, want):
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("form", merge.FORMS)
def test_two_launch_walk_matches_plain(lib, form, mode, elementwise, shape):
    got, want = host_round(lib, form, mode, elementwise, shape, 11)
    assert_equal(got, want)
    assert want[3].sum() > 0 and (want[4] < SHAPES[shape][0]).any()
    if mode != "crash-only":
        assert want[6].sum() > 0 and want[7].sum() > 0


@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
@pytest.mark.parametrize("form", merge.FORMS)
def test_part_word_segments_match_plain(lib, form, elementwise):
    """nc = 300 (nc % 16 == 12): rows start off 16-byte boundaries, so
    every segment moves word by word, and the last segment of the ragged
    last tile holds 3 words."""
    got, want = host_round(lib, form, "suspicion+lh", elementwise,
                           (256, 300, 0, 128, 3), 13, al16=False)
    assert_equal(got, want)


@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
@pytest.mark.parametrize("form", ["edges", "arc"])
def test_two_launch_walk_past_one_gather_chunk(lib, form, elementwise):
    """38 sender rows: the gather's later chunks of sender slots (the
    first chunk's in-edges come loaded a row ahead, the later ones are read
    in the gather)."""
    got, want = host_round(lib, form, "suspicion", elementwise, "square", 3,
                           fanout=38)
    assert_equal(got, want)


@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
def test_kernel_tile_ragged_last_tile(lib, elementwise):
    """The kernel's own 1,024-column tile over a column block of 1,100
    columns from global subject 300: two tiles, the last ragged at 76
    columns and ending in a 3-word segment, rows off 16-byte boundaries,
    part of the diagonal; explicit edges F = 3, 264 pass-B blocks (2 a
    card of 132 SMs)."""
    got, want = host_round(lib, "edges", "suspicion+lh", elementwise,
                           (1_536, 1_100, 300, 0, 264), 17, fanout=5,
                           al16=False)
    assert_equal(got, want)


def diag_inputs(m: int, seed: int, sus: bool):
    rng = np.random.default_rng(seed)
    hb = rng.integers(-128, 128, (m, 16)).astype(np.int8)
    hb[rng.random((m, 16)) < 0.05] = -128
    st = rng.integers(0, 4 if sus else 3, (m, 16))
    age = np.where(st == 3, rng.integers(2, 14, (m, 16)),
                   rng.integers(0, 64, (m, 16)))
    asl = ((age << 2 | st) - 128).astype(np.int8)
    flags = rng.integers(0, 32, m).astype(np.int32)
    sa = rng.integers(-260, 60, 16 * m).astype(np.int32)
    g = rng.integers(-200, 60, 16 * m).astype(np.int32)
    t = torch.from_numpy
    vecs = merge.threshold_stack(t(sa), t(sa), t(g), 126).numpy()
    words = lambda x: np.ascontiguousarray(x).view(np.uint32)  # noqa: E731
    return words(hb), words(asl), flags, words(vecs.reshape(11, m, 16))


@pytest.mark.parametrize("elementwise", merge.ELEMENTWISE)
@pytest.mark.parametrize("mode", ["crash-only", "suspicion"])
@pytest.mark.parametrize("word", [0, 1, 2, 3, "none"])
def test_diagonal_at_each_word_of_a_segment(lib, word, mode, elementwise):
    """A 16-byte segment's tick with the diagonal at each byte of word 0,
    1, 2 or 3 (or past the segment): tick_seg's eye-free words and its
    out-of-line diagonal word against rr_elem.cuh's lanes tick and view
    byte by byte with the eye on that byte only."""
    m = 4096
    sus = mode != "crash-only"
    hb, asl, flags, vecs = diag_inputs(m, 29, sus)
    for d0 in ([16, -1] if word == "none" else range(4 * word, 4 * word + 4)):
        out = np.empty((2, m, 5, 4), np.uint32)
        call(lib.host_diag, m, d0, int(sus), int(elementwise == "swar"), hb,
             asl, flags, vecs, 3 if sus else 5, 12, 5, 11, out)
        np.testing.assert_array_equal(out[0], out[1], err_msg=f"d0={d0}")
    # the eye bumped a heartbeat somewhere; with no eye none moves
    assert (out[0, :, 0] != hb).any() == (word != "none")
