// K3's two-launch round (resident_round.cu) in __host__ __device__
// functions: the thread map, pass A's per-thread walk over one 8-row
// sender group and pass B's per-thread merge of one receiver row, with
// the reductions behind sinks, so that a host build in the CPU tests
// (tests/test_torch_twopass_host.py, tests/test_torch_swar_host.py)
// replays the kernel's walk with g++ against the plain PyTorch version
// (gossipfs_tpu_torch/ops/merge.py resident_round_plain).
//
// Thread map.  A thread takes one 16-byte segment (kSeg words, 16
// subjects) of a row: ``lanes`` = tile / 16 threads a row, ``slots`` =
// 256 / lanes rows a block at a time, over column tiles of kTile = 1,024
// (64 threads a row, 4 rows a block).  Narrower tiles at large N, which
// keep the strip of the view pass B gathers from inside the 50 MB L2 (256
// columns at N = 65,536), were measured slower on the card: the gathers
// hit L2 more often, but each row segment of the lanes streams shrank to
// 256 bytes and the per-row count atomics grew fourfold (PERF.md, PR 10).
//
//   pass A  a thread ticks the 8 rows of one sender group at its segment
//           (the lanes tick a row at a time, the next row's loads in
//           flight; SWAR unrolled), writes the ticked lanes back, encodes
//           their view and stores it (full view) or folds it into the
//           group max; detections and SUSPECT entries go to a sink.
//   pass B  persistent blocks walk the items (column tile, S-row block) of
//           the round tile by tile, each thread one row of an item at its
//           segment: gather ``best`` from the view strip, merge, store
//           both lanes.  Per-subject counts accumulate in 0/1-per-byte
//           counter words and go out once a tile (or every 255 rows) per
//           block, so their atomics grow with the blocks, not the rows.
//
// Every per-entry formula is rr_elem.cuh's (lanes) or rr_swar.cuh's
// (SWAR); the gathers, the byte max, the merge word and the out-of-line
// diagonal word are rr_onepass.cuh's.  Only the words the diagonal
// crosses take the eye (one out-of-line call a row, for one thread).
#pragma once

#include <cstdint>
#include <cstring>

#include "rr_elem.cuh"
#include "rr_onepass.cuh"
#include "rr_swar.cuh"

#if defined(__CUDACC__)
#define TP_HD __host__ __device__ __forceinline__
#define TP_UNROLL _Pragma("unroll")
#else
#define TP_HD inline
#define TP_UNROLL
#endif

namespace twopass {

using onepass::Knobs;
using onepass::Meta;
using onepass::Seg;
using onepass::SegMax;

constexpr int kSeg = 4;                 // words a thread takes of a row
constexpr int kSegBytes = 4 * kSeg;     // 16 subjects
constexpr int kThreads = 256;
constexpr int kAlign = 8;               // rows a sender group
constexpr int kTile = 1024;             // columns a tile
constexpr int kCountMax = 255;          // rows a counter byte may hold
constexpr int kStackRows = 8;          // the merge's stack rows

// The round's geometry: ``n`` global rows, ``nc`` local columns (the row
// stride of every [*, nc] buffer) from global subject ``col_offset``; the
// tile, threads a row (``lanes``), rows a block at a time (``slots``),
// tiles over nc; ``al16``: every row of every buffer starts 16-byte
// aligned (nc % 16 == 0 and aligned bases), so a segment moves as one
// 16-byte access.
struct Geo {
  int n, nc, col_offset;
  int tile, lanes, slots, tiles;
  bool al16;
};

// ``tile``: kTile on the card; the host tests pass smaller powers of two
// (from 128) to walk several tiles at a small N.
TP_HD Geo geometry(int n, int nc, int col_offset, bool al16,
                   int tile = kTile) {
  Geo g;
  g.n = n;
  g.nc = nc;
  g.col_offset = col_offset;
  g.tile = tile;
  g.lanes = g.tile / kSegBytes;
  g.slots = kThreads / g.lanes;
  g.tiles = (nc + g.tile - 1) / g.tile;
  g.al16 = al16;
  return g;
}

// A thread's segment: its first local column and how many of its words
// lie inside the nc columns (0..kSeg; fewer than kSeg only at the end of
// a ragged last tile).
struct SegAt {
  int col0, words;
};

TP_HD SegAt seg_at(const Geo& g, int tile, int lane) {
  const int col0 = tile * g.tile + lane * kSegBytes;
  int w = (g.nc - col0) / 4;
  w = w < 0 ? 0 : w > kSeg ? kSeg : w;
  return {col0, w};
}

// The thread's ``words`` words at p: one 16-byte access where ``al16`` and
// the segment is whole, else word by word (words past ``words`` are 0).
// ``kStream``: a lane row read once a pass (evict-first in L2, so the view
// strip stays).
template <bool kStream = false>
TP_HD Seg load_seg(const int8_t* p, int words, bool al16) {
#if defined(__CUDA_ARCH__)
  if (al16 && words == kSeg) {
    const uint4 v = kStream ? __ldcs(reinterpret_cast<const uint4*>(p))
                            : *reinterpret_cast<const uint4*>(p);
    return {{v.x, v.y, v.z, v.w}};
  }
  Seg s{};
  TP_UNROLL
  for (int k = 0; k < kSeg; ++k)
    if (k < words) s.w[k] = reinterpret_cast<const uint32_t*>(p)[k];
  return s;
#else
  (void)al16;
  Seg s{};
  std::memcpy(s.w, p, 4 * (size_t)words);
  return s;
#endif
}

template <bool kStream = false>
TP_HD void store_seg(int8_t* p, const Seg& s, int words, bool al16) {
#if defined(__CUDA_ARCH__)
  if (al16 && words == kSeg) {
    const uint4 v = make_uint4(s.w[0], s.w[1], s.w[2], s.w[3]);
    if (kStream)
      __stcs(reinterpret_cast<uint4*>(p), v);
    else
      *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  TP_UNROLL
  for (int k = 0; k < kSeg; ++k)
    if (k < words) reinterpret_cast<uint32_t*>(p)[k] = s.w[k];
#else
  (void)al16;
  std::memcpy(p, s.w, 4 * (size_t)words);
#endif
}

// The tick (and view encode) of one row's segment: every word eye-free
// (the SWAR word tick, or the lanes functions with no eye), then the word
// the diagonal crosses, if any (d0 = the row minus the segment's first
// global column, in [0, 16)), again with the eye at byte d0 % 4 through
// the out-of-line onepass::diagonal_word.  ``f`` the row's flags.
template <bool kSus, bool kMute, bool kSwar>
TP_HD void tick_seg(const Seg& h, const Seg& a, int f, int d0,
                    const SwVec (&vec)[kSeg], const Knobs& kn,
                    SwTickView (&tv)[kSeg]) {
  const bool act = (f & 1) != 0;
  const bool ref = (f & 2) != 0;
  const bool lh = (f & 16) != 0;
  const bool sends = rr_sends(f, kMute);
  TP_UNROLL
  for (int k = 0; k < kSeg; ++k)
    tv[k] = kSwar ? rr_tick_view_swar<kSus>(
                        h.w[k], a.w[k], swar::row(act), swar::row(ref),
                        swar::row(lh), swar::row(sends), vec[k], kn.t_fail,
                        kn.t_cooldown, kn.confirm, kn.confirm_hi)
                  : rr_tick_view_lanes_word<kSus>(
                        h.w[k], a.w[k], act, ref, lh, sends, 4, vec[k],
                        kn.t_fail, kn.t_cooldown, kn.confirm,
                        kn.confirm_hi);
  if ((unsigned)d0 < (unsigned)kSegBytes) {
    const int kd = d0 >> 2;
    uint32_t hw = h.w[0], aw = a.w[0];
    SwVec v = vec[0];
    TP_UNROLL
    for (int k = 1; k < kSeg; ++k)
      if (k == kd) {
        hw = h.w[k];
        aw = a.w[k];
        v = vec[k];
      }
    const SwTickView dv = onepass::diagonal_word<kSus>(
        hw, aw, f, kMute, d0 & 3, v.v[V_SA_N], v.v[V_SA_ALL], v.v[V_HI_N],
        v.v[V_THR_G], kn);
    TP_UNROLL
    for (int k = 0; k < kSeg; ++k)
      if (k == kd) tv[k] = dv;
  }
}

// Pass A for one thread: sender group ``grp`` (rows [8 grp, 8 grp +
// rows), fewer than 8 only in a ragged last group of the full-view forms)
// at segment ``sa``.  Ticks its rows and encodes their view: kFull stores
// each row's encoded segment at view[row], else their max at view[grp]
// (G[n/8, nc]); stores the ticked lanes back in place.  The sink takes,
// per local column c, det(c, count, first firing global row) and
// entered(c, count).
template <bool kSus, bool kFull, bool kMute, bool kSwar, typename Sink>
TP_HD void tick_group(int8_t* __restrict__ hb, int8_t* __restrict__ asl,
                      const int8_t* __restrict__ flags,
                      const int8_t* __restrict__ vecs,
                      int8_t* __restrict__ view, const Geo& g, int grp,
                      SegAt sa, const Knobs& kn, Sink& sink) {
  const int row0 = grp * kAlign;
  const int rows = kFull && g.n - row0 < kAlign ? g.n - row0 : kAlign;
  const size_t nc = (size_t)g.nc;
  SwVec vec[kSeg];
  {
    const Seg s0 = load_seg(vecs + V_SA_N * nc + sa.col0, sa.words, g.al16);
    const Seg s1 = load_seg(vecs + V_SA_ALL * nc + sa.col0, sa.words,
                            g.al16);
    const Seg s2 = load_seg(vecs + V_HI_N * nc + sa.col0, sa.words, g.al16);
    const Seg s3 = load_seg(vecs + V_THR_G * nc + sa.col0, sa.words,
                            g.al16);
    TP_UNROLL
    for (int k = 0; k < kSeg; ++k) {
      vec[k].v[V_SA_N] = s0.w[k];
      vec[k].v[V_SA_ALL] = s1.w[k];
      vec[k].v[V_HI_N] = s2.w[k];
      vec[k].v[V_THR_G] = s3.w[k];
    }
  }
  // 0/1-per-byte counter words (at most 8 per byte); the first firing row
  // per byte rides a word of row numbers
  uint32_t det[kSeg], ent[kSeg], seen[kSeg], first[kSeg];
  TP_UNROLL
  for (int k = 0; k < kSeg; ++k) det[k] = ent[k] = seen[k] = first[k] = 0;
  SegMax gm(swar::H);
  Seg prev{};
  const size_t at0 = (size_t)row0 * nc + sa.col0;
  Seg nh = load_seg<true>(hb + at0, sa.words, g.al16);
  Seg na = load_seg<true>(asl + at0, sa.words, g.al16);
  const int gcol0 = g.col_offset + sa.col0;
  // the lanes tick, unrolled over 8 rows of 16 bytes, outgrows the
  // instruction cache (rr_onepass.cuh): one row at a time, the next row's
  // loads in flight
#if defined(__CUDACC__)
#pragma unroll(kSwar ? kAlign : 1)
#endif
  for (int r = 0; r < kAlign; ++r) {
    if (r >= rows) break;
    const int row = row0 + r;
    const int f = flags[row];
    const Seg ih = nh, ia = na;
    if (r + 1 < rows) {
      nh = load_seg<true>(hb + at0 + (r + 1) * nc, sa.words, g.al16);
      na = load_seg<true>(asl + at0 + (r + 1) * nc, sa.words, g.al16);
    }
    SwTickView tv[kSeg];
    tick_seg<kSus, kMute, kSwar>(ih, ia, f, row - gcol0, vec, kn, tv);
    Seg enc;
    TP_UNROLL
    for (int k = 0; k < kSeg; ++k) {
      enc.w[k] = tv[k].enc;
      if (k >= sa.words) continue;
      det[k] += tv[k].fail >> 7;
      if (tv[k].fail) {
        const uint32_t fresh = tv[k].fail & ~seen[k];
        seen[k] |= tv[k].fail;
        first[k] = swar::sel(swar::bytes(fresh), swar::word(r), first[k]);
      }
      if (kSus) ent[k] += tv[k].entered >> 7;
    }
    {
      Seg th, ta;
      TP_UNROLL
      for (int k = 0; k < kSeg; ++k) {
        th.w[k] = tv[k].hb;
        ta.w[k] = tv[k].asl;
      }
      store_seg<true>(hb + at0 + r * nc, th, sa.words, g.al16);
      store_seg<true>(asl + at0 + r * nc, ta, sa.words, g.al16);
    }
    if (kFull)
      store_seg(view + at0 + r * nc, enc, sa.words, g.al16);
    else if (r & 1)
      gm.add2(prev, enc);
    else
      prev = enc;
  }
  if (!kFull)
    store_seg(view + (size_t)grp * nc + sa.col0, gm.seg(), sa.words, g.al16);
  TP_UNROLL
  for (int k = 0; k < kSeg; ++k) {
    if (!(det[k] | ent[k])) continue;
    for (int b = 0; b < 4; ++b) {
      const int s = 8 * b;
      const int c = sa.col0 + 4 * k + b;
      const int cd = (int)((det[k] >> s) & 0xFF);
      if (cd) sink.det(c, cd, row0 + (int)((first[k] >> s) & 0xFF));
      const int e = (int)((ent[k] >> s) & 0xFF);
      if (kSus && e) sink.entered(c, e);
    }
  }
}

// pass B's stack row j (0..kStackRows)
TP_HD constexpr int stack_row(int j) { return onepass::merge_vec(j); }

// A thread's stack words from pass B's staged tile stack ``vs``
// ([kStackRows, tile], shared memory on the card) at its lane.
TP_HD void load_stack(const int8_t* vs, int tile, int lane,
                      SwVec (&vec)[kSeg]) {
  TP_UNROLL
  for (int j = 0; j < kStackRows; ++j) {
    const Seg r = onepass::lds_seg(vs + j * tile + lane * kSegBytes);
    TP_UNROLL
    for (int k = 0; k < kSeg; ++k) vec[k].v[stack_row(j)] = r.w[k];
  }
}

// A thread's per-subject counter words over the rows it merged since the
// last flush: listed receivers, refuted and held entries, 0/1 per byte.
struct Counts {
  uint32_t cw[kSeg], rw[kSeg], hw[kSeg];
};

TP_HD void clear(Counts& c) {
  TP_UNROLL
  for (int k = 0; k < kSeg; ++k) c.cw[k] = c.rw[k] = c.hw[k] = 0;
}

// Pass B for one thread and receiver row ``row`` at segment ``sa``, its
// Meta ``m`` (flags, senders) loaded ahead: both ticked lanes read (pass
// A's), ``best`` gathered for a live receiver (``gather(m, row)``: a dead
// one's is never read), the merge epilogue, both lanes stored once;
// per-subject counter words into ``cnt``.  Returns the row's listed and
// SUSPECT counts over the segment.
struct RowCounts {
  int listed, held;
};

template <bool kSus, int kForm, bool kSwar, typename Gather>
TP_HD RowCounts merge_row(int8_t* __restrict__ hb, int8_t* __restrict__ asl,
                          const Meta<kForm>& m, int row, const Geo& g,
                          SegAt sa, const Knobs& kn,
                          const SwVec (&vec)[kSeg], Gather gather,
                          Counts& cnt) {
  const size_t off = (size_t)row * g.nc + sa.col0;
  const Seg ph = load_seg<true>(hb + off, sa.words, g.al16);
  const Seg pa = load_seg<true>(asl + off, sa.words, g.al16);
  const bool recv = (m.flags & 4) != 0;
  const Seg best = recv ? gather(m, row) : onepass::splat(0xFFFFFFFFu);
  Seg oh, oa;
  uint32_t ls = 0, hs = 0;
  TP_UNROLL
  for (int k = 0; k < kSeg; ++k) {
    const onepass::MergeWord mw = onepass::merge_word<kSus, kSwar>(
        ph.w[k], pa.w[k], best.w[k], recv, vec[k], kn.age_clamp);
    oh.w[k] = mw.hb;
    oa.w[k] = mw.asl;
    if (k >= sa.words) continue;
    if (recv) cnt.cw[k] += mw.listed;
    ls += mw.listed;
    if (kSus) {
      cnt.rw[k] += mw.refuted;
      cnt.hw[k] += mw.held;
      hs += mw.held;
    }
  }
  store_seg<true>(hb + off, oh, sa.words, g.al16);
  store_seg<true>(asl + off, oa, sa.words, g.al16);
  return {onepass::byte_sum(ls), onepass::byte_sum(hs)};
}

// Pass B's persistent walk: item i (0 <= i < tiles * row_blocks) is
// column tile i / row_blocks, receiver rows [(i % row_blocks) * slots, +
// slots); block b of ``blocks`` takes items b, b + blocks, ..., so the
// blocks in flight share one tile's view strip.
struct Walk {
  int row_blocks, items;
};

TP_HD Walk walk(const Geo& g) {
  const int rb = (g.n + g.slots - 1) / g.slots;
  return {rb, rb * g.tiles};
}

// the blocks of pass B: ``resident`` (blocks the card holds at once), at
// most one an item
TP_HD int pass_b_blocks(const Geo& g, int resident) {
  const int items = walk(g).items;
  return resident < items ? resident : items;
}

// A thread's counter words as per-column addends: ``add(c, q, v)`` for
// local column c, count q (0 member, 1 refuted, 2 held), v > 0.
template <bool kSus, typename Add>
TP_HD void spill_counts(const Counts& cnt, SegAt sa, Add add) {
  TP_UNROLL
  for (int k = 0; k < kSeg; ++k) {
    if (k >= sa.words) continue;
    for (int b = 0; b < 4; ++b) {
      const int s = 8 * b;
      const int c = sa.col0 + 4 * k + b;
      const int v0 = (int)((cnt.cw[k] >> s) & 0xFF);
      if (v0) add(c, 0, v0);
      if (kSus) {
        const int v1 = (int)((cnt.rw[k] >> s) & 0xFF);
        const int v2 = (int)((cnt.hw[k] >> s) & 0xFF);
        if (v1) add(c, 1, v1);
        if (v2) add(c, 2, v2);
      }
    }
  }
}

}  // namespace twopass
