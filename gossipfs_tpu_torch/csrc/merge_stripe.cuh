// The per-thread bodies of K5 (stripe_merge.cu) and K4 (arc_merge.cu), in
// __host__ __device__ functions that a host build in the CPU tests compiles
// with g++ (tests/test_torch_suspicion_host.py, test_torch_merge_elem_host.py)
// and replays, the blocks and the cluster replaced by host arrays and
// their threads run one after another, against the plain PyTorch versions
// (gossipfs_tpu_torch/ops/merge_update.py).
//
// Both kernels work on stripes of subject columns, 16 bytes of a row a
// thread and up to 8 threads a row: every lane access is a 16-byte piece
// of a 128-byte (or 64-byte) stripe of the row, which is what lets the
// lanes stream (an H100 moves int8 lanes in 128-byte row pieces at ~2.5
// TB/s, in 32-byte ones at ~1.3).  A receiver row's merge (merge_seg) runs
// the epilogue (merge_elem.cuh) entry by entry and keeps per-subject
// counter bytes that the kernel reduces over the warp and the block.
//
//   K5  a thread-block cluster of 16 CTAs of 512 threads parks the view's
//       stripe for all n rows in shared memory (a "park"), rows by round
//       robin (row s in CTA s % 16 at park row s / 16: a mask and a
//       shift), and each CTA sweeps its own receiver rows: best is the
//       byte max over the receiver's F in-edges (gather_edges), from -1,
//       read from the parks over distributed shared memory and from the
//       view in L2; the cluster sums the counts.
//   K4  a block stages a tile of rows of the view's stripe and the F - 1
//       rows after it (the halo, wrapping at n) and turns it in place into
//       M_p[x] = max view[x .. x + p) (p the largest power of two <= F) by
//       shift doubling (window_read / window_write, chunk by chunk between
//       barriers), writing W = max(M_p[x], M_p[x + F - p]) (tile_window);
//       a row pass then reads one W row a receiver (load_row_seg).
#pragma once

#include <cstdint>
#include <cstring>

#include "merge_elem.cuh"
#include "rr_onepass.cuh"  // Seg, ByteMax, SegMax, vimax3_s16x2

#if defined(__CUDACC__)
#define MS_HD __host__ __device__ __forceinline__
#define MS_UNROLL _Pragma("unroll")
#else
#define MS_HD inline
#define MS_UNROLL
#endif

namespace mstripe {

using onepass::Seg;

constexpr int kCtasLog = 4;
constexpr int kCtas = 1 << kCtasLog;  // CTAs a cluster (non-portable size)
constexpr int kThreads = 512;         // threads a CTA, one CTA an SM
constexpr int kSegBytes = 16;         // a thread's bytes of a park row
constexpr int kMaxRowBytes = 128;     // park row bytes at most
constexpr int kChunk = 8;             // K5: sender rows gathered a batch
constexpr int kWinItems = 8;          // K4: row segments a thread holds a
                                      // window chunk
constexpr int kMaxCols = 128;         // stripe columns at most
// a CTA's count block: int32 [kOuts][kMaxCols]
enum { kOutCnt = 0, kOutDet, kOutFobs, kOutRef, kOutHeld, kOuts };
constexpr int kBlockInts = kOuts * kMaxCols;
// the opt-in shared memory of one Hopper block
constexpr long kSmemLimit = 232448;
// rows a thread sweeps a stripe at most: its counters are bytes
constexpr int kMaxSweep = 255;

// a CTA's shared memory: the park, one row of absent (-1) bytes and two
// count blocks (by the stripe's parity)
MS_HD constexpr long smem_bytes(long park_rows, int rb) {
  return park_rows * rb + kMaxRowBytes + 2L * kBlockInts * 4;
}

// the most rows a CTA holds: ceil(n / kCtas)
MS_HD constexpr int cta_rows(long n) { return (int)((n + kCtas - 1) / kCtas); }

// whether a park of ``park_rows`` rows of ``rb`` bytes fits one CTA and a
// thread's share of ``rows`` receiver rows keeps to its counter bytes
MS_HD constexpr bool park_fits(long rows, long park_rows, int rb) {
  return smem_bytes(park_rows, rb) <= kSmemLimit &&
         rows <= (long)kMaxSweep * (kThreads / (rb / kSegBytes));
}

// The park's row bytes: the widest of 128, 64 and 32 whose park fits, else
// 0.  Wide rows let the lanes stream: a thread moves 16 bytes of a row, and
// the rb / 16 threads of a row touch rb contiguous bytes of each lane row,
// where DRAM pages reward 128 bytes and punish 32 (an H100 moves two int8
// [16,384 x 16,384] lanes in and out at ~2.5 TB/s in 128-byte row pieces,
// ~1.3 in 32-byte ones).  K5 parks its rows.
MS_HD constexpr int stripe_row_bytes(long n) {
  return park_fits(cta_rows(n), cta_rows(n), 128)  ? 128
         : park_fits(cta_rows(n), cta_rows(n), 64) ? 64
         : park_fits(cta_rows(n), cta_rows(n), 32) ? 32
                                                   : 0;
}

// K4's window tiles: kTileRows rows and the F - 1 rows after them in
// 128-byte rows, where they fit one block (else van Herk segments).
constexpr int kTileRows = 512;

MS_HD constexpr long tile_smem_bytes(long fanout) {
  return (kTileRows + fanout - 1) * kMaxRowBytes;
}

MS_HD constexpr bool tile_fits(long fanout) {
  return tile_smem_bytes(fanout) <= kSmemLimit;
}

// the row pass's blocks: a 128-byte stripe of columns by up to
// kRowsPerBlock rows, kRowThreads threads
constexpr int kRowThreads = 256;
constexpr int kRowsPerBlock = 2048;

// K5's round robin: the rows of CTA ``cta`` and the global row of its park
// row ``li``; row s lives in CTA s & (kCtas - 1) at park row s >> kCtasLog
MS_HD int rr_rows(int n, int cta) {
  return n > cta ? (n - cta + kCtas - 1) >> kCtasLog : 0;
}

MS_HD int rr_global(int cta, int li) { return (li << kCtasLog) | cta; }

// the largest power of two <= f
MS_HD int pow2_floor(int f) {
  int p = 1;
  while (2 * p <= f) p *= 2;
  return p;
}

// Hopper's 3-input s32 max (a DPX instruction), and its host form
MS_HD uint32_t vimax3_s32(uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  return (uint32_t)__vimax3_s32((int)a, (int)b, (int)c);
#else
  const int m = (int)a > (int)b ? (int)a : (int)b;
  return (uint32_t)(m > (int)c ? m : (int)c);
#endif
}

// The signed max of three words of int16 pairs or of int32 values, one
// DPX instruction.
template <typename V>
MS_HD uint32_t max3_word(uint32_t a, uint32_t b, uint32_t c) {
  return sizeof(V) == 2 ? onepass::vimax3_s16x2(a, b, c) : vimax3_s32(a, b, c);
}

// A signed max of two 16-byte segments of V values.
template <typename V>
MS_HD Seg max_seg(const Seg& a, const Seg& b) {
  Seg r;
  MS_UNROLL
  for (int k = 0; k < 4; ++k) {
    if (sizeof(V) == 1) {
      onepass::ByteMax m(a.w[k]);
      m.add2(b.w[k], b.w[k]);
      r.w[k] = m.word();
    } else {
      r.w[k] = max3_word<V>(a.w[k], b.w[k], b.w[k]);
    }
  }
  return r;
}

// Stage segment h of view row ``g`` for a stripe from column ``col0`` into
// ``dst`` (a park row's 16 bytes): ``copy(dst, src)`` moves 16 bytes (the
// vector path: cp.async on the card), columns at or past nc read as absent
// (-1).  The element path (kVec false: nc % 16 != 0 or unaligned lanes)
// loads value by value.
template <typename V, bool kVec, typename Copy16>
MS_HD void stage_seg(const V* __restrict__ view, int nc, int col0, int g,
                     int h, int8_t* dst, Copy16 copy) {
  constexpr int kE = kSegBytes / sizeof(V);
  const int c = col0 + h * kE;
  const V* src = view + (size_t)g * nc + c;
  if (kVec) {
    if (c < nc)
      copy(dst, reinterpret_cast<const int8_t*>(src));
    else
      onepass::store_seg(dst, onepass::splat(0xFFFFFFFFu));
  } else {
    union {
      V v[kE];
      Seg s;
    } u;
    MS_UNROLL
    for (int k = 0; k < kE; ++k) u.v[k] = c + k < nc ? src[k] : (V)-1;
    onepass::store_seg(dst, u.s);
  }
}

// Sender slots f0 .. f0 + kChunk - 1 of receiver ``row``'s in-edges (int16
// [n, F]): -1 past F or for a sender outside [0, n) (absent).
struct Ids {
  int s[kChunk];
};

MS_HD Ids load_ids(const int16_t* __restrict__ edges, int row, int n,
                   int fanout, int f0) {
  Ids ids;
  const int16_t* e = edges + (size_t)row * fanout;
  MS_UNROLL
  for (int i = 0; i < kChunk; ++i) {
    const int s = f0 + i < fanout ? (int)e[f0 + i] : -1;
    ids.s[i] = (unsigned)s < (unsigned)n ? s : -1;
  }
  return ids;
}

// K5's best for a live receiver ``row``: the byte max over the stripe's
// rows of its F in-edges, kChunk independent 16-byte loads a batch, then
// the fold, from -1: an absent slot reads the absent row.  ``first`` the first batch's slots (load_ids, loaded ahead).
// Even batches read the parks (``addr(s)`` the address of park row s at
// this thread's segment, s < 0 the absent row; ``load(a)`` its 16 bytes),
// odd batches the view itself (``gaddr(s)``, ``gload(a)``: the stripe's
// rows sit in L2 once staged), so that the two paths share the traffic.
template <typename RowAddr, typename LoadSeg, typename GAddr, typename GLoad>
MS_HD Seg gather_edges(const Ids& first, const int16_t* __restrict__ edges,
                       int row, int n, int fanout, RowAddr addr,
                       LoadSeg load, GAddr gaddr, GLoad gload) {
  onepass::SegMax best(0xFFFFFFFFu);
  Ids ids = first;
  for (int f0 = 0; f0 < fanout; f0 += kChunk) {
    if (f0 > 0) ids = load_ids(edges, row, n, fanout, f0);
    Seg v[kChunk];
    if ((f0 / kChunk) % 2 == 0) {
      MS_UNROLL
      for (int i = 0; i < kChunk; ++i) v[i] = load(addr(ids.s[i]));
    } else {
      MS_UNROLL
      for (int i = 0; i < kChunk; ++i) v[i] = gload(gaddr(ids.s[i]));
    }
    MS_UNROLL
    for (int i = 0; i < kChunk; i += 2) best.add2(v[i], v[i + 1]);
  }
  return best.seg();
}

// K4's window: one read step of the doubling, M_{s r}[x] = max_{j < r}
// M_s[x + j s] (radix r = 4 while s * 4 <= p, else 2), over a park of
// ``len`` rows (``lanes`` segments a row), chunk ``chunk`` as thread t of
// nt: item i = chunk * nt * kWinItems + j * nt + t (row i / lanes, segment
// i % lanes) for rows < len - (r - 1) s.  Every thread reads its items,
// the CTA synchronises, every thread writes them back (window_write), the
// CTA synchronises: rows a later chunk reads are at or past its own first
// row, which no earlier chunk wrote.
MS_HD int window_radix(int s, int p) { return s * 4 <= p ? 4 : 2; }

MS_HD int window_chunks(int len, int s, int r, int lanes, int nt) {
  const int items = (len - (r - 1) * s) * lanes;
  return items > 0 ? (items + nt * kWinItems - 1) / (nt * kWinItems) : 0;
}

template <typename V>
MS_HD void window_read(const int8_t* park, int rb, int len, int s, int r,
                       int chunk, int t, int nt, Seg (&v)[kWinItems]) {
  const int lanes = rb / kSegBytes;
  const int items = (len - (r - 1) * s) * lanes;
  MS_UNROLL
  for (int j = 0; j < kWinItems; ++j) {
    const int i = chunk * nt * kWinItems + j * nt + t;
    if (i >= items) break;
    const int8_t* p = park + (i / lanes) * rb + (i % lanes) * kSegBytes;
    const size_t d = (size_t)s * rb;
    Seg m = max_seg<V>(onepass::load_seg(p), onepass::load_seg(p + d));
    if (r == 4)
      m = max_seg<V>(m, max_seg<V>(onepass::load_seg(p + 2 * d),
                                   onepass::load_seg(p + 3 * d)));
    v[j] = m;
  }
}

MS_HD void window_write(int8_t* park, int rb, int len, int s, int r,
                        int chunk, int t, int nt,
                        const Seg (&v)[kWinItems]) {
  const int lanes = rb / kSegBytes;
  const int items = (len - (r - 1) * s) * lanes;
  MS_UNROLL
  for (int j = 0; j < kWinItems; ++j) {
    const int i = chunk * nt * kWinItems + j * nt + t;
    if (i >= items) break;
    onepass::store_seg(park + (i / lanes) * rb + (i % lanes) * kSegBytes,
                       v[j]);
  }
}

// The 16 bytes of segment h of row ``g`` of an [n, nc] array of V (W, the
// window max, in the two-launch forms), columns from col0 + h * 16 /
// sizeof(V): a 16-byte load on the vector path, else value by value (the
// ``valid`` that exist; the rest absent).
template <typename V, bool kVec>
MS_HD Seg load_row_seg(const V* __restrict__ w, int nc, int g, int col,
                       int valid) {
  constexpr int kE = kSegBytes / sizeof(V);
  const V* src = w + (size_t)g * nc + col;
  union {
    V v[kE];
    Seg s;
  } u;
  if (kVec) {
#if defined(__CUDA_ARCH__)
    const int4 v = __ldg(reinterpret_cast<const int4*>(src));
    u.s = {{(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z, (uint32_t)v.w}};
#else
    u.s = onepass::load_seg(reinterpret_cast<const int8_t*>(src));
#endif
  } else {
    MS_UNROLL
    for (int k = 0; k < kE; ++k) u.v[k] = k < valid ? src[k] : (V)-1;
  }
  return u.s;
}

// A window tile's output row x: W = max(M_p[x], M_p[x + F - p]) from the
// tile's park (rows of 128 bytes), segment h.
template <typename V>
MS_HD Seg tile_window(const int8_t* park, int x, int h, int fanout, int p) {
  const int8_t* a = park + (size_t)x * kMaxRowBytes + h * kSegBytes;
  const Seg m = onepass::load_seg(a);
  if (p == fanout) return m;
  return max_seg<V>(m, onepass::load_seg(
                           a + (size_t)(fanout - p) * kMaxRowBytes));
}

// A thread's lanes of one receiver row: kE entries of hb (raw words) and
// of asl.
template <typename H, int kE>
struct Lanes {
  uint32_t h[kE * sizeof(H) / 4];
  uint32_t a[kE / 4];
};

// 16 (or 8) bytes at p; the card's vector loads and stores of lane rows
// are evict-first (every lane byte is touched once a round)
MS_HD void ld_words(const void* p, uint32_t* w, int bytes) {
#if defined(__CUDA_ARCH__)
  if (bytes == 16) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const int2 v = __ldcs(reinterpret_cast<const int2*>(p));
    w[0] = v.x; w[1] = v.y;
  }
#else
  std::memcpy(w, p, bytes);
#endif
}

MS_HD void st_words(void* p, const uint32_t* w, int bytes) {
#if defined(__CUDA_ARCH__)
  if (bytes == 16)
    __stcs(reinterpret_cast<int4*>(p),
           make_int4(w[0], w[1], w[2], w[3]));
  else
    __stcs(reinterpret_cast<int2*>(p), make_int2(w[0], w[1]));
#else
  std::memcpy(p, w, bytes);
#endif
}

// lane value k of raw words of T values, widened (sign-extended)
template <typename T>
MS_HD int lane_at(const uint32_t* w, int k) {
  if (sizeof(T) == 1) return swar::byte_at(w[k >> 2], k & 3);
  if (sizeof(T) == 2) return (int)(int16_t)(w[k >> 1] >> (16 * (k & 1)));
  return (int)w[k];
}

// 4 values as raw words of T (sizeof(T) words)
template <typename T>
MS_HD void pack4(const int (&v)[4], uint32_t* w) {
  if (sizeof(T) == 1) {
    w[0] = swar::pack(v[0], v[1], v[2], v[3]);
  } else if (sizeof(T) == 2) {
    w[0] = swar::prmt((uint32_t)v[0], (uint32_t)v[1], 0x5410);
    w[1] = swar::prmt((uint32_t)v[2], (uint32_t)v[3], 0x5410);
  } else {
    MS_UNROLL
    for (int i = 0; i < 4; ++i) w[i] = (uint32_t)v[i];
  }
}

// kE values as raw words of T
template <typename T, int kE>
MS_HD void pack_lanes(const int (&v)[kE], uint32_t* w) {
  MS_UNROLL
  for (int i = 0; i < kE / 4; ++i) {
    const int q[4] = {v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]};
    pack4<T>(q, w + i * sizeof(T));
  }
}

// Load a thread's lanes of a row: hb and asl at the thread's first column;
// the vector path in 16-byte (asl of 8 entries: 8-byte) pieces, the element
// path the ``valid`` entries that exist (the rest read 0).
template <typename H, int kE, bool kVec>
MS_HD void load_lanes(const H* hb, const int8_t* asl, int valid,
                      Lanes<H, kE>& ld) {
  if (kVec) {
    MS_UNROLL
    for (int i = 0; i < (int)(kE * sizeof(H)) / 16; ++i)
      ld_words(hb + i * (16 / sizeof(H)), ld.h + 4 * i, 16);
    ld_words(asl, ld.a, kE);
  } else {
    int h[kE], a[kE];
    MS_UNROLL
    for (int k = 0; k < kE; ++k) {
      h[k] = k < valid ? (int)hb[k] : 0;
      a[k] = k < valid ? (int)asl[k] : 0;
    }
    pack_lanes<H, kE>(h, ld.h);
    pack_lanes<int8_t, kE>(a, ld.a);
  }
}

template <typename H, int kE, bool kVec>
MS_HD void store_lanes(H* hb, int8_t* asl, int valid,
                       const Lanes<H, kE>& ld) {
  if (kVec) {
    MS_UNROLL
    for (int i = 0; i < (int)(kE * sizeof(H)) / 16; ++i)
      st_words(hb + i * (16 / sizeof(H)), ld.h + 4 * i, 16);
    st_words(asl, ld.a, kE);
  } else {
    MS_UNROLL
    for (int k = 0; k < kE; ++k) {
      if (k >= valid) break;
      hb[k] = (H)lane_at<H>(ld.h, k);
      asl[k] = (int8_t)lane_at<int8_t>(ld.a, k);
    }
  }
}

// A thread's per-subject counters over its rows of a stripe: one byte a
// column of its segment (a thread sweeps at most kMaxSweep rows) in words
// of 4 columns: receivers listing the subject after the merge, detections,
// refutations and SUSPECT entries (kSus); for the first observer, the
// columns that fired (0x80 a byte) and the sweep step (a byte) at which
// each first did.
template <int kE>
struct Counts {
  static constexpr int kW = kE / 4;
  uint32_t cnt[kW], det[kW], ref[kW], held[kW], seen[kW], first[kW];
};

template <int kE>
MS_HD void clear(Counts<kE>& c) {
  MS_UNROLL
  for (int w = 0; w < kE / 4; ++w)
    c.cnt[w] = c.det[w] = c.ref[w] = c.held[w] = c.seen[w] = c.first[w] = 0;
}

// counter byte j of counter words ``w``
MS_HD int count_at(const uint32_t* w, int j) {
  return (int)((w[j >> 2] >> (8 * (j & 3))) & 0xFF);
}

// the sweep step of column j's first detection, or -1
template <int kE>
MS_HD int first_step(const Counts<kE>& cn, int j) {
  return (cn.seen[j >> 2] >> (8 * (j & 3) + 7)) & 1 ? count_at(cn.first, j)
                                                     : -1;
}

// the bytes (0xFF) of the first ``valid`` - 4 w entries of word w
MS_HD uint32_t valid_bytes(int valid, int w) {
  const int m = valid - 4 * w;
  return m >= 4 ? 0xFFFFFFFFu : m <= 0 ? 0u : (1u << (8 * m)) - 1u;
}

// The merge of a thread's segment of one receiver row, at sweep step
// ``step``: best (V values), the lanes ``ld`` updated in place, the
// shifts of the thread's columns, the receiver's alive bit; the first
// ``valid`` entries count (all kE on the 16-byte path, kVec).  The
// epilogue runs entry by entry (merge_elem); the counts are read off the
// packed words, 4 entries at a time: listed and SUSPECT from the merged
// status, a detection from the incoming byte (FAILED at age 0), a
// refutation as SUSPECT in and MEMBER out (only an advance turns a
// SUSPECT entry into a MEMBER).  kDet: the detections and first observers
// are counted.
template <typename V, typename H, bool kSus, bool kDet, bool kVec, int kE>
MS_HD void merge_seg(const Seg& best, Lanes<H, kE>& ld, int valid,
                     const int32_t* sa, const int32_t* sb, bool recv,
                     int age_clamp, int step, Counts<kE>& cn) {
  using namespace swar;
  const uint32_t rl = recv ? L : 0u;          // the receiver, 1 a byte
  MS_UNROLL
  for (int w = 0; w < kE / 4; ++w) {
    const uint32_t ain = ld.a[w];
    int oh[4], oa[4];
    MS_UNROLL
    for (int b = 0; b < 4; ++b) {
      const int k = 4 * w + b;
      const MeOut m = merge_elem<kSus>(
          lane_at<V>(best.w, k), lane_at<H>(ld.h, k), byte_at(ain, b), recv,
          sa[k], sb[k], MeLim<H>::lo, MeLim<H>::hi, age_clamp);
      oh[b] = m.hb;
      oa[b] = m.asl;
    }
    pack4<H>(oh, ld.h + w * sizeof(H));
    const uint32_t aout = pack(oa[0], oa[1], oa[2], oa[3]);
    ld.a[w] = aout;
    const uint32_t vl = kVec ? L : valid_bytes(valid, w) & L;
    const uint32_t st = aout & word(3);
    const uint32_t listed =
        kSus ? st & L : eq(st, word(ME_MEMBER)) >> 7;
    cn.cnt[w] += listed & rl & vl;
    if (kSus) {
      const uint32_t held = eq(st, word(ME_SUSPECT)) >> 7;
      cn.held[w] += held & vl;
      cn.ref[w] += eq(ain & word(3), word(ME_SUSPECT)) >> 7 &
                   eq(st, word(ME_MEMBER)) >> 7 & vl;
    }
    if (kDet) {
      // FAILED at age 0: the byte (0 << 2 | FAILED) - 128
      const uint32_t fresh =
          eq(ain, word(ME_FAILED - 128)) >> 7 & rl & vl;
      cn.det[w] += fresh;
      const uint32_t nf = (fresh << 7) & ~cn.seen[w];
      if (nf) {
        cn.seen[w] |= nf;
        cn.first[w] = sel(bytes(nf), word(step), cn.first[w]);
      }
    }
  }
}

// a fresh count block: zeros, and n for the first observer (no row fired)
MS_HD int32_t blank_count(int i, int n) {
  return i / kMaxCols == kOutFobs ? n : 0;
}

// One stripe output: column ``c`` of stat ``s`` from the cluster's count
// blocks, ``blk(q)`` the block of CTA q: the sum over the CTAs, or for the
// first observer their min.
template <typename Blk>
MS_HD int finish(int s, int c, Blk blk) {
  int acc = blk(0)[s * kMaxCols + c];
  for (int q = 1; q < kCtas; ++q) {
    const int v = blk(q)[s * kMaxCols + c];
    acc = s == kOutFobs ? (v < acc ? v : acc) : acc + v;
  }
  return acc;
}

// the value written to output row ``s``: n_det and first_obs are 0
// without detection stats
MS_HD int output_value(int s, int v, bool detect) {
  return (s == kOutDet || s == kOutFobs) && !detect ? 0 : v;
}

#if defined(__CUDACC__)
// The card's side: distributed shared memory, cp.async and the warp's
// share of the count reduction.

// 32-bit shared::cluster addresses: ``a`` (this CTA's shared window) in
// CTA ``rank``'s window, and the 16 bytes there
__device__ __forceinline__ uint32_t mapa(uint32_t a, int rank) {
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ Seg ld_cluster(uint32_t a) {
  Seg s;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(s.w[0]), "=r"(s.w[1]), "=r"(s.w[2]), "=r"(s.w[3])
               : "r"(a));
  return s;
}

// 16 bytes of the view through the read-only path, or absent (-1) bytes
// for a null address
__device__ __forceinline__ Seg ld_view(const int8_t* p) {
  if (p == nullptr) return onepass::splat(0xFFFFFFFFu);
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  return {{(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z, (uint32_t)v.w}};
}

// 16 bytes from global to shared memory without a register (cp.async,
// bypassing L1); cp.async.wait_all makes them visible to this thread
__device__ __forceinline__ void copy16(int8_t* dst, const int8_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// A thread's counters into its CTA's count block ``cnt``, by every thread
// of the CTA at once: each sum over the warp's threads of the same segment
// (``lanes`` threads a row) as 16-bit column pairs, then one shared atomic
// a column and warp; the first observer (with ``detect``) as the warp's
// min of ``row_of(step)`` over the columns that fired.
template <bool kSus, bool kDet, int kE, typename RowOf>
__device__ __forceinline__ void flush_counts(int32_t* cnt,
                                             const Counts<kE>& cn, int h,
                                             int lanes, int n, RowOf row_of) {
  const int lane = threadIdx.x & 31;
  auto sum = [&](int stat, const uint32_t (&w)[kE / 4]) {
#pragma unroll
    for (int i = 0; i < kE / 4; ++i) {
      // bytes 0, 1 and bytes 2, 3 as 16-bit halves
      uint32_t p[2] = {swar::prmt(w[i], 0, 0x4140),
                       swar::prmt(w[i], 0, 0x4342)};
      for (int o = lanes; o < 32; o <<= 1) {
        p[0] += __shfl_xor_sync(0xffffffffu, p[0], o);
        p[1] += __shfl_xor_sync(0xffffffffu, p[1], o);
      }
      if (lane >= lanes) continue;
      int32_t* c = cnt + stat * kMaxCols + h * kE + 4 * i;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int v = (int)((p[b >> 1] >> (16 * (b & 1))) & 0xFFFF);
        if (v) atomicAdd(c + b, v);
      }
    }
  };
  sum(kOutCnt, cn.cnt);
  if (kDet) {
    sum(kOutDet, cn.det);
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int st = first_step(cn, j);
      int v = st >= 0 ? row_of(st) : n;
      for (int o = lanes; o < 32; o <<= 1)
        v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane < lanes && v < n)
        atomicMin(cnt + kOutFobs * kMaxCols + h * kE + j, v);
    }
  }
  if (kSus) {
    sum(kOutRef, cn.ref);
    sum(kOutHeld, cn.held);
  }
}

// A block's count block ``cnt`` (complete: after the barrier that follows
// every thread's flush_counts) for its stripe of ``cols`` columns from
// ``col0`` into the initialised outputs ``out`` [3 or 5, nc], by every
// thread of the block: one global atomic a column and output, none for a
// zero sum or a column where no row fired.
template <bool kSus, bool kDet>
__device__ __forceinline__ void add_block_counts(const int32_t* cnt,
                                                 int32_t* out, int col0,
                                                 int cols, int nc, int n) {
  for (int i = threadIdx.x; i < kOuts * cols; i += blockDim.x) {
    const int s = i / cols;
    const int c = i % cols;
    if (col0 + c >= nc || (!kSus && s >= kOutRef) ||
        (!kDet && (s == kOutDet || s == kOutFobs)))
      continue;
    const int v = cnt[s * kMaxCols + c];
    int32_t* o = out + (size_t)s * nc + col0 + c;
    if (s == kOutFobs) {
      if (v < n) atomicMin(o, v);
    } else if (v) {
      atomicAdd(o, v);
    }
  }
}
#endif

}  // namespace mstripe
