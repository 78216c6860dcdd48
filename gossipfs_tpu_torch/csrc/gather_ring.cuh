// The explicit-edge gather of K2 (fused_merge.cu) and K1 (fanout_max.cu),
// through a ring of shared memory that asynchronous copies fill ahead of
// the row being folded, and the per-thread bodies of both kernels over it
// (fm_thread: K2's row merge, merge_stripe.cuh's merge_seg and Counts;
// fx_thread: K1's row store).  __host__ __device__ code: a host build in
// the CPU tests (tests/test_torch_fused_merge_host.py) compiles it with g++
// and replays both kernels, blocks and threads one after another, the
// copies as memcpy, against the plain PyTorch versions.
//
// Geometry.  A block of kThreads = 256 threads takes one item: a stripe of
// 128 bytes of the view's columns (128 int8, 64 int16 or 32 int32) by a
// range of receiver rows, 8 threads a row (kLanes), 16 bytes each: every
// view, lane and output access is a 16-byte piece of a 128-byte row piece
// (an H100 moves int8 lanes in those at ~2.5 TB/s, in 32-byte ones at
// ~1.3).  The block's threads take the range's rows 32 at a time (a step).
//
// The ring.  A thread's gather is a sequence of items: receiver row k's F
// senders in `chunks` chunks of at most kSlots (plan), chunk j of row k at
// item q = k * chunks + j.  The ring holds kDepth = 2 stages of `chunk`
// 16-byte slots a thread, item q in stage q % kDepth.  Before a thread waits
// for item q (cp.async.wait_group kDepth - 1) and folds it, it issues the
// copies of item q + 1 (cp.async.cg: through L2, not L1) and commits them as
// one group (empty for a dead receiver or past its rows), so one chunk's
// copies are in flight while the chunk before it folds and, at the row's
// last chunk, while the row merges.  The copies in flight hold no
// register: 2 blocks of 256 threads keep 2 x 256 x 7 x 16 B = 57 KB of the
// gather in flight an SM at F = 14 (K1: 4 blocks, 115 KB), where an L2
// hit's few hundred cycles at ~30 B a clock an SM need ~20-30 KB.  A third
// stage (two chunks ahead) was 1-14 % slower everywhere it was timed, the
// ring filled by plain loads through registers 49-79 % slower (PERF.md
// section 6).  Each thread folds only the slots it filled, so the ring
// needs no barrier.  An absent sender (outside [0, n)) writes `none` into
// its slot: -1 for K2 (its best starts at -1), the type's minimum for K1
// (no floor).  A chunk's sender ids and alive bit load one item before its
// copies issue.  K2's block first stages its item's ids in shared memory
// behind the ring (stage_ids, before the block's one barrier), and the
// chunks' ids load from there: 2.4-12.1 % faster than from global memory
// (PERF.md section 6).  K1, whose fanout has no bound, loads them from
// global memory.  The element path (a ragged row: nc % 16 != 0 or
// unaligned lanes) fills the slots by plain loads, value by value.
//
// Order.  Items run row ranges fastest inside a stripe (item = stripe *
// splits + range), so the blocks in flight gather from a few stripes, each
// a strip of the view of n x 128 B: item_rows sizes the ranges so that the
// blocks the card holds at once span about kL2Budget (12 MB, a quarter of
// the L2) of strips, and at least one: 30 ranges of 352 rows a stripe at
// config 3's N = 10,240 with K2's 264 blocks held.  Items stripe-fastest
// were 26-142 % slower; budgets of 24 and 6 MB 0-10 % slower, but for K1
// at 6 MB (1.4 % faster).  K2's counts flush once an item.
#pragma once

#include <cstdint>
#include <cstring>

#include "merge_stripe.cuh"

#if defined(__CUDACC__)
#define GR_HD __host__ __device__ __forceinline__
#define GR_UNROLL _Pragma("unroll")
#else
#define GR_HD inline
#define GR_UNROLL
#endif

namespace gring {

using mstripe::Counts;
using mstripe::kMaxRowBytes;
using mstripe::kSegBytes;
using onepass::Seg;

constexpr int kThreads = 256;                 // threads a block
constexpr int kLanes = kMaxRowBytes / kSegBytes;  // threads a row: 8
constexpr int kStepRows = kThreads / kLanes;  // rows a step: 32
constexpr int kDepth = 2;                     // ring stages
constexpr int kSlots = 8;                     // a stage's slots a thread, most
constexpr long kL2Budget = 12L << 20;         // view strips in flight, bytes
// a thread's rows an item at most: its counters (and the first observer's
// step) are bytes
constexpr int kMaxItemRows = mstripe::kMaxSweep * kStepRows;
// an item's staged sender ids at most, bytes; one step's rows may take
// more, at most kStepRows x kMaxStagedFanout x 4
constexpr long kIdsBudget = 40L << 10;
constexpr int kMaxStagedFanout = 512;

// A row's senders in `chunks` chunks of `chunk` (the last may be shorter).
struct Plan {
  int chunk, chunks;
};

GR_HD Plan plan(int fanout) {
  const int m = (fanout + kSlots - 1) / kSlots;
  return {(fanout + m - 1) / m, m};
}

// the ring's bytes a block: kDepth stages of `chunk` slots a thread
GR_HD constexpr long ring_bytes(int chunk) {
  return (long)kDepth * chunk * kSegBytes * kThreads;
}

// Receiver rows an item: the blocks the card holds at once (`held`) span
// about kL2Budget of view strips (n x 128 B each): ceil(held / strips)
// ranges a stripe, rows rounded up to whole steps, at most kMaxItemRows.
GR_HD int item_rows(long n, long held) {
  long strips = kL2Budget / (n * kMaxRowBytes);
  if (strips < 1) strips = 1;
  const long splits = (held + strips - 1) / strips;
  long rows = (n + splits - 1) / splits;
  rows = (rows + kStepRows - 1) / kStepRows * kStepRows;
  if (rows < kStepRows) rows = kStepRows;
  return (int)(rows < kMaxItemRows ? rows : kMaxItemRows);
}

// Receiver rows an item whose sender ids are staged: ``rows`` cut, in
// whole steps, to what kIdsBudget holds at ``fanout``, one step at least.
GR_HD int staged_rows(int rows, int fanout) {
  long cap = kIdsBudget / (4L * fanout) / kStepRows * kStepRows;
  if (cap < kStepRows) cap = kStepRows;
  return rows < cap ? rows : (int)cap;
}

// An item's staged sender ids: the in-edges (int32 [n, F]) of its rows r0
// .. r0 + rows - 1 into ``ids`` ([rows, F]), thread t of ``threads``
// taking every threads-th id.
GR_HD void stage_ids(const int32_t* __restrict__ edges, int32_t* ids, int r0,
                     int rows, int fanout, int t, int threads) {
  const int32_t* e = edges + (size_t)r0 * fanout;
  for (int i = t; i < rows * fanout; i += threads) ids[i] = e[i];
}

// slot i of stage d of thread t: consecutive threads at consecutive 16
// bytes (a warp's 16-byte accesses fill whole shared-memory wavefronts)
GR_HD int slot_at(int d, int i, int chunk, int t) {
  return ((d * chunk + i) * kThreads + t) * kSegBytes;
}

// A signed max of many 16-byte segments of V values, two a call, from
// `none`: the byte max two words a DPX instruction (onepass::SegMax), the
// s16x2 and s32 maxes one 3-input DPX instruction a word.
template <typename V>
struct SegFold {
  Seg s;
  GR_HD explicit SegFold(uint32_t none) : s(onepass::splat(none)) {}
  GR_HD void add2(const Seg& a, const Seg& b) {
    GR_UNROLL
    for (int k = 0; k < 4; ++k)
      s.w[k] = mstripe::max3_word<V>(s.w[k], a.w[k], b.w[k]);
  }
  GR_HD Seg seg() const { return s; }
};

template <>
struct SegFold<int8_t> {
  onepass::SegMax m;
  GR_HD explicit SegFold(uint32_t none) : m(none) {}
  GR_HD void add2(const Seg& a, const Seg& b) { m.add2(a, b); }
  GR_HD Seg seg() const { return m.seg(); }
};

// An item's senders: slots 0 .. cnt - 1 of the chunk from sender f0 of
// receiver ``row``'s in-edges, row ``row - ids_r0`` of ``ids_in`` (int32
// [rows, F]), -1 for a sender outside [0, n) (absent); ``live``: the
// receiver is alive (always, without an alive vector), else no sender is
// read.
struct Ids {
  int s[kSlots];
  int cnt;
  bool live;
};

GR_HD Ids load_ids(const int32_t* __restrict__ ids_in, int ids_r0,
                   const uint8_t* __restrict__ alive, int row, int n,
                   int fanout, int f0, int cnt) {
  Ids ids;
  ids.cnt = cnt;
  ids.live = alive == nullptr || alive[row] != 0;
  const int32_t* e = ids_in + (size_t)(row - ids_r0) * fanout + f0;
  GR_UNROLL
  for (int i = 0; i < kSlots; ++i) {
    const int s = ids.live && i < cnt ? e[i] : -1;
    ids.s[i] = (unsigned)s < (unsigned)n ? s : -1;
  }
  return ids;
}

// One thread's sweep of an item: rows row0, row0 + 32, ... (rows_t of
// them), segment h of the stripe from column col0, the rows' in-edges
// from row ids_r0 of ``ids_in`` (int32 [., F]).  For each row k,
// ``begin(k)`` (returns whether to gather: the receiver is alive), then the
// row's chunks through the ring, then ``end(k, best)`` with the max over
// the row's senders from ``none`` (``none`` itself for a dead receiver).
// ``copy(dst, src)`` moves 16 bytes (cp.async on the card), ``commit()``
// closes an item's copies as a group, ``wait()`` waits until at most
// kDepth - 1 groups are pending (the card's cp.async.wait_group).
template <typename V, bool kVec, typename Copy16, typename Commit,
          typename Wait, typename Begin, typename End>
GR_HD void ring_sweep(const V* __restrict__ view,
                      const int32_t* __restrict__ ids_in, int ids_r0,
                      const uint8_t* __restrict__ alive, int n, int nc,
                      int fanout, int row0, int rows_t, int col0, int h,
                      int t, int8_t* ring, uint32_t none, Copy16 copy,
                      Commit commit, Wait wait, Begin begin, End end) {
  const Plan pl = plan(fanout);
  const int items = rows_t * pl.chunks;
  // the producer: the next item to issue (row pk, chunk pj) and its ids
  int pk = 0, pj = 0;
  Ids ids = load_ids(ids_in, ids_r0, alive, row0, n, fanout, 0,
                     pl.chunk < fanout ? pl.chunk : fanout);
  auto issue = [&](int p) {
    if (p < items) {
      if (ids.live) {
        const int d = p % kDepth;
        GR_UNROLL
        for (int i = 0; i < kSlots; ++i) {
          if (i >= ids.cnt) break;
          int8_t* dst = ring + slot_at(d, i, pl.chunk, t);
          if (ids.s[i] >= 0)
            mstripe::stage_seg<V, kVec>(view, nc, col0, ids.s[i], h, dst,
                                        copy);
          else
            onepass::store_seg(dst, onepass::splat(none));
        }
      }
      if (++pj == pl.chunks) {
        pj = 0;
        ++pk;
      }
      if (p + 1 < items) {
        const int f0 = pj * pl.chunk;
        ids = load_ids(ids_in, ids_r0, alive, row0 + pk * kStepRows, n,
                       fanout, f0,
                       fanout - f0 < pl.chunk ? fanout - f0 : pl.chunk);
      }
    }
    commit();
  };
  for (int p = 0; p < kDepth - 1; ++p) issue(p);
  for (int k = 0, q = 0; k < rows_t; ++k) {
    const bool recv = begin(k);
    SegFold<V> best(none);
    for (int j = 0; j < pl.chunks; ++j, ++q) {
      issue(q + kDepth - 1);
      wait();
      if (!recv) continue;
      const int d = q % kDepth;
      const int cnt = fanout - j * pl.chunk < pl.chunk ? fanout - j * pl.chunk
                                                       : pl.chunk;
      GR_UNROLL
      for (int i = 0; i < kSlots; i += 2) {
        if (i >= cnt) break;
        const Seg a = onepass::lds_seg(ring + slot_at(d, i, pl.chunk, t));
        const Seg b = i + 1 < cnt
                          ? onepass::lds_seg(
                                ring + slot_at(d, i + 1, pl.chunk, t))
                          : a;
        best.add2(a, b);
      }
    }
    end(k, best.seg());
  }
}

// K2's arguments: the view and lanes are [n, nc] column blocks, ids the
// item's staged in-edges (int32 [rows, F] from row r0), the shifts the
// stripe's (shared memory, [128] each).
template <typename V, typename H>
struct FmArgs {
  const V* view;
  const int32_t* ids;
  H* hb;
  int8_t* asl;
  const uint8_t* alive;
  int n, nc, fanout, age_clamp;
};

// K2's thread t of the item (rows r0 .. r0 + rows - 1, the stripe from
// col0): for each of its rows the gather through the ring, the merge of
// its lane segment (merge_seg, entry by entry) and the lanes stored once;
// the next row's lanes and alive bit load while this row gathers.  Its
// counts go to ``cn`` (step k: its k-th row).  A thread past the columns
// or the rows does nothing.
template <typename V, typename H, bool kSus, bool kDet, bool kVec,
          typename Copy16, typename Commit, typename Wait>
GR_HD void fm_thread(const FmArgs<V, H>& a, int r0, int rows, int col0,
                     int t, int8_t* ring, const int32_t* sa,
                     const int32_t* sb, Copy16 copy, Commit commit,
                     Wait wait,
                     Counts<kSegBytes / sizeof(V)>& cn) {
  using namespace mstripe;
  constexpr int kE = kSegBytes / sizeof(V);
  const int h = t % kLanes;
  const int col = col0 + h * kE;
  const int valid =
      kVec ? (col < a.nc ? kE : 0) : (a.nc - col < kE ? a.nc - col : kE);
  const int li = t / kLanes;
  if (valid <= 0 || li >= rows) return;
  const int rows_t = (rows - li + kStepRows - 1) / kStepRows;
  const int row0 = r0 + li;
  Lanes<H, kE> ld, nld;
  load_lanes<H, kE, kVec>(a.hb + (size_t)row0 * a.nc + col,
                          a.asl + (size_t)row0 * a.nc + col, valid, ld);
  bool recv = a.alive[row0] != 0, nrecv = false;
  ring_sweep<V, kVec>(
      a.view, a.ids, r0, a.alive, a.n, a.nc, a.fanout, row0, rows_t, col0,
      h, t, ring, 0xFFFFFFFFu, copy, commit, wait,
      [&](int k) {
        if (k + 1 < rows_t) {
          const int row = row0 + (k + 1) * kStepRows;
          const size_t off = (size_t)row * a.nc + col;
          load_lanes<H, kE, kVec>(a.hb + off, a.asl + off, valid, nld);
          nrecv = a.alive[row] != 0;
        }
        return recv;
      },
      [&](int k, const Seg& best) {
        merge_seg<V, H, kSus, kDet, kVec, kE>(best, ld, valid, sa + h * kE,
                                              sb + h * kE, recv, a.age_clamp,
                                              k, cn);
        const size_t off = (size_t)(row0 + k * kStepRows) * a.nc + col;
        store_lanes<H, kE, kVec>(a.hb + off, a.asl + off, valid, ld);
        if (k + 1 < rows_t) {
          ld = nld;
          recv = nrecv;
        }
      });
}

// the fold's identity of K1: the type's minimum in every lane
template <typename T>
GR_HD constexpr uint32_t lowest() {
  return sizeof(T) == 1 ? 0x80808080u
         : sizeof(T) == 2 ? 0x80008000u
                          : 0x80000000u;
}

// K1's thread t of the item (a square [n, n] view): for each of its rows
// the max over the receiver's F senders, stored once (16 bytes
// evict-first on the vector path, the values that exist on the element
// path).
template <typename T, bool kVec, typename Copy16, typename Commit,
          typename Wait>
GR_HD void fx_thread(const T* __restrict__ view,
                     const int32_t* __restrict__ edges, T* __restrict__ out,
                     int n, int fanout, int r0, int rows, int col0, int t,
                     int8_t* ring, Copy16 copy, Commit commit, Wait wait) {
  constexpr int kE = kSegBytes / sizeof(T);
  const int h = t % kLanes;
  const int col = col0 + h * kE;
  const int valid = kVec ? (col < n ? kE : 0) : (n - col < kE ? n - col : kE);
  const int li = t / kLanes;
  if (valid <= 0 || li >= rows) return;
  const int rows_t = (rows - li + kStepRows - 1) / kStepRows;
  const int row0 = r0 + li;
  ring_sweep<T, kVec>(
      view, edges, 0, nullptr, n, n, fanout, row0, rows_t, col0, h, t,
      ring, lowest<T>(), copy, commit, wait, [](int) { return true; },
      [&](int k, const Seg& best) {
        T* dst = out + (size_t)(row0 + k * kStepRows) * n + col;
        if (kVec) {
          mstripe::st_words(dst, best.w, 16);
        } else {
          union {
            T v[kE];
            Seg s;
          } u;
          u.s = best;
          for (int i = 0; i < valid; ++i) dst[i] = u.v[i];
        }
      });
}

#if defined(__CUDACC__)
// What a launcher asks the card once a card and ring size, per kernel
// instantiation (each keeps its own, a function-local static).
struct Held {
  static constexpr int kMaxCards = 64;
  bool raised[kMaxCards];
  int asked[kMaxCards], per_sm[kMaxCards], sms[kMaxCards];
};

// The blocks of ``kern`` an SM holds with ``smem`` bytes of ring, and the
// card's SMs: the opt-in shared memory raised to the largest ring once a
// card, the occupancy asked once a ring size and card.  A kernel that no
// SM holds is an error.
template <typename Kern>
inline cudaError_t held_blocks(Kern kern, int smem, Held& h, int* per_sm,
                               int* sms) {
  int card = 0;
  cudaError_t e = cudaGetDevice(&card);
  if (e != cudaSuccess) return e;
  if (card >= Held::kMaxCards) return cudaErrorInvalidDevice;
  if (!h.raised[card]) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(ring_bytes(kSlots) + 4L * kStepRows * kMaxStagedFanout));
    if (e != cudaSuccess) return e;
    h.raised[card] = true;
  }
  if (h.asked[card] != smem) {
    e = cudaDeviceGetAttribute(&h.sms[card], cudaDevAttrMultiProcessorCount,
                               card);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&h.per_sm[card], kern,
                                                      kThreads, smem);
    if (e != cudaSuccess) return e;
    if (h.per_sm[card] < 1) return cudaErrorInvalidConfiguration;
    h.asked[card] = smem;
  }
  *per_sm = h.per_sm[card];
  *sms = h.sms[card];
  return cudaSuccess;
}

// An item launch: shared memory a block (the ring, then the item's staged
// ids), receiver rows an item, items (the grid's blocks).
struct Grid {
  int smem, rows, items;
};

// The grid of ``kern`` over an [n, nc] block of ``elem``-byte view values
// at ``fanout``: the rows from item_rows over the blocks that the card
// holds with the ring alone (held_blocks), cut by staged_rows and the
// ids' bytes added where ``staged`` (fanout <= kMaxStagedFanout); with
// ``info``, the geometry into info[10] as well: stripe columns, rows an
// item, ring stages, slots a stage and thread, shared memory a block,
// threads a block, blocks an SM, registers and local memory (spills) a
// thread, items.
template <typename Kern>
inline cudaError_t grid(Kern kern, int n, int nc, int elem, int fanout,
                        bool staged, Held& h, Grid* g, int* info) {
  if (staged && fanout > kMaxStagedFanout) return cudaErrorInvalidValue;
  const Plan pl = plan(fanout);
  g->smem = (int)ring_bytes(pl.chunk);
  int per_sm = 0, sms = 0;
  cudaError_t e = held_blocks(kern, g->smem, h, &per_sm, &sms);
  if (e != cudaSuccess) return e;
  g->rows = item_rows(n, per_sm * sms);
  if (staged) {
    g->rows = staged_rows(g->rows, fanout);
    g->smem += 4 * g->rows * fanout;
  }
  const int cols = kLanes * (kSegBytes / elem);
  g->items = (nc + cols - 1) / cols * ((n + g->rows - 1) / g->rows);
  if (info == nullptr) return cudaSuccess;
  if (staged) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, g->smem);
    if (e != cudaSuccess) return e;
  }
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return e;
  const int v[10] = {cols,     g->rows,    kDepth,
                     pl.chunk, g->smem,    kThreads,
                     per_sm,   fa.numRegs, (int)fa.localSizeBytes,
                     g->items};
  for (int i = 0; i < 10; ++i) info[i] = v[i];
  return cudaSuccess;
}
#endif

}  // namespace gring
