// One lean gossip round (tick, gossip view, merge and the round's
// reductions) for NVIDIA Hopper (sm_90a), in two launches: K3's
// two-launch form, which runs every shape the one-pass form (f)
// (rr_onepass.cu) does not hold, N = 49,152 and 65,536 among them.
//
// Replaces the TPU kernel gossipfs_tpu/ops/merge_pallas.py
// resident_round_blocked (:2611) in its merge forms: aligned arcs of
// 8-row sender groups, explicit [n, F] in-edges, and plain arcs (F
// consecutive sender rows from a per-receiver base; aligned bases of any
// other granularity take this form too); the edge_filter forms (the
// scenario engine on aligned arcs, merge_pallas.py:2276-2301, the mute on
// flags bit 3); each crash-only and with the SWIM lifecycle (suspect /
// confirm in the tick, refute in the merge, the Lifeguard stretch as a
// per-row confirm threshold on flags bit 4); the lanes form and the SWAR
// form (kSwar, config elementwise="swar": 4 subjects a 32-bit word,
// rr_swar.cuh; the JAX package's _rr_tick_view_swar / _rr_merge_swar,
// merge_pallas.py:1643, :1720); square rounds and column blocks (the JAX
// kernel's ``col_offset``, merge_pallas.py:2633: all n receiver rows over
// nc subject columns from global subject col_offset; the per-receiver
// counts are then partial, over the block's columns).  The function it
// computes is defined by the plain PyTorch version,
// gossipfs_tpu_torch/ops/merge.py resident_round_plain.
//
// Bound.  Bytes: the information floor reads and writes each packed lane
// once, 4 B per [receiver, subject] entry (17.2 GB at N = 65,536: 5.13 ms
// at the H100's 3.35 TB/s).  The TPU kernel met it by parking the ticked
// lanes in VMEM for the receiver sweep; a Hopper block has 227 KB of
// shared memory, which parks a 32-column stripe only up to N = 19,264
// (rr_onepass.cu).  Beyond that the view crosses device memory, and the
// round is two launches in stream order.
//
// Design (rr_twopass.cuh has the per-thread bodies; a thread takes one
// 16-byte segment, 16 subjects, of a row; both launches in stream order):
//   A  rr_tick_view_kernel: a block holds 4 sender groups of 8 rows over
//      one 1,024-column tile.  Each thread ticks its group's 8 rows at its
//      segment (16-byte loads, the next row's in flight; SWAR unrolled;
//      the lanes tick eye-free but on the diagonal's word, one
//      out-of-line call a row for one thread), writes the ticked lanes
//      back, encodes the gossip view and writes each row's view
//      (full-view forms: G is the whole view [n, nc]) or the group max
//      G[n/8, nc] (two words folded an instruction pair by Hopper's s16x2
//      3-input max), and counts detections per subject (n_det, lowest
//      firing row) and SUSPECT entries with atomics on the rare firing
//      columns.
//   B  rr_merge_kernel: as many blocks as the card holds at once, each
//      walking items (1,024-column tile, 4 receiver rows) b, b + blocks,
//      ..., so that the blocks in flight gather from one tile's strip of
//      G.  A thread reads its row's ticked lanes, gathers best (F/8 group
//      maxes, or F view rows 8 at a time), merges, and writes both
//      lanes.  recv_cnt (and the Lifeguard suspect_cnt) is a
//      reduction over the row's threads and one atomic a row and warp;
//      member_cnt (refuted, held) accumulate in 0/1-per-byte counter words
//      and leave once a tile (or every 255 rows) per block through shared
//      memory, one atomic a column, so these atomics grow with the blocks
//      (a few hundred a column), not with N / 32.
// Lane rows are read and written evict-first, so that the strip keeps
// more of L2 (64 MB of the whole view at N = 65,536; narrower tiles whose
// strip fits were measured slower, rr_twopass.cuh).  Bytes: both lanes
// read and written by each pass, G written once and read from the strip:
// about 8.4 B per entry (aligned) and 10 B (full view),
// 2.1x and 2.5x the floor.  A pass B that ticks the pre-tick lanes again,
// so that pass A writes no lanes (6.1 B / 7 B an entry), was measured and
// dropped: the second tick cost more than the bytes saved (PERF.md, PR
// 10).
// Registers are capped by launch bounds: the lanes tick, a dependent byte
// chain, runs 3 blocks an SM (80 registers), everything else 2 (128), the
// aligned forms' crash-only merge 3; with a 16-byte segment a thread the
// uncapped kernels held one block an SM and waited on memory.  Integer
// counts make every atomic order give the same result.
//
// Every instantiation takes nc and col_offset at run time (a square round
// is nc = n, col_offset 0); a row of any buffer that does not start on a
// 16-byte boundary (nc % 16 != 0) moves word by word.
#include <cstdint>
#include <cuda_runtime.h>

#include "rr_twopass.cuh"

using namespace twopass;

namespace {

// pass B's merge forms (rr_round's ``form``)
using onepass::kFormArc;
using onepass::kFormEdges;
using onepass::kFormFilterGroup;
using onepass::kFormFilterRows;
using onepass::kFormGroup;

constexpr int kFobsUnset = 0x7F7F7F7F;  // memset(0x7F) sentinel


// a 16-byte row of each gather start value: -128 a byte, and -1 (the
// edge_filter forms' dropped group)
__device__ __align__(16) const uint32_t kNoneRows[2][kSeg] = {
    {0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u},
    {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu}};

// pass A's counts: atomics on the firing columns
struct TickSink {
  int32_t* n_det;
  int32_t* first_obs;
  int32_t* ent;
  __device__ void det(int c, int count, int first_row) {
    atomicAdd(n_det + c, count);
    atomicMin(first_obs + c, first_row);
  }
  __device__ void entered(int c, int count) { atomicAdd(ent + c, count); }
};

// kFull: G is the whole view [n, nc], else the group max [n/8, nc].
// kMute: flags bit 3 mutes the row's view (the edge_filter forms).
// Blocks an SM must hold, so registers a thread: the lanes tick (a
// dependent byte chain) wants warps, 3 blocks (80 registers); the SWAR
// tick wants its registers, 2 (128); the merge gathering 8 rows of 16
// bytes at once 2, the aligned forms' merge 3, or 2 with the suspicion
// counts (each timed on the card against the others; PERF.md, PR 10).
constexpr int tick_blocks(bool swar) { return swar ? 2 : 3; }
constexpr int merge_blocks(int form, bool sus) {
  return onepass::full_view(form) || sus ? 2 : 3;
}

template <bool kSus, bool kFull, bool kMute, bool kSwar>
__global__ void __launch_bounds__(kThreads, tick_blocks(kSwar))
rr_tick_view_kernel(int8_t* __restrict__ hb, int8_t* __restrict__ asl,
                    const int8_t* __restrict__ flags,
                    const int8_t* __restrict__ vecs,
                    int8_t* __restrict__ gmax, int32_t* __restrict__ n_det,
                    int32_t* __restrict__ first_obs,
                    int32_t* __restrict__ entered, Geo g, Knobs kn) {
  const int lane = threadIdx.x % g.lanes;
  const int grp = blockIdx.x * g.slots + threadIdx.x / g.lanes;
  if (grp * kAlign >= g.n) return;
  const SegAt sa = seg_at(g, blockIdx.y, lane);
  if (!sa.words) return;
  TickSink sink{n_det, first_obs, entered};
  tick_group<kSus, kFull, kMute, kSwar>(hb, asl, flags, vecs, gmax, g, grp,
                                        sa, kn, sink);
}

// the merge pass's suspicion outputs (null in the crash-only form)
struct SusOut {
  int32_t* refuted;      // [nc] per subject
  int32_t* held;         // [nc] per subject, post-merge SUSPECT, all rows
  int32_t* suspect_cnt;  // [n] per receiver (the Lifeguard lane), partial
                         // over the block's columns
};

// a row's count over its ``lanes`` threads (neighbouring lanes, one warp
// or, for 64 lanes, two): a shuffle reduction, then one atomic a row and
// warp where it is nonzero; every thread of the warp calls it
__device__ __forceinline__ void row_add(int32_t* out, int row, int v,
                                        int span) {
  for (int o = span >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & (span - 1)) == 0 && v) atomicAdd(out + row, v);
}

// kForm: kFormGroup takes ``senders`` as arc bases (multiples of 8) and
// kn.width = F/8 groups of G[n/8, nc]; kFormEdges int32 [n, F] in-edges
// and kFormArc arc bases [n], kn.width = F, over the whole view G[n, nc];
// the edge_filter forms int32 [n, 2] (arc base, group-match bitmask):
// kFormFilterGroup over G[n/8, nc] with kn.width = F/8, kFormFilterRows
// over the whole view with kn.width = F and kn.group_shift =
// log2(arc_align).  Rows (senders, receivers) are global; the nc columns
// are the block's.
template <bool kSus, bool kLh, int kForm, bool kSwar>
__global__ void __launch_bounds__(kThreads, merge_blocks(kForm, kSus))
rr_merge_kernel(int8_t* __restrict__ hb, int8_t* __restrict__ asl,
                const int8_t* __restrict__ flags,
                const int8_t* __restrict__ vecs,
                const int32_t* __restrict__ senders,
                const int8_t* __restrict__ gmax,
                int32_t* __restrict__ member_cnt,
                int32_t* __restrict__ recv_cnt,
                int32_t* __restrict__ first_obs, SusOut so, Geo g,
                Knobs kn) {
  constexpr bool kFull = onepass::full_view(kForm);
  constexpr int kCounts = kSus ? 3 : 1;
  __shared__ int sums[kCounts][kTile];
  __shared__ __align__(16) int8_t vs[kStackRows * kTile];
  const int t = threadIdx.x;
  const int lane = t % g.lanes;
  const int slot = t / g.lanes;
  const int span = g.lanes < 32 ? g.lanes : 32;
  const size_t nc = (size_t)g.nc;
  const Walk w = walk(g);
  const int8_t* none = reinterpret_cast<const int8_t*>(
      kNoneRows[onepass::mutes(kForm) ? 1 : 0]);
  int32_t* outs[3] = {member_cnt, so.refuted, so.held};
  for (int i = t; i < kCounts * kTile; i += kThreads)
    sums[i / kTile][i % kTile] = 0;
  SwVec vec[kSeg] = {};
  Counts cnt;
  clear(cnt);
  int since = 0;
  int tile = -1;
  SegAt sa{0, 0};
  // the counts of the rows merged since the last flush, into the block's
  // column sums, then one atomic a column
  auto flush = [&]() {
    __syncthreads();
    spill_counts<kSus>(cnt, sa, [&](int c, int q, int v) {
      atomicAdd(&sums[q][c - tile * g.tile], v);
    });
    clear(cnt);
    since = 0;
    __syncthreads();
    for (int i = t; i < g.tile; i += kThreads) {
      const int col = tile * g.tile + i;
      for (int q = 0; q < kCounts; ++q) {
        const int v = sums[q][i];
        if (v) {
          if (col < g.nc) atomicAdd(outs[q] + col, v);
          sums[q][i] = 0;
        }
      }
    }
  };
  Meta<kForm> next;
  if (blockIdx.x < w.items) {
    const int row = (blockIdx.x % w.row_blocks) * g.slots + slot;
    if (row < g.n)
      next = onepass::load_meta<kForm>(flags, senders, row, kn.width);
  }
  for (int item = blockIdx.x; item < w.items; item += gridDim.x) {
    const int it = item / w.row_blocks;
    const int rb = item % w.row_blocks;
    if (it != tile) {
      if (tile >= 0) flush();
      tile = it;
      sa = seg_at(g, tile, lane);
      // stage the tile's stack rows
      __syncthreads();
      for (int i = t; i < kStackRows * g.lanes; i += kThreads) {
        const SegAt si = seg_at(g, tile, i % g.lanes);
        const Seg r = load_seg(vecs + stack_row(i / g.lanes) * nc + si.col0,
                               si.words, g.al16);
        store_seg(vs + (i / g.lanes) * g.tile + (i % g.lanes) * kSegBytes, r,
                  kSeg, true);
      }
      __syncthreads();
      if (kSwar) load_stack(vs, g.tile, lane, vec);
    } else if (since >= kCountMax) {
      flush();
    }
    const int row = rb * g.slots + slot;
    const bool valid = row < g.n && sa.words > 0;
    const Meta<kForm> m = next;
    const int nitem = item + gridDim.x;
    if (nitem < w.items) {
      const int nrow = (nitem % w.row_blocks) * g.slots + slot;
      if (nrow < g.n)
        next = onepass::load_meta<kForm>(flags, senders, nrow, kn.width);
    }
    RowCounts rc{0, 0};
    if (valid) {
      if (!kSwar) load_stack(vs, g.tile, lane, vec);
      const SegAt s = sa;
      auto load = [s, &g](const int8_t* p) {
        return load_seg(p, s.words, g.al16);
      };
      auto gather = [&](const Meta<kForm>& mm, int r) {
        if constexpr (kFull) {
          return onepass::gather_rows<kForm>(
              mm, senders, r, g.n, kn,
              [&](int sr) {
                return sr < 0 ? none : gmax + (size_t)sr * nc + s.col0;
              },
              load);
        } else {
          return onepass::gather_groups<kForm>(
              mm, g.n, kn,
              [&](int gi) {
                return gi < 0 ? none : gmax + (size_t)gi * nc + s.col0;
              },
              load);
        }
      };
      rc = merge_row<kSus, kForm, kSwar>(hb, asl, m, row, g, sa, kn, vec,
                                         gather, cnt);
    }
    ++since;  // every thread: the flush it may call is block-wide
    const int rrow = row < g.n ? row : g.n - 1;
    row_add(recv_cnt, rrow, rc.listed, span);
    if (kLh) row_add(so.suspect_cnt, rrow, rc.held, span);
    // after pass A (stream order): columns no row fired on get the
    // sentinel N (the global row count), as the plain version gives
    if (rb == 0 && slot == 0)
      for (int c = sa.col0; c < sa.col0 + 4 * sa.words; ++c)
        if (first_obs[c] == kFobsUnset) first_obs[c] = g.n;
  }
  if (tile >= 0) flush();
}

// The outputs, split by axis: ``subj`` int32 [3, nc] (member_cnt, n_det,
// first_obs) or [6, nc] adding (entered, refuted, held) under kSus;
// ``recv`` int32 [1, n] (recv_cnt) or [2, n] adding suspect_cnt under kLh.
struct Outs {
  int32_t* subj;
  int32_t* recv;
};

template <bool kSus, bool kLh, int kForm, bool kSwar>
cudaError_t launch_pair(int8_t* hb, int8_t* asl, const int8_t* flags,
                        const int8_t* vecs, const int32_t* senders,
                        int8_t* gmax, Outs o, Geo g, Knobs kn,
                        cudaStream_t s) {
  constexpr bool kFull = onepass::full_view(kForm);
  constexpr bool kMute = onepass::mutes(kForm);
  const size_t c = (size_t)g.nc;
  const int groups = (g.n + kAlign - 1) / kAlign;
  rr_tick_view_kernel<kSus, kFull, kMute, kSwar>
      <<<dim3((groups + g.slots - 1) / g.slots, g.tiles), kThreads, 0, s>>>(
          hb, asl, flags, vecs, gmax, o.subj + c, o.subj + 2 * c,
          kSus ? o.subj + 3 * c : nullptr, g, kn);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  SusOut so{kSus ? o.subj + 4 * c : nullptr, kSus ? o.subj + 5 * c : nullptr,
            kLh ? o.recv + (size_t)g.n : nullptr};
  // the blocks the card holds at once, walking the items
  auto kern = rr_merge_kernel<kSus, kLh, kForm, kSwar>;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                         kThreads, 0)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  kern<<<pass_b_blocks(g, per_sm * sms), kThreads, 0, s>>>(
      hb, asl, flags, vecs, senders, gmax, o.subj, o.recv, o.subj + 2 * c,
      so, g, kn);
  return cudaGetLastError();
}

template <int kForm, bool kSwar>
cudaError_t launch_form(int suspect, int lh, int8_t* hb, int8_t* asl,
                        const int8_t* flags, const int8_t* vecs,
                        const int32_t* senders, int8_t* gmax, Outs o, Geo g,
                        Knobs kn, cudaStream_t s) {
#define RR_ARGS hb, asl, flags, vecs, senders, gmax, o, g, kn, s
  if (!suspect) return launch_pair<false, false, kForm, kSwar>(RR_ARGS);
  if (!lh) return launch_pair<true, false, kForm, kSwar>(RR_ARGS);
  return launch_pair<true, true, kForm, kSwar>(RR_ARGS);
#undef RR_ARGS
}

template <bool kSwar>
cudaError_t launch_elementwise(int form, int suspect, int lh, int8_t* hb,
                               int8_t* asl, const int8_t* flags,
                               const int8_t* vecs, const int32_t* senders,
                               int8_t* gmax, Outs o, Geo g, Knobs kn,
                               cudaStream_t s) {
#define RR_ARGS suspect, lh, hb, asl, flags, vecs, senders, gmax, o, g, kn, s
  switch (form) {
    case kFormGroup: return launch_form<kFormGroup, kSwar>(RR_ARGS);
    case kFormEdges: return launch_form<kFormEdges, kSwar>(RR_ARGS);
    case kFormArc: return launch_form<kFormArc, kSwar>(RR_ARGS);
    case kFormFilterGroup:
      return launch_form<kFormFilterGroup, kSwar>(RR_ARGS);
    default: return launch_form<kFormFilterRows, kSwar>(RR_ARGS);
  }
#undef RR_ARGS
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Launch one round on ``stream`` over a column block of the lanes: all n
// receiver rows, nc subject columns starting at global subject
// ``col_offset`` (the column-shard form; a square round passes nc = n and
// col_offset 0).  hb, asl: int8 [n, nc] row-major, pre-tick, updated in
// place.  flags: int8 [n] (bit 0 active sender, bit 1 small-group
// refresher, bit 2 alive, bit 3 muted sender, read by forms 3 and 4 only,
// bit 4 Lifeguard-degraded receiver).  vecs: int8 [11, nc] threshold
// stack of the shard's subjects.  ``form`` 0 (aligned arcs): senders
// int32 [n] arc starts, multiples of 8 in [0, n), gmax int8 [n/8, nc]
// scratch; 1 (explicit edges): senders int32 [n, fanout] in [0, n), gmax
// int8 [n, nc] scratch; 2 (plain arcs): senders int32 [n] arc starts in
// [0, n), gmax int8 [n, nc] scratch; 3 and 4 (edge_filter: aligned arcs
// of ``align`` with a group-match mask): senders int32 [n, 2] (arc start,
// a multiple of ``align``; bitmask, bit k keeps window group k of the
// fanout / align <= 31), 3 for ``align`` 8 with gmax int8 [n/8, nc], 4
// for any other power of two with gmax int8 [n, nc].  ``align`` is read
// by forms 3 and 4 only.  out_subj: int32 [3, nc] = member_cnt, n_det,
// first_obs per subject (first_obs n where no row fired); with
// ``suspect`` [6, nc], adding entered, refuted and held.  out_recv: int32
// [1, n] = recv_cnt per receiver; with ``lh`` [2, n], adding suspect_cnt;
// both count over the nc columns only (a shard's partial).
// ``confirm_thr`` / ``confirm_thr_hi``: the suspicion confirm ages of a
// healthy / degraded receiver.  ``swar`` 1 runs the SWAR form (same
// outputs).  Returns the CUDA error code of the launches (0 on success).
extern "C" int rr_round(void* hb, void* asl, const void* flags,
                        const void* vecs, const void* senders, void* gmax,
                        void* out_subj, void* out_recv, int n, int nc,
                        int col_offset, int fanout, int form, int align,
                        int t_fail, int t_cooldown, int age_clamp,
                        int suspect, int lh, int confirm_thr,
                        int confirm_thr_hi, int swar, void* stream) {
  if (n <= 0 || n % 4 || nc <= 0 || nc % 4 || col_offset < 0 ||
      col_offset > n - nc || fanout <= 0 || fanout > n || (lh && !suspect) ||
      form < kFormGroup || form > kFormFilterRows ||
      ((form == kFormGroup || form == kFormFilterGroup) &&
       (n % kAlign || fanout % kAlign)))
    return (int)cudaErrorInvalidValue;
  int group_shift = 0;
  if (form >= kFormFilterGroup) {
    // a power of two > 1 dividing n and fanout, at most 31 window groups
    if (align <= 1 || (align & (align - 1)) || n % align || fanout % align ||
        fanout / align > 31 || (form == kFormFilterGroup && align != kAlign))
      return (int)cudaErrorInvalidValue;
    while ((1 << group_shift) < align) ++group_shift;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Outs o{static_cast<int32_t*>(out_subj),
               static_cast<int32_t*>(out_recv)};
  const size_t c = (size_t)nc;
  cudaError_t e =
      cudaMemsetAsync(o.subj, 0, sizeof(int32_t) * (suspect ? 6 : 3) * c, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(o.subj + 2 * c, 0x7F, sizeof(int32_t) * c, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(o.recv, 0, sizeof(int32_t) * (lh ? 2 : 1) * (size_t)n,
                      s);
  if (e != cudaSuccess) return (int)e;
  const bool full = onepass::full_view(form);
  const bool al16 = nc % kSegBytes == 0 && aligned16(hb) && aligned16(asl) &&
                    aligned16(vecs) && aligned16(gmax);
  const Geo g = geometry(n, nc, col_offset, al16);
  const Knobs kn{t_fail, t_cooldown, confirm_thr, confirm_thr_hi, age_clamp,
                 full ? fanout : fanout / kAlign, group_shift};
#define RR_ARGS form, suspect, lh, static_cast<int8_t*>(hb), \
      static_cast<int8_t*>(asl), static_cast<const int8_t*>(flags), \
      static_cast<const int8_t*>(vecs), \
      static_cast<const int32_t*>(senders), static_cast<int8_t*>(gmax), o, \
      g, kn, s
  e = swar ? launch_elementwise<true>(RR_ARGS)
           : launch_elementwise<false>(RR_ARGS);
#undef RR_ARGS
  return (int)e;
}

