// One lean gossip round (tick, gossip view, merge and the round's
// reductions) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gossipfs_tpu/ops/merge_pallas.py
// resident_round_blocked (:2611) in its merge forms: aligned arcs of
// 8-row sender groups, explicit [n, F] in-edges, and plain arcs (F
// consecutive sender rows from a per-receiver base; aligned bases of any
// other granularity take this form too); each crash-only and with the
// SWIM lifecycle (suspect / confirm in the tick, refute in the merge, the
// Lifeguard stretch as a per-row confirm threshold on flags bit 4).  The
// function it computes is defined by the plain PyTorch version,
// gossipfs_tpu_torch/ops/merge.py resident_round_plain.
//
// Bound.  The round is pure byte traffic plus small integer arithmetic:
// the information floor reads and writes each packed lane once, 4 B per
// [receiver, subject] entry (1.07 GB at N = 16,384: 0.32 ms at the H100's
// 3.35 TB/s).  The TPU kernel met that floor by parking the ticked lanes in
// VMEM for the receiver sweep; a Hopper block has 227 KB of shared memory,
// far too little to park an N-row stripe, and blocks run in no order.
//
// Design (simple and right first).  Two launches in stream order:
//   A  rr_tick_view_kernel: one block per 8-row sender group x 1024-column
//      tile, 4 subjects per thread (one 4-byte load per lane per row).
//      Ticks every entry and writes the post-tick lanes back, encodes the
//      gossip view and writes the group max G[N/8, N] (int8), and counts
//      detections per subject (n_det, lowest firing row) with atomics on
//      the rare firing columns.
//   B  rr_merge_kernel: one block per 32 receiver rows x 1024-column tile.
//      best = max over the arc's F/8 groups of G, then the merge epilogue
//      on the post-tick lanes in place; member_cnt accumulates over the
//      block's rows in registers (one atomic per column per block) and
//      recv_cnt is a warp reduce plus one atomic per warp and row.
// That moves about 8.4 B per entry (lanes read and written twice, G once
// written and read twice), 2.1x the floor.  Integer counts make every
// atomic order give the same result.  4 subjects per thread keeps each
// pass near 60 registers (16 per thread needed ~180, and the low
// occupancy left the card idle between loads).  Each subject still costs
// an estimated ~100 scalar integer instructions over the two passes (byte
// extracts included), which would make instruction issue, not bytes, the
// limit: the SWAR form below packs 4 subjects per 32-bit op to test that.
//
// The explicit-edge and plain-arc forms (kFullView) run pass A with the
// same 8-row blocks but write every sender row's encoded view, so G is the
// whole view [N, N] int8 (5 B per entry instead of 4 1/8), and pass B
// gathers each receiver's F sender rows through gather_rows.cuh (K1's
// gather): edges[row, f] for explicit edges, (base + f) mod N for plain
// arcs.  A dead receiver skips its gather: the epilogue is gated on its
// alive bit, which is why explicit edges need no remap for dead
// receivers (merge_pallas.py:2665-2666).  The F gathered rows of one
// 1,024-column tile lie in that tile's view strip (16 MB at N = 16,384),
// which the blocks in flight share through L2.  These forms move about
// 10 B per entry (lanes twice each way, the view written once and read
// once from device memory), 2.5x the floor.  The aligned-group form's
// instantiations compile as before: kFullView and kForm are template
// constants.
//
// The suspicion form (kSus) is the same two launches: pass A also counts
// the entries that entered SUSPECT per subject (a bit per group row, like
// the detections), pass B the refuted entries and the entries still
// SUSPECT after the merge per subject (registers over the block's rows,
// one atomic each), and with the Lifeguard lane (kLh) the per-receiver
// count of post-merge SUSPECT entries (a warp reduce, like recv_cnt),
// which the round loop turns into next round's flags bit 4.  The
// crash-only instantiation is the code it was.
//
// The edge_filter forms (the scenario engine on aligned arcs,
// merge_pallas.py:2276-2301 and the mute on flags bit 3) are two more
// instantiations of the same two launches.  Pass A (kMute) reads flags
// bit 3: a muted sender ticks as ever and its view row encodes absent
// (rr_elem.cuh rr_sends).  Pass B takes senders as int32 [n, 2] (arc base,
// group-match bitmask) and gathers through gather_rows.cuh
// gather_max_masked: kFormFilterGroup (arc_align 8) the masked max over
// the arc's F/8 group maxes of G[n/8, n]; kFormFilterRows (any other
// alignment) the masked max over the arc's F rows of the whole view, row f
// kept iff bit f / arc_align is set.  A dropped group contributes -1, so
// a zero mask (a receiver in a blacked-out rack) merges nothing and only
// ages.  Bytes as the aligned form's (filter_group) or the plain-arc
// form's (filter_rows), plus 8 B of senders per receiver.
//
// The SWAR form (kSwar, config elementwise="swar"; the JAX package's
// _rr_tick_view_swar / _rr_merge_swar, merge_pallas.py:1643, :1720) is
// one more template flag on both launches, every merge form and
// suspicion mode: the same blocks, gathers and bytes, with the per-entry
// arithmetic on one 32-bit word of 4 subjects per thread and row
// (rr_swar.cuh: carry-safe byte-SIMD compares and selects, ~2x the
// operations of one lane's on 1/4 the lanes, and no byte extracts).  The
// words the diagonal crosses keep the lanes functions, as the JAX kernel
// keeps its diagonal chunks on the lanes path.  Counts accumulate as
// 0/1-per-byte counter words.  Its outputs are the lanes form's bit for
// bit; if it is faster, the lanes form was issue-bound.
//
// The column-shard form (the JAX kernel's ``col_offset``,
// merge_pallas.py:2633, :1887) is the same code over a tall-skinny block:
// all n receiver rows, nc subject columns starting at global subject
// ``col_offset``.  Every buffer indexed by subject ([n, nc] lanes, the
// [11, nc] stack, G[*, nc]) takes nc as its row stride and the grid's
// column tiles cover nc; rows, senders and flags stay global.  The
// diagonal sits at row == col_offset + local column, so a shard holds it
// for rows [col_offset, col_offset + nc) only (a SWAR word it crosses is
// found the same way).  Per-subject outputs are the shard's [nc]; the
// per-receiver counts (recv_cnt, suspect_cnt) are partial, over the
// shard's columns, and the round loop sums them across shards.  A square
// round is nc = n, col_offset = 0: the same launches, from instantiations
// where those are compile-time facts (kBlock false), so the square code is
// what it was; a column block runs the kBlock instantiations.
#include <cstdint>
#include <cuda_runtime.h>

#include "gather_rows.cuh"
#include "rr_elem.cuh"
#include "rr_swar.cuh"

namespace {

constexpr int kAlign = 8;              // rows per sender group (and per
                                       // pass-A block)
constexpr int kVec = 4;                // subjects per thread
constexpr int kThreads = 256;
constexpr int kTile = kVec * kThreads;  // columns per block
constexpr int kRowsB = 32;             // receiver rows per merge block
constexpr int kFobsUnset = 0x7F7F7F7F;  // memset(0x7F) sentinel

// pass B's merge forms (rr_round's ``form``)
enum {
  kFormGroup = 0, kFormEdges = 1, kFormArc = 2, kFormFilterGroup = 3,
  kFormFilterRows = 4
};

// kVec int8 lanes moved as one vector load/store
template <int V> struct Word;
template <> struct Word<4> { using T = int; };
template <> struct Word<8> { using T = int2; };
template <> struct Word<16> { using T = int4; };

union Bytes {
  Word<kVec>::T v;
  int8_t b[kVec];
};

__device__ __forceinline__ Bytes load_vec(const int8_t* p) {
  Bytes u;
  u.v = *reinterpret_cast<const Word<kVec>::T*>(p);
  return u;
}

__device__ __forceinline__ void store_vec(int8_t* p, const Bytes& u) {
  *reinterpret_cast<Word<kVec>::T*>(p) = u.v;
}

// the tick's suspicion thresholds (unused by the crash-only form)
struct SusThr {
  int confirm, confirm_hi;
};

// kFullView: G is the whole view [n, n] (each row's encoded values), else
// the 8-row group max [n/8, n].  kMute: flags bit 3 mutes the row's view
// (the edge_filter forms).
template <bool kSus, bool kFullView, bool kMute>
__device__ __forceinline__ void tick_view_lanes(
    int8_t* __restrict__ hb, int8_t* __restrict__ asl,
    const int8_t* __restrict__ flags, const int8_t* __restrict__ vecs,
    int8_t* __restrict__ gmax, int32_t* __restrict__ n_det,
    int32_t* __restrict__ first_obs, int32_t* __restrict__ entered, int n,
    int nc, int col_offset, int t_fail, int t_cooldown, SusThr sus) {
  const int grp = blockIdx.x;
  const int col0 = blockIdx.y * kTile + threadIdx.x * kVec;
  if (col0 >= nc) return;
  const Bytes sa_n = load_vec(vecs + (size_t)V_SA_N * nc + col0);
  const Bytes sa_all = load_vec(vecs + (size_t)V_SA_ALL * nc + col0);
  const Bytes hi_n = load_vec(vecs + (size_t)V_HI_N * nc + col0);
  const Bytes thr_g = load_vec(vecs + (size_t)V_THR_G * nc + col0);
  // per subject: the group max of the view, and a bit per group row
  // whose detector fired
  int gm[kVec];
  unsigned fired[kVec], ent[kVec];
  // a ragged last block (n % 8 != 0) in the full-view form
  const int rows = kFullView ? min(kAlign, n - grp * kAlign) : kAlign;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    gm[k] = -128;
    fired[k] = 0;
    ent[k] = 0;
  }
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    const int row = grp * kAlign + r;
    const int f = flags[row];
    const bool act = (f & 1) != 0;
    const bool ref = (f & 2) != 0;
    const bool lh = (f & 16) != 0;
    const bool sends = rr_sends(f, kMute);
    const size_t off = (size_t)row * nc + col0;
    Bytes h = load_vec(hb + off);
    Bytes a = load_vec(asl + off);
    Bytes venc;
    // the diagonal sits at k == d: global column col_offset + col0 + k
    const int d = row - (col_offset + col0);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      int th, ta;
      bool fail, elig;
      if (kSus) {
        const RrTickSus t = rr_tick_sus(h.b[k], a.b[k], act, ref, k == d, lh,
                                        thr_g.b[k], t_fail, t_cooldown,
                                        sus.confirm, sus.confirm_hi);
        th = t.hb;
        ta = t.asl;
        fail = t.fail;
        elig = t.elig;
        ent[k] |= (unsigned)t.entered << r;
      } else {
        const RrTick t = rr_tick(h.b[k], a.b[k], act, ref, k == d,
                                 thr_g.b[k], t_fail, t_cooldown);
        th = t.hb;
        ta = t.asl;
        fail = t.fail;
        elig = t.elig;
      }
      h.b[k] = (int8_t)th;
      a.b[k] = (int8_t)ta;
      const int enc = rr_view(th, elig, sends, sa_n.b[k], sa_all.b[k],
                              hi_n.b[k]);
      if (kFullView)
        venc.b[k] = (int8_t)enc;
      else
        gm[k] = max(gm[k], enc);
      fired[k] |= (unsigned)fail << r;
    }
    store_vec(hb + off, h);
    store_vec(asl + off, a);
    if (kFullView) store_vec(gmax + off, venc);
  }
  if (!kFullView) {
    Bytes g;
#pragma unroll
    for (int k = 0; k < kVec; ++k) g.b[k] = (int8_t)gm[k];
    store_vec(gmax + (size_t)grp * nc + col0, g);
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (fired[k]) {
      atomicAdd(n_det + col0 + k, __popc(fired[k]));
      atomicMin(first_obs + col0 + k, grp * kAlign + __ffs(fired[k]) - 1);
    }
    if (kSus && ent[k]) atomicAdd(entered + col0 + k, __popc(ent[k]));
  }
}

// Pass A in the SWAR form: the same block walk with one 4-subject word
// per thread and row.  A word the diagonal crosses (row in [col0, col0 +
// 4)) takes the lanes functions byte by byte; every other word the
// eye-free word tick (rr_swar.cuh).  The group max is one maxs per word;
// detections and SUSPECT entries accumulate as 0/1-per-byte counter words
// over the block's 8 rows (at most 8 per byte), unpacked once before the
// atomics; the lowest firing row per byte rides a word of row numbers
// written where a byte fires first (the rare path, behind a branch).
template <bool kSus, bool kFullView, bool kMute>
__device__ __forceinline__ void tick_view_swar(
    int8_t* __restrict__ hb, int8_t* __restrict__ asl,
    const int8_t* __restrict__ flags, const int8_t* __restrict__ vecs,
    int8_t* __restrict__ gmax, int32_t* __restrict__ n_det,
    int32_t* __restrict__ first_obs, int32_t* __restrict__ entered, int n,
    int nc, int col_offset, int t_fail, int t_cooldown, SusThr sus) {
  const int grp = blockIdx.x;
  const int col0 = blockIdx.y * kTile + threadIdx.x * kVec;
  if (col0 >= nc) return;
  // the stack rows pass A reads
  SwVec vec{};
  vec.v[V_SA_N] = swar::load(vecs + (size_t)V_SA_N * nc + col0);
  vec.v[V_SA_ALL] = swar::load(vecs + (size_t)V_SA_ALL * nc + col0);
  vec.v[V_HI_N] = swar::load(vecs + (size_t)V_HI_N * nc + col0);
  vec.v[V_THR_G] = swar::load(vecs + (size_t)V_THR_G * nc + col0);
  uint32_t gm = swar::H;  // -128 per byte
  uint32_t det = 0, ent = 0, seen = 0, first = 0;
  const int rows = kFullView ? min(kAlign, n - grp * kAlign) : kAlign;
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    const int row = grp * kAlign + r;
    const int f = flags[row];
    const bool act = (f & 1) != 0;
    const bool ref = (f & 2) != 0;
    const bool lh = (f & 16) != 0;
    const bool sends = rr_sends(f, kMute);
    const size_t off = (size_t)row * nc + col0;
    const uint32_t h = swar::load(hb + off);
    const uint32_t a = swar::load(asl + off);
    // the diagonal's byte, if in [0, 4): global column col_offset + col0
    const int d = row - (col_offset + col0);
    const SwTickView t =
        (unsigned)d < 4u
            ? rr_tick_view_lanes_word<kSus>(h, a, act, ref, lh, sends, d,
                                            vec, t_fail, t_cooldown,
                                            sus.confirm, sus.confirm_hi)
            : rr_tick_view_swar<kSus>(h, a, swar::row(act), swar::row(ref),
                                      swar::row(lh), swar::row(sends), vec,
                                      t_fail, t_cooldown, sus.confirm,
                                      sus.confirm_hi);
    swar::store(hb + off, t.hb);
    swar::store(asl + off, t.asl);
    if (kFullView)
      swar::store(gmax + off, t.enc);
    else
      gm = swar::maxs(gm, t.enc);
    det += t.fail >> 7;
    if (t.fail) {
      const uint32_t fresh = t.fail & ~seen;
      seen |= t.fail;
      first = swar::sel(swar::bytes(fresh), swar::word(r), first);
    }
    if (kSus) ent += t.entered >> 7;
  }
  if (!kFullView) swar::store(gmax + (size_t)grp * nc + col0, gm);
  if (!(det | ent)) return;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int c = (det >> (8 * k)) & 0xFF;
    if (c) {
      atomicAdd(n_det + col0 + k, c);
      atomicMin(first_obs + col0 + k,
                grp * kAlign + (int)((first >> (8 * k)) & 0xFF));
    }
    const int e = (ent >> (8 * k)) & 0xFF;
    if (kSus && e) atomicAdd(entered + col0 + k, e);
  }
}

// kSwar picks the SWAR form of the pass, same outputs.  kBlock: the
// column-shard form; without it the pass is the square round, nc = n and
// col_offset = 0 as compile-time facts (the square kernels then compile
// to the code they had before the column-shard form existed).
template <bool kSus, bool kFullView, bool kMute, bool kSwar, bool kBlock>
__global__ void __launch_bounds__(kThreads)
rr_tick_view_kernel(int8_t* __restrict__ hb, int8_t* __restrict__ asl,
                    const int8_t* __restrict__ flags,
                    const int8_t* __restrict__ vecs,
                    int8_t* __restrict__ gmax, int32_t* __restrict__ n_det,
                    int32_t* __restrict__ first_obs,
                    int32_t* __restrict__ entered, int n, int nc,
                    int col_offset, int t_fail, int t_cooldown, SusThr sus) {
  if (!kBlock) {
    nc = n;
    col_offset = 0;
  }
  if constexpr (kSwar)
    tick_view_swar<kSus, kFullView, kMute>(hb, asl, flags, vecs, gmax, n_det,
                                           first_obs, entered, n, nc,
                                           col_offset, t_fail, t_cooldown,
                                           sus);
  else
    tick_view_lanes<kSus, kFullView, kMute>(hb, asl, flags, vecs, gmax,
                                            n_det, first_obs, entered, n, nc,
                                            col_offset, t_fail, t_cooldown,
                                            sus);
}

// After pass A (stream order): columns no row fired on get the sentinel
// N (the global row count, whatever the shard's width), as the plain
// version gives.  Run by pass B's first row of blocks.
__device__ __forceinline__ void fobs_unset_to_n(int32_t* first_obs, int col0,
                                                int n) {
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    if (first_obs[col0 + k] == kFobsUnset) first_obs[col0 + k] = n;
}

// the merge pass's suspicion outputs (null in the crash-only form)
struct SusOut {
  int32_t* refuted;      // [nc] per subject
  int32_t* held;         // [nc] per subject, post-merge SUSPECT, all rows
  int32_t* suspect_cnt;  // [n] per receiver (the Lifeguard lane), partial
                         // over the shard's columns
};

// kForm: kFormGroup takes ``senders`` as arc bases (multiples of 8) and
// ``width`` = F/8 groups of G[n/8, nc]; kFormEdges takes ``senders`` as
// int32 [n, width] in-edges and kFormArc as arc bases [n], ``width`` = F,
// both over the whole view G[n, nc].  The edge_filter forms take
// ``senders`` as int32 [n, 2] (arc base, group-match bitmask):
// kFormFilterGroup over G[n/8, nc] with ``width`` = F/8, kFormFilterRows
// over the whole view with ``width`` = F and ``group_shift`` =
// log2(arc_align).  Rows (senders, receivers) are global; the nc columns
// are the shard's.
template <bool kSus, bool kLh, int kForm>
__device__ __forceinline__ void merge_lanes(
    int8_t* __restrict__ hb, int8_t* __restrict__ asl,
    const int8_t* __restrict__ flags, const int8_t* __restrict__ vecs,
    const int32_t* __restrict__ senders, const int8_t* __restrict__ gmax,
    int32_t* __restrict__ member_cnt, int32_t* __restrict__ recv_cnt,
    int32_t* __restrict__ first_obs, SusOut so, int n, int nc, int width,
    int group_shift, int age_clamp) {
  const int row0 = blockIdx.x * kRowsB;
  const int col0 = blockIdx.y * kTile + threadIdx.x * kVec;
  // every lane of a warp takes part in the row reductions below, so a
  // thread past the last column stays in the loop with nothing to count
  const bool valid = col0 < nc;
  const int nb = n / kAlign;
  Bytes vr[N_VEC];
#pragma unroll
  for (int i = 0; i < N_VEC; ++i) {
    vr[i].v = Word<kVec>::T{};
    if (valid && i != V_SA_ALL && i != V_HI_N && i != V_THR_G)
      vr[i] = load_vec(vecs + (size_t)i * nc + col0);
  }
  int cnt[kVec], ref[kVec], hld[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    cnt[k] = 0;
    ref[k] = 0;
    hld[k] = 0;
  }
#pragma unroll 1
  for (int r = 0; r < kRowsB; ++r) {
    const int row = row0 + r;
    if (row >= n) break;  // uniform across the block
    int listed_sum = 0;
    int sus_sum = 0;
    if (valid) {
      const bool recv = (flags[row] & 4) != 0;
      Bytes best;
      if (kForm == kFormGroup) {
        const int g0 = senders[row] / kAlign;
        best = load_vec(gmax + (size_t)g0 * nc + col0);
        for (int w = 1; w < width; ++w) {
          const int g = (g0 + w) % nb;
          const Bytes o = load_vec(gmax + (size_t)g * nc + col0);
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            best.b[k] = (int8_t)max((int)best.b[k], (int)o.b[k]);
        }
      } else {
        // a dead receiver's best is never read (the epilogue is gated
        // on recv), so it skips the gather
        int bm[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k) bm[k] = -1;
        if (recv) {
          if (kForm == kFormEdges) {
            const int32_t* e = senders + (size_t)row * width;
            gather_rows::gather_max_block<int8_t, kVec, true>(
                gmax, n, nc, col0, kVec, width, [e](int f) { return e[f]; },
                bm);
          } else if (kForm == kFormArc) {
            const int base = senders[row];
            gather_rows::gather_max_block<int8_t, kVec, true>(
                gmax, n, nc, col0, kVec, width,
                [base, n](int f) {
                  const int s = base + f;
                  return s >= n ? s - n : s;
                },
                bm);
          } else if (kForm == kFormFilterGroup) {
            const int g0 = senders[2 * (size_t)row] / kAlign;
            const unsigned mask = (unsigned)senders[2 * (size_t)row + 1];
            gather_rows::gather_max_masked<int8_t, kVec, true>(
                gmax, nb, nc, col0, kVec, width, 0, mask,
                [g0, nb](int k) {
                  const int g = g0 + k;
                  return g >= nb ? g - nb : g;
                },
                bm);
          } else {
            const int base = senders[2 * (size_t)row];
            const unsigned mask = (unsigned)senders[2 * (size_t)row + 1];
            gather_rows::gather_max_masked<int8_t, kVec, true>(
                gmax, n, nc, col0, kVec, width, group_shift, mask,
                [base, n](int f) {
                  const int s = base + f;
                  return s >= n ? s - n : s;
                },
                bm);
          }
        }
#pragma unroll
        for (int k = 0; k < kVec; ++k) best.b[k] = (int8_t)bm[k];
      }
      const size_t off = (size_t)row * nc + col0;
      Bytes h = load_vec(hb + off);
      Bytes a = load_vec(asl + off);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        int v[N_VEC];
#pragma unroll
        for (int i = 0; i < N_VEC; ++i) v[i] = vr[i].b[k];
        const RrMerge m = rr_merge_t<kSus>(h.b[k], a.b[k], best.b[k], recv,
                                           v, age_clamp);
        h.b[k] = (int8_t)m.hb;
        a.b[k] = (int8_t)m.asl;
        const int st = m.asl & 3;
        const int listed = kSus ? (st & 1) : st == RR_MEMBER;
        cnt[k] += recv ? listed : 0;
        listed_sum += listed;
        if (kSus) {
          const int held = st == RR_SUSPECT;
          ref[k] += m.refuted ? 1 : 0;
          hld[k] += held;
          sus_sum += held;
        }
      }
      store_vec(hb + off, h);
      store_vec(asl + off, a);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      listed_sum += __shfl_down_sync(0xffffffffu, listed_sum, o);
    if ((threadIdx.x & 31) == 0 && listed_sum)
      atomicAdd(recv_cnt + row, listed_sum);
    if (kLh) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sus_sum += __shfl_down_sync(0xffffffffu, sus_sum, o);
      if ((threadIdx.x & 31) == 0 && sus_sum)
        atomicAdd(so.suspect_cnt + row, sus_sum);
    }
  }
  if (!valid) return;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (cnt[k]) atomicAdd(member_cnt + col0 + k, cnt[k]);
    if (kSus && ref[k]) atomicAdd(so.refuted + col0 + k, ref[k]);
    if (kSus && hld[k]) atomicAdd(so.held + col0 + k, hld[k]);
  }
  if (blockIdx.x == 0) fobs_unset_to_n(first_obs, col0, n);
}

// Pass B in the SWAR form: the byte max over the groups or gathered rows
// is one maxs per word, the epilogue rr_merge_swar_t; recv_cnt and the
// Lifeguard SUSPECT count are __popc of a 0/1-per-byte word into the same
// warp reduce, and the per-subject member, refuted and held counts
// accumulate as 0/1-per-byte counter words over the block's 32 rows (at
// most 32 per byte), unpacked once before the atomics.
template <bool kSus, bool kLh, int kForm>
__device__ __forceinline__ void merge_swar(
    int8_t* __restrict__ hb, int8_t* __restrict__ asl,
    const int8_t* __restrict__ flags, const int8_t* __restrict__ vecs,
    const int32_t* __restrict__ senders, const int8_t* __restrict__ gmax,
    int32_t* __restrict__ member_cnt, int32_t* __restrict__ recv_cnt,
    int32_t* __restrict__ first_obs, SusOut so, int n, int nc, int width,
    int group_shift, int age_clamp) {
  using swar::word;
  const int row0 = blockIdx.x * kRowsB;
  const int col0 = blockIdx.y * kTile + threadIdx.x * kVec;
  // every lane of a warp takes part in the row reductions below, so a
  // thread past the last column stays in the loop with nothing to count
  const bool valid = col0 < nc;
  const int nb = n / kAlign;
  // the stack rows the epilogue reads (pass A's four are not)
  SwVec vec{};
#pragma unroll
  for (int i = 0; i < N_VEC; ++i)
    if (valid && i != V_SA_ALL && i != V_HI_N && i != V_THR_G)
      vec.v[i] = swar::load(vecs + (size_t)i * nc + col0);
  uint32_t cnt = 0, refw = 0, hld = 0;
#pragma unroll 1
  for (int r = 0; r < kRowsB; ++r) {
    const int row = row0 + r;
    if (row >= n) break;  // uniform across the block
    int listed_sum = 0;
    int sus_sum = 0;
    if (valid) {
      const bool recv = (flags[row] & 4) != 0;
      uint32_t best = 0xFFFFFFFFu;
      if (kForm == kFormGroup) {
        const int g0 = senders[row] / kAlign;
        best = swar::load(gmax + (size_t)g0 * nc + col0);
        for (int w = 1; w < width; ++w) {
          const int g = (g0 + w) % nb;
          best = swar::maxs(best, swar::load(gmax + (size_t)g * nc + col0));
        }
      } else if (recv) {
        // a dead receiver's best is never read: it skips the gather
        if (kForm == kFormEdges) {
          const int32_t* e = senders + (size_t)row * width;
          best = gather_max_swar(gmax, n, nc, col0, width,
                                 [e](int f) { return e[f]; });
        } else if (kForm == kFormArc) {
          const int base = senders[row];
          best = gather_max_swar(gmax, n, nc, col0, width, [base, n](int f) {
            const int s = base + f;
            return s >= n ? s - n : s;
          });
        } else if (kForm == kFormFilterGroup) {
          const int g0 = senders[2 * (size_t)row] / kAlign;
          const unsigned mask = (unsigned)senders[2 * (size_t)row + 1];
          best = gather_max_masked_swar(gmax, nb, nc, col0, width, 0, mask,
                                        [g0, nb](int k) {
                                          const int g = g0 + k;
                                          return g >= nb ? g - nb : g;
                                        });
        } else {
          const int base = senders[2 * (size_t)row];
          const unsigned mask = (unsigned)senders[2 * (size_t)row + 1];
          best = gather_max_masked_swar(gmax, n, nc, col0, width, group_shift,
                                        mask, [base, n](int f) {
                                          const int s = base + f;
                                          return s >= n ? s - n : s;
                                        });
        }
      }
      const size_t off = (size_t)row * nc + col0;
      const SwMerge m = rr_merge_swar_t<kSus>(
          swar::load(hb + off), swar::load(asl + off), best, swar::row(recv),
          vec, age_clamp);
      swar::store(hb + off, m.hb);
      swar::store(asl + off, m.asl);
      const uint32_t st = m.asl & word(3);
      // 0/1 per byte: listed (status bit 0 under suspicion), SUSPECT
      const uint32_t listed =
          kSus ? st & swar::L : swar::eq(st, word(RR_MEMBER)) >> 7;
      if (recv) cnt += listed;
      listed_sum = __popc(listed);
      if (kSus) {
        const uint32_t held = swar::eq(st, word(RR_SUSPECT)) >> 7;
        refw += m.refuted & swar::L;
        hld += held;
        sus_sum = __popc(held);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      listed_sum += __shfl_down_sync(0xffffffffu, listed_sum, o);
    if ((threadIdx.x & 31) == 0 && listed_sum)
      atomicAdd(recv_cnt + row, listed_sum);
    if (kLh) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sus_sum += __shfl_down_sync(0xffffffffu, sus_sum, o);
      if ((threadIdx.x & 31) == 0 && sus_sum)
        atomicAdd(so.suspect_cnt + row, sus_sum);
    }
  }
  if (!valid) return;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int s = 8 * k;
    if ((cnt >> s) & 0xFF) atomicAdd(member_cnt + col0 + k, (cnt >> s) & 0xFF);
    if (kSus && ((refw >> s) & 0xFF))
      atomicAdd(so.refuted + col0 + k, (refw >> s) & 0xFF);
    if (kSus && ((hld >> s) & 0xFF))
      atomicAdd(so.held + col0 + k, (hld >> s) & 0xFF);
  }
  if (blockIdx.x == 0) fobs_unset_to_n(first_obs, col0, n);
}

// kSwar picks the SWAR form of the pass, same outputs; kBlock as pass
// A's.
template <bool kSus, bool kLh, int kForm, bool kSwar, bool kBlock>
__global__ void __launch_bounds__(kThreads)
rr_merge_kernel(int8_t* __restrict__ hb, int8_t* __restrict__ asl,
                const int8_t* __restrict__ flags,
                const int8_t* __restrict__ vecs,
                const int32_t* __restrict__ senders,
                const int8_t* __restrict__ gmax,
                int32_t* __restrict__ member_cnt,
                int32_t* __restrict__ recv_cnt,
                int32_t* __restrict__ first_obs, SusOut so, int n, int nc,
                int width, int group_shift, int age_clamp) {
  if (!kBlock) nc = n;
  if constexpr (kSwar)
    merge_swar<kSus, kLh, kForm>(hb, asl, flags, vecs, senders, gmax,
                                 member_cnt, recv_cnt, first_obs, so, n, nc,
                                 width, group_shift, age_clamp);
  else
    merge_lanes<kSus, kLh, kForm>(hb, asl, flags, vecs, senders, gmax,
                                  member_cnt, recv_cnt, first_obs, so, n, nc,
                                  width, group_shift, age_clamp);
}

// The round's geometry: ``n`` global rows (receivers and senders), ``nc``
// local columns (the row stride of every [*, nc] buffer), the first of
// which is global subject ``col_offset``.  A square round is nc = n,
// col_offset = 0.
struct Shape {
  int n, nc, col_offset;
};

// The outputs, split by axis: ``subj`` int32 [3, nc] (member_cnt, n_det,
// first_obs) or [6, nc] adding (entered, refuted, held) under kSus;
// ``recv`` int32 [1, n] (recv_cnt) or [2, n] adding suspect_cnt under kLh.
struct Outs {
  int32_t* subj;
  int32_t* recv;
};

template <bool kSus, bool kLh, int kForm, bool kSwar, bool kBlock>
cudaError_t launch_pair(int8_t* hb, int8_t* asl, const int8_t* flags,
                        const int8_t* vecs, const int32_t* senders,
                        int8_t* gmax, Outs o, Shape sh, int fanout,
                        int group_shift, int t_fail, int t_cooldown,
                        SusThr sus, int age_clamp, cudaStream_t s) {
  constexpr bool kFull = kForm != kFormGroup && kForm != kFormFilterGroup;
  constexpr bool kMute = kForm == kFormFilterGroup || kForm == kFormFilterRows;
  const int n = sh.n, nc = sh.nc;
  const int tiles = (nc + kTile - 1) / kTile;
  const size_t c = (size_t)nc;
  rr_tick_view_kernel<kSus, kFull, kMute, kSwar, kBlock>
      <<<dim3((n + kAlign - 1) / kAlign, tiles), kThreads, 0, s>>>(
          hb, asl, flags, vecs, gmax, o.subj + c, o.subj + 2 * c,
          kSus ? o.subj + 3 * c : nullptr, n, nc, sh.col_offset, t_fail,
          t_cooldown, sus);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  SusOut so{kSus ? o.subj + 4 * c : nullptr, kSus ? o.subj + 5 * c : nullptr,
            kLh ? o.recv + (size_t)n : nullptr};
  rr_merge_kernel<kSus, kLh, kForm, kSwar, kBlock>
      <<<dim3((n + kRowsB - 1) / kRowsB, tiles), kThreads, 0, s>>>(
          hb, asl, flags, vecs, senders, gmax, o.subj, o.recv, o.subj + 2 * c,
          so, n, nc, kFull ? fanout : fanout / kAlign, group_shift,
          age_clamp);
  return cudaGetLastError();
}

// The two launches of one round: the square kernels for a square round,
// the column-shard ones for a column block.
template <bool kSus, bool kLh, int kForm, bool kSwar>
cudaError_t launch_round(int8_t* hb, int8_t* asl, const int8_t* flags,
                         const int8_t* vecs, const int32_t* senders,
                         int8_t* gmax, Outs o, Shape sh, int fanout,
                         int group_shift, int t_fail, int t_cooldown,
                         SusThr sus, int age_clamp, cudaStream_t s) {
#define RR_ARGS hb, asl, flags, vecs, senders, gmax, o, sh, fanout, \
      group_shift, t_fail, t_cooldown, sus, age_clamp, s
  if (sh.nc == sh.n && sh.col_offset == 0)
    return launch_pair<kSus, kLh, kForm, kSwar, false>(RR_ARGS);
  return launch_pair<kSus, kLh, kForm, kSwar, true>(RR_ARGS);
#undef RR_ARGS
}

template <int kForm, bool kSwar>
cudaError_t launch_form(int suspect, int lh, int8_t* hb, int8_t* asl,
                        const int8_t* flags, const int8_t* vecs,
                        const int32_t* senders, int8_t* gmax, Outs o,
                        Shape sh, int fanout, int group_shift, int t_fail,
                        int t_cooldown, SusThr sus, int age_clamp,
                        cudaStream_t s) {
#define RR_ARGS hb, asl, flags, vecs, senders, gmax, o, sh, fanout, \
      group_shift, t_fail, t_cooldown, sus, age_clamp, s
  if (!suspect) return launch_round<false, false, kForm, kSwar>(RR_ARGS);
  if (!lh) return launch_round<true, false, kForm, kSwar>(RR_ARGS);
  return launch_round<true, true, kForm, kSwar>(RR_ARGS);
#undef RR_ARGS
}

template <bool kSwar>
cudaError_t launch_elementwise(int form, int suspect, int lh, int8_t* hb,
                               int8_t* asl, const int8_t* flags,
                               const int8_t* vecs, const int32_t* senders,
                               int8_t* gmax, Outs o, Shape sh, int fanout,
                               int group_shift, int t_fail, int t_cooldown,
                               SusThr sus, int age_clamp, cudaStream_t s) {
#define RR_ARGS suspect, lh, hb, asl, flags, vecs, senders, gmax, o, sh, \
      fanout, group_shift, t_fail, t_cooldown, sus, age_clamp, s
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
  if (n <= 0 || n % kVec || nc <= 0 || nc % kVec || col_offset < 0 ||
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
  const SusThr sus{confirm_thr, confirm_thr_hi};
  const Shape sh{n, nc, col_offset};
#define RR_ARGS form, suspect, lh, static_cast<int8_t*>(hb), \
      static_cast<int8_t*>(asl), static_cast<const int8_t*>(flags), \
      static_cast<const int8_t*>(vecs), \
      static_cast<const int32_t*>(senders), static_cast<int8_t*>(gmax), o, \
      sh, fanout, group_shift, t_fail, t_cooldown, sus, age_clamp, s
  e = swar ? launch_elementwise<true>(RR_ARGS)
           : launch_elementwise<false>(RR_ARGS);
#undef RR_ARGS
  return (int)e;
}
