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
// limit: packing 4 subjects per 32-bit op (the JAX package's SWAR form) is
// the next step to try.
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
#include <cstdint>
#include <cuda_runtime.h>

#include "gather_rows.cuh"
#include "rr_elem.cuh"

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
__global__ void __launch_bounds__(kThreads)
rr_tick_view_kernel(int8_t* __restrict__ hb, int8_t* __restrict__ asl,
                    const int8_t* __restrict__ flags,
                    const int8_t* __restrict__ vecs,
                    int8_t* __restrict__ gmax, int32_t* __restrict__ n_det,
                    int32_t* __restrict__ first_obs,
                    int32_t* __restrict__ entered, int n, int t_fail,
                    int t_cooldown, SusThr sus) {
  const int grp = blockIdx.x;
  const int col0 = blockIdx.y * kTile + threadIdx.x * kVec;
  if (col0 >= n) return;
  const Bytes sa_n = load_vec(vecs + (size_t)V_SA_N * n + col0);
  const Bytes sa_all = load_vec(vecs + (size_t)V_SA_ALL * n + col0);
  const Bytes hi_n = load_vec(vecs + (size_t)V_HI_N * n + col0);
  const Bytes thr_g = load_vec(vecs + (size_t)V_THR_G * n + col0);
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
    const size_t off = (size_t)row * n + col0;
    Bytes h = load_vec(hb + off);
    Bytes a = load_vec(asl + off);
    Bytes venc;
    const int d = row - col0;  // the diagonal sits at k == d
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
    store_vec(gmax + (size_t)grp * n + col0, g);
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

// the merge pass's suspicion outputs (null in the crash-only form)
struct SusOut {
  int32_t* refuted;      // [n] per subject
  int32_t* held;         // [n] per subject, post-merge SUSPECT, all rows
  int32_t* suspect_cnt;  // [n] per receiver (the Lifeguard lane)
};

// kForm: kFormGroup takes ``senders`` as arc bases (multiples of 8) and
// ``width`` = F/8 groups of G[n/8, n]; kFormEdges takes ``senders`` as
// int32 [n, width] in-edges and kFormArc as arc bases [n], ``width`` = F,
// both over the whole view G[n, n].  The edge_filter forms take
// ``senders`` as int32 [n, 2] (arc base, group-match bitmask):
// kFormFilterGroup over G[n/8, n] with ``width`` = F/8, kFormFilterRows
// over the whole view with ``width`` = F and ``group_shift`` =
// log2(arc_align).
template <bool kSus, bool kLh, int kForm>
__global__ void __launch_bounds__(kThreads)
rr_merge_kernel(int8_t* __restrict__ hb, int8_t* __restrict__ asl,
                const int8_t* __restrict__ flags,
                const int8_t* __restrict__ vecs,
                const int32_t* __restrict__ senders,
                const int8_t* __restrict__ gmax,
                int32_t* __restrict__ member_cnt,
                int32_t* __restrict__ recv_cnt,
                int32_t* __restrict__ first_obs, SusOut so, int n, int width,
                int group_shift, int age_clamp) {
  const int row0 = blockIdx.x * kRowsB;
  const int col0 = blockIdx.y * kTile + threadIdx.x * kVec;
  // every lane of a warp takes part in the row reductions below, so a
  // thread past the last column stays in the loop with nothing to count
  const bool valid = col0 < n;
  const int nb = n / kAlign;
  Bytes vr[N_VEC];
#pragma unroll
  for (int i = 0; i < N_VEC; ++i) {
    vr[i].v = Word<kVec>::T{};
    if (valid && i != V_SA_ALL && i != V_HI_N && i != V_THR_G)
      vr[i] = load_vec(vecs + (size_t)i * n + col0);
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
        best = load_vec(gmax + (size_t)g0 * n + col0);
        for (int w = 1; w < width; ++w) {
          const int g = (g0 + w) % nb;
          const Bytes o = load_vec(gmax + (size_t)g * n + col0);
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
            gather_rows::gather_max<int8_t, kVec, true>(
                gmax, n, col0, kVec, width, [e](int f) { return e[f]; }, bm);
          } else if (kForm == kFormArc) {
            const int base = senders[row];
            gather_rows::gather_max<int8_t, kVec, true>(
                gmax, n, col0, kVec, width,
                [base, n](int f) {
                  const int s = base + f;
                  return s >= n ? s - n : s;
                },
                bm);
          } else if (kForm == kFormFilterGroup) {
            const int g0 = senders[2 * (size_t)row] / kAlign;
            const unsigned mask = (unsigned)senders[2 * (size_t)row + 1];
            gather_rows::gather_max_masked<int8_t, kVec, true>(
                gmax, nb, n, col0, kVec, width, 0, mask,
                [g0, nb](int k) {
                  const int g = g0 + k;
                  return g >= nb ? g - nb : g;
                },
                bm);
          } else {
            const int base = senders[2 * (size_t)row];
            const unsigned mask = (unsigned)senders[2 * (size_t)row + 1];
            gather_rows::gather_max_masked<int8_t, kVec, true>(
                gmax, n, n, col0, kVec, width, group_shift, mask,
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
      const size_t off = (size_t)row * n + col0;
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
  if (blockIdx.x == 0) {
    // pass A has finished (stream order): columns no row fired on get
    // the sentinel N, as the plain version gives
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (first_obs[col0 + k] == kFobsUnset) first_obs[col0 + k] = n;
  }
}

template <bool kSus, bool kLh, int kForm>
cudaError_t launch_round(int8_t* hb, int8_t* asl, const int8_t* flags,
                         const int8_t* vecs, const int32_t* senders,
                         int8_t* gmax, int32_t* o, int n, int fanout,
                         int group_shift, int t_fail, int t_cooldown,
                         SusThr sus, int age_clamp, cudaStream_t s) {
  constexpr bool kFull = kForm != kFormGroup && kForm != kFormFilterGroup;
  constexpr bool kMute = kForm == kFormFilterGroup || kForm == kFormFilterRows;
  const int tiles = (n + kTile - 1) / kTile;
  const size_t nn = (size_t)n;
  rr_tick_view_kernel<kSus, kFull, kMute>
      <<<dim3((n + kAlign - 1) / kAlign, tiles), kThreads, 0, s>>>(
          hb, asl, flags, vecs, gmax, o + nn, o + 2 * nn,
          kSus ? o + 4 * nn : nullptr, n, t_fail, t_cooldown, sus);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  SusOut so{kSus ? o + 5 * nn : nullptr, kSus ? o + 6 * nn : nullptr,
            kLh ? o + 7 * nn : nullptr};
  rr_merge_kernel<kSus, kLh, kForm>
      <<<dim3((n + kRowsB - 1) / kRowsB, tiles), kThreads, 0, s>>>(
          hb, asl, flags, vecs, senders, gmax, o, o + 3 * nn, o + 2 * nn, so,
          n, kFull ? fanout : fanout / kAlign, group_shift, age_clamp);
  return cudaGetLastError();
}

template <int kForm>
cudaError_t launch_form(int suspect, int lh, int8_t* hb, int8_t* asl,
                        const int8_t* flags, const int8_t* vecs,
                        const int32_t* senders, int8_t* gmax, int32_t* o,
                        int n, int fanout, int group_shift, int t_fail,
                        int t_cooldown, SusThr sus, int age_clamp,
                        cudaStream_t s) {
#define RR_ARGS hb, asl, flags, vecs, senders, gmax, o, n, fanout, \
      group_shift, t_fail, t_cooldown, sus, age_clamp, s
  if (!suspect) return launch_round<false, false, kForm>(RR_ARGS);
  if (!lh) return launch_round<true, false, kForm>(RR_ARGS);
  return launch_round<true, true, kForm>(RR_ARGS);
#undef RR_ARGS
}

}  // namespace

// Launch one round on ``stream``.  hb, asl: int8 [n, n] row-major,
// pre-tick, updated in place.  flags: int8 [n] (bit 0 active sender,
// bit 1 small-group refresher, bit 2 alive, bit 3 muted sender, read by
// forms 3 and 4 only, bit 4 Lifeguard-degraded receiver).  vecs: int8 [11, n] threshold stack.  ``form`` 0 (aligned
// arcs): senders int32 [n] arc starts, multiples of 8 in [0, n), gmax
// int8 [n/8, n] scratch; 1 (explicit edges): senders int32 [n, fanout]
// in [0, n), gmax int8 [n, n] scratch; 2 (plain arcs): senders int32 [n]
// arc starts in [0, n), gmax int8 [n, n] scratch; 3 and 4 (edge_filter:
// aligned arcs of ``align`` with a group-match mask): senders int32 [n, 2]
// (arc start, a multiple of ``align``; bitmask, bit k keeps window group
// k of the fanout / align <= 31), 3 for ``align`` 8 with gmax int8
// [n/8, n], 4 for any other power of two with gmax int8 [n, n].
// ``align`` is read by forms 3 and 4 only.  out:
// int32 [4, n] = member_cnt, n_det, first_obs, recv_cnt; with ``suspect``
// [7, n], adding entered, refuted and held per subject; with ``lh`` too
// [8, n], adding suspect_cnt per receiver.  ``confirm_thr`` /
// ``confirm_thr_hi``: the suspicion confirm ages of a healthy / degraded
// receiver.  Returns the CUDA error code of the launches (0 on success).
extern "C" int rr_round(void* hb, void* asl, const void* flags,
                        const void* vecs, const void* senders, void* gmax,
                        void* out, int n, int fanout, int form, int align,
                        int t_fail, int t_cooldown, int age_clamp,
                        int suspect, int lh, int confirm_thr,
                        int confirm_thr_hi, void* stream) {
  if (n <= 0 || n % kVec || fanout <= 0 || fanout > n || (lh && !suspect) ||
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
  int32_t* o = static_cast<int32_t*>(out);
  const int rows = suspect ? (lh ? 8 : 7) : 4;
  cudaError_t e = cudaMemsetAsync(o, 0, sizeof(int32_t) * rows * (size_t)n, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(o + 2 * (size_t)n, 0x7F, sizeof(int32_t) * (size_t)n, s);
  if (e != cudaSuccess) return (int)e;
  const SusThr sus{confirm_thr, confirm_thr_hi};
#define RR_ARGS suspect, lh, static_cast<int8_t*>(hb), \
      static_cast<int8_t*>(asl), static_cast<const int8_t*>(flags), \
      static_cast<const int8_t*>(vecs), \
      static_cast<const int32_t*>(senders), static_cast<int8_t*>(gmax), o, \
      n, fanout, group_shift, t_fail, t_cooldown, sus, age_clamp, s
  if (form == kFormGroup) e = launch_form<kFormGroup>(RR_ARGS);
  else if (form == kFormEdges) e = launch_form<kFormEdges>(RR_ARGS);
  else if (form == kFormArc) e = launch_form<kFormArc>(RR_ARGS);
  else if (form == kFormFilterGroup) e = launch_form<kFormFilterGroup>(RR_ARGS);
  else e = launch_form<kFormFilterRows>(RR_ARGS);
#undef RR_ARGS
  return (int)e;
}
