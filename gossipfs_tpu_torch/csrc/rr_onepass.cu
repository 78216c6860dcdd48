// The one-pass lean gossip round (K3 form (f)) for NVIDIA Hopper (sm_90a):
// tick, gossip view, merge and the round's reductions in ONE kernel launch
// (after a memset of the [N] per-receiver counts it adds into), each packed
// lane read once and written once.
//
// Replaces the TPU kernel gossipfs_tpu/ops/merge_pallas.py
// resident_round_blocked (:2611) with ``resident=True`` (:2631; the parked
// lanes :1844-1860, :1950-2081, the sweep from them :2340-2420): the TPU
// parks an N x c_blk stripe of ticked lanes in VMEM during the view build
// so the receiver sweep reads no HBM.  The function it computes is the
// two-launch kernel's (resident_round.cu), defined by the plain PyTorch
// version gossipfs_tpu_torch/ops/merge.py resident_round_plain, in every
// merge form (aligned groups, explicit edges, plain arcs, the edge_filter
// forms), crash-only, suspicion and suspicion + Lifeguard, lanes and SWAR,
// square and column block.
//
// Bound.  Bytes: each packed lane read and written once, 4 B per entry
// (1.07 GB at N = 16,384: 0.32 ms at 3.35 TB/s), where the two-launch form
// moves ~8.4 B (aligned) to ~10 B (full view).  On the H100 the round is
// bound by instruction issue, not bytes, so the design cuts the
// instructions a word and the waits (chip_smoke.py's one-pass phase times
// this kernel beside the two-launch form, prints its step timeline and
// counts its SASS; python -m gossipfs_tpu_torch.stub_bisect times it with
// stages compiled out, the RR_STUB variants of rr_onepass.cuh).
//
// Design.  A Hopper block has 227 KB of shared memory, far less than the
// TPU's 102 MB stripe, so a thread-block cluster of kCtas CTAs owns one
// stripe of kC subject columns over all N rows; each CTA parks N / kCtas
// rows of the stripe in dynamic shared memory, one CTA an SM.  Two
// blockings (rr_onepass.cuh Blocking), one library each, ops/merge.py
// onepass_blocking picking the first that holds the shape:
//   this file, Cluster8x32: a portable cluster of 8 CTAs, stripes of 32
//     columns (one 32-byte sector a row segment), both ticked lanes parked,
//     the aligned forms' whole group-max table in every CTA: 12N + 1,280 B
//     a CTA, so N <= 19,264 (N % 64 == 0; 232,448 B, the whole opt-in);
//     4 B an entry;
//   rr_onepass_wide.cu, Cluster16x16: a non-portable cluster of 16 CTAs
//     (16 free SMs of one GPC each: fewer clusters in flight), stripes of
//     16 columns (a 16-byte row segment: half a sector); in the full-view
//     forms asl alone parked and hb read again from device memory in step
//     2 (the tick changes hb only on the diagonal, whose segments step 1
//     parks on the side), in the aligned ones both lanes parked and the
//     group-max table split over the CTAs (each its own groups' rows, the
//     others' gathered through distributed shared memory): 2N + 896 B a
//     CTA in the full-view forms, 17N/8 + 640 in the aligned ones, so N <=
//     115,712 and 109,056 (N % 128 == 0); 5 B an entry in the full-view
//     forms, 4 in the aligned ones.  The TPU runs one pass up to N =
//     69,632 (explicit edges) and 104,448 (arcs with arc_align > 1) at
//     merge_block_c = 512, and N = 65,536 only at that block width
//     (gossipfs_tpu/ops/merge_pallas.py rr_resident_supported, :953).
//     Priced by its stage variants (stub_bisect --n 65536), the wide walk
//     spent 40-42 ms of a 45-85 ms round on its skeleton (the lanes'
//     16-byte pieces, ~550 GB/s), and the full-view forms ~30 ms more on
//     their gathers (16 remote 16-byte rows a receiver); the epilogue, the
//     aligned gathers and the per-receiver atomics little.  So it keeps
//     its clusters in lockstep in the aligned forms (lockstep: a turn's 7
//     clusters walk 7 neighbouring stripes, 112 contiguous bytes of every
//     row, which L2 merges into whole sectors only while they keep in
//     step; left alone they drift 20-120 stripes apart), asks L2 for 128
//     bytes of a row on each lane read from device memory (ldg_seg,
//     copy16), and holds each step-2 thread's receiver rows' metadata and
//     counts across its stripes (rr_onepass.cuh Hold).  The sector-pair
//     stripe order, hb staged beside asl, the park staged (and stored) by
//     tensor copies in one part or four, and the full-view gathers issued
//     a row ahead were each timed and left out: none moved the round
//     (PERF.md).
// The grid is the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters, at most one a stripe), each walking
// stripes c, c + clusters, ... (persistent: one launch's clusters never
// wait for a wave).  A thread takes 16 bytes (4 words) of a row, so every
// lane load and store, parked row access and gathered view row is one
// 16-byte access, and a row's flags, senders and counts are shared by
// kLanes threads (2 or 1), not 8.  The stripe walk is rr_onepass.cuh:
//   step 1  each CTA ticks its rows: asl in place in its park, where
//           cp.async staged it (no register holds it in flight), hb read
//           from device memory a row ahead (the stripe's reads split
//           between the steps: step 2, which also writes both lanes, was
//           bound by them with both staged); the SWAR tick over a thread's
//           8 rows unrolled, the lanes tick a row at a time (unrolled it
//           outgrows the instruction cache) and with no diagonal bump but
//           on the diagonal's word; then it writes its
//           part of the stripe's view: its 8-row group maxes into all 8
//           CTAs' copies of the stripe's group-max table (aligned_group,
//           filter_group; 16-byte distributed shared memory stores, after a
//           cluster barrier that every CTA has reached, so that none writes
//           a CTA that has not started) or into its own split table, or its
//           rows' encoded view into its own slice (edges, arc, filter_rows);
//           detections, the first observer and SUSPECT entries go to the
//           CTA's count block (shared-memory atomics);
//   cluster.sync();
//   step 2  each CTA merges its own receiver rows: best from its own group
//           table, or gathered from the other CTAs' view slices or split
//           tables through distributed shared memory (ld.shared::cluster.v4:
//           a thread computes the slots of its 16 bytes itself, 8 rows in
//           flight),
//           the byte max folded two words an instruction by Hopper's s16x2
//           3-input max (DPX, 2 instructions a word); the epilogue on the
//           parked lanes (the lanes form unpacks and packs bytes by prmt),
//           hb and asl written once, and at once the row's asl segment of
//           the cluster's next stripe staged by cp.async into the park row
//           it frees (the reads spread over step 2; a burst after it waits
//           on the barrier's release); per-receiver counts (recv_cnt, the
//           Lifeguard suspect_cnt) are partial over the stripe's columns:
//           one global atomic per row and stripe into counts the host
//           zeroes before the launch (one memset), or (the wide blocking)
//           summed in the thread's registers over its cluster's stripes
//           and added once after the last; per-subject counts
//           reduce over the warp, then one shared atomic per column pair;
//   cluster.sync(); the next stripe's stack staged.  Per-subject counts
//           are then complete inside the cluster (every row of the stripe
//           is there): CTA r sums its columns of the kCtas count blocks
//           through distributed shared memory and stores them, no global
//           atomics, at the start of the next stripe's step 1 (the other
//           warps tick meanwhile).  Counts alternate between two blocks a
//           CTA by stripe, so no third barrier guards the next stripe's
//           counting; one cluster.sync() after the last stripe keeps every
//           CTA until its blocks are read.
// Shared memory per CTA (onepass::smem_bytes): the parked lanes, the view
// (its rows' slice, the whole table of N/8 group maxes, or its own
// groups'), the stripe's 11-row threshold stack, a row of the gathers'
// start value, the diagonal's rows (Cluster16x16) and two count blocks
// (16-bit column pairs): 197,888 B at N = 16,384 (Cluster8x32), 209,536 B
// at N = 98,304 in the aligned forms and 131,968 at 65,536 in the
// full-view ones (Cluster16x16).
// Rows go to the CTAs by 8-row group round robin (rr_onepass.cuh), so a
// view row's or a group's home is a shift and a mask.  The square round
// and the column block (kBlock, nc and col_offset runtime values) are
// separate instantiations, as in resident_round.cu.  No fallback: a
// refused launch, or an occupancy query that finds no place for a
// cluster, returns its error and the wrapper raises.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "rr_onepass.cuh"

namespace cg = cooperative_groups;
using namespace onepass;

namespace {

// the blocking this library instantiates (rr_onepass_wide.cu defines
// RR_WIDE)
#if defined(RR_WIDE)
using Blk = Cluster16x16;
#else
using Blk = Cluster8x32;
#endif
constexpr int kC = Blk::kC;
constexpr int kCtas = Blk::kCtas;
constexpr int kLanes = Blk::kLanes;
constexpr int kPairs = Blk::kPairs;
constexpr int kFobsAt = Blk::kFobsAt;
constexpr int kBlockWords = Blk::kBlockWords;

// threads a CTA, one CTA an SM (16 warps; a thread's 4 words of a row are
// 4 independent instruction streams)
constexpr int kThreads = 512;

// globaltimer stamps a CTA and stripe in the optional timeline: start,
// step 1 done, view ready (after the cluster sync), step 2 done, end
constexpr int kStamps = 5;

struct Params {
  int8_t* hb;
  int8_t* asl;
  const int8_t* flags;
  const int8_t* vecs;
  const int32_t* senders;
  int32_t* subj;       // [3 or 6, nc]: member_cnt, n_det, first_obs
                       // (entered, refuted, held)
  int32_t* recv;       // [1 or 2, n]: recv_cnt (suspect_cnt), zeroed
  unsigned long long* timeline;  // [stripes, kCtas, kStamps] or null
  int n, nc, col_offset;
  Knobs kn;
};

// step 1's counts into the CTA's count block
struct TickSink {
  uint32_t* cnt;
  __device__ void det(int c, int count, int first_row) {
    atomicAdd(cnt + kSumDet * kPairs + c / 2, pair_addend(c, count));
    atomicMin(reinterpret_cast<int*>(cnt) + kFobsAt + c, first_row);
  }
  __device__ void entered(int c, int count) {
    atomicAdd(cnt + kSumEntered * kPairs + c / 2, pair_addend(c, count));
  }
};

// step 2's counts: per receiver a sum over the row's kLanes threads
// (neighbouring lanes of one warp) and one atomic per row and stripe; per
// subject the counter words summed over the warp's threads of the same
// segment as 16-bit column pairs, then one atomic per pair
template <bool kSus, bool kLh>
struct MergeSink {
  uint32_t* cnt;
  int32_t* recv;  // [n] recv_cnt, then [n] suspect_cnt
  int n;
  __device__ void row(int r, bool valid, int listed, int held) {
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) {
      listed += __shfl_xor_sync(0xffffffffu, listed, o);
      if (kLh) held += __shfl_xor_sync(0xffffffffu, held, o);
    }
    if (!valid || (threadIdx.x % kLanes) != 0) return;
    if (listed) atomicAdd(recv + r, listed);
    if (kLh && held) atomicAdd(recv + n + r, held);
  }
  // a held row's counts over the cluster's stripes (Hold::flush)
  __device__ void add_row(int r, int listed, int held) {
    if (listed) atomicAdd(recv + r, listed);
    if (kLh && held) atomicAdd(recv + n + r, held);
  }
  __device__ void add(int sum, int h, const uint32_t (&w)[kSeg]) {
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      // bytes 0, 1 and bytes 2, 3 as 16-bit halves: columns 2i, 2i + 1
      uint32_t p[2] = {swar::prmt(w[k], 0, 0x4140),
                       swar::prmt(w[k], 0, 0x4342)};
#pragma unroll
      for (int o = kLanes; o < 32; o <<= 1) {
        p[0] += __shfl_xor_sync(0xffffffffu, p[0], o);
        p[1] += __shfl_xor_sync(0xffffffffu, p[1], o);
      }
      if ((threadIdx.x & 31) >= kLanes) continue;
      const int at = sum * kPairs + (kSeg * h + k) * 2;
      if (p[0]) atomicAdd(cnt + at, p[0]);
      if (p[1]) atomicAdd(cnt + at + 1, p[1]);
    }
  }
  __device__ void subj(int h, const uint32_t (&member)[kSeg],
                       const uint32_t (&refuted)[kSeg],
                       const uint32_t (&held)[kSeg]) {
    add(kSumMember, h, member);
    if (kSus && !stubbed(kStubSus)) {
      add(kSumRefuted, h, refuted);
      add(kSumHeld, h, held);
    }
  }
};

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

// 16 bytes from global to shared memory without a register (cp.async,
// bypassing L1); cp.async.wait_all makes them visible to this thread
__device__ __forceinline__ void copy16(int8_t* dst, const int8_t* src) {
  if constexpr (Blk::kWide)
    // as ldg_seg: 128 bytes of the row into L2 on a miss
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t a, const Seg& s) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "r"(s.w[0]), "r"(s.w[1]), "r"(s.w[2]), "r"(s.w[3])
               : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// globaltimer (ns) into the timeline slot ``k`` of this CTA and stripe
__device__ __forceinline__ void stamp(unsigned long long* timeline,
                                      int stripe, int cta, int k) {
  if (timeline == nullptr || threadIdx.x != 0) return;
  timeline[((size_t)stripe * kCtas + cta) * kStamps + k] = globaltimer();
}

// The wide blocking's clusters walk their turns in lockstep (the aligned
// forms; the full-view forms, their step 2 long with gathers, keep in step
// by themselves, and the wait would only add to them).  A turn's
// clusters walk neighbouring stripes (c + clusters * turn), so a row's
// 16-byte pieces of one turn are 112 contiguous bytes (7 clusters), whose
// reads share the sectors L2 brings in and whose partial writes merge
// there into whole sectors, but only while the clusters keep in step: left
// alone they drift apart by tens of stripes within a round (each cluster
// then moves lone half sectors, at ~430 GB/s).  So before each turn, one
// thread a CTA waits until every cluster has begun it (CTA 0's thread 0
// announces its cluster's turn; a finished cluster announces ~0u).  The
// wait is advisory, bounded by kLockstepNs a turn, so that a cluster the
// card did not hold at once only slows the launch; nothing the round
// computes depends on it.  A CTA that has waited its bound once waits no
// more in that launch, so a launch pays at most kLockstepNs a CTA (its
// cluster's CTAs wait side by side: about kLockstepNs a launch).  The
// turns are a __device__ array of the library (one a card: each card's
// context holds its own), which the launcher zeroes before each launch
// beside the per-receiver counts; so two wide launches in flight at once
// on one card would share them, which only loosens their lockstep.
constexpr int kMaxTurns = 64;
constexpr unsigned long long kLockstepNs = 100000;
__device__ unsigned g_turns[kMaxTurns];

// Announce (``announce``) cluster ``me``'s turn and wait for every cluster
// to begin it, unless ``waiting`` is false; false once the bound ran out.
__device__ bool lockstep(volatile unsigned* turns, int me, int clusters,
                         unsigned turn, bool announce, bool waiting) {
  if (announce) turns[me] = turn;
  if (!waiting) return false;
  const unsigned long long t0 = globaltimer();
  for (int q = 0; q < clusters; ++q)
    while (turns[q] < turn) {
      if (globaltimer() - t0 > kLockstepNs) return false;
      __nanosleep(64);
    }
  return true;
}

template <bool kSus, bool kLh, int kForm, bool kSwar, bool kBlock>
__global__ void __launch_bounds__(kThreads, 1)
rr_onepass_kernel(const Params p) {
  constexpr bool kFull = full_view(kForm);
  constexpr bool kParkHb = park_hb<Blk>(kFull);
  constexpr bool kSplit = Blk::kSplitTable && !kFull;
  constexpr int kStats = kSus ? 6 : 3;
  cg::cluster_group cluster = cg::this_cluster();
  const int cta = (int)cluster.block_rank();
  const int n = p.n;
  const int nc = kBlock ? p.nc : n;
  const int col_offset = kBlock ? p.col_offset : 0;
  const int stripes = nc / kC;
  const int clusters = (int)gridDim.x / kCtas;
  const int rows = n / kCtas;
  const int groups = rows / kAlign;
  const int t = threadIdx.x;
  const int h = t % kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  Park pk;
  pk.hb = kParkHb ? reinterpret_cast<int8_t*>(smem) : nullptr;
  pk.asl = reinterpret_cast<int8_t*>(smem) + (kParkHb ? (size_t)rows * kC : 0);
  pk.view = pk.asl + (size_t)rows * kC;
  int8_t* vs = pk.view + (size_t)view_rows<Blk>(n, kFull) * kC;
  int8_t* none = vs + N_VEC * kC;
  pk.diag = none + kC;
  uint32_t* blocks =
      reinterpret_cast<uint32_t*>(pk.diag + diag_rows<Blk>(kFull) * kC);
  auto stage_copy = [](int8_t* dst, const int8_t* src) { copy16(dst, src); };
  int stripe = (int)blockIdx.x / kCtas;
  stage<Blk>(p.asl, p.vecs, stripe_at<Blk>(n, nc, col_offset, stripe), pk,
             vs, cta, rows, t, kThreads, stage_copy);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int i = t; i < kBlockWords; i += kThreads)
    blocks[i] = blank_count<Blk>(i, n);
  if (t < Blk::kWords)
    reinterpret_cast<uint32_t*>(none)[t] = gather_none(kForm);
  // a step-2 thread's held rows (the wide blocking): their Meta, once
  using HoldT = std::conditional_t<(Blk::kHeld > 0), Hold<Blk, kForm, kLh>,
                                   NoHold>;
  HoldT hold;
  if constexpr (HoldT::kRows > 0)
    hold.load(p.flags, p.senders, cta, rows, t, kThreads, p.kn.width);
  // a step-1 thread's first group: its rows' flags, the same every stripe
  GroupFlags fw{};
  if (t / kLanes < groups)
    fw = group_flags(p.flags, group_row0<Blk>(cta, t / kLanes));
  const uint32_t view_sa = (uint32_t)__cvta_generic_to_shared(pk.view);
  const uint32_t none_ca =
      mapa((uint32_t)__cvta_generic_to_shared(none) + 4 * kSeg * h, cta);

  // the aligned forms of the narrow blocking: each group max into every
  // CTA's table, so that step 2 gathers from its own shared memory.  A CTA
  // may touch another's shared memory only once that one runs: every
  // thread arrives at a cluster barrier here and waits on it before its
  // first push (or after the first step 1, if it pushed nothing); later
  // stripes push after the previous stripe's last barrier, when every CTA
  // has read its table.  The split table of the wide blocking takes each
  // group max into its own CTA's table only, and step 2 reads the others'
  // after the cluster barrier, as the full-view forms read view rows
  bool started = kFull || kSplit;
  if (!started) asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
  auto put_group = [&](int g, int hh, const Seg& v) {
    if constexpr (kSplit) {
      store_seg(pk.view + group_home<Blk>(g).local * kC + 4 * kSeg * hh, v);
      return;
    }
    if (!started) {
      asm volatile("barrier.cluster.wait;" ::: "memory");
      started = true;
    }
    const uint32_t a = view_sa + g * kC + 4 * kSeg * hh;
#pragma unroll
    for (int q = 0; q < kCtas; ++q) st_cluster(mapa(a, q), v);
  };
  auto gather = [&](const auto& m, int row, int hh) -> Seg {
    if constexpr (kFull) {
      return gather_rows<kForm>(
          m, p.senders, row, n, p.kn,
          [&](int s) -> uint32_t {
            if (s < 0) return none_ca;
            const Where w = row_home<Blk>(s);
            return mapa(view_sa + w.local * kC + 4 * kSeg * hh, w.cta);
          },
          [](uint32_t a) { return ld_cluster(a); });
    } else if constexpr (kSplit) {
      return gather_groups<kForm>(
          m, n, p.kn,
          [&](int g) -> uint32_t {
            if (g < 0) return none_ca;
            const Where w = group_home<Blk>(g);
            return mapa(view_sa + w.local * kC + 4 * kSeg * hh, w.cta);
          },
          [](uint32_t a) { return ld_cluster(a); });
    } else {
      return gather_groups<kForm>(
          m, n, p.kn,
          [&](int g) -> const int8_t* {
            return g < 0 ? none + 4 * kSeg * hh
                         : pk.view + g * kC + 4 * kSeg * hh;
          },
          [](const int8_t* a) { return load_seg(a); });
    }
  };

  // CTA ``cta`` stores its kC / kCtas columns of every stat of stripe
  // ``done`` from the count blocks ``blk`` of the cluster
  constexpr int kCols = kC / kCtas;
  auto finish_stripe = [&](int done, const uint32_t* blk) {
    if (t >= kCols * kStats) return;
    const int s = t / kCols;
    const int c = kCols * cta + t % kCols;
    p.subj[(size_t)s * nc + done * kC + c] = finish<Blk>(s, c, [&](int q) {
      return (const uint32_t*)cluster.map_shared_rank(blk, q);
    });
  };

  const bool in_step = Blk::kWide && !kFull && clusters <= kMaxTurns;
  volatile unsigned* turns = g_turns;
  bool waiting = true;
  for (int it = 0; stripe < stripes; stripe += clusters, ++it) {
    const Stripe sp = stripe_at<Blk>(n, nc, col_offset, stripe);
    uint32_t* cnt = blocks + (it & 1) * kBlockWords;
    stamp(p.timeline, stripe, cta, 0);
    if constexpr (Blk::kWide)
      if (in_step && t == 0)
        waiting = lockstep(turns, (int)blockIdx.x / kCtas, clusters,
                           (unsigned)it, cta == 0, waiting);
    // the staged rows and stack (every thread's copies) in place
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    // the previous stripe's outputs, from its blocks (complete at its last
    // barrier, cleared again only after this stripe's next one), while the
    // other warps tick
    if (it > 0)
      finish_stripe(stripe - clusters, blocks + ((it - 1) & 1) * kBlockWords);
    TickSink ts{cnt};
    step1<Blk, kSus, kFull, mutes(kForm), kSwar>(p.hb, p.flags, vs, sp, p.kn,
                                                 pk, cta, groups, t, kThreads,
                                                 fw, ts, put_group);
    if (!started) {
      asm volatile("barrier.cluster.wait;" ::: "memory");
      started = true;
    }
    stamp(p.timeline, stripe, cta, 1);
    cluster.sync();
    stamp(p.timeline, stripe, cta, 2);
    // the next stripe's block: every CTA read it (the finish two stripes
    // back) before it reached the barrier above
    uint32_t* spare = blocks + ((it + 1) & 1) * kBlockWords;
    for (int i = t; i < kBlockWords; i += kThreads)
      spare[i] = blank_count<Blk>(i, n);
    MergeSink<kSus, kLh> ms{cnt, p.recv, n};
    // each merged row's next-stripe segments go out at once, spread over
    // step 2 (the row's park segment is this thread's alone)
    const bool more = stripe + clusters < stripes;
    const Stripe next = stripe_at<Blk>(n, nc, col_offset, stripe + clusters);
    step2<Blk, kSus, kForm, kSwar>(p.hb, p.asl, p.flags, vs, p.senders, sp,
                                   p.kn, pk, cta, rows, t, kThreads, gather,
                                   ms, [&](int li, int hh) {
                                     if (more)
                                       stage_row<Blk>(p.asl, next, pk, cta,
                                                      li, hh, stage_copy);
                                   }, &hold);
    stamp(p.timeline, stripe, cta, 3);
    cluster.sync();
    // every thread done with the stack: the next one's copies
    if (more) stage_stack<Blk>(p.vecs, next, vs, t, kThreads, stage_copy);
    else finish_stripe(stripe, cnt);
    stamp(p.timeline, stripe, cta, 4);
  }
  if constexpr (Blk::kWide)
    if (in_step && t == 0 && cta == 0) turns[blockIdx.x / kCtas] = ~0u;
  // the held rows' per-receiver counts, once
  if constexpr (HoldT::kRows > 0) {
    MergeSink<kSus, kLh> ms{nullptr, p.recv, n};
    hold.flush(ms, cta, rows, t, kThreads);
  }
  // no CTA leaves while another reads its count blocks
  cluster.sync();
}

template <bool kSus, bool kLh, int kForm, bool kSwar, bool kBlock>
cudaError_t launch(const Params& p, int* clusters_out, cudaStream_t s) {
  auto kern = rr_onepass_kernel<kSus, kLh, kForm, kSwar, kBlock>;
  const size_t smem = (size_t)smem_bytes<Blk>(p.n, full_view(kForm));
  cudaError_t e;
  const int stripes = (kBlock ? p.nc : p.n) / kC;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(stripes * kCtas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the shared-memory limit raised and the clusters of this instantiation
  // the card holds at once at this size asked, once a size and card: none
  // refuses the launch
  constexpr int kMaxCards = 64;
  static size_t checked[kMaxCards] = {};
  static int held[kMaxCards] = {};
  int card = 0;
  e = cudaGetDevice(&card);
  if (e != cudaSuccess) return e;
  if (card >= kMaxCards) return cudaErrorInvalidDevice;
  if (clusters_out != nullptr || checked[card] != smem) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (kCtas > 8) {
      // past the portable cluster size of 8
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
    }
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    checked[card] = smem;
    held[card] = clusters;
    if (clusters_out != nullptr) {
      cudaFuncAttributes fa;
      e = cudaFuncGetAttributes(&fa, kern);
      if (e != cudaSuccess) return e;
      clusters_out[0] = clusters;
      clusters_out[1] = (int)smem;
      clusters_out[2] = fa.maxDynamicSharedSizeBytes;
      return cudaSuccess;
    }
  }
  // persistent clusters: as many as the card holds, none without a stripe
  cfg.gridDim = dim3((held[card] < stripes ? held[card] : stripes) * kCtas);
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool kSus, bool kLh, int kForm, bool kSwar>
cudaError_t launch_shape(const Params& p, int* clusters, cudaStream_t s) {
  if (p.nc == p.n && p.col_offset == 0)
    return launch<kSus, kLh, kForm, kSwar, false>(p, clusters, s);
  return launch<kSus, kLh, kForm, kSwar, true>(p, clusters, s);
}

template <int kForm, bool kSwar>
cudaError_t launch_mode(int suspect, int lh, const Params& p, int* clusters,
                        cudaStream_t s) {
  if (!suspect) return launch_shape<false, false, kForm, kSwar>(p, clusters, s);
  if (!lh) return launch_shape<true, false, kForm, kSwar>(p, clusters, s);
  return launch_shape<true, true, kForm, kSwar>(p, clusters, s);
}

#if defined(RR_ONLY_FORM)
// A stage variant's build (ops/_build.py, load with defines) compiles the
// one instantiation it is built for: merge form RR_ONLY_FORM, mode
// RR_ONLY_MODE (0 crash-only, 1 suspicion, 2 suspicion + Lifeguard),
// RR_ONLY_SWAR and RR_ONLY_BLOCK; a launch that asks for another returns
// cudaErrorInvalidValue.
cudaError_t dispatch(int form, int suspect, int lh, int swar, const Params& p,
                     int* clusters, cudaStream_t s) {
  constexpr bool kSus = RR_ONLY_MODE > 0;
  constexpr bool kLh = RR_ONLY_MODE > 1;
  const bool block = !(p.nc == p.n && p.col_offset == 0);
  if (form != RR_ONLY_FORM || (suspect != 0) != kSus || (lh != 0) != kLh ||
      (swar != 0) != (RR_ONLY_SWAR != 0) || block != (RR_ONLY_BLOCK != 0))
    return cudaErrorInvalidValue;
  return launch<kSus, kLh, RR_ONLY_FORM, RR_ONLY_SWAR != 0,
                RR_ONLY_BLOCK != 0>(p, clusters, s);
}
#else
template <bool kSwar>
cudaError_t launch_form(int form, int suspect, int lh, const Params& p,
                        int* clusters, cudaStream_t s) {
  switch (form) {
    case kFormGroup:
      return launch_mode<kFormGroup, kSwar>(suspect, lh, p, clusters, s);
    case kFormEdges:
      return launch_mode<kFormEdges, kSwar>(suspect, lh, p, clusters, s);
    case kFormArc:
      return launch_mode<kFormArc, kSwar>(suspect, lh, p, clusters, s);
    case kFormFilterGroup:
      return launch_mode<kFormFilterGroup, kSwar>(suspect, lh, p, clusters,
                                                  s);
    default:
      return launch_mode<kFormFilterRows, kSwar>(suspect, lh, p, clusters, s);
  }
}

cudaError_t dispatch(int form, int suspect, int lh, int swar, const Params& p,
                     int* clusters, cudaStream_t s) {
  return swar ? launch_form<true>(form, suspect, lh, p, clusters, s)
              : launch_form<false>(form, suspect, lh, p, clusters, s);
}
#endif

int run(void* hb, void* asl, const void* flags, const void* vecs,
        const void* senders, void* out_subj, void* out_recv, void* timeline, int n, int nc, int col_offset, int fanout, int form,
        int align, int t_fail, int t_cooldown, int age_clamp, int suspect,
        int lh,
        int confirm_thr, int confirm_thr_hi, int swar, int* clusters,
        void* stream) {
  const bool group = form == kFormGroup || form == kFormFilterGroup;
  if (n <= 0 || n % (kCtas * kAlign) || nc <= 0 || nc % kC ||
      col_offset < 0 || col_offset > n - nc ||
      fanout <= 0 || fanout > n || (lh && !suspect) || form < kFormGroup ||
      form > kFormFilterRows || (group && fanout % kAlign))
    return (int)cudaErrorInvalidValue;
  int group_shift = 0;
  if (form >= kFormFilterGroup) {
    if (align <= 1 || (align & (align - 1)) || n % align || fanout % align ||
        fanout / align > 31 || (form == kFormFilterGroup && align != kAlign))
      return (int)cudaErrorInvalidValue;
    while ((1 << group_shift) < align) ++group_shift;
  }
  // 16-byte row segments
  if ((reinterpret_cast<uintptr_t>(hb) | reinterpret_cast<uintptr_t>(asl) |
       reinterpret_cast<uintptr_t>(vecs)) & 15)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p;
  p.hb = static_cast<int8_t*>(hb);
  p.asl = static_cast<int8_t*>(asl);
  p.flags = static_cast<const int8_t*>(flags);
  p.vecs = static_cast<const int8_t*>(vecs);
  p.senders = static_cast<const int32_t*>(senders);
  p.subj = static_cast<int32_t*>(out_subj);
  p.recv = static_cast<int32_t*>(out_recv);
  p.timeline = static_cast<unsigned long long*>(timeline);
  p.n = n;
  p.nc = nc;
  p.col_offset = col_offset;
  p.kn = Knobs{t_fail, t_cooldown, confirm_thr, confirm_thr_hi, age_clamp,
               group ? fanout / kAlign : fanout, group_shift};
  if (clusters == nullptr) {
    cudaError_t e = cudaMemsetAsync(
        p.recv, 0, sizeof(int32_t) * (lh ? 2 : 1) * (size_t)n, s);
    if (e != cudaSuccess) return (int)e;
    if (Blk::kWide) {
      // the clusters' turns (lockstep), zero for this launch
      void* turns = nullptr;
      e = cudaGetSymbolAddress(&turns, g_turns);
      if (e == cudaSuccess) e = cudaMemsetAsync(turns, 0, sizeof g_turns, s);
      if (e != cudaSuccess) return (int)e;
    }
  }
  return (int)dispatch(form, suspect, lh, swar, p, clusters, s);
}

}  // namespace

// Launch one round on ``stream`` in one pass: the arguments and outputs of
// resident_round.cu's rr_round (every output written; out_recv complete),
// for n % (kCtas * 8) == 0, nc % kC == 0 (64 and 32 here, 128 and 16 in
// rr_onepass_wide.cu) and a shared-memory need (onepass::smem_bytes) the
// card grants: one memset of out_recv (the per-receiver counts add up
// there by global atomics), then one launch.  ``timeline`` null, or uint64
// [nc / kC, kCtas, kStamps]: each CTA's globaltimer stamps (ns) of its
// stripe's steps.  rr_onepass_wide.cu zeroes its clusters' turns
// (lockstep) before the launch too.  Returns the CUDA error code (0 on
// success).
extern "C" int rr_onepass(void* hb, void* asl, const void* flags,
                          const void* vecs, const void* senders,
                          void* out_subj, void* out_recv, void* timeline, int n, int nc, int col_offset,
                          int fanout,
                          int form, int align, int t_fail, int t_cooldown,
                          int age_clamp, int suspect, int lh,
                          int confirm_thr, int confirm_thr_hi, int swar,
                          void* stream) {
  return run(hb, asl, flags, vecs, senders, out_subj, out_recv, timeline, n, nc, col_offset, fanout, form, align, t_fail,
             t_cooldown,
             age_clamp, suspect, lh, confirm_thr, confirm_thr_hi, swar,
             nullptr, stream);
}

// The instantiation rr_onepass would launch for this shape and form, into
// clusters[3] (launches nothing): cudaOccupancyMaxActiveClusters, the
// dynamic shared memory a CTA it asks for (onepass::smem_bytes) and the
// kernel's opt-in maximum as cudaFuncGetAttributes reports it.
extern "C" int rr_onepass_clusters(int n, int nc, int col_offset, int fanout,
                                   int form, int align, int suspect, int lh,
                                   int swar, int* clusters) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, n, nc, col_offset, fanout, form, align, 1, 1, 63,
             suspect, lh, 0, 0, swar, clusters, nullptr);
}
