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
// bound by instruction issue, not bytes: each step costs what the
// two-launch form's pass of the same work costs (chip_smoke.py's one-pass
// phase times both and prints this kernel's step timeline).
//
// Design.  A Hopper block has 227 KB of shared memory, far less than the
// TPU's 102 MB stripe, so a thread-block cluster of kCtas = 8 CTAs owns one
// stripe of kC = 32 subject columns over all N rows (one 32-byte sector per
// row segment); each CTA parks N/8 rows of the stripe in dynamic shared
// memory, one CTA an SM.  The stripe walk is rr_onepass.cuh:
//   step 1  each CTA reads its rows' hb and asl once (a thread's 8 rows of
//           one word issued together), ticks them, parks the ticked lanes
//           and writes its part of the stripe's view: its 8-row group
//           maxes into all 8 CTAs' copies of the stripe's group-max table
//           (aligned_group, filter_group; distributed shared memory
//           stores, after a cluster barrier that every CTA has reached,
//           so that none writes a CTA that has not started), or its rows'
//           encoded view into its own slice (edges,
//           arc, filter_rows); detections, the first observer and SUSPECT
//           entries go to the CTA's count block (shared-memory atomics);
//   cluster.sync();
//   step 2  each CTA merges its own receiver rows: best from its own group
//           table, or gathered from the other CTAs' view slices through
//           distributed shared memory (ld.shared::cluster; a row's 8 lanes
//           compute the sender slots two each and share them by shuffle,
//           16 loads in flight), the byte max folded two words an
//           instruction by Hopper's s16x2 3-input max (DPX); the epilogue
//           on the parked lanes, hb and asl written once; per-receiver
//           counts (recv_cnt, the Lifeguard suspect_cnt) are partial over
//           the stripe's columns: one global atomic per row and stripe
//           into counts the host zeroes before the launch (one 64 KB
//           memset; per-stripe partials summed by a second kernel were
//           measured 1.4-2.8 % slower, PERF.md);
//   cluster.sync(); per-subject counts are complete inside the cluster
//           (every row of the stripe is there): CTA r sums its columns of
//           the 8 count blocks through distributed shared memory and
//           stores them, no global atomics; cluster.sync() so no CTA
//           leaves while its block is read.
// Shared memory per CTA: 2 * N/8 * 32 B of parked lanes, an N/8-row view
// (its rows' slice, or the whole table of N/8 group maxes) and 768 B of
// counts: 197,376 B at N = 16,384.  The full-view forms fit there with
// C = 32 and a portable cluster of 8, so neither way out of the limit is
// taken: C = 16 would halve the 32-byte sector each row segment fills,
// and a non-portable cluster of 16 needs 16 free SMs in one GPC, which
// leaves fewer clusters in flight.  The largest N is 19,264
// (N % 64 == 0); a larger N runs the two-launch form
// (ops/merge.onepass_fits), as the TPU does at N = 65,536.  Rows go to the
// CTAs by 8-row group round robin (rr_onepass.cuh), so a view row's home is
// a shift and a mask.  The square round and the column block (kBlock, nc
// and col_offset runtime values) are separate instantiations, as in
// resident_round.cu.  No fallback: a refused launch, or an occupancy query
// that finds no place for a cluster, returns its error and the wrapper
// raises.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rr_onepass.cuh"

namespace cg = cooperative_groups;
using namespace onepass;

namespace {

// threads a CTA, one CTA an SM: the lanes form takes 128 registers a
// thread (512 threads fill the register file), the SWAR form under 100,
// which leaves room for 768: more warps to cover step 2's gather latency
constexpr int kThreadsLanes = 512;
constexpr int kThreadsSwar = 768;

template <bool kSwar>
__host__ __device__ constexpr int threads() {
  return kSwar ? kThreadsSwar : kThreadsLanes;
}

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
  int32_t* cnt;
  __device__ void det(int c, int count, int first_row) {
    atomicAdd(cnt + kDet * kC + c, count);
    atomicMin(cnt + kFobs * kC + c, first_row);
  }
  __device__ void entered(int c, int count) {
    atomicAdd(cnt + kEntered * kC + c, count);
  }
};

// step 2's counts: per receiver a sum over the row's kWords threads (8
// consecutive lanes of one warp) and one atomic per row and stripe; per
// subject into the CTA's count block
template <bool kSus, bool kLh>
struct MergeSink {
  int32_t* cnt;
  int32_t* recv;  // [n] recv_cnt, then [n] suspect_cnt
  int n;
  __device__ void row(int r, bool valid, int listed, int held) {
#pragma unroll
    for (int o = 1; o < kWords; o <<= 1) {
      listed += __shfl_xor_sync(0xffffffffu, listed, o);
      if (kLh) held += __shfl_xor_sync(0xffffffffu, held, o);
    }
    if (!valid || (threadIdx.x % kWords) != 0) return;
    if (listed) atomicAdd(recv + r, listed);
    if (kLh && held) atomicAdd(recv + n + r, held);
  }
  __device__ void subj(int c, int member, int refuted, int held) {
    if (member) atomicAdd(cnt + kMember * kC + c, member);
    if (kSus && refuted) atomicAdd(cnt + kRefuted * kC + c, refuted);
    if (kSus && held) atomicAdd(cnt + kHeld * kC + c, held);
  }
};

// 32-bit shared::cluster addresses: ``a`` (this CTA's shared window) in
// CTA ``rank``'s window, and a word loaded from one
__device__ __forceinline__ uint32_t mapa(uint32_t a, int rank) {
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ uint32_t ld_cluster(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

// A signed byte max over many words as two s16x2 halves (bytes 0, 2 and
// bytes 1, 3, sign-extended by prmt), so that Hopper's 3-input s16x2 max
// (a DPX instruction) folds two words in per half: ~3 instructions a word
// where swar::maxs takes ~12.
struct ByteMax {
  uint32_t lo, hi;
  __device__ __forceinline__ static uint32_t lo_of(uint32_t w) {
    uint32_t r;
    asm("prmt.b32 %0, %1, 0, 0xA280;" : "=r"(r) : "r"(w));
    return r;
  }
  __device__ __forceinline__ static uint32_t hi_of(uint32_t w) {
    uint32_t r;
    asm("prmt.b32 %0, %1, 0, 0xB391;" : "=r"(r) : "r"(w));
    return r;
  }
  __device__ __forceinline__ explicit ByteMax(uint32_t w)
      : lo(lo_of(w)), hi(hi_of(w)) {}
  __device__ __forceinline__ void add2(uint32_t a, uint32_t b) {
    lo = (uint32_t)__vimax3_s16x2(lo, lo_of(a), lo_of(b));
    hi = (uint32_t)__vimax3_s16x2(hi, hi_of(a), hi_of(b));
  }
  __device__ __forceinline__ uint32_t word() const {
    uint32_t r;
    asm("prmt.b32 %0, %1, %2, 0x6240;" : "=r"(r) : "r"(lo), "r"(hi));
    return r;
  }
};

// gather_rows on the card: the row's kWords lanes (consecutive lanes of
// one warp, all taking this call together) each compute two slots of a
// chunk (lane_slot) and their cluster addresses, shuffle them to each
// other, and every lane issues the chunk's kChunk loads of its word before
// using any, then folds them with ByteMax.  ``view_sa`` this CTA's view, a
// 32-bit shared address: a dropped slot loads it and keeps ``none``.
template <int kForm>
__device__ __forceinline__ uint32_t gather_rows_cluster(
    const Meta<kForm>& m, const int32_t* __restrict__ senders, int row,
    int n, Knobs kn, uint32_t view_sa, int w) {
  const unsigned mask = 0xFFu << (threadIdx.x & 24);
  const uint32_t none = mutes(kForm) ? 0xFFFFFFFFu : swar::H;
  ByteMax best(none);
  for (int f0 = 0; f0 < kn.width; f0 += kChunk) {
    uint32_t addr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = lane_slot<kForm>(m, senders, row, n, kn, f0, w, i);
      const Where h = row_home(s < 0 ? 0 : s);
      addr[i] = s < 0 ? 0u : mapa(view_sa + h.local * kC, h.cta);
    }
    uint32_t v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const uint32_t a = __shfl_sync(mask, addr[k / kWords], k % kWords,
                                     kWords);
      const uint32_t x = ld_cluster((a ? a : view_sa) + 4 * w);
      v[k] = a ? x : none;
    }
#pragma unroll
    for (int k = 0; k < kChunk; k += 2) best.add2(v[k], v[k + 1]);
  }
  return best.word();
}

// globaltimer (ns) into the timeline slot ``k`` of this CTA and stripe
__device__ __forceinline__ void stamp(unsigned long long* timeline,
                                      int stripe, int cta, int k) {
  if (timeline == nullptr || threadIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  timeline[((size_t)stripe * kCtas + cta) * kStamps + k] = t;
}

// gather_groups on the card: the same max over the receiver's F/8 groups
// of the CTA's own table (``table``: group 0 at this thread's word), two
// groups a ByteMax step.
template <int kForm>
__device__ __forceinline__ uint32_t gather_groups_card(const Meta<kForm>& m,
                                                       int n, Knobs kn,
                                                       const int8_t* table) {
  const int nb = n / kAlign;
  const int g0 = m.s0 / kAlign;
  const uint32_t none = mutes(kForm) ? 0xFFFFFFFFu : swar::H;
  auto group = [&](int k) -> uint32_t {
    if (k >= kn.width || (mutes(kForm) && !((m.s1 >> k) & 1))) return none;
    const int g = g0 + k;
    return *reinterpret_cast<const uint32_t*>(table +
                                              (g >= nb ? g - nb : g) * kC);
  };
  ByteMax best(none);
  for (int k = 0; k < kn.width; k += 2) best.add2(group(k), group(k + 1));
  return best.word();
}

template <bool kSus, bool kLh, int kForm, bool kSwar, bool kBlock>
__global__ void __launch_bounds__(threads<kSwar>(), 1)
rr_onepass_kernel(const Params p) {
  constexpr int kThreads = threads<kSwar>();
  constexpr bool kFull = full_view(kForm);
  constexpr int kStats = kSus ? 6 : 3;
  cg::cluster_group cluster = cg::this_cluster();
  const int cta = (int)cluster.block_rank();
  const int n = p.n;
  const int nc = kBlock ? p.nc : n;
  const int col_offset = kBlock ? p.col_offset : 0;
  const int stripe = blockIdx.x / kCtas;
  const int rows = n / kCtas;
  extern __shared__ __align__(16) unsigned char smem[];
  stamp(p.timeline, stripe, cta, 0);
  Park pk;
  pk.hb = reinterpret_cast<int8_t*>(smem);
  pk.asl = pk.hb + (size_t)rows * kC;
  pk.view = pk.asl + (size_t)rows * kC;
  int32_t* cnt = reinterpret_cast<int32_t*>(
      pk.view + (size_t)view_rows(n, kFull) * kC);
  for (int i = threadIdx.x; i < kStats * kC; i += kThreads)
    cnt[i] = i / kC == kFobs ? n : 0;
  __syncthreads();
  const Stripe sp{n, nc, stripe * kC, col_offset + stripe * kC};

  TickSink ts{cnt};
  // the aligned forms: each group max into every CTA's table, so that
  // step 2 gathers from its own shared memory.  A CTA may touch another's
  // shared memory only once that one runs: every thread arrives at a
  // cluster barrier here and waits on it before its first push (or after
  // step 1, if it pushed nothing)
  bool started = kFull;
  if (!kFull) asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
  auto put_group = [&](int g, int w, const uint32_t (&enc)[kAlign]) {
    if (!started) {
      asm volatile("barrier.cluster.wait;" ::: "memory");
      started = true;
    }
    ByteMax m(enc[0]);
#pragma unroll
    for (int r = 1; r < kAlign; r += 2)
      m.add2(enc[r], enc[r + 1 < kAlign ? r + 1 : r]);
    const uint32_t v = m.word();
#pragma unroll
    for (int q = 0; q < kCtas; ++q)
      *reinterpret_cast<uint32_t*>(cluster.map_shared_rank(pk.view, q) +
                                   g * kC + 4 * w) = v;
  };
  step1<kSus, kFull, mutes(kForm), kSwar>(p.hb, p.asl, p.flags, p.vecs, sp,
                                          p.kn, pk, cta, rows / kAlign,
                                          threadIdx.x, kThreads, ts,
                                          put_group);
  if (!started) asm volatile("barrier.cluster.wait;" ::: "memory");
  stamp(p.timeline, stripe, cta, 1);
  cluster.sync();
  stamp(p.timeline, stripe, cta, 2);
  const int8_t* view = pk.view;
  const uint32_t view_sa = (uint32_t)__cvta_generic_to_shared(view);
  auto gather = [&](const Meta<kForm>& m, int row, int w) -> uint32_t {
    if constexpr (kFull) {
      return gather_rows_cluster<kForm>(m, p.senders, row, n, p.kn, view_sa,
                                        w);
    } else {
      return gather_groups_card<kForm>(m, n, p.kn, view + 4 * w);
    }
  };
  MergeSink<kSus, kLh> ms{cnt, p.recv, n};
  step2<kSus, kForm, kSwar>(p.hb, p.asl, p.flags, p.vecs, p.senders, sp,
                            p.kn, pk, cta, rows, threadIdx.x, kThreads,
                            gather, ms);
  stamp(p.timeline, stripe, cta, 3);
  cluster.sync();

  // CTA ``cta`` stores its kC / kCtas columns of every stat
  constexpr int kCols = kC / kCtas;
  if (threadIdx.x < kCols * kStats) {
    const int s = threadIdx.x / kCols;
    const int c = kCols * cta + threadIdx.x % kCols;
    const int v = finish(s, c, [&](int q) {
      return (const int32_t*)cluster.map_shared_rank(cnt, q);
    });
    p.subj[(size_t)s * nc + sp.col0 + c] = v;
  }
  // no CTA leaves while another reads its shared memory
  cluster.sync();
  stamp(p.timeline, stripe, cta, 4);
}

template <bool kSus, bool kLh, int kForm, bool kSwar, bool kBlock>
cudaError_t launch(const Params& p, int* clusters_out, cudaStream_t s) {
  auto kern = rr_onepass_kernel<kSus, kLh, kForm, kSwar, kBlock>;
  const size_t smem = (size_t)smem_bytes(p.n, full_view(kForm));
  cudaError_t e;
  const int stripes = (kBlock ? p.nc : p.n) / kC;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(stripes * kCtas);
  cfg.blockDim = dim3(threads<kSwar>());
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
  int card = 0;
  e = cudaGetDevice(&card);
  if (e != cudaSuccess) return e;
  if (card >= kMaxCards) return cudaErrorInvalidDevice;
  if (clusters_out != nullptr || checked[card] != smem) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    checked[card] = smem;
    if (clusters_out != nullptr) {
      *clusters_out = clusters;
      return cudaSuccess;
    }
  }
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
    const cudaError_t e = cudaMemsetAsync(
        p.recv, 0, sizeof(int32_t) * (lh ? 2 : 1) * (size_t)n, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)(swar ? launch_form<true>(form, suspect, lh, p, clusters, s)
                    : launch_form<false>(form, suspect, lh, p, clusters, s));
}

}  // namespace

// Launch one round on ``stream`` in one pass: the arguments and outputs of
// resident_round.cu's rr_round (every output written; out_recv complete),
// for n % 64 == 0, nc % 32 == 0 and a shared-memory need
// (onepass::smem_bytes) the card grants: one memset of out_recv (the
// per-receiver counts add up there by global atomics), then one launch.
// ``timeline`` null, or uint64 [nc / 32, kCtas, kStamps]: each CTA's
// globaltimer stamps (ns) of its stripe's steps.  Returns the CUDA error
// code (0 on success).
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

// cudaOccupancyMaxActiveClusters of the instantiation rr_onepass would
// launch for this shape and form, into ``*clusters`` (launches nothing).
extern "C" int rr_onepass_clusters(int n, int nc, int col_offset, int fanout,
                                   int form, int align, int suspect, int lh,
                                   int swar, int* clusters) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, n, nc, col_offset, fanout, form, align, 1, 1, 63,
             suspect, lh, 0, 0, swar, clusters, nullptr);
}
