// K2: the explicit-edge gossip merge (gather-max over each receiver's F
// in-edges, then the membership-update epilogue and the per-subject
// reductions) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gossipfs_tpu/ops/merge_pallas.py
// fused_merge_update_blocked (:387).  The function it computes is defined
// by the plain PyTorch version, gossipfs_tpu_torch/ops/merge_update.py
// fused_merge_update_plain.
//
// Bound: bytes.  The floor moves the view once and the lanes once each way:
// at config 3's shape (N = 10,240, int8 view, int16 hb, the packed
// age|status byte) that is N^2 x (1 + 2x2 + 2x1) B = 734 MB, 0.22 ms at the
// H100's 3.35 TB/s; the epilogue is a few dozen integer ops an entry.  The
// gather reads F view rows a receiver (1.47 GB at config 3): those have to
// come from L2, and their latency has to be hidden.  The TPU kernel
// gathered its F rows with slotted async DMAs into VMEM.
//
// Design: one launch, its per-thread bodies in gather_ring.cuh (tested on the
// host).  A block of 256 threads takes a 128-byte stripe of the view's columns
// by a range of receiver rows, 8 threads a row, 16 bytes each.  The block first
// stages the item's sender ids in shared memory behind the ring (at most 40 KB
// at F <= 17; 2.4-12.1 % faster than each thread loading them from global
// memory).  Each receiver's F sender segments go by cp.async.cg into a ring of
// 2 stages of up to 8 slots a thread in shared memory (56 KB a block at F = 14,
// chunks of 7), one chunk ahead of the fold, so the gather's latency is hidden
// by bytes in flight rather than by warps (plain loads through registers into
// the same ring: 68 % slower at config 3); the next row's lanes and alive bit
// load into registers as this row gathers; the epilogue (merge_elem.cuh) runs
// entry by entry on the 16-byte lane pieces, loaded and stored once,
// evict-first.  Counts are bytes in registers, summed over the warp by
// shuffles, one shared atomic a column and warp, then one global atomic a
// column and output an item (0.9M a call at config 3; flushed every 32-row
// step instead: 51-62 % slower).  Items run row ranges fastest inside a
// stripe, sized (item_rows) so that the blocks the card holds at once
// gather from ~12 MB of view strips (items stripe-fastest: 26-45 %
// slower).  fm_info reports the geometry.  What is left: at config 4's
// shard (F = 17) the gather's 36.5 GB from L2 take ~5.2 ms beside the
// lanes' ~5.4, at ~7 TB/s (PERF.md section 6).  Dead receivers skip their
// gather (best stays -1), a sender outside [0, n) is absent.  No fallback:
// a refused launch returns its error and the wrapper raises.
#include <cstdint>
#include <cuda_runtime.h>

#include "gather_ring.cuh"

using namespace mstripe;

namespace {

struct Params {
  const void* view;
  const int32_t* edges;
  void* hb;
  int8_t* asl;
  const int32_t* sa;
  const int32_t* sb;
  const uint8_t* alive;
  int32_t* out;
  int n, nc, fanout, age_clamp, rows;  // rows: an item's receiver rows
};

template <typename V, typename H, bool kVec, bool kSus, bool kDet>
__global__ void __launch_bounds__(gring::kThreads, 2)
fused_kernel(const Params p) {
  using gring::kLanes;
  using gring::kStepRows;
  constexpr int kE = kSegBytes / sizeof(V);
  constexpr int cols = kLanes * kE;
  const int n = p.n;
  const int nc = p.nc;
  const int splits = (n + p.rows - 1) / p.rows;
  const int col0 = (int)(blockIdx.x / splits) * cols;
  const int r0 = (int)(blockIdx.x % splits) * p.rows;
  const int rows = min(p.rows, n - r0);
  const int t = threadIdx.x;
  __shared__ int32_t cnt[kBlockInts];
  __shared__ __align__(16) int32_t shifts[2][kMaxCols];
  extern __shared__ __align__(16) unsigned char smem[];
  for (int i = t; i < kBlockInts; i += gring::kThreads)
    cnt[i] = blank_count(i, n);
  if (t < 2 * cols) {
    const int c = col0 + t % cols;
    shifts[t / cols][t % cols] = c < nc ? (t < cols ? p.sa[c] : p.sb[c]) : 0;
  }
  // the item's sender ids, behind the ring
  int32_t* ids = reinterpret_cast<int32_t*>(
      smem + gring::ring_bytes(gring::plan(p.fanout).chunk));
  gring::stage_ids(p.edges, ids, r0, rows, p.fanout, t, gring::kThreads);
  __syncthreads();
  const gring::FmArgs<V, H> a{static_cast<const V*>(p.view), ids,
                              static_cast<H*>(p.hb), p.asl, p.alive, n, nc,
                              p.fanout, p.age_clamp};
  Counts<kE> cn;
  clear(cn);
  gring::fm_thread<V, H, kSus, kDet, kVec>(
      a, r0, rows, col0, t, reinterpret_cast<int8_t*>(smem), shifts[0],
      shifts[1], [](int8_t* d, const int8_t* s) { copy16(d, s); },
      [] { asm volatile("cp.async.commit_group;" ::: "memory"); },
      [] {
        asm volatile("cp.async.wait_group %0;" ::"n"(gring::kDepth - 1)
                     : "memory");
      },
      cn);
  flush_counts<kSus, kDet, kE>(cnt, cn, t % kLanes, kLanes, n, [&](int st) {
    return r0 + st * kStepRows + t / kLanes;
  });
  __syncthreads();
  add_block_counts<kSus, kDet>(cnt, p.out, col0, cols, nc, n);
}

// the launch, or its geometry into ``info`` (launching nothing)
template <typename V, typename H, bool kVec, bool kSus, bool kDet>
cudaError_t launch(Params p, int* info, cudaStream_t s) {
  auto kern = fused_kernel<V, H, kVec, kSus, kDet>;
  static gring::Held held;
  gring::Grid g;
  const cudaError_t e = gring::grid(kern, p.n, p.nc, (int)sizeof(V),
                                    p.fanout, true, held, &g, info);
  if (e != cudaSuccess || info != nullptr) return e;
  p.rows = g.rows;
  kern<<<g.items, gring::kThreads, g.smem, s>>>(p);
  return cudaGetLastError();
}

template <typename V, typename H, bool kVec>
cudaError_t launch_v(const Params& p, int detect, int suspect, int* info,
                     cudaStream_t s) {
  if (detect)
    return suspect ? launch<V, H, kVec, true, true>(p, info, s)
                   : launch<V, H, kVec, false, true>(p, info, s);
  return suspect ? launch<V, H, kVec, true, false>(p, info, s)
                 : launch<V, H, kVec, false, false>(p, info, s);
}

template <typename V, typename H>
cudaError_t launch_vh(const Params& p, bool vec, int detect, int suspect,
                      int* info, cudaStream_t s) {
  return vec ? launch_v<V, H, true>(p, detect, suspect, info, s)
             : launch_v<V, H, false>(p, detect, suspect, info, s);
}

int run(const void* view, const void* edges, void* hb, void* asl,
        const void* sa, const void* sb, const void* alive, void* out, int n,
        int nc, int fanout, int view_bytes, int hb_bytes, int detect,
        int suspect, int age_clamp, int aligned, int* info, void* stream) {
  if (n <= 0 || nc <= 0 || nc > n || fanout < 1 || fanout > 512 ||
      age_clamp < 0 || age_clamp > 63)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.view = view;
  p.edges = static_cast<const int32_t*>(edges);
  p.hb = hb;
  p.asl = static_cast<int8_t*>(asl);
  p.sa = static_cast<const int32_t*>(sa);
  p.sb = static_cast<const int32_t*>(sb);
  p.alive = static_cast<const uint8_t*>(alive);
  p.out = static_cast<int32_t*>(out);
  p.n = n;
  p.nc = nc;
  p.fanout = fanout;
  p.age_clamp = age_clamp;
  p.rows = 0;
  // 16-byte segments: every row's stripe segment whole and aligned
  const bool vec = aligned != 0 && nc % kSegBytes == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FM_LAUNCH(V, H) \
  (int)launch_vh<V, H>(p, vec, detect, suspect, info, s)
  if (view_bytes == 1 && hb_bytes == 1) return FM_LAUNCH(int8_t, int8_t);
  if (view_bytes == 1 && hb_bytes == 2) return FM_LAUNCH(int8_t, int16_t);
  if (view_bytes == 1 && hb_bytes == 4) return FM_LAUNCH(int8_t, int32_t);
  if (view_bytes == 2 && hb_bytes == 2) return FM_LAUNCH(int16_t, int16_t);
  if (view_bytes == 2 && hb_bytes == 4) return FM_LAUNCH(int16_t, int32_t);
#undef FM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch K2 on ``stream`` over column blocks: n rows, nc subject columns
// (nc = n for a square round, n / shards on a subject shard).  view:
// int8/int16 [n, nc]; edges: int32 [n, fanout] (1 <= fanout <= 512; a
// sender outside [0, n) is absent); hb: int8/16/32 [n, nc] and asl: int8
// [n, nc], post-tick, updated in place; sa, sb: int32 [nc]; alive: bool
// [n]; out: int32 [3, nc] = cnt_incl, n_det, first_obs ([5, nc] with
// refuted and held when ``suspect``), initialised by the caller (zeros,
// first_obs n when detect).  ``aligned``: 16-byte aligned lanes with nc %
// 4 == 0 (16-byte accesses where also nc % 16 == 0).  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int fm_merge(const void* view, const void* edges, void* hb,
                        void* asl, const void* sa, const void* sb,
                        const void* alive, void* out, int n, int nc,
                        int fanout, int view_bytes, int hb_bytes, int detect,
                        int suspect, int age_clamp, int aligned,
                        void* stream) {
  return run(view, edges, hb, asl, sa, sb, alive, out, n, nc, fanout,
             view_bytes, hb_bytes, detect, suspect, age_clamp, aligned,
             nullptr, stream);
}

// The geometry of what fm_merge would launch for this shape, into info[11]
// (launches nothing): stripe columns, receiver rows an item, ring stages,
// slots a stage and thread, shared memory a block (the ring and the staged
// ids), threads a block, blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
// memory (spills) a thread, items (blocks) of the launch, and the kernel's
// opt-in shared memory as cudaFuncGetAttributes reports it
// (gring::max_smem_bytes).
extern "C" int fm_info(int n, int nc, int fanout, int view_bytes,
                       int hb_bytes, int detect, int suspect, int aligned,
                       int* info) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, n, nc, fanout, view_bytes, hb_bytes, detect, suspect,
             63, aligned, info, nullptr);
}
