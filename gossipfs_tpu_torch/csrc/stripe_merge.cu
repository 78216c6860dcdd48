// K5: the stripe gossip merge (K2's contract: gather-max over each
// receiver's F in-edges, the membership-update epilogue and the
// per-subject reductions) with the view read from device memory once per
// round, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gossipfs_tpu/ops/merge_pallas.py
// stripe_merge_update_blocked (:998).  The function it computes is defined
// by the plain PyTorch version, gossipfs_tpu_torch/ops/merge_update.py
// stripe_merge_update_plain (the same function as K2's).
//
// Bound: bytes.  The floor reads the int8 view once and moves the lanes
// once each way: at the suspicion_rr shape (N = 16,384, F = 14, all-int8)
// that is N^2 x (1 + 2 + 2) B plus edges and vectors, ~1.343 GB, 0.401 ms
// at the H100's 3.35 TB/s.  K2 reads the view F times (through L2); the
// TPU kernel kept a view column stripe resident in VMEM for every
// receiver block, so the view crossed HBM once.
//
// Design: a thread-block cluster of kCtas = 16 CTAs of 512 threads (a
// non-portable size) owns a stripe of 128 subject columns over all N rows
// (64 where a 128-byte park does not fit, N > ~27,000); merge_stripe.cuh
// holds the per-thread bodies, tested on the host.  128-byte row pieces
// are what lets the lanes stream: an H100 moves int8 lanes at ~2.5 TB/s in
// them and ~1.3 in 32-byte ones.
//   1. each CTA parks its rows of the int8 view stripe in shared memory,
//      rows by round robin (row s in CTA s % 16 at park row s / 16), staged
//      by 16-byte cp.async: N / 16 x 128 B, 128 KB at N = 16,384 (111 KB
//      of 64-byte rows at 28,416), one CTA an SM;
//   2. cluster.sync();
//   3. each CTA sweeps its own receiver rows, 8 threads a row, 16 bytes of
//      the stripe each: the next row's lanes (16-byte evict-first loads of
//      int8, 32 or 64 bytes of hb), alive bit and first 8 sender ids load
//      while this row merges; the receiver's F in-edges (int16, read once
//      a stripe) name the senders' rows, gathered 8 at a time, even
//      batches from the parks wherever they live (ld.shared::cluster.v4),
//      odd ones from the view in L2 (where staging left the stripe), and
//      folded by a signed byte max from -1 (two words a DPX instruction);
//      the epilogue (merge_elem.cuh) entry by entry; the lanes stored once;
//   4. per-subject counts: bytes in registers over a thread's rows, summed
//      over the warp by shuffles, one shared atomic a column and warp into
//      the CTA's count block; after the next cluster.sync each CTA sums its
//      8 columns of the 16 blocks over distributed shared memory and writes
//      every output entry once (no global atomics, no initialised output);
//      two blocks by the stripe's parity, so two barriers a stripe.
// Persistent clusters (as many as the card holds at once,
// cudaOccupancyMaxActiveClusters: 7 on an H100) walk stripes c, c +
// clusters, ...  Byte account at N = 16,384, F = 14: view 1 B and lanes 4
// B an entry, plus every receiver's edges once a stripe (128 x 458 KB = 59
// MB, mostly from L2): ~4 % over the floor.  The gather is bound by
// latency, not by either memory's bandwidth (PERF.md section 6).  Dead
// receivers skip their gather (best stays -1) and are masked in the
// epilogue, as in K2; the TPU kernel remapped their edges to themselves:
// the outputs are the same.  No fallback: a refused launch, or an
// occupancy query that finds no place for a cluster, returns its error
// and the wrapper raises.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "merge_stripe.cuh"

namespace cg = cooperative_groups;
using namespace mstripe;

namespace {

struct Params {
  const int8_t* view;
  const int16_t* edges;
  void* hb;
  int8_t* asl;
  const int32_t* sa;
  const int32_t* sb;
  const uint8_t* alive;
  int32_t* out;
  int n, nc, fanout, rb, age_clamp;
};

template <typename H, bool kVec, bool kSus, bool kDet>
__global__ void __launch_bounds__(kThreads, 1)
stripe_kernel(const Params p) {
  constexpr int kE = kSegBytes;              // int8 columns a thread
  cg::cluster_group cluster = cg::this_cluster();
  const int cta = (int)cluster.block_rank();
  const int n = p.n;
  const int nc = p.nc;
  const int rb = p.rb;                       // park row bytes: 128 or 64
  const int lanes = rb / kSegBytes;          // threads a row
  const int cols = rb;                       // stripe columns
  const int step_rows = kThreads / lanes;    // rows a CTA sweeps at once
  const int stripes = (nc + cols - 1) / cols;
  const int clusters = (int)gridDim.x / kCtas;
  const int rows = rr_rows(n, cta);
  const int t = threadIdx.x;
  const int h = t % lanes;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* park = reinterpret_cast<int8_t*>(smem);
  int8_t* none = park + (size_t)cta_rows(n) * rb;
  int32_t* blocks = reinterpret_cast<int32_t*>(none + kMaxRowBytes);
  __shared__ __align__(16) int32_t shifts[2][kMaxCols];  // shift_a, shift_b
  H* hb = static_cast<H*>(p.hb);

  // park row li, segment hh at park + li * rb + hh * 16
  auto stage = [&](int col0) {
    for (int i = t; i < rows * lanes; i += kThreads)
      stage_seg<int8_t, kVec>(p.view, nc, col0, rr_global(cta, i / lanes),
                              i % lanes, park + (size_t)i * kSegBytes,
                              [](int8_t* d, const int8_t* s) { copy16(d, s); });
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  if (t < kMaxRowBytes / 4) reinterpret_cast<uint32_t*>(none)[t] = ~0u;
  for (int i = t; i < 2 * kBlockInts; i += kThreads)
    blocks[i] = blank_count(i % kBlockInts, n);
  const uint32_t park_sa = (uint32_t)__cvta_generic_to_shared(park);
  const uint32_t none_ca =
      mapa((uint32_t)__cvta_generic_to_shared(none) + kSegBytes * h, cta);
  auto addr = [&](int s) -> uint32_t {
    if (s < 0) return none_ca;
    return mapa(park_sa + (uint32_t)((s >> kCtasLog) * rb + h * kSegBytes),
                s & (kCtas - 1));
  };
  // the view rows themselves (the 16-byte path: every segment whole); an
  // absent slot loads nothing
  auto gaddr = [&](int s, int col) -> const int8_t* {
    return s < 0 ? nullptr : p.view + (size_t)s * nc + col;
  };

  // CTA ``cta`` writes its columns (c % kCtas == cta) of every output of
  // stripe ``done`` from the cluster's count blocks ``blk``
  auto finish_stripe = [&](int done, const int32_t* blk) {
    for (int i = t; i < kOuts * cols; i += kThreads) {
      const int s = i / cols;
      const int c = i % cols;
      const int col = done * cols + c;
      if ((c & (kCtas - 1)) != cta || col >= nc || (!kSus && s >= kOutRef))
        continue;
      const int v = finish(s, c, [&](int q) {
        return (const int32_t*)cluster.map_shared_rank(blk, q);
      });
      p.out[(size_t)s * nc + col] = output_value(s, v, kDet);
    }
  };

  int stripe = (int)blockIdx.x / kCtas;
  stage(stripe * cols);
  for (int it = 0; stripe < stripes; stripe += clusters, ++it) {
    const int col0 = stripe * cols;
    int32_t* cnt = blocks + (it & 1) * kBlockInts;
    if (t < 2 * cols) {
      const int c = col0 + t % cols;
      shifts[t / cols][t % cols] =
          c < nc ? (t < cols ? p.sa[c] : p.sb[c]) : 0;
    }
    // the previous stripe's outputs, from its blocks (complete at its last
    // barrier)
    if (it > 0)
      finish_stripe(stripe - clusters,
                    blocks + ((it - 1) & 1) * kBlockInts);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    cluster.sync();
    // every CTA read the other block (the finish above) before the barrier
    int32_t* spare = blocks + ((it + 1) & 1) * kBlockInts;
    for (int i = t; i < kBlockInts; i += kThreads)
      spare[i] = blank_count(i, n);

    const int col = col0 + h * kE;
    const int valid = kVec ? (col < nc ? kE : 0) : max(0, min(kE, nc - col));
    Counts<kE> cn;
    clear(cn);
    int li = t / lanes;
    if (valid > 0 && li < rows) {
      // each row's lanes, alive bit and first sender slots are loaded while
      // the row before it merges
      int row = rr_global(cta, li);
      Lanes<H, kE> ld;
      load_lanes<H, kE, kVec>(hb + (size_t)row * nc + col,
                              p.asl + (size_t)row * nc + col, valid, ld);
      bool recv = p.alive[row] != 0;
      Ids ids = load_ids(p.edges, row, n, p.fanout, 0);
      for (int step = 0; li < rows; li += step_rows, ++step) {
        const int nrow = rr_global(cta, li + step_rows);
        const bool more = li + step_rows < rows;
        Lanes<H, kE> nld;
        bool nrecv = false;
        Ids nids;
        if (more) {
          load_lanes<H, kE, kVec>(hb + (size_t)nrow * nc + col,
                                  p.asl + (size_t)nrow * nc + col, valid,
                                  nld);
          nrecv = p.alive[nrow] != 0;
          nids = load_ids(p.edges, nrow, n, p.fanout, 0);
        }
        const Seg best =
            !recv ? onepass::splat(0xFFFFFFFFu)
            : kVec
                ? gather_edges(
                      ids, p.edges, row, n, p.fanout, addr,
                      [](uint32_t a) { return ld_cluster(a); },
                      [&](int s) { return gaddr(s, col); },
                      [](const int8_t* a) { return ld_view(a); })
                : gather_edges(
                      ids, p.edges, row, n, p.fanout, addr,
                      [](uint32_t a) { return ld_cluster(a); }, addr,
                      [](uint32_t a) { return ld_cluster(a); });
        merge_seg<int8_t, H, kSus, kDet, kVec, kE>(
            best, ld, valid, shifts[0] + h * kE, shifts[1] + h * kE, recv,
            p.age_clamp, step, cn);
        store_lanes<H, kE, kVec>(hb + (size_t)row * nc + col,
                                 p.asl + (size_t)row * nc + col, valid, ld);
        if (more) {
          row = nrow;
          ld = nld;
          recv = nrecv;
          ids = nids;
        }
      }
    }
    flush_counts<kSus, kDet, kE>(cnt, cn, h, lanes, n, [&](int st) {
      return rr_global(cta, st * step_rows + t / lanes);
    });
    // every sweep done: the parks are free and the counts complete
    cluster.sync();
    if (stripe + clusters < stripes)
      stage((stripe + clusters) * cols);
    else
      finish_stripe(stripe, cnt);
  }
  // no CTA leaves while another reads its count blocks
  cluster.sync();
}

template <typename H, bool kVec, bool kSus, bool kDet>
cudaError_t launch(const Params& p, int* info, cudaStream_t s) {
  auto kern = stripe_kernel<H, kVec, kSus, kDet>;
  const size_t smem = (size_t)smem_bytes(cta_rows(p.n), p.rb);
  const int stripes = (p.nc + p.rb - 1) / p.rb;
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
  // the shared-memory limit raised and the clusters the card holds at once
  // at this size asked, once a size and card
  constexpr int kMaxCards = 64;
  static size_t checked[kMaxCards] = {};
  static int held[kMaxCards] = {};
  int card = 0;
  cudaError_t e = cudaGetDevice(&card);
  if (e != cudaSuccess) return e;
  if (card >= kMaxCards) return cudaErrorInvalidDevice;
  if (info != nullptr || checked[card] != smem) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    checked[card] = smem;
    held[card] = clusters;
    if (info != nullptr) {
      cudaFuncAttributes fa;
      e = cudaFuncGetAttributes(&fa, kern);
      if (e != cudaSuccess) return e;
      const int v[9] = {kCtas, p.rb, p.rb, clusters, fa.numRegs,
                        (int)fa.localSizeBytes, (int)smem, kThreads,
                        fa.maxDynamicSharedSizeBytes};
      for (int i = 0; i < 9; ++i) info[i] = v[i];
      return cudaSuccess;
    }
  }
  // persistent clusters: as many as the card holds, none without a stripe
  cfg.gridDim = dim3((held[card] < stripes ? held[card] : stripes) * kCtas);
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename H, bool kVec>
cudaError_t launch_v(const Params& p, int detect, int suspect, int* info,
                     cudaStream_t s) {
  if (detect)
    return suspect ? launch<H, kVec, true, true>(p, info, s)
                   : launch<H, kVec, false, true>(p, info, s);
  return suspect ? launch<H, kVec, true, false>(p, info, s)
                 : launch<H, kVec, false, false>(p, info, s);
}

template <typename H>
cudaError_t launch_h(const Params& p, bool vec, int detect, int suspect,
                     int* info, cudaStream_t s) {
  return vec ? launch_v<H, true>(p, detect, suspect, info, s)
             : launch_v<H, false>(p, detect, suspect, info, s);
}

int run(const void* view, const void* edges, void* hb, void* asl,
        const void* sa, const void* sb, const void* alive, void* out, int n,
        int nc, int fanout, int view_bytes, int hb_bytes, int detect,
        int suspect, int age_clamp, int aligned, int* info, void* stream) {
  // int16 edges: n < 2^15
  if (n <= 0 || n > 32767 || nc <= 0 || nc > n || fanout < 1 ||
      view_bytes != 1 || age_clamp < 0 || age_clamp > 63 ||
      stripe_row_bytes(n) == 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.view = static_cast<const int8_t*>(view);
  p.edges = static_cast<const int16_t*>(edges);
  p.hb = hb;
  p.asl = static_cast<int8_t*>(asl);
  p.sa = static_cast<const int32_t*>(sa);
  p.sb = static_cast<const int32_t*>(sb);
  p.alive = static_cast<const uint8_t*>(alive);
  p.out = static_cast<int32_t*>(out);
  p.n = n;
  p.nc = nc;
  p.fanout = fanout;
  p.rb = stripe_row_bytes(n);
  p.age_clamp = age_clamp;
  // 16-byte segments: every row's stripe segment whole and aligned
  const bool vec = aligned != 0 && nc % kSegBytes == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SM_LAUNCH(H) (int)launch_h<H>(p, vec, detect, suspect, info, s)
  if (hb_bytes == 1) return SM_LAUNCH(int8_t);
  if (hb_bytes == 2) return SM_LAUNCH(int16_t);
  if (hb_bytes == 4) return SM_LAUNCH(int32_t);
#undef SM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch K5 on ``stream`` over column blocks: n rows, nc subject columns
// (nc = n for a square round, n / shards on a subject shard; the park holds
// every row, so the shared-memory bound is on n, whatever nc).
// view: int8 [n, nc] (view_bytes must be 1); edges: int16 [n, fanout]
// (n < 2^15); hb: int8/16/32 [n, nc] and asl: int8 [n, nc], post-tick,
// updated in place; sa, sb: int32 [nc]; alive: bool [n]; out: int32
// [3, nc] = cnt_incl, n_det, first_obs ([5, nc] with refuted and held
// when ``suspect``), every entry written by the kernel.  ``aligned``: 16-byte
// aligned lanes with nc % 4 == 0 (the 16-byte path runs where also nc % 16
// == 0).  Returns the CUDA error code of the launch (0 on success).
extern "C" int sm_merge(const void* view, const void* edges, void* hb,
                        void* asl, const void* sa, const void* sb,
                        const void* alive, void* out, int n, int nc,
                        int fanout, int view_bytes, int hb_bytes, int detect,
                        int suspect, int age_clamp, int aligned,
                        void* stream) {
  return run(view, edges, hb, asl, sa, sb, alive, out, n, nc, fanout,
             view_bytes, hb_bytes, detect, suspect, age_clamp, aligned,
             nullptr, stream);
}

// The geometry of the instantiation sm_merge would launch for this shape,
// into info[9] (launches nothing): CTAs a cluster, stripe columns, park row
// bytes, clusters the card holds at once, registers a thread, local memory
// a thread (spills), dynamic shared memory a CTA, threads a CTA, and the
// kernel's opt-in shared memory as cudaFuncGetAttributes reports it.
extern "C" int sm_info(int n, int nc, int fanout, int hb_bytes, int detect,
                       int suspect, int aligned, int* info) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, n, nc, fanout, 1, hb_bytes, detect, suspect, 63,
             aligned, info, nullptr);
}
