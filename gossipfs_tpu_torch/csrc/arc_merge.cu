// K4: the arc gossip merge (window max over F consecutive sender rows, one
// window row per receiver at its arc base, then the membership-update
// epilogue and the per-subject reductions) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gossipfs_tpu/ops/merge_pallas.py
// arc_merge_update_blocked (:1248).  The function it computes is defined
// by the plain PyTorch version, gossipfs_tpu_torch/ops/merge_update.py
// arc_merge_update_plain.
//
// Bound: bytes.  The floor reads the view once and moves the lanes once
// each way: at the headline shape (N = 16,384, all-int8 lanes) that is
// N^2 x (1 + 2 + 2) B = 1.34 GB, 0.40 ms at the H100's 3.35 TB/s.  The TPU
// kernel window-maxed a VMEM-resident column stripe of the view in
// O(log F) shift-doubling passes and read one window row per receiver.
//
// Design: two launches in stream order, the window max W written to a
// scratch [N, C] (merge_stripe.cuh holds the per-thread bodies, tested on
// the host).  Every access is a 16-byte piece of a 128-byte stripe of a
// row: an H100 moves int8 lanes in 128-byte row pieces at ~2.5 TB/s, in
// 32-byte ones at ~1.3, so the 7 B an entry of this form stream faster
// than the 5 B of a one-launch park, which at N = 16,384 holds 128-byte
// rows only on 112 SMs (clusters of 16) and at full_scale's N = 65,536
// 32-byte rows at most (PERF.md section 6 has both forms' times).
//   1. window_tile_kernel: a block of 512 threads stages a tile of 512
//      rows of a 128-byte view stripe and the F - 1 rows after it (the
//      halo, wrapping at N) by 16-byte cp.async, turns it in place into
//      M_p[x] = max view[x .. x + p) (p the largest power of two <= F) by
//      shift doubling, radix 4 while it fits, each step in chunks of 8 row
//      segments a thread (read, barrier, write, barrier), and writes W[x] =
//      max(M_p[x], M_p[x + F - p]) for its rows: the view read once (and
//      ~3 % of halo), W written once.  Where a tile and its halo outgrow a
//      block's shared memory (F > ~1,300) window_max_kernel computes W by
//      van Herk/Gil-Werman segments of F rows instead (its accesses 4 B a
//      thread; no main path has such a fanout).
//   2. arc_rows_kernel: blocks of 256 threads over a 128-byte stripe of up
//      to 2,048 rows, 8 threads a row, 16 bytes each: receiver i's W row
//      bases[i] read once (a 128-byte line), the lanes loaded (16-byte
//      evict-first loads of int8, 32 or 64 bytes of hb) with the next
//      row's lanes, alive bit and base in flight, the epilogue
//      (merge_elem.cuh) entry by entry, the lanes stored once; counts as
//      bytes in registers, summed over the warp by shuffles, one shared
//      atomic a column and warp into the block's counts, then one global
//      atomic a column and output a block (N / 2,048 a column).
// No fallback from a refused launch: it returns its error and the wrapper
// raises.
#include <climits>
#include <cuda_runtime.h>

#include <cstdint>

#include "merge_rows.cuh"
#include "merge_stripe.cuh"

using namespace mstripe;

namespace {

struct Params {
  const void* view;
  const int32_t* bases;
  void* hb;
  int8_t* asl;
  const int32_t* sa;
  const int32_t* sb;
  const uint8_t* alive;
  int32_t* out;
  void* wbuf;
  int n, nc, fanout, age_clamp, aligned;
};

template <typename V, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
window_tile_kernel(const V* __restrict__ view, V* __restrict__ w, int n,
                   int nc, int fanout) {
  constexpr int kE = kSegBytes / sizeof(V);
  constexpr int lanes = kMaxRowBytes / kSegBytes;
  constexpr int cols = lanes * kE;
  const int stripes = (nc + cols - 1) / cols;
  const int col0 = (int)(blockIdx.x % stripes) * cols;
  const int r0 = (int)(blockIdx.x / stripes) * kTileRows;
  const int rows = min(kTileRows, n - r0);
  const int len = rows + fanout - 1;
  const int pw = pow2_floor(fanout);
  const int t = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* park = reinterpret_cast<int8_t*>(smem);
  for (int i = t; i < len * lanes; i += kThreads) {
    int g = r0 + i / lanes;
    if (g >= n) g -= n;
    stage_seg<V, kVec>(view, nc, col0, g, i % lanes,
                       park + (size_t)i * kSegBytes,
                       [](int8_t* d, const int8_t* s) { copy16(d, s); });
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  for (int s = 1; s < pw;) {
    const int r = window_radix(s, pw);
    const int chunks = window_chunks(len, s, r, lanes, kThreads);
    for (int c = 0; c < chunks; ++c) {
      Seg v[kWinItems];
      window_read<V>(park, kMaxRowBytes, len, s, r, c, t, kThreads, v);
      __syncthreads();
      window_write(park, kMaxRowBytes, len, s, r, c, t, kThreads, v);
      __syncthreads();
    }
    s *= r;
  }
  for (int i = t; i < rows * lanes; i += kThreads) {
    const int h = i % lanes;
    const int col = col0 + h * kE;
    if (col >= nc) continue;
    const Seg m = tile_window<V>(park, i / lanes, h, fanout, pw);
    V* dst = w + (size_t)(r0 + i / lanes) * nc + col;
    if (kVec) {
      st_words(dst, m.w, 16);
    } else {
      union {
        V v[kE];
        Seg s;
      } u;
      u.s = m;
      for (int k = 0; k < kE && col + k < nc; ++k) dst[k] = u.v[k];
    }
  }
}

// The window max by van Herk/Gil-Werman segments of F rows (the segments
// form: a fanout whose halo outgrows a tile).
template <typename V, bool kAligned>
__global__ void __launch_bounds__(merge_rows::kThreads)
window_max_kernel(const V* __restrict__ view, V* __restrict__ w, int n,
                  int nc, int fanout) {
  using merge_rows::kTile;
  using merge_rows::kVec;
  using merge_rows::load4;
  using merge_rows::store4;
  const int s0 = blockIdx.x * fanout;  // segment start, extended index
  const int col0 = blockIdx.y * kTile + threadIdx.x * kVec;
  if (col0 >= nc) return;
  const int valid = min(kVec, nc - col0);
  const int end = min(s0 + fanout, n);  // window starts owned: [s0, end)
  int run[kVec], v[kVec];
  // suffix maxima of segment m, from its last row down to s0
#pragma unroll
  for (int k = 0; k < kVec; ++k) run[k] = INT_MIN;
#pragma unroll 4
  for (int x = s0 + fanout - 1; x >= s0; --x) {
    const int row = x < n ? x : x - n;
    load4<V, kAligned>(view + (size_t)row * nc + col0, valid, v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) run[k] = max(run[k], v[k]);
    if (x < end) store4<V, kAligned>(w + (size_t)x * nc + col0, valid, run);
  }
  // prefix maxima of segment m+1, folded into the windows ending there
#pragma unroll
  for (int k = 0; k < kVec; ++k) run[k] = INT_MIN;
#pragma unroll 4
  for (int x = s0 + fanout; x <= end + fanout - 2; ++x) {
    const int row = x < n ? x : x - n;  // x < 2n: fanout < n
    load4<V, kAligned>(view + (size_t)row * nc + col0, valid, v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) run[k] = max(run[k], v[k]);
    V* wr = w + (size_t)(x - fanout + 1) * nc + col0;
    int cur[kVec];
    load4<V, kAligned>(wr, valid, cur);
#pragma unroll
    for (int k = 0; k < kVec; ++k) cur[k] = max(cur[k], run[k]);
    store4<V, kAligned>(wr, valid, cur);
  }
}

template <typename V, typename H, bool kVec, bool kSus, bool kDet>
__global__ void __launch_bounds__(kRowThreads, 2)
arc_rows_kernel(const Params p) {
  constexpr int kE = kSegBytes / sizeof(V);
  constexpr int lanes = kMaxRowBytes / kSegBytes;
  constexpr int cols = lanes * kE;
  constexpr int step_rows = kRowThreads / lanes;
  const int n = p.n;
  const int nc = p.nc;
  const int stripes = (nc + cols - 1) / cols;
  const int col0 = (int)(blockIdx.x % stripes) * cols;
  const int r0 = (int)(blockIdx.x / stripes) * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, n - r0);
  const int t = threadIdx.x;
  const int h = t % lanes;
  __shared__ int32_t cnt[kBlockInts];
  __shared__ __align__(16) int32_t shifts[2][kMaxCols];
  const V* w = static_cast<const V*>(p.wbuf);
  H* hb = static_cast<H*>(p.hb);
  for (int i = t; i < kBlockInts; i += kRowThreads) cnt[i] = blank_count(i, n);
  if (t < 2 * cols) {
    const int c = col0 + t % cols;
    shifts[t / cols][t % cols] = c < nc ? (t < cols ? p.sa[c] : p.sb[c]) : 0;
  }
  __syncthreads();
  const int col = col0 + h * kE;
  const int valid = kVec ? (col < nc ? kE : 0) : max(0, min(kE, nc - col));
  Counts<kE> cn;
  clear(cn);
  int li = t / lanes;
  if (valid > 0 && li < rows) {
    Lanes<H, kE> ld;
    const size_t off0 = (size_t)(r0 + li) * nc + col;
    load_lanes<H, kE, kVec>(hb + off0, p.asl + off0, valid, ld);
    bool recv = p.alive[r0 + li] != 0;
    int base = p.bases[r0 + li];
    for (int step = 0; li < rows; li += step_rows, ++step) {
      const int row = r0 + li;
      const bool more = li + step_rows < rows;
      Lanes<H, kE> nld;
      bool nrecv = false;
      int nbase = 0;
      if (more) {
        const size_t noff = (size_t)(row + step_rows) * nc + col;
        load_lanes<H, kE, kVec>(hb + noff, p.asl + noff, valid, nld);
        nrecv = p.alive[row + step_rows] != 0;
        nbase = p.bases[row + step_rows];
      }
      const Seg best = recv && (unsigned)base < (unsigned)n
                           ? load_row_seg<V, kVec>(w, nc, base, col, valid)
                           : onepass::splat(0xFFFFFFFFu);
      merge_seg<V, H, kSus, kDet, kVec, kE>(
          best, ld, valid, shifts[0] + h * kE, shifts[1] + h * kE, recv,
          p.age_clamp, step, cn);
      const size_t off = (size_t)row * nc + col;
      store_lanes<H, kE, kVec>(hb + off, p.asl + off, valid, ld);
      if (more) {
        ld = nld;
        recv = nrecv;
        base = nbase;
      }
    }
  }
  flush_counts<kSus, kDet, kE>(cnt, cn, h, lanes, n, [&](int st) {
    return r0 + st * step_rows + t / lanes;
  });
  __syncthreads();
  add_block_counts<kSus, kDet>(cnt, p.out, col0, cols, nc, n);
}

// the two launches, or the row pass's geometry into ``info``
template <typename V, typename H, bool kVec, bool kSus, bool kDet>
cudaError_t launch(const Params& p, int* info, cudaStream_t s) {
  auto rows = arc_rows_kernel<V, H, kVec, kSus, kDet>;
  const int cols = kMaxRowBytes / (int)sizeof(V);
  const int stripes = (p.nc + cols - 1) / cols;
  const bool tiles = tile_fits(p.fanout);
  const size_t tile_smem = tiles ? (size_t)tile_smem_bytes(p.fanout) : 0;
  cudaError_t e;
  if (info != nullptr) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, rows);
    if (e != cudaSuccess) return e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rows,
                                                      kRowThreads, 0);
    if (e != cudaSuccess) return e;
    const int v[8] = {cols, per_sm, fa.numRegs, (int)fa.localSizeBytes,
                      kRowThreads, (int)tile_smem, 0, 0};
    for (int i = 0; i < 8; ++i) info[i] = v[i];
    return cudaSuccess;
  }
  if (p.wbuf == nullptr) return cudaErrorInvalidValue;
  const V* view = static_cast<const V*>(p.view);
  V* w = static_cast<V*>(p.wbuf);
  if (tiles) {
    auto tile = window_tile_kernel<V, kVec>;
    e = cudaFuncSetAttribute(
        tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tile_smem);
    if (e != cudaSuccess) return e;
    const int row_tiles = (p.n + kTileRows - 1) / kTileRows;
    tile<<<row_tiles * stripes, kThreads, tile_smem, s>>>(view, w, p.n, p.nc,
                                                          p.fanout);
  } else {
    const dim3 grid((p.n + p.fanout - 1) / p.fanout,
                    (p.nc + merge_rows::kTile - 1) / merge_rows::kTile);
    if (p.aligned)
      window_max_kernel<V, true><<<grid, merge_rows::kThreads, 0, s>>>(
          view, w, p.n, p.nc, p.fanout);
    else
      window_max_kernel<V, false><<<grid, merge_rows::kThreads, 0, s>>>(
          view, w, p.n, p.nc, p.fanout);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int splits = (p.n + kRowsPerBlock - 1) / kRowsPerBlock;
  rows<<<stripes * splits, kRowThreads, 0, s>>>(p);
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

int run(const void* view, const void* bases, void* hb, void* asl,
        const void* sa, const void* sb, const void* alive, void* wbuf,
        void* out, int n, int nc, int fanout, int view_bytes, int hb_bytes,
        int detect, int suspect, int age_clamp, int aligned, int* info,
        void* stream) {
  if (n <= 1 || nc <= 0 || nc > n || fanout < 1 || fanout >= n ||
      age_clamp < 0 || age_clamp > 63)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.view = view;
  p.bases = static_cast<const int32_t*>(bases);
  p.hb = hb;
  p.asl = static_cast<int8_t*>(asl);
  p.sa = static_cast<const int32_t*>(sa);
  p.sb = static_cast<const int32_t*>(sb);
  p.alive = static_cast<const uint8_t*>(alive);
  p.out = static_cast<int32_t*>(out);
  p.wbuf = wbuf;
  p.n = n;
  p.nc = nc;
  p.fanout = fanout;
  p.age_clamp = age_clamp;
  p.aligned = aligned;
  // 16-byte segments: every row's stripe segment whole and aligned
  const bool vec = aligned != 0 && nc % kSegBytes == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AM_LAUNCH(V, H) \
  (int)launch_vh<V, H>(p, vec, detect, suspect, info, s)
  if (view_bytes == 1 && hb_bytes == 1) return AM_LAUNCH(int8_t, int8_t);
  if (view_bytes == 1 && hb_bytes == 2) return AM_LAUNCH(int8_t, int16_t);
  if (view_bytes == 1 && hb_bytes == 4) return AM_LAUNCH(int8_t, int32_t);
  if (view_bytes == 2 && hb_bytes == 2) return AM_LAUNCH(int16_t, int16_t);
  if (view_bytes == 2 && hb_bytes == 4) return AM_LAUNCH(int16_t, int32_t);
#undef AM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch K4 on ``stream`` over column blocks (n rows, nc subject columns;
// the window runs down the rows, so a shard needs only its columns):
// the window max into ``wbuf`` [n, nc] (scratch of the view's type), then
// the row pass.  view: int8/int16 [n, nc]; bases: int32 [n] in [0, n); hb,
// asl, sa, sb, alive, out, suspect as fm_merge (out initialised by the
// caller: zeros, first_obs n when detect).  ``aligned``: 16-byte aligned
// lanes with nc % 4 == 0 (16-byte accesses where also nc % 16 == 0).
// Returns the CUDA error code of the launches.
extern "C" int am_merge(const void* view, const void* bases, void* hb,
                        void* asl, const void* sa, const void* sb,
                        const void* alive, void* wbuf, void* out, int n,
                        int nc, int fanout, int view_bytes, int hb_bytes,
                        int detect, int suspect, int age_clamp, int aligned,
                        void* stream) {
  return run(view, bases, hb, asl, sa, sb, alive, wbuf, out, n, nc, fanout,
             view_bytes, hb_bytes, detect, suspect, age_clamp, aligned,
             nullptr, stream);
}

// The geometry of what am_merge would launch for this shape, into info[8]
// (launches nothing): stripe columns, the row pass's blocks an SM,
// registers and local memory (spills) a thread and threads a block, the
// window tile's shared memory a block (0: the van Herk window), 0, 0.
extern "C" int am_info(int n, int nc, int fanout, int view_bytes,
                       int hb_bytes, int detect, int suspect, int aligned,
                       int* info) {
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, nullptr, n, nc, fanout, view_bytes, hb_bytes, detect,
             suspect, 63, aligned, info, nullptr);
}
