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
// Design (simple and right first).  One block owns a strip of kCols = 8
// subject columns for ALL N receivers:
//   1. it stages the view strip [N, 8] in dynamic shared memory (8 B per
//      receiver row: 128 KB at N = 16,384, so one 1,024-thread block per
//      SM), as two 4-byte words per row;
//   2. it sweeps the receivers, two threads per receiver row (4 subjects
//      each), two rows per thread at a time so that their loads overlap:
//      the F-way max is a per-byte signed max (__vmaxs4) over the
//      senders' words in shared memory, then the shared epilogue
//      (merge_elem.cuh) on the receiver's lanes, in place.  Every block
//      reads every receiver's edges, so they come as int16 (half the
//      bytes; N <= 28,416 fits) in their row-major [N, F] layout, which
//      measured faster than [F, N] (a warp's 16 receivers then read a few
//      lines that stay in L1 across f);
//   3. each thread keeps its 4 subjects' reductions in registers over its
//      rows; a warp shuffle and a shared-memory pass over the warps give
//      the block's totals.  The block sees every receiver of its subjects,
//      so the reductions need no atomics and no initialised output.
// The known cost: the lanes and the view are read in 8-byte row segments
// (4 B per thread), a quarter of a 32-byte sector for int8 lanes, so
// device-memory traffic stays near the floor only while the blocks of
// neighbouring strips run together and share those sectors in L2.
// Dead receivers skip their gather (best stays -1) and are masked in the
// epilogue, as in K2; the TPU kernel remapped their edges to themselves:
// the outputs are the same.
#include <cstdint>
#include <cuda_runtime.h>

#include "merge_rows.cuh"

namespace {

using merge_rows::kVec;
using merge_rows::load4;
using merge_rows::Pack4;
using merge_rows::store4;

constexpr int kCols = 8;                 // subject columns per block
constexpr int kHalves = kCols / kVec;    // threads per receiver row
constexpr int kThreads = 1024;
constexpr int kRowStep = kThreads / kHalves;
constexpr int kRowUnroll = 2;            // receiver rows per thread and step
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 5;                  // cnt, n_det, first_obs, ref, held
// the opt-in shared memory of one Hopper block; ops/merge_update.py
// derives the largest N the kernel admits from the same numbers
constexpr int kSmemLimit = 232448;
constexpr int kStaticSmem = sizeof(int32_t) * kAcc * kWarps * kCols;

__device__ __forceinline__ int warp_sum_half(int v) {
  // lanes of one half (same lane parity) combine
#pragma unroll
  for (int o = kHalves; o < 32; o <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_min_half(int v) {
#pragma unroll
  for (int o = kHalves; o < 32; o <<= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename H, bool kAligned, bool kSus>
__global__ void __launch_bounds__(kThreads)
stripe_kernel(const int8_t* __restrict__ view,
              const int16_t* __restrict__ edges, int fanout,
              H* __restrict__ hb, int8_t* __restrict__ asl,
              const int32_t* __restrict__ shift_a,
              const int32_t* __restrict__ shift_b,
              const uint8_t* __restrict__ alive, int32_t* __restrict__ out,
              int n, int nc, int detect, int age_clamp) {
  extern __shared__ int32_t strip[];     // [n][kHalves] packed view words
  __shared__ int32_t red[kAcc][kWarps][kCols];
  const int c0 = blockIdx.x * kCols;
  // 1. the view strip, word (r, h) = view[r, c0 + 4h .. c0 + 4h + 3];
  //    columns past the block's nc read as absent (-1)
#pragma unroll 4
  for (int t = threadIdx.x; t < n * kHalves; t += kThreads) {
    const int r = t / kHalves;
    const int col = c0 + (t % kHalves) * kVec;
    const int8_t* p = view + (size_t)r * nc + col;
    int w = -1;
    if (kAligned) {
      if (col < nc) w = *reinterpret_cast<const int*>(p);
    } else {
      Pack4<int8_t> u;
#pragma unroll
      for (int k = 0; k < kVec; ++k) u.v[k] = col + k < nc ? p[k] : -1;
      w = u.w;
    }
    strip[t] = w;
  }
  __syncthreads();

  // 2. the receiver sweep
  const int half = threadIdx.x % kHalves;
  const int col0 = c0 + half * kVec;
  const int valid = min(kVec, nc - col0);  // <= 0: no columns here
  int sa[kVec], sb[kVec], c[kVec], nd[kVec], fo[kVec], rf[kVec], hd[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    sa[k] = k < valid ? shift_a[col0 + k] : 0;
    sb[k] = k < valid ? shift_b[col0 + k] : 0;
    c[k] = 0;
    nd[k] = 0;
    fo[k] = n;
    rf[k] = 0;
    hd[k] = 0;
  }
  if (valid > 0) {
    // kRowUnroll receiver rows per step, so that their lane loads and
    // their senders' edge loads are in flight together
#pragma unroll 1
    for (int row0 = threadIdx.x / kHalves; row0 < n;
         row0 += kRowStep * kRowUnroll) {
      int h[kRowUnroll][kVec], a[kRowUnroll][kVec], bw[kRowUnroll];
      bool recv[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int row = row0 + u * kRowStep;
        recv[u] = row < n && alive[row] != 0;
        bw[u] = -1;                         // four absent (-1) bytes
        if (row < n) {
          const size_t off = (size_t)row * nc + col0;
          load4<H, kAligned>(hb + off, valid, h[u]);
          load4<int8_t, kAligned>(asl + off, valid, a[u]);
        }
      }
#pragma unroll 2
      for (int f = 0; f < fanout; ++f) {
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u) {
          if (!recv[u]) continue;
          const int s = edges[(size_t)(row0 + u * kRowStep) * fanout + f];
          if ((unsigned)s < (unsigned)n)
            bw[u] = __vmaxs4(bw[u], strip[s * kHalves + half]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int row = row0 + u * kRowStep;
        if (row >= n) break;
        Pack4<int8_t> bu;
        bu.w = bw[u];
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const MeOut m = merge_elem<kSus>(bu.v[k], h[u][k], a[u][k],
                                           recv[u], sa[k], sb[k],
                                           MeLim<H>::lo, MeLim<H>::hi,
                                           age_clamp);
          h[u][k] = m.hb;
          a[u][k] = m.asl;
          c[k] += (recv[u] && m.listed) ? 1 : 0;
          if (m.fresh) {
            nd[k] += 1;
            fo[k] = min(fo[k], row);
          }
          if (kSus) {
            rf[k] += m.refuted ? 1 : 0;
            hd[k] += m.held ? 1 : 0;
          }
        }
        const size_t off = (size_t)row * nc + col0;
        store4<H, kAligned>(hb + off, valid, h[u]);
        store4<int8_t, kAligned>(asl + off, valid, a[u]);
      }
    }
  }

  // 3. the block's reductions: warp (per half), then across warps
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int cs = warp_sum_half(c[k]);
    const int ns = warp_sum_half(nd[k]);
    const int fs = warp_min_half(fo[k]);
    const int rs = kSus ? warp_sum_half(rf[k]) : 0;
    const int hs = kSus ? warp_sum_half(hd[k]) : 0;
    if (lane < kHalves) {
      const int j = lane * kVec + k;
      red[0][warp][j] = cs;
      red[1][warp][j] = ns;
      red[2][warp][j] = fs;
      red[3][warp][j] = rs;
      red[4][warp][j] = hs;
    }
  }
  __syncthreads();
  const int j = threadIdx.x;
  if (j < kCols && c0 + j < nc) {
    int cs = 0, ns = 0, fs = n, rs = 0, hs = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      cs += red[0][w][j];
      ns += red[1][w][j];
      fs = min(fs, red[2][w][j]);
      rs += red[3][w][j];
      hs += red[4][w][j];
    }
    const int col = c0 + j;
    out[col] = cs;
    out[nc + col] = detect ? ns : 0;
    out[2 * nc + col] = detect ? fs : 0;
    if (kSus) {
      out[3 * nc + col] = rs;
      out[4 * nc + col] = hs;
    }
  }
}

template <typename H, bool kAligned, bool kSus>
cudaError_t launch_t(const void* view, const int16_t* edges, int fanout,
                     void* hb, void* asl, const int32_t* sa,
                     const int32_t* sb, const uint8_t* alive, int32_t* out,
                     int n, int nc, int detect, int age_clamp,
                     cudaStream_t s) {
  const size_t smem = sizeof(int32_t) * kHalves * (size_t)n;
  auto kernel = stripe_kernel<H, kAligned, kSus>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<(nc + kCols - 1) / kCols, kThreads, smem, s>>>(
      static_cast<const int8_t*>(view), edges, fanout, static_cast<H*>(hb),
      static_cast<int8_t*>(asl), sa, sb, alive, out, n, nc, detect,
      age_clamp);
  return cudaGetLastError();
}

template <typename H>
cudaError_t launch_h(const void* view, const int16_t* edges, int fanout,
                     void* hb, void* asl, const int32_t* sa,
                     const int32_t* sb, const uint8_t* alive, int32_t* out,
                     int n, int nc, int detect, int suspect, int age_clamp,
                     bool aligned, cudaStream_t s) {
#define SM_ARGS view, edges, fanout, hb, asl, sa, sb, alive, out, n, nc, \
                detect, age_clamp, s
  if (aligned)
    return suspect ? launch_t<H, true, true>(SM_ARGS)
                   : launch_t<H, true, false>(SM_ARGS);
  return suspect ? launch_t<H, false, true>(SM_ARGS)
                 : launch_t<H, false, false>(SM_ARGS);
#undef SM_ARGS
}

}  // namespace

// Launch K5 on ``stream`` over column blocks: n rows, nc subject columns
// (nc = n for a square round, n / shards on a subject shard; the strip
// holds every row, so the shared-memory bound is on n, whatever nc).
// view: int8 [n, nc] (view_bytes must be 1); edges: int16 [n, fanout]
// (every block reads all of them: int16 halves that traffic, and N <=
// 28,416 fits); hb: int8/16/32 [n, nc] and asl: int8 [n, nc], post-tick,
// updated in place; sa, sb: int32 [nc]; alive: bool [n]; out: int32
// [3, nc] = cnt_incl, n_det, first_obs ([5, nc] with refuted and held
// when ``suspect``), every entry written by the kernel.  ``aligned``: nc
// % 4 == 0 and 16-byte aligned lanes (vector loads).  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int sm_merge(const void* view, const void* edges, void* hb,
                        void* asl, const void* sa, const void* sb,
                        const void* alive, void* out, int n, int nc,
                        int fanout, int view_bytes, int hb_bytes, int detect,
                        int suspect, int age_clamp, int aligned,
                        void* stream) {
  if (n <= 0 || nc <= 0 || nc > n || fanout < 1 || view_bytes != 1 ||
      age_clamp < 0 || age_clamp > 63 ||
      (size_t)kHalves * sizeof(int32_t) * n + kStaticSmem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int16_t* e = static_cast<const int16_t*>(edges);
  const int32_t* a = static_cast<const int32_t*>(sa);
  const int32_t* b = static_cast<const int32_t*>(sb);
  const uint8_t* al = static_cast<const uint8_t*>(alive);
  int32_t* o = static_cast<int32_t*>(out);
#define SM_ARGS view, e, fanout, hb, asl, a, b, al, o, n, nc, detect, \
                suspect, age_clamp, aligned != 0, s
  if (hb_bytes == 1) return (int)launch_h<int8_t>(SM_ARGS);
  if (hb_bytes == 2) return (int)launch_h<int16_t>(SM_ARGS);
  if (hb_bytes == 4) return (int)launch_h<int32_t>(SM_ARGS);
#undef SM_ARGS
  return (int)cudaErrorInvalidValue;
}
