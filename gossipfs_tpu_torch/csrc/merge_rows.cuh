// The receiver-row pass shared by K2 (fused_merge.cu) and K4
// (arc_merge.cu): per receiver row, the max over its senders' view rows,
// then the merge epilogue (merge_elem.cuh) in place on the lanes, and the
// per-subject reductions.  K2 gives each receiver its F in-edges; K4 gives
// it one row of the window max (F = 1, the senders being its arc base).
// The suspicion form (kSus) adds two reductions: refuted entries and
// entries still SUSPECT after the merge, per subject, over all rows.
//
// Geometry: a block covers kRows receiver rows x kTile subject columns;
// each thread owns kVec = 4 consecutive subjects of every row (one 4, 8 or
// 16-byte vector load per lane when the column count % 4 == 0 and the
// lanes are 16-byte aligned, element loads otherwise) and keeps its subjects' counts in
// registers across the block's rows; one atomic per subject and block
// then adds them to the global reductions.  Counts and minima are
// integers, so every block order gives the same result.  The block's
// sender indices are staged in shared memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "merge_elem.cuh"

namespace merge_rows {

constexpr int kVec = 4;                 // subjects per thread
constexpr int kThreads = 256;
constexpr int kTile = kVec * kThreads;  // subject columns per block
constexpr int kRows = 16;               // receiver rows per block
constexpr int kMaxFanout = 512;         // kRows x kMaxFanout int32 = 32 KB

template <int B> struct Word;
template <> struct Word<4> { using T = int; };
template <> struct Word<8> { using T = int2; };
template <> struct Word<16> { using T = int4; };

// kVec lane values moved as one vector
template <typename T> union Pack4 {
  typename Word<kVec * sizeof(T)>::T w;
  T v[kVec];
};

// p[0..kVec) widened to int; only the first ``valid`` exist when the
// lanes are not aligned (the last tile of a ragged N)
template <typename T, bool kAligned>
__device__ __forceinline__ void load4(const T* p, int valid, int (&out)[kVec]) {
  if (kAligned) {
    Pack4<T> u;
    u.w = *reinterpret_cast<const typename Word<kVec * sizeof(T)>::T*>(p);
#pragma unroll
    for (int k = 0; k < kVec; ++k) out[k] = u.v[k];
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) out[k] = k < valid ? (int)p[k] : 0;
  }
}

template <typename T, bool kAligned>
__device__ __forceinline__ void store4(T* p, int valid, const int (&in)[kVec]) {
  if (kAligned) {
    Pack4<T> u;
#pragma unroll
    for (int k = 0; k < kVec; ++k) u.v[k] = (T)in[k];
    *reinterpret_cast<typename Word<kVec * sizeof(T)>::T*>(p) = u.w;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (k < valid) p[k] = (T)in[k];
  }
}

// The lanes and the view are column blocks [n, nc]: all n receiver (and
// sender) rows, nc subject columns (nc = n for a square round, n / shards
// under subject sharding; the function is columnwise, so a shard needs
// only its columns).  senders: int32 [n, fanout] row-major.  A dead
// receiver's gather is skipped (best stays -1): its epilogue is gated on
// recv anyway, which is what the TPU kernel's remap of dead receivers'
// edges to themselves achieves.  A sender outside [0, n) counts as
// absent.  ``out`` is int32 [3, nc] (cnt, n_det, first_obs), [5, nc] with
// refuted and held under kSus.  kBlock: a column block; without it nc = n
// is a compile-time fact (the square code is what it was before blocks).
template <typename V, typename H, bool kAligned, bool kSus, bool kBlock>
__global__ void __launch_bounds__(kThreads)
merge_rows_kernel(const V* __restrict__ view,
                  const int32_t* __restrict__ senders, int fanout,
                  H* __restrict__ hb, int8_t* __restrict__ asl,
                  const int32_t* __restrict__ shift_a,
                  const int32_t* __restrict__ shift_b,
                  const uint8_t* __restrict__ alive,
                  int32_t* __restrict__ out, int n, int nc, int detect,
                  int age_clamp) {
  extern __shared__ int32_t s_send[];  // [kRows][fanout]
  if (!kBlock) nc = n;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  for (int t = threadIdx.x; t < rows * fanout; t += kThreads)
    s_send[t] = senders[(size_t)row0 * fanout + t];
  __syncthreads();
  const int col0 = blockIdx.y * kTile + threadIdx.x * kVec;
  if (col0 >= nc) return;  // after the block's only barrier
  const int valid = min(kVec, nc - col0);
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
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    const int row = row0 + r;
    const bool recv = alive[row] != 0;
    int best[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) best[k] = -1;
    if (recv) {
      // unrolled so several sender rows' loads are in flight at once
#pragma unroll 4
      for (int f = 0; f < fanout; ++f) {
        const int s = s_send[r * fanout + f];
        if ((unsigned)s < (unsigned)n) {
          int v[kVec];
          load4<V, kAligned>(view + (size_t)s * nc + col0, valid, v);
#pragma unroll
          for (int k = 0; k < kVec; ++k) best[k] = max(best[k], v[k]);
        }
      }
    }
    const size_t off = (size_t)row * nc + col0;
    int h[kVec], a[kVec];
    load4<H, kAligned>(hb + off, valid, h);
    load4<int8_t, kAligned>(asl + off, valid, a);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const MeOut m = merge_elem<kSus>(best[k], h[k], a[k], recv, sa[k],
                                       sb[k], MeLim<H>::lo, MeLim<H>::hi,
                                       age_clamp);
      h[k] = m.hb;
      a[k] = m.asl;
      c[k] += (recv && m.listed) ? 1 : 0;
      if (m.fresh) {
        nd[k] += 1;
        fo[k] = min(fo[k], row);
      }
      if (kSus) {
        rf[k] += m.refuted ? 1 : 0;
        hd[k] += m.held ? 1 : 0;
      }
    }
    store4<H, kAligned>(hb + off, valid, h);
    store4<int8_t, kAligned>(asl + off, valid, a);
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (k >= valid) break;
    if (c[k]) atomicAdd(out + col0 + k, c[k]);
    if (detect && nd[k]) {
      atomicAdd(out + nc + col0 + k, nd[k]);
      atomicMin(out + 2 * nc + col0 + k, fo[k]);
    }
    if (kSus && rf[k]) atomicAdd(out + 3 * nc + col0 + k, rf[k]);
    if (kSus && hd[k]) atomicAdd(out + 4 * nc + col0 + k, hd[k]);
  }
}

template <typename V, typename H, bool kSus>
cudaError_t launch_rows_s(const V* v, const int32_t* senders, int fanout,
                          H* h, int8_t* a, const int32_t* sa,
                          const int32_t* sb, const uint8_t* alive,
                          int32_t* out, int n, int nc, int detect,
                          int age_clamp, bool aligned, cudaStream_t s) {
  const dim3 grid((n + kRows - 1) / kRows, (nc + kTile - 1) / kTile);
  const size_t smem = sizeof(int32_t) * kRows * (size_t)fanout;
#define MR_LAUNCH(al, blk)                                                  \
  merge_rows_kernel<V, H, al, kSus, blk><<<grid, kThreads, smem, s>>>(      \
      v, senders, fanout, h, a, sa, sb, alive, out, n, nc, detect, age_clamp)
  if (nc == n) {
    if (aligned)
      MR_LAUNCH(true, false);
    else
      MR_LAUNCH(false, false);
  } else if (aligned) {
    MR_LAUNCH(true, true);
  } else {
    MR_LAUNCH(false, true);
  }
#undef MR_LAUNCH
  return cudaGetLastError();
}

template <typename V, typename H>
cudaError_t launch_rows_t(const void* view, const int32_t* senders,
                          int fanout, void* hb, void* asl,
                          const int32_t* sa, const int32_t* sb,
                          const uint8_t* alive, int32_t* out, int n, int nc,
                          int detect, int suspect, int age_clamp,
                          bool aligned, cudaStream_t s) {
  const V* v = static_cast<const V*>(view);
  H* h = static_cast<H*>(hb);
  int8_t* a = static_cast<int8_t*>(asl);
  if (suspect)
    return launch_rows_s<V, H, true>(v, senders, fanout, h, a, sa, sb, alive,
                                     out, n, nc, detect, age_clamp, aligned,
                                     s);
  return launch_rows_s<V, H, false>(v, senders, fanout, h, a, sa, sb, alive,
                                    out, n, nc, detect, age_clamp, aligned,
                                    s);
}

// The row pass for every (view, hb) pair SimConfig admits, by byte width,
// over [n, nc] column blocks.  out: int32 [3, nc] = cnt_incl, n_det,
// first_obs ([5, nc] with refuted and held when ``suspect``), initialised
// by the caller (zeros; first_obs n when detect).
inline cudaError_t launch_rows(int view_bytes, int hb_bytes, const void* view,
                               const int32_t* senders, int fanout, void* hb,
                               void* asl, const int32_t* sa,
                               const int32_t* sb, const uint8_t* alive,
                               int32_t* out, int n, int nc, int detect,
                               int suspect, int age_clamp, bool aligned,
                               cudaStream_t s) {
  if (n <= 0 || nc <= 0 || nc > n || fanout < 1 || fanout > kMaxFanout ||
      age_clamp < 0 || age_clamp > 63)
    return cudaErrorInvalidValue;
#define MR_ARGS view, senders, fanout, hb, asl, sa, sb, alive, out, n, nc, \
                detect, suspect, age_clamp, aligned, s
  if (view_bytes == 1 && hb_bytes == 1)
    return launch_rows_t<int8_t, int8_t>(MR_ARGS);
  if (view_bytes == 1 && hb_bytes == 2)
    return launch_rows_t<int8_t, int16_t>(MR_ARGS);
  if (view_bytes == 1 && hb_bytes == 4)
    return launch_rows_t<int8_t, int32_t>(MR_ARGS);
  if (view_bytes == 2 && hb_bytes == 2)
    return launch_rows_t<int16_t, int16_t>(MR_ARGS);
  if (view_bytes == 2 && hb_bytes == 4)
    return launch_rows_t<int16_t, int32_t>(MR_ARGS);
#undef MR_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace merge_rows
