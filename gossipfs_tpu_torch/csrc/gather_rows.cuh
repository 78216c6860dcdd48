// The per-receiver F-row gather-max: for one receiver, the max over its F
// sender rows of a row-major [n, n] view, at kV consecutive columns: K1
// (fanout_max.cu: the gather is the whole kernel), compiled by a g++
// harness in the CPU tests (tests/test_torch_gather_rows_host.py) against
// the plain version.  K3's forms gather 16 bytes a row through
// rr_onepass.cuh instead.
//
// The max starts at the element type's minimum, so it is the max over
// the F rows with no floor, as the TPU kernels compute it (the XLA oracle
// fanout_max_merge_xla starts at -1 instead: the two agree for views
// >= -1).  A sender outside [0, n) is skipped, so a bad index never reads
// out of bounds; every caller's senders lie in [0, n).
#pragma once

#include <cstddef>
#include <cstdint>

#if defined(__CUDACC__)
#define GR_HD __host__ __device__ __forceinline__
#define GR_UNROLL _Pragma("unroll 4")
#else
#define GR_HD inline
#define GR_UNROLL
#endif

namespace gather_rows {

template <typename T> struct Lo;
template <> struct Lo<int8_t> { static constexpr int v = -128; };
template <> struct Lo<int16_t> { static constexpr int v = -32768; };
template <> struct Lo<int32_t> { static constexpr int v = INT32_MIN; };

#if defined(__CUDACC__)
template <int B> struct Word;
template <> struct Word<4> { using T = int; };
template <> struct Word<8> { using T = int2; };
template <> struct Word<16> { using T = int4; };
#endif

// p[0..kV) widened to int.  kAligned: p is kV * sizeof(T)-byte aligned
// and all kV exist, so the card moves them as one vector; otherwise only
// the first ``valid`` exist (the last tile of a ragged n).
template <typename T, int kV, bool kAligned>
GR_HD void load_row(const T* p, int valid, int (&out)[kV]) {
#if defined(__CUDA_ARCH__)
  if constexpr (kAligned) {
    union {
      typename Word<kV * sizeof(T)>::T w;
      T v[kV];
    } u;
    u.w = *reinterpret_cast<const typename Word<kV * sizeof(T)>::T*>(p);
#pragma unroll
    for (int k = 0; k < kV; ++k) out[k] = u.v[k];
  } else
#endif
  {
    for (int k = 0; k < kV; ++k)
      out[k] = (kAligned || k < valid) ? (int)p[k] : 0;
  }
}

template <typename T, int kV, bool kAligned>
GR_HD void store_row(T* p, int valid, const int (&in)[kV]) {
#if defined(__CUDA_ARCH__)
  if constexpr (kAligned) {
    union {
      typename Word<kV * sizeof(T)>::T w;
      T v[kV];
    } u;
#pragma unroll
    for (int k = 0; k < kV; ++k) u.v[k] = (T)in[k];
    *reinterpret_cast<typename Word<kV * sizeof(T)>::T*>(p) = u.w;
  } else
#endif
  {
    for (int k = 0; k < kV; ++k)
      if (kAligned || k < valid) p[k] = (T)in[k];
  }
}

// best[k] = max over f < fanout of view[row_of(f), col0 + k]; ``view``
// is [rows, cols] row-major (a column block of the view under subject
// sharding: all sender rows, the shard's columns), ``row_of(f)`` the f-th
// sender row.
template <typename T, int kV, bool kAligned, typename RowOf>
GR_HD void gather_max_block(const T* view, int rows, int cols, int col0,
                            int valid, int fanout, RowOf row_of,
                            int (&best)[kV]) {
  for (int k = 0; k < kV; ++k) best[k] = Lo<T>::v;
  // unrolled so several sender rows' loads are in flight at once
  GR_UNROLL
  for (int f = 0; f < fanout; ++f) {
    const int s = row_of(f);
    if ((unsigned)s < (unsigned)rows) {
      int v[kV];
      load_row<T, kV, kAligned>(view + (size_t)s * cols + col0, valid, v);
      for (int k = 0; k < kV; ++k) best[k] = v[k] > best[k] ? v[k] : best[k];
    }
  }
}

// gather_max_block over a square [n, n] view
template <typename T, int kV, bool kAligned, typename RowOf>
GR_HD void gather_max(const T* view, int n, int col0, int valid, int fanout,
                      RowOf row_of, int (&best)[kV]) {
  gather_max_block<T, kV, kAligned>(view, n, n, col0, valid, fanout, row_of,
                                    best);
}

}  // namespace gather_rows
