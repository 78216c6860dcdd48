// Vector loads and stores of kVec = 4 consecutive values (one 4, 8 or
// 16-byte access where the values are aligned, element by element at a
// ragged edge), widened to int, for K4's van Herk/Gil-Werman window
// (arc_merge.cu window_max_kernel: a block of kThreads threads covers kTile
// columns, kVec a thread).  That window runs only where a window tile and
// its halo outgrow a block's shared memory (F > ~1,300); every other
// kernel moves 16 bytes a thread (merge_stripe.cuh, gather_ring.cuh).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace merge_rows {

constexpr int kVec = 4;                 // columns per thread
constexpr int kThreads = 256;
constexpr int kTile = kVec * kThreads;  // columns per block

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

}  // namespace merge_rows
