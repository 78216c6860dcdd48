// K1: the F-way row gather-max, out[i, :] = max over f of view[edges[i, f], :],
// for NVIDIA Hopper (sm_90a), over an int8, int16 or int32 view.
//
// Replaces the TPU kernel gossipfs_tpu/ops/merge_pallas.py fanout_max_merge
// (:146, its slotted async-DMA row gather _gather_max_rows :66).  The
// function it computes is defined by the plain PyTorch version,
// gossipfs_tpu_torch/ops/fanout_max.py fanout_max_merge_plain: the max over
// the F gathered rows with no floor.
//
// Bound: bytes.  The floor reads the view once and writes the output once,
// 2 N^2 elements (0.54 GB at N = 16,384 in int8: 0.16 ms at the H100's
// 3.35 TB/s), plus the N x F int32 edges; the work is F - 1 compares per
// output element.  The gather reads F view rows per output row, F times the
// floor's view bytes: what keeps that off device memory is L2.  The grid
// runs its receiver-row blocks fastest inside one 1,024-column tile, so
// that tile's view strip (N x 1,024 elements: 16 MB in int8 at N = 16,384)
// is what the blocks in flight gather from, and it fits the 50 MB L2.
//
// Design (simple and right first): a block covers 16 receiver rows x 1,024
// columns, 4 consecutive columns per thread (one 4, 8 or 16-byte vector
// load per sender row when N % 4 == 0, element loads otherwise), the
// sender ids read by every thread of the block from the same address (a
// broadcast).  The gather itself is gather_rows.cuh.
#include <cstdint>
#include <cuda_runtime.h>

#include "gather_rows.cuh"

namespace {

constexpr int kVec = 4;                 // columns per thread
constexpr int kThreads = 256;
constexpr int kTile = kVec * kThreads;  // columns per block
constexpr int kRows = 16;               // receiver rows per block

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
fanout_max_kernel(const T* __restrict__ view,
                  const int32_t* __restrict__ edges, T* __restrict__ out,
                  int n, int fanout) {
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kTile + threadIdx.x * kVec;
  if (col0 >= n) return;
  const int valid = min(kVec, n - col0);
  const int rows = min(kRows, n - row0);
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    const int32_t* e = edges + (size_t)(row0 + r) * fanout;
    int best[kVec];
    gather_rows::gather_max<T, kVec, kAligned>(
        view, n, col0, valid, fanout, [e](int f) { return e[f]; }, best);
    gather_rows::store_row<T, kVec, kAligned>(
        out + (size_t)(row0 + r) * n + col0, valid, best);
  }
}

template <typename T>
cudaError_t launch(const void* view, const int32_t* edges, void* out, int n,
                   int fanout, bool aligned, cudaStream_t s) {
  const dim3 grid((n + kRows - 1) / kRows, (n + kTile - 1) / kTile);
  const T* v = static_cast<const T*>(view);
  T* o = static_cast<T*>(out);
  if (aligned)
    fanout_max_kernel<T, true><<<grid, kThreads, 0, s>>>(v, edges, o, n,
                                                         fanout);
  else
    fanout_max_kernel<T, false><<<grid, kThreads, 0, s>>>(v, edges, o, n,
                                                          fanout);
  return cudaGetLastError();
}

}  // namespace

// Launch K1 on ``stream``.  view: [n, n] row-major of ``elem_bytes``-byte
// signed integers (1, 2 or 4); edges: int32 [n, fanout], each in [0, n);
// out: like view.  ``aligned``: n % 4 == 0 and every pointer 16-byte
// aligned (vector loads).  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int fx_fanout_max(const void* view, const void* edges, void* out,
                             int n, int fanout, int elem_bytes, int aligned,
                             void* stream) {
  if (n <= 0 || fanout < 1) return (int)cudaErrorInvalidValue;
  const int32_t* e = static_cast<const int32_t*>(edges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool al = aligned != 0;
  switch (elem_bytes) {
    case 1: return (int)launch<int8_t>(view, e, out, n, fanout, al, s);
    case 2: return (int)launch<int16_t>(view, e, out, n, fanout, al, s);
    case 4: return (int)launch<int32_t>(view, e, out, n, fanout, al, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
