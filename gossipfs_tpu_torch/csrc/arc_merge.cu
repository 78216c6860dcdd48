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
// Design (simple and right first): two launches in stream order.
//   A  window_max_kernel: W[r] = max view[r..r+F-1 mod N], per column, by
//      the van Herk/Gil-Werman split: rows fall in segments of F (in the
//      index space extended past N by the wrap); a window starting at r
//      in segment m is the suffix max of m from r joined with the prefix
//      max of segment m+1 up to r+F-1.  One block per segment x 1024
//      columns, 4 per thread: a backward pass over segment m writes the
//      suffix maxima to W, a forward pass over segment m+1 folds the
//      prefix maxima in.  O(1) work per entry whatever F is; each view
//      row is read twice (by its own segment and by the one before) and
//      W is written, read back (by the same thread, mostly from L2) and
//      written again.
//   B  the receiver-row pass of merge_rows.cuh with F = 1: receiver i's
//      single "sender" is W row bases[i].  Dead receivers are masked in
//      the epilogue (a base cannot be remapped: every W row holds values).
// That moves about 7 B per entry at the headline against the floor's 5.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "merge_rows.cuh"

namespace {

using merge_rows::kThreads;
using merge_rows::kTile;
using merge_rows::kVec;
using merge_rows::load4;
using merge_rows::store4;

template <typename V, bool kAligned>
__global__ void __launch_bounds__(kThreads)
window_max_kernel(const V* __restrict__ view, V* __restrict__ w, int n,
                  int nc, int fanout) {
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

template <typename V>
cudaError_t launch_window(const void* view, void* w, int n, int nc,
                          int fanout, bool aligned, cudaStream_t s) {
  const dim3 grid((n + fanout - 1) / fanout, (nc + kTile - 1) / kTile);
  if (aligned)
    window_max_kernel<V, true><<<grid, kThreads, 0, s>>>(
        static_cast<const V*>(view), static_cast<V*>(w), n, nc, fanout);
  else
    window_max_kernel<V, false><<<grid, kThreads, 0, s>>>(
        static_cast<const V*>(view), static_cast<V*>(w), n, nc, fanout);
  return cudaGetLastError();
}

}  // namespace

// Launch K4 on ``stream`` over column blocks (n rows, nc subject columns;
// the window runs down the rows, so a shard needs only its columns).
// view: int8/int16 [n, nc]; bases: int32 [n] in [0, n); hb, asl, sa, sb,
// alive, out, suspect as fm_merge; wbuf: [n, nc] scratch of the view's
// type.  Returns the CUDA error code of the launches.
extern "C" int am_merge(const void* view, const void* bases, void* hb,
                        void* asl, const void* sa, const void* sb,
                        const void* alive, void* wbuf, void* out, int n,
                        int nc, int fanout, int view_bytes, int hb_bytes,
                        int detect, int suspect, int age_clamp, int aligned,
                        void* stream) {
  if (n <= 1 || nc <= 0 || nc > n || fanout < 1 || fanout >= n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (view_bytes == 1)
    e = launch_window<int8_t>(view, wbuf, n, nc, fanout, aligned != 0, s);
  else if (view_bytes == 2)
    e = launch_window<int16_t>(view, wbuf, n, nc, fanout, aligned != 0, s);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)merge_rows::launch_rows(
      view_bytes, hb_bytes, wbuf, static_cast<const int32_t*>(bases), 1, hb,
      asl, static_cast<const int32_t*>(sa), static_cast<const int32_t*>(sb),
      static_cast<const uint8_t*>(alive), static_cast<int32_t*>(out), n, nc,
      detect, suspect, age_clamp, aligned != 0, s);
}
