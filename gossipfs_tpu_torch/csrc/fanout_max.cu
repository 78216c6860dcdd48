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
// 3.35 TB/s), plus the N x F int32 edges; the work is F - 1 compares an
// output element.  The gather reads F view rows an output row, F times the
// floor's view bytes (3.76 GB at N = 16,384, F = 14): those come from L2,
// and what bounds the kernel is how fast L2 serves them and how well their
// latency is hidden.
//
// Design: K2's gather alone (gather_ring.cuh, tested on the host): a block of
// 256 threads takes a 128-byte stripe of columns by a range of receiver rows, 8
// threads a row, 16 bytes each; each receiver's F sender segments go by
// cp.async.cg into a 2-stage ring in shared memory one chunk ahead of the fold
// (a DPX max, two words an instruction in int8), and the output row piece is
// stored once, 16 bytes evict-first.  Its 44 registers let 4 blocks share an
// SM.  Items run row ranges fastest inside a stripe, sized so that the blocks
// the card holds at once gather from ~12 MB of view strips (item_rows;
// stripe-fastest items: 142 % slower).  At N = 16,384, F = 14 the gather reads
// 3.76 GB from L2 at ~9 TB/s.  A sender outside [0, n) is skipped (the fold
// starts at the type's minimum); every caller's senders lie in [0, n).  fx_info
// reports the geometry.  No fallback: a refused launch returns its error and
// the wrapper raises.
#include <cstdint>
#include <cuda_runtime.h>

#include "gather_ring.cuh"

namespace {

template <typename T, bool kVec>
__global__ void __launch_bounds__(gring::kThreads, 2)
fanout_max_kernel(const T* __restrict__ view,
                  const int32_t* __restrict__ edges, T* __restrict__ out,
                  int n, int fanout, int item_rows) {
  constexpr int cols = gring::kLanes * (mstripe::kSegBytes / (int)sizeof(T));
  const int splits = (n + item_rows - 1) / item_rows;
  const int col0 = (int)(blockIdx.x / splits) * cols;
  const int r0 = (int)(blockIdx.x % splits) * item_rows;
  extern __shared__ __align__(16) unsigned char smem[];
  gring::fx_thread<T, kVec>(
      view, edges, out, n, fanout, r0, min(item_rows, n - r0), col0,
      threadIdx.x, reinterpret_cast<int8_t*>(smem),
      [](int8_t* d, const int8_t* s) { mstripe::copy16(d, s); },
      [] { asm volatile("cp.async.commit_group;" ::: "memory"); },
      [] {
        asm volatile("cp.async.wait_group %0;" ::"n"(gring::kDepth - 1)
                     : "memory");
      });
}

// the launch, or its geometry into ``info`` (as fm_info's)
template <typename T, bool kVec>
cudaError_t launch(const void* view, const int32_t* edges, void* out, int n,
                   int fanout, int* info, cudaStream_t s) {
  auto kern = fanout_max_kernel<T, kVec>;
  static gring::Held held;
  gring::Grid g;
  const cudaError_t e =
      gring::grid(kern, n, n, (int)sizeof(T), fanout, false, held, &g, info);
  if (e != cudaSuccess || info != nullptr) return e;
  kern<<<g.items, gring::kThreads, g.smem, s>>>(static_cast<const T*>(view),
                                                edges, static_cast<T*>(out),
                                                n, fanout, g.rows);
  return cudaGetLastError();
}

int run(const void* view, const void* edges, void* out, int n, int fanout,
        int elem_bytes, int aligned, int* info, void* stream) {
  if (n <= 0 || fanout < 1) return (int)cudaErrorInvalidValue;
  const int32_t* e = static_cast<const int32_t*>(edges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte segments: every row's stripe segment whole and aligned
  const bool vec = aligned != 0 && n % mstripe::kSegBytes == 0;
#define FX_LAUNCH(T)                                            \
  (int)(vec ? launch<T, true>(view, e, out, n, fanout, info, s) \
            : launch<T, false>(view, e, out, n, fanout, info, s))
  switch (elem_bytes) {
    case 1: return FX_LAUNCH(int8_t);
    case 2: return FX_LAUNCH(int16_t);
    case 4: return FX_LAUNCH(int32_t);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FX_LAUNCH
}

}  // namespace

// Launch K1 on ``stream``.  view: [n, n] row-major of ``elem_bytes``-byte
// signed integers (1, 2 or 4); edges: int32 [n, fanout], each in [0, n);
// out: like view.  ``aligned``: n % 4 == 0 and every pointer 16-byte
// aligned (16-byte accesses where also n % 16 == 0).  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int fx_fanout_max(const void* view, const void* edges, void* out,
                             int n, int fanout, int elem_bytes, int aligned,
                             void* stream) {
  return run(view, edges, out, n, fanout, elem_bytes, aligned, nullptr,
             stream);
}

// The geometry of what fx_fanout_max would launch for this shape, into
// info[10] (launches nothing), as fm_info's: stripe columns, receiver rows
// an item, ring stages, slots a stage and thread, shared memory a block,
// threads a block, blocks an SM, registers and local memory a thread,
// items (blocks) of the launch.
extern "C" int fx_info(int n, int fanout, int elem_bytes, int aligned,
                       int* info) {
  return run(nullptr, nullptr, nullptr, n, fanout, elem_bytes, aligned, info,
             nullptr);
}
