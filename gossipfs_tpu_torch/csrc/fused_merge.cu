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
// H100's 3.35 TB/s; the epilogue is a few dozen integer ops per entry.
// The TPU kernel gathered the F sender rows with async DMAs into VMEM.
//
// Design (simple and right first): one pass, merge_rows.cuh.  A block
// covers 16 receiver rows x 1024 subjects, 4 subjects per thread; the F
// sender rows of each receiver are read straight from device memory
// (F view reads per entry: 14 at config 3, so about 2.1 GB moved, ~3x the
// floor; the view is 105 MB, twice the 50 MB L2, so only part of the
// gather hits in L2).  Each lane is read and written once, in place.
// Staging a column stripe of the view in shared memory for many receivers
// (the JAX package's stripe kernel K5) is the step that would cut the
// gather's bytes: csrc/stripe_merge.cu (K5) does that.
#include <cstdint>
#include <cuda_runtime.h>

#include "merge_rows.cuh"

// Launch K2 on ``stream`` over column blocks: n rows, nc subject columns
// (nc = n for a square round, n / shards on a subject shard).  view:
// int8/int16 [n, nc]; edges: int32 [n, fanout] in [0, n); hb: int8/16/32
// [n, nc] and asl: int8 [n, nc], post-tick, updated in place; sa, sb:
// int32 [nc]; alive: bool [n]; out: int32 [3, nc] = cnt_incl, n_det,
// first_obs ([5, nc] with refuted and held when ``suspect``), initialised
// by the caller.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int fm_merge(const void* view, const void* edges, void* hb,
                        void* asl, const void* sa, const void* sb,
                        const void* alive, void* out, int n, int nc,
                        int fanout,
                        int view_bytes, int hb_bytes, int detect, int suspect,
                        int age_clamp, int aligned, void* stream) {
  return (int)merge_rows::launch_rows(
      view_bytes, hb_bytes, view, static_cast<const int32_t*>(edges), fanout,
      hb, asl, static_cast<const int32_t*>(sa),
      static_cast<const int32_t*>(sb), static_cast<const uint8_t*>(alive),
      static_cast<int32_t*>(out), n, nc, detect, suspect, age_clamp,
      aligned != 0, static_cast<cudaStream_t>(stream));
}
