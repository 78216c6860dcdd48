// Per-entry merge epilogue of the separate-pass round, shared by the
// Hopper kernels K2 (fused_merge.cu) and K4 (arc_merge.cu) and by a host
// build that the CPU tests compile with g++ and hold against the plain
// PyTorch version (gossipfs_tpu_torch/ops/merge_update.py:
// epilogue_plain).
//
// The int32 + clip formulation of the JAX package's
// _epilogue_and_count (gossipfs_tpu/ops/merge_pallas.py): every lane value
// is widened to int, the new heartbeat is clipped to the lane type's range
// (MeLim below), and the age|status byte is unpacked, updated and packed
// again.  Values stay far inside int: heartbeats, shifts and bases are
// round counts.  No CUDA-only intrinsics here: the header must compile
// with g++.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define ME_HD __host__ __device__ __forceinline__
#else
#define ME_HD inline
#endif

// status codes (gossipfs_tpu_torch/core/state.py)
#define ME_UNKNOWN 0
#define ME_MEMBER 1
#define ME_FAILED 2

// value range of each heartbeat lane type: the epilogue's clip
template <typename H> struct MeLim;
template <> struct MeLim<int8_t> {
  static constexpr int lo = -128, hi = 127;
};
template <> struct MeLim<int16_t> {
  static constexpr int lo = -32768, hi = 32767;
};
template <> struct MeLim<int32_t> {
  static constexpr int lo = -2147483647 - 1, hi = 2147483647;
};

struct MeOut {
  int hb, asl;
  bool listed;  // MEMBER after the merge
  bool fresh;   // the detector fired on this entry this round
};

// One entry: ``best`` the max of the senders' view values for the subject
// (-1 when no sender carried it), ``hb`` the post-tick stored heartbeat,
// ``asl`` the packed byte ((age << 2) | status) - 128, ``recv`` the
// receiver's alive bit, ``sa``/``sb`` the subject's view and store
// shifts.  Advance a listed entry that some sender holds fresher, add an
// UNKNOWN one, renormalise to the new base, age by one.  ``fresh`` is the
// detection identity (FAILED at age 0 before the merge) that the
// crash-only fresh-cooldown fault model makes exact.
ME_HD MeOut merge_elem(int best, int hb, int asl, bool recv, int sa, int sb,
                       int lo, int hi, int age_clamp) {
  const int p = asl + 128;
  const int st = p & 3;
  const int age = p >> 2;
  const bool any = best >= 0;
  const bool advance = recv && any && st == ME_MEMBER && best > hb - sa;
  const bool add = recv && any && st == ME_UNKNOWN;
  const bool upd = advance || add;
  int v = upd ? best + (sa - sb) : hb - sb;
  v = v < lo ? lo : (v > hi ? hi : v);
  const int a1 = (upd ? 0 : age) + 1;
  const int new_age = a1 < age_clamp ? a1 : age_clamp;
  const int new_st = upd ? ME_MEMBER : st;
  MeOut out;
  out.hb = v;
  out.asl = ((new_age << 2) | new_st) - 128;
  out.listed = new_st == ME_MEMBER;
  out.fresh = recv && st == ME_FAILED && age == 0;
  return out;
}
