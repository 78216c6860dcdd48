// Per-entry merge epilogue of the separate-pass round, shared by the
// Hopper kernels K2 (fused_merge.cu), K4 (arc_merge.cu) and K5
// (stripe_merge.cu) and by a host build that the CPU tests compile with
// g++ and hold against the plain PyTorch version
// (gossipfs_tpu_torch/ops/merge_update.py: epilogue_plain).
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
#define ME_SUSPECT 3

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
  bool listed;   // in the list after the merge (MEMBER, or SUSPECT)
  bool fresh;    // the detector fired on this entry this round
  bool refuted;  // suspicion: an advance on a SUSPECT entry (-> MEMBER)
  bool held;     // suspicion: still SUSPECT after the merge
};

// One entry: ``best`` the max of the senders' view values for the subject
// (-1 when no sender carried it), ``hb`` the post-tick stored heartbeat,
// ``asl`` the packed byte ((age << 2) | status) - 128, ``recv`` the
// receiver's alive bit, ``sa``/``sb`` the subject's view and store
// shifts.  Advance a listed entry that some sender holds fresher, add an
// UNKNOWN one, renormalise to the new base, age by one.  ``fresh`` is the
// detection identity (FAILED at age 0 before the merge) that the
// crash-only fresh-cooldown fault model makes exact.
//
// ``kSus`` is the SWIM form (the JAX kernels' ``suspect=`` epilogue): a
// SUSPECT entry is still listed (listed = the odd statuses, MEMBER and
// SUSPECT), so it takes the advance compare, and an advance on it is the
// refutation: every update writes MEMBER.  It also reports ``refuted``
// and ``held`` for the per-subject suspicion reductions.  With ``kSus``
// false the two stay false and the rest is the suspicion-off epilogue.
template <bool kSus = false>
ME_HD MeOut merge_elem(int best, int hb, int asl, bool recv, int sa, int sb,
                       int lo, int hi, int age_clamp) {
  const int p = asl + 128;
  const int st = p & 3;
  const int age = p >> 2;
  const bool any = best >= 0;
  const bool listed_pre = kSus ? (st & 1) != 0 : st == ME_MEMBER;
  const bool advance = recv && any && listed_pre && best > hb - sa;
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
  out.listed = kSus ? (new_st & 1) != 0 : new_st == ME_MEMBER;
  out.fresh = recv && st == ME_FAILED && age == 0;
  out.refuted = kSus && advance && st == ME_SUSPECT;
  out.held = kSus && new_st == ME_SUSPECT;
  return out;
}
