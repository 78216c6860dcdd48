// Per-entry arithmetic of the lean gossip round, shared by the Hopper
// kernel (resident_round.cu) and a host build that the CPU tests compile
// with g++ and hold against the plain PyTorch version
// (gossipfs_tpu_torch/ops/merge.py: tick_plain, view_plain, merge_plain).
//
// Every value is an int8 lane value widened to int; results that are
// compared wrap explicitly (rr_wrap8) and every store truncates to the
// low byte, which reproduces the reference's mod-2^8 int8 arithmetic.
// No CUDA-only intrinsics here: the header must compile with g++.
#pragma once

#if defined(__CUDACC__)
#define RR_HD __host__ __device__ __forceinline__
#else
#define RR_HD inline
#endif

// status codes (gossipfs_tpu_torch/core/state.py)
#define RR_UNKNOWN 0
#define RR_MEMBER 1
#define RR_FAILED 2
#define RR_SUSPECT 3

// rows of the per-subject int8 threshold stack (ops/merge.threshold_stack)
enum {
  V_SA_N = 0, V_SA_ALL, V_HI_N, V_THR_G, V_CMP_DEEP, V_D8, V_UP_DEEP,
  V_KEEP_THR, V_HI_THR, V_HAS_HI, V_SB8, N_VEC
};

// int8 wrap of an int in [-384, 383]
RR_HD int rr_wrap8(int x) { return ((x + 128) & 255) - 128; }

struct RrTick {
  int hb, asl;
  bool fail;   // the detector fired on this entry this round
  bool elig;   // post-tick MEMBER (may be gossiped)
};

// The heartbeat tick over hb and the packed age|status byte
// asl = ((age << 2) | status) - 128: small-group refresh, the
// sentinel-sticky diagonal bump, detection over the post-refresh age,
// the fresh cooldown stamp, then cooldown expiry.  Order matters.
// ``fail`` needs no diagonal exclusion: a bumped diagonal has age 0, and
// an unbumped one fails another conjunct.
RR_HD RrTick rr_tick(int hb, int asl, bool act, bool ref, bool eye,
                     int thr_g, int t_fail, int t_cooldown) {
  const int st = asl & 3;
  const bool st_mem = st == RR_MEMBER;
  const bool nsent = hb != -128;
  if (ref && st_mem) asl = st - 128;            // refresh: age 0
  const bool bump = eye && act && st_mem && nsent;
  if (bump) {
    hb = rr_wrap8(hb + 1);
    asl = st - 128;
  }
  const bool past = (hb >= thr_g) && nsent;
  const bool fail = act && st_mem && past &&
                    asl > (((t_fail << 2) | RR_MEMBER) - 128);
  if (fail) asl = RR_FAILED - 128;              // fresh cooldown stamp
  const bool expire = (asl & 3) == RR_FAILED &&
                      asl > (((t_cooldown << 2) | RR_FAILED) - 128);
  if (expire) asl = asl & -4;                   // -> UNKNOWN, age kept
  RrTick out;
  out.hb = hb;
  out.asl = asl;
  out.fail = fail;
  out.elig = st_mem && !fail;
  return out;
}

struct RrTickSus {
  int hb, asl;
  bool fail;     // a SUSPECT entry confirmed to FAILED this round
  bool elig;     // post-tick listed, MEMBER or SUSPECT (may be gossiped)
  bool entered;  // a MEMBER entry entered SUSPECT this round
};

// The tick's SWIM form (suspicion armed): as rr_tick, except that the
// small-group refresh also reverts SUSPECT -> MEMBER (both land at
// (MEMBER, age 0)), a stale MEMBER enters SUSPECT (status bit 1 set: the
// age keeps running, it is the suspicion clock), and a SUSPECT entry
// confirms to FAILED once its age passes ``confirm_thr``, or
// ``confirm_thr_hi`` on a Lifeguard-degraded row (``lh``).  Both masks
// read the pre-write status, so an entry spends at least one round
// SUSPECT, and the FAILED write lands last.  The confirm compare needs no
// diagonal exclusion: the diagonal is never SUSPECT.
RR_HD RrTickSus rr_tick_sus(int hb, int asl, bool act, bool ref, bool eye,
                            bool lh, int thr_g, int t_fail, int t_cooldown,
                            int confirm_thr, int confirm_thr_hi) {
  const int st = asl & 3;
  const bool st_mem = st == RR_MEMBER;
  const bool st_sus = st == RR_SUSPECT;
  const bool nsent = hb != -128;
  if (ref && (st_mem || st_sus)) asl = RR_MEMBER - 128;  // refresh/revert
  const bool bump = eye && act && st_mem && nsent;
  if (bump) {
    hb = rr_wrap8(hb + 1);
    asl = RR_MEMBER - 128;
  }
  const bool past = (hb >= thr_g) && nsent;
  const bool stale = act && st_mem && past &&
                     asl > (((t_fail << 2) | RR_MEMBER) - 128);
  const int thr = lh ? confirm_thr_hi : confirm_thr;
  const bool confirm = act && st_sus &&
                       asl > (((thr << 2) | RR_SUSPECT) - 128);
  if (stale) asl |= 2;                          // MEMBER -> SUSPECT
  if (confirm) asl = RR_FAILED - 128;           // fresh cooldown stamp
  const bool expire = (asl & 3) == RR_FAILED &&
                      asl > (((t_cooldown << 2) | RR_FAILED) - 128);
  if (expire) asl = asl & -4;
  RrTickSus out;
  out.hb = hb;
  out.asl = asl;
  out.fail = confirm;
  out.elig = (st_mem || st_sus) && !confirm;
  out.entered = stale;
  return out;
}

// Whether a row's view is sent this round, from its flags byte: an
// active sender (bit 0) that the scenario engine has not muted (bit 3,
// read in the edge_filter form only: a slow or flapping sender, or a
// member of a blacked-out rack).  A muted row ticks as ever (its tick
// takes ``act`` from bit 0); only its view encodes absent.
RR_HD bool rr_sends(int flags, bool edge_filter) {
  return (flags & 1) != 0 && !(edge_filter && (flags & 8) != 0);
}

// The gossip view of one post-tick entry: a sender's (``act``: rr_sends)
// MEMBER entry within the rebase window, encoded relative to the view
// shift; -1 when absent.  Returned wrapped to int8: the group max runs
// over the wrapped values.
RR_HD int rr_view(int hb, bool elig, bool act, int sa_n, int sa_all,
                  int hi_n) {
  const bool goss = elig && act && (hb >= sa_n || sa_all != 0) &&
                    hb <= hi_n && hb != -128;
  return rr_wrap8(goss ? hb - sa_n : -1);
}

struct RrMerge {
  int hb, asl;
  bool refuted;  // suspicion: an advance on a SUSPECT entry (-> MEMBER)
};

// Merge epilogue on one post-tick entry: advance / add / rebase / age
// advance, gated on the receiver's alive bit.  ``best`` is the max of the
// senders' view values for this subject; ``v`` the subject's threshold
// stack column (int8 values widened).  ``kSus``: a SUSPECT entry is
// listed and takes the advance, which refutes it (every update writes
// (MEMBER, age 0)).
template <bool kSus>
RR_HD RrMerge rr_merge_t(int hb, int asl, int best, bool recv, const int* v,
                         int age_clamp) {
  const int st = asl & 3;
  const bool any_m = best >= 0;
  const bool listed = kSus ? (st & 1) != 0 : st == RR_MEMBER;
  const bool advance = recv && listed && any_m &&
                       best > v[V_CMP_DEEP] &&
                       rr_wrap8(best + v[V_SA_N]) > hb;
  const bool add = recv && st == RR_UNKNOWN && any_m;
  const bool upd = advance || add;
  const int up_val = best <= v[V_UP_DEEP] ? -128 : best + v[V_D8];
  int keep_val = (v[V_HAS_HI] != 0 && hb >= v[V_HI_THR]) ? 127
                                                          : hb - v[V_SB8];
  if (hb <= v[V_KEEP_THR]) keep_val = -128;
  RrMerge out;
  out.hb = rr_wrap8(upd ? up_val : keep_val);
  const int base = upd ? RR_MEMBER - 128 : asl;
  out.asl = base >= (age_clamp << 2) - 128 ? base : base + 4;
  out.refuted = kSus && advance && st == RR_SUSPECT;
  return out;
}

RR_HD RrMerge rr_merge(int hb, int asl, int best, bool recv, const int* v,
                       int age_clamp) {
  return rr_merge_t<false>(hb, asl, best, recv, v, age_clamp);
}
