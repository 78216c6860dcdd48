// The SWAR form of the lean gossip round's per-entry arithmetic: one
// 32-bit word carries 4 subjects (int8 lanes, little-endian: byte 0 = the
// lowest subject), and every compare, select and wrap-around add runs on
// the 4 at once with carry-safe bitwise word arithmetic.  Shared by the
// Hopper kernels (resident_round.cu and rr_onepass.cu, kSwar) and a host
// build that the CPU
// tests compile with g++ (tests/test_torch_swar_host.py) and hold against
// the plain PyTorch version (gossipfs_tpu_torch/ops/merge.py:
// tick_view_swar_plain, merge_swar_plain, itself the port of the JAX
// package's _rr_tick_view_swar / _rr_merge_swar) and against rr_elem.cuh's
// lanes functions.
//
// The primitives are ops/swar.py's portable formulas term for term, over
// uint32 (no signed overflow): ``eq`` is one add and two logic ops, the
// ordered compares one subtract and a logic fold, all of which the
// compiler fuses into LOP3/IADD3.  No CUDA intrinsic is used: the
// __vcmpges4/__vmaxs4 class is emulated by several instructions on sm_90,
// so the host build replays exactly the code the card runs.
//
// Conventions: an "hmask" has 0x80 per true byte; ``bytes(m)`` expands it
// to 0xFF per true byte for a select.  A row-uniform flag enters as a
// full mask (all ones / zero), which serves as both.
#pragma once

#include <cstdint>
#include <cstring>

#include "rr_elem.cuh"

#if defined(__CUDACC__)
#define SW_HD __host__ __device__ __forceinline__
#else
#define SW_HD inline
#endif

namespace swar {

constexpr uint32_t H = 0x80808080u;    // per-byte sign bits
constexpr uint32_t L = 0x01010101u;    // per-byte ones
constexpr uint32_t B7F = 0x7F7F7F7Fu;  // per-byte low 7 bits

// the word whose 4 bytes all equal ``b`` (mod 256)
SW_HD constexpr uint32_t word(int b) { return (uint32_t)(b & 0xFF) * L; }

// a row-uniform flag as a full mask
SW_HD uint32_t row(bool b) { return b ? 0xFFFFFFFFu : 0u; }

SW_HD uint32_t eq(uint32_t x, uint32_t y) {
  const uint32_t z = x ^ y;
  return ~(((z & B7F) + B7F) | z) & H;
}

SW_HD uint32_t ne(uint32_t x, uint32_t y) {
  const uint32_t z = x ^ y;
  return (((z & B7F) + B7F) | z) & H;
}

// signed x >= y per byte: unsigned low-7 compare folded with the signs
SW_HD uint32_t ges(uint32_t x, uint32_t y) {
  const uint32_t t = (x | H) - (y & B7F);
  return ((~x & y) | (~(x ^ y) & t)) & H;
}

SW_HD uint32_t gts(uint32_t x, uint32_t y) { return ~ges(y, x) & H; }
SW_HD uint32_t les(uint32_t x, uint32_t y) { return ges(y, x); }

SW_HD uint32_t bytes(uint32_t m) { return ((m >> 7) & L) * 0xFFu; }

SW_HD uint32_t sel(uint32_t m, uint32_t x, uint32_t y) {
  return y ^ ((x ^ y) & m);
}

SW_HD uint32_t add(uint32_t x, uint32_t y) {
  return ((x & B7F) + (y & B7F)) ^ ((x ^ y) & H);
}

SW_HD uint32_t sub(uint32_t x, uint32_t y) {
  return ((x | H) - (y & B7F)) ^ ((x ^ ~y) & H);
}

SW_HD uint32_t maxs(uint32_t x, uint32_t y) {
  return sel(bytes(ges(x, y)), x, y);
}

SW_HD uint32_t mins(uint32_t x, uint32_t y) {
  return sel(bytes(les(x, y)), x, y);
}

// PTX prmt.b32 (default mode): byte i of the result is byte (s & 7) of
// the 8 bytes {a, b}, or its sign replicated where s & 8 (s the selector's
// nibble i).  One instruction on the card.
SW_HD uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
#else
  const uint64_t x = (uint64_t)b << 32 | a;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) {
    const uint32_t s = (sel >> (4 * i)) & 15;
    uint32_t v = (uint32_t)(x >> (8 * (s & 7))) & 0xFF;
    if (s & 8) v = (v & 0x80) ? 0xFF : 0;
    r |= v << (8 * i);
  }
  return r;
#endif
}

// byte k of a word, sign-extended (one prmt)
SW_HD int byte_at(uint32_t w, int k) {
  const uint32_t sx = (uint32_t)(k | 8);
  return (int)prmt(w, 0, (uint32_t)k | sx << 4 | sx << 8 | sx << 12);
}

// the low bytes of four ints as one word, byte 0 first (three prmt)
SW_HD uint32_t pack(int b0, int b1, int b2, int b3) {
  return prmt(prmt((uint32_t)b0, (uint32_t)b1, 0x0040),
              prmt((uint32_t)b2, (uint32_t)b3, 0x0040), 0x5410);
}

// 4 consecutive int8 lanes as one word (p is 4-byte aligned)
SW_HD uint32_t load(const int8_t* p) {
#if defined(__CUDA_ARCH__)
  return *reinterpret_cast<const uint32_t*>(p);
#else
  uint32_t w;
  std::memcpy(&w, p, 4);
  return w;
#endif
}

SW_HD void store(int8_t* p, uint32_t w) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint32_t*>(p) = w;
#else
  std::memcpy(p, &w, 4);
#endif
}

}  // namespace swar

// The threshold-stack rows a pass reads, as words of the same 4 subjects.
struct SwVec {
  uint32_t v[N_VEC];
};

// Pass A's result for one word: post-tick lanes, the view encode (-1 per
// absent byte), and hmasks of the detector firing (the confirmations
// under suspicion) and of the entries that entered SUSPECT.
struct SwTickView {
  uint32_t hb, asl, enc, fail, entered;
};

// The tick and view encode of a word the diagonal does not cross
// (ops/merge.tick_view_swar_plain): rr_tick / rr_tick_sus and rr_view of
// rr_elem.cuh with eye false, on 4 subjects at once.  ``act``, ``ref``,
// ``lh``, ``sends``: row masks.  Suspicion off, ``entered`` is 0 and
// ``lh``/``confirm*`` are unused.
template <bool kSus>
SW_HD SwTickView rr_tick_view_swar(uint32_t hb, uint32_t asl, uint32_t act,
                                   uint32_t ref, uint32_t lh, uint32_t sends,
                                   const SwVec& vec, int t_fail,
                                   int t_cooldown, int confirm_thr,
                                   int confirm_thr_hi) {
  using namespace swar;
  const uint32_t st = asl & word(3);
  const uint32_t stm = eq(st, word(RR_MEMBER));
  const uint32_t nsent = ne(hb, H);
  uint32_t sus_pre = 0;
  if (kSus) {
    sus_pre = eq(st, word(RR_SUSPECT));
    // listed refreshers land at (MEMBER, age 0), SUSPECT reverted
    asl = sel(bytes(ref & (stm | sus_pre)), word(RR_MEMBER - 128), asl);
  } else {
    asl = sel(bytes(ref & stm), st | H, asl);
  }
  const uint32_t past = ges(hb, vec.v[V_THR_G]) & nsent;
  const uint32_t stale =
      act & stm & past & gts(asl, word(((t_fail << 2) | RR_MEMBER) - 128));
  uint32_t fail, elig;
  SwTickView out;
  out.entered = 0;
  if (kSus) {
    const uint32_t thr =
        sel(lh, word(((confirm_thr_hi << 2) | RR_SUSPECT) - 128),
            word(((confirm_thr << 2) | RR_SUSPECT) - 128));
    fail = act & sus_pre & gts(asl, thr);
    asl |= bytes(stale) & word(2);  // MEMBER -> SUSPECT, age kept
    elig = (stm | sus_pre) & ~fail;
    out.entered = stale;
  } else {
    fail = stale;
    elig = stm & ~fail;
  }
  asl = sel(bytes(fail), word(RR_FAILED - 128), asl);
  const uint32_t expire =
      eq(asl & word(3), word(RR_FAILED)) &
      gts(asl, word(((t_cooldown << 2) | RR_FAILED) - 128));
  asl = sel(bytes(expire), asl & word(0xFC), asl);
  const uint32_t goss = elig & sends &
                        (ges(hb, vec.v[V_SA_N]) | ne(vec.v[V_SA_ALL], 0)) &
                        les(hb, vec.v[V_HI_N]) & nsent;
  out.hb = hb;
  out.asl = asl;
  out.enc = sel(bytes(goss), sub(hb, vec.v[V_SA_N]), 0xFFFFFFFFu);
  out.fail = fail;
  return out;
}

// The same for a word the diagonal crosses, at byte ``d`` (0..3; any
// other ``d`` crosses none): the lanes functions of rr_elem.cuh byte by
// byte (the bump needs the per-byte eye), bytes unpacked and packed back
// into words by prmt.
template <bool kSus>
SW_HD SwTickView rr_tick_view_lanes_word(uint32_t hb, uint32_t asl, bool act,
                                         bool ref, bool lh, bool sends,
                                         int d, const SwVec& vec, int t_fail,
                                         int t_cooldown, int confirm_thr,
                                         int confirm_thr_hi) {
  using swar::byte_at;
  int oh[4], oa[4], oe[4], of[4], on[4];
#if defined(__CUDACC__)
#pragma unroll
#endif
  for (int k = 0; k < 4; ++k) {
    int th, ta;
    bool fail, elig, entered = false;
    if (kSus) {
      const RrTickSus t = rr_tick_sus(
          byte_at(hb, k), byte_at(asl, k), act, ref, k == d, lh,
          byte_at(vec.v[V_THR_G], k), t_fail, t_cooldown, confirm_thr,
          confirm_thr_hi);
      th = t.hb;
      ta = t.asl;
      fail = t.fail;
      elig = t.elig;
      entered = t.entered;
    } else {
      const RrTick t = rr_tick(byte_at(hb, k), byte_at(asl, k), act, ref,
                               k == d, byte_at(vec.v[V_THR_G], k), t_fail,
                               t_cooldown);
      th = t.hb;
      ta = t.asl;
      fail = t.fail;
      elig = t.elig;
    }
    const int enc = rr_view(th, elig, sends, byte_at(vec.v[V_SA_N], k),
                            byte_at(vec.v[V_SA_ALL], k),
                            byte_at(vec.v[V_HI_N], k));
    oh[k] = th;
    oa[k] = ta;
    oe[k] = enc;
    of[k] = fail ? 0x80 : 0;
    on[k] = entered ? 0x80 : 0;
  }
  SwTickView out;
  out.hb = swar::pack(oh[0], oh[1], oh[2], oh[3]);
  out.asl = swar::pack(oa[0], oa[1], oa[2], oa[3]);
  out.enc = swar::pack(oe[0], oe[1], oe[2], oe[3]);
  out.fail = swar::pack(of[0], of[1], of[2], of[3]);
  out.entered = kSus ? swar::pack(on[0], on[1], on[2], on[3]) : 0u;
  return out;
}

struct SwMerge {
  uint32_t hb, asl;
  uint32_t refuted;  // full-byte mask: an advance on a SUSPECT entry
};

// The merge epilogue on a word (ops/merge.merge_swar_plain; rr_elem.cuh
// rr_merge_t on 4 subjects): advance / add / rebase / age advance, gated
// on the receiver row mask ``recv``.  ``best`` the merged view word.
template <bool kSus>
SW_HD SwMerge rr_merge_swar_t(uint32_t hb, uint32_t asl, uint32_t best,
                              uint32_t recv, const SwVec& vec,
                              int age_clamp) {
  using namespace swar;
  const uint32_t st = asl & word(3);
  const uint32_t anym = ~best & H;  // best >= 0
  const uint32_t listed = kSus ? ne(st & L, 0) : eq(st, word(RR_MEMBER));
  const uint32_t adv =
      recv & bytes(listed & anym & gts(best, vec.v[V_CMP_DEEP]) &
                   gts(add(best, vec.v[V_SA_N]), hb));
  const uint32_t addm = recv & bytes(eq(st, word(RR_UNKNOWN)) & anym);
  const uint32_t upd = adv | addm;
  const uint32_t up_val = sel(bytes(les(best, vec.v[V_UP_DEEP])), H,
                              add(best, vec.v[V_D8]));
  uint32_t keep = sel(
      bytes(ne(vec.v[V_HAS_HI], 0) & ges(hb, vec.v[V_HI_THR])), word(127),
      sub(hb, vec.v[V_SB8]));
  keep = sel(bytes(les(hb, vec.v[V_KEEP_THR])), H, keep);
  SwMerge out;
  out.hb = sel(upd, up_val, keep);
  // every update lands at (MEMBER, age 0); then the saturating age step
  const uint32_t base = sel(upd, word(RR_MEMBER - 128), asl);
  out.asl = sel(bytes(ges(base, word((age_clamp << 2) - 128))), base,
                add(base, word(4)));
  out.refuted = kSus ? adv & bytes(eq(st, word(RR_SUSPECT))) : 0u;
  return out;
}
