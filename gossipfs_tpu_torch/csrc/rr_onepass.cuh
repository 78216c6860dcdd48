// The one-pass resident round's stripe walk (K3 form (f), rr_onepass.cu),
// in __host__ __device__ functions that a host build in the CPU tests
// compiles with g++ (tests/test_torch_onepass_host.py) and replays with the
// thread-block cluster replaced by host arrays, against the plain PyTorch
// version (gossipfs_tpu_torch/ops/merge.py resident_round_plain).
//
// A cluster of B::kCtas CTAs walks stripes of B::kC subject columns over
// all n receiver rows: stripe c, c + clusters, ... (a persistent cluster).
// ``B`` is the blocking (Blocking below): 8 CTAs x 32 columns
// (Cluster8x32: N <= 19,264), or 16 CTAs x 16 columns (Cluster16x16: N <=
// 115,712 in the full-view forms, which park asl only, and 109,056 in the
// aligned ones, whose group-max table is split over the CTAs).
// Rows go to the CTAs by 8-row sender group, round robin: group g (rows
// [8g, 8g + 8)) lives in CTA g % kCtas at local group g / kCtas, so every
// owner and local index is a shift and a mask.  A thread takes one
// 16-byte segment (kSeg words) of a row: B::kLanes threads a row (2 of
// the 32-byte rows of Cluster8x32, 1 of Cluster16x16's 16-byte rows),
// every load, store and gather 16 bytes wide.
//
//   step1  each CTA ticks its groups' lanes for the stripe, asl in place in
//          its park (stage / stage_row copied it there), hb read from
//          device memory, and writes
//          its part of the stripe's view: its groups' maxes into the
//          stripe's group-max table G[n/8, kC] (the aligned forms: a
//          PutGroup callable: every CTA's copy of the whole table, or
//          under B::kSplitTable its own groups' rows only), or its rows'
//          encoded view into its own (the explicit-edge, plain-arc and
//          filter_rows forms); the ticked hb into its park, or (where
//          park_hb is false) only the segments the diagonal crosses, into
//          the park's diagonal rows; detections and SUSPECT entries go to
//          a Sink.
//   (the cluster synchronises)
//   step2  each CTA merges its own receiver rows: best gathered from the
//          stripe's view wherever it lives (a Gather callable: the local
//          G, or other CTAs' rows or groups, distributed shared memory on
//          the card, kChunk 16-byte rows a batch), the next row's flags
//          and senders loaded while this one merges; the epilogue on the
//          parked lanes (where park_hb is false on hb read again from
//          device memory: the tick changes hb only on the diagonal), hb and asl
//          written once, then the row's asl staged for the cluster's next
//          stripe; per-subject counts accumulate per thread and go to the
//          Sink once, per-receiver counts go to the Sink once a row (the
//          wide blocking: a Hold keeps a thread's first rows' metadata,
//          loaded once a launch, and their counts over the cluster's
//          stripes, added once after its last).
//   finish per column, the cluster's per-CTA counts summed (the first
//          observer: their min) into the stripe's outputs.
//
// Counts go to one of two count blocks a CTA by the stripe's parity, so
// the next stripe may count while another CTA still reads this one's.
//
// Every per-entry formula is rr_elem.cuh's (lanes) or rr_swar.cuh's (SWAR):
// the words the diagonal crosses stay on the lanes functions in the SWAR
// form, as in the two-launch kernel.  The gathers (gather_groups,
// gather_rows) and the byte max (ByteMax) are the card's own code; only
// the row addresses and the 16-byte loads are callables (host arrays here,
// ld.shared::cluster on the card).
#pragma once

#include <cstdint>
#include <cstring>

#include "rr_elem.cuh"
#include "rr_swar.cuh"

#if defined(__CUDACC__)
#define OP_HD __host__ __device__ __forceinline__
#define OP_UNROLL _Pragma("unroll")
#else
#define OP_HD inline
#define OP_UNROLL
#endif

namespace onepass {

constexpr int kSeg = 4;            // words a thread takes of a row (16 B)
constexpr int kAlign = 8;          // rows per sender group
constexpr int kChunk = 8;          // sender rows gathered in one batch

// Stage stubs: a build with -DRR_STUB=<mask> compiles the masked stages of
// the stripe walk out, so that a round timed without them prices each
// (python -m gossipfs_tpu_torch.stub_bisect; the JAX kernel's ``_stub``,
// gossipfs_tpu/ops/merge_pallas.py:2642).  The default, 0, compiles every
// stage: each stub is an ``if constexpr`` on a constant that is false
// there.
//   vtick   the tick and view encode become a raw copy of hb into the park
//           and the view (nor is the group-max table built: it rides them)
//   wmax    the aligned forms' group-max table is not built
//   gather  best stays at the gathers' start row (gather_none)
//   epi     the parked (ticked) lanes are written back; every count is 0
//   rcnt    the per-receiver counts are 0, with no global atomics
//   sus     the entered, refuted and held sums are 0 (the suspicion
//           transitions still run)
// A stubbed round's outputs are its stage's meaning, not the round's;
// the table and view the vtick and wmax stubs leave unbuilt are read as
// shared memory holds them.
#ifndef RR_STUB
#define RR_STUB 0
#endif
enum : unsigned {
  kStubVtick = 1, kStubWmax = 2, kStubGather = 4, kStubEpi = 8,
  kStubRcnt = 16, kStubSus = 32
};

OP_HD constexpr bool stubbed(unsigned stages) {
  return ((unsigned)(RR_STUB) & stages) != 0;
}

// the merge forms (resident_round.cu's rr_round ``form``)
enum {
  kFormGroup = 0, kFormEdges = 1, kFormArc = 2, kFormFilterGroup = 3,
  kFormFilterRows = 4
};

// the form keeps every sender row's view (else the 8-row group maxes)
OP_HD constexpr bool full_view(int form) {
  return form == kFormEdges || form == kFormArc || form == kFormFilterRows;
}

// the form reads the mute bit (flags bit 3)
OP_HD constexpr bool mutes(int form) {
  return form == kFormFilterGroup || form == kFormFilterRows;
}

// the gathers' start value: the max with no floor (-128 a byte), or from
// -1 under the edge_filter forms (a dropped group's contribution)
OP_HD constexpr uint32_t gather_none(int form) {
  return mutes(form) ? 0xFFFFFFFFu : swar::H;
}

// the five sums of a count block
enum { kSumMember = 0, kSumDet, kSumEntered, kSumRefuted, kSumHeld, kSums };

// A blocking of the stripe walk: a cluster of kCtas = 2^kCtasLog CTAs, a
// stripe of kC columns.  A CTA's count block holds the five sums as 16-bit
// column pairs (a partial over a CTA's rows is at most n / kCtas < 2^16;
// one 32-bit word holds columns 2i and 2i + 1), then the first observers
// as int32.  ``kWide_``: the aligned forms' group-max table is split over
// the cluster's CTAs, each holding its own groups' rows (step 2 gathers the
// others' through distributed shared memory), where each CTA of the narrow
// blocking holds the whole table; and in the full-view forms the park
// holds asl only (park_hb).
template <int kCtasLog_, int kC_, bool kWide_>
struct Blocking {
  static constexpr bool kWide = kWide_;
  static constexpr int kCtasLog = kCtasLog_;
  static constexpr int kCtas = 1 << kCtasLog;   // CTAs per cluster
  static constexpr int kC = kC_;                // subject columns per stripe
  static constexpr int kWords = kC / 4;         // 4-subject words a row
  static constexpr int kLanes = kWords / kSeg;  // threads a row
  static constexpr int kPairs = kC / 2;
  static constexpr int kFobsAt = kSums * kPairs;
  static constexpr int kBlockWords = kFobsAt + kC;
  static constexpr bool kSplitTable = kWide;
  // a step-2 thread's receiver rows whose metadata and per-receiver counts
  // the wide blocking holds in registers across its cluster's stripes
  // (Hold): every row of the thread to N = 65,536 at 512 threads
  static constexpr int kHeld = kWide ? 8 : 0;
  static_assert(kHeld == 0 || kLanes == 1, "a held row has one thread");
};
using Cluster8x32 = Blocking<3, 32, false>;
using Cluster16x16 = Blocking<4, 16, true>;

// Whether the park holds the ticked hb beside asl: always, but in the wide
// blocking's full-view forms, where both lanes and the view slice do not
// fit past N ~ 77,000.  There step 2 reads hb again from device memory
// (the tick changes hb only on the diagonal) and step 1 parks the ticked
// hb of the segments the diagonal crosses in diag_rows rows on the side.
template <class B>
OP_HD constexpr bool park_hb(bool full) {
  return !B::kWide || !full;
}

template <class B>
OP_HD constexpr int diag_rows(bool full) {
  return park_hb<B>(full) ? 0 : 4 * kSeg;
}

// entry i of a fresh count block: 0, and n for a first observer (no row
// fired)
template <class B>
OP_HD uint32_t blank_count(int i, int n) {
  return i >= B::kFobsAt ? (uint32_t)n : 0u;
}

// ``v`` as an addend of column c's word of a sum row
OP_HD uint32_t pair_addend(int c, int v) {
  return (uint32_t)v << (16 * (c & 1));
}

// where a full-view sender row ``s`` lives: the CTA and the row inside
// its view slice
struct Where {
  int cta, local;
};

template <class B>
OP_HD Where row_home(int s) {
  return {(s >> 3) & (B::kCtas - 1),
          ((s >> (3 + B::kCtasLog)) << 3) | (s & 7)};
}

// where group g of the aligned forms' split table lives: the CTA and the
// row of its table (the CTA that owns the group's rows)
template <class B>
OP_HD Where group_home(int g) {
  return {g & (B::kCtas - 1), g >> B::kCtasLog};
}

// the rows of a CTA's view: its rows' slice (full view), its own groups'
// rows of the group-max table (kSplitTable) or the whole table
template <class B>
OP_HD constexpr long view_rows(long n, bool full) {
  return full ? n / B::kCtas
              : B::kSplitTable ? n / kAlign / B::kCtas : n / kAlign;
}

// the global row of a CTA's local row ``li``
template <class B>
OP_HD int global_row(int cta, int li) {
  return ((((li >> 3) << B::kCtasLog) | cta) << 3) | (li & 7);
}

// the stripe: ``n`` global rows; ``nc`` the lanes' row stride (the block's
// column count); ``col0`` the stripe's first local column and ``gcol0`` its
// global subject id (col_offset + col0)
struct Stripe {
  int n, nc, col0, gcol0;
};

template <class B>
OP_HD Stripe stripe_at(int n, int nc, int col_offset, int stripe) {
  return {n, nc, stripe * B::kC, col_offset + stripe * B::kC};
}

struct Knobs {
  int t_fail, t_cooldown, confirm, confirm_hi, age_clamp;
  int width;        // groups (aligned forms) or rows gathered a receiver
  int group_shift;  // filter_rows: log2(arc_align)
};

// A CTA's shared memory: ticked lanes [rows, kC] of its local rows (hb:
// null where park_hb is false) and its view: its rows' slice [rows, kC] (full
// view), or the group-max table: the whole [n / 8, kC] in global group
// order, or its own groups' [n / 8 / kCtas, kC] in local group order
// (B::kSplitTable); where park_hb is false ``diag`` [diag_rows, kC], the
// ticked hb of the rows the diagonal crosses a segment in (row
// gcol0 + 4 * kSeg * h + d at segment h in row d).
struct Park {
  int8_t* hb;
  int8_t* asl;
  int8_t* view;
  int8_t* diag = nullptr;
};

// a thread's 16 bytes of a row
struct Seg {
  uint32_t w[kSeg];
};

OP_HD Seg splat(uint32_t v) { return {{v, v, v, v}}; }

// 16 bytes at ``p`` (16-byte aligned)
OP_HD Seg load_seg(const int8_t* p) {
#if defined(__CUDA_ARCH__)
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  return {{v.x, v.y, v.z, v.w}};
#else
  Seg s;
  std::memcpy(s.w, p, sizeof s.w);
  return s;
#endif
}

// 16 bytes of a lane row at ``p`` in device memory: load_seg, but that the
// wide blocking asks L2 for 128 bytes of the row on a miss, the pieces of
// the neighbouring stripes that the other clusters read in the same turn
template <class B>
OP_HD Seg ldg_seg(const int8_t* p) {
#if defined(__CUDA_ARCH__)
  if constexpr (B::kWide) {
    Seg s;
    asm volatile("ld.global.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(s.w[0]), "=r"(s.w[1]), "=r"(s.w[2]), "=r"(s.w[3])
                 : "l"(p));
    return s;
  }
#endif
  return load_seg(p);
}

OP_HD void store_seg(int8_t* p, const Seg& s) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint4*>(p) = make_uint4(s.w[0], s.w[1], s.w[2], s.w[3]);
#else
  std::memcpy(p, s.w, sizeof s.w);
#endif
}

// Hopper's 3-input s16x2 max (a DPX instruction), and its host form
OP_HD uint32_t vimax3_s16x2(uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  return (uint32_t)__vimax3_s16x2(a, b, c);
#else
  uint32_t r = 0;
  for (int s = 0; s < 32; s += 16) {
    int m = (int16_t)(a >> s);
    if ((int16_t)(b >> s) > m) m = (int16_t)(b >> s);
    if ((int16_t)(c >> s) > m) m = (int16_t)(c >> s);
    r |= (uint32_t)(m & 0xFFFF) << s;
  }
  return r;
#endif
}

// A signed byte max over many words as two s16x2 halves, so that Hopper's
// 3-input s16x2 max (a DPX instruction) folds two words in per half: the
// even bytes sign-extended by prmt (``lo``), the odd bytes as they stand
// (``hi``: an s16 compare orders by its high byte first, so the high byte
// of the max is the max of the high bytes, whatever the low ones).  2
// instructions a word where swar::maxs takes ~12.
struct ByteMax {
  uint32_t lo, hi;
  OP_HD static uint32_t lo_of(uint32_t w) { return swar::prmt(w, 0, 0xA280); }
  OP_HD explicit ByteMax(uint32_t w) : lo(lo_of(w)), hi(w) {}
  OP_HD void add2(uint32_t a, uint32_t b) {
    lo = vimax3_s16x2(lo, lo_of(a), lo_of(b));
    hi = vimax3_s16x2(hi, a, b);
  }
  OP_HD uint32_t word() const { return swar::prmt(lo, hi, 0x7250); }
};

// the byte max of a thread's 16 bytes of many rows
struct SegMax {
  ByteMax m[kSeg];
  OP_HD explicit SegMax(uint32_t w) : m{ByteMax(w), ByteMax(w), ByteMax(w),
                                        ByteMax(w)} {}
  OP_HD void add2(const Seg& a, const Seg& b) {
    OP_UNROLL
    for (int k = 0; k < kSeg; ++k) m[k].add2(a.w[k], b.w[k]);
  }
  OP_HD Seg seg() const {
    Seg s;
    OP_UNROLL
    for (int k = 0; k < kSeg; ++k) s.w[k] = m[k].word();
    return s;
  }
};

// 16 bytes of shared memory, read again at every call (the card's step 2
// takes a stripe's threshold rows from there row after row rather than
// holding them in registers)
OP_HD Seg lds_seg(const int8_t* p) {
#if defined(__CUDA_ARCH__)
  Seg s;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(s.w[0]), "=r"(s.w[1]), "=r"(s.w[2]), "=r"(s.w[3])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
  return s;
#else
  return load_seg(p);
#endif
}

// row j of the threshold stack step 1 (the tick and view: 4 rows) and
// step 2 (the merge: 8 rows) read
OP_HD constexpr int tick_vec(int j) {
  return j == 0 ? V_SA_N : j == 1 ? V_SA_ALL : j == 2 ? V_HI_N : V_THR_G;
}

OP_HD constexpr int merge_vec(int j) {
  return j == 0   ? V_SA_N
         : j == 1 ? V_CMP_DEEP
         : j == 2 ? V_D8
         : j == 3 ? V_UP_DEEP
         : j == 4 ? V_KEEP_THR
         : j == 5 ? V_HI_THR
         : j == 6 ? V_HAS_HI
                  : V_SB8;
}

// the stack rows step 1 (kMerge false) or step 2 reads, from the stripe's
// stack staged in shared memory ``vs`` ([N_VEC, kC]) at segment h, as one
// SwVec a word
template <class B, bool kMerge>
OP_HD void load_vecs(const int8_t* vs, int h, SwVec (&vec)[kSeg]) {
  OP_UNROLL
  for (int j = 0; j < (kMerge ? 8 : 4); ++j) {
    const int i = kMerge ? merge_vec(j) : tick_vec(j);
    const Seg r = lds_seg(vs + i * B::kC + 4 * kSeg * h);
    OP_UNROLL
    for (int k = 0; k < kSeg; ++k) vec[k].v[i] = r.w[k];
  }
}

// the first row of local group ``lg`` of CTA ``cta``
template <class B>
OP_HD int group_row0(int cta, int lg) {
  return (lg * B::kCtas + cta) * kAlign;
}

// the flags of the 8 rows from row0, packed 4 a word (the same in every
// stripe: a step-1 thread keeps its first group's)
struct GroupFlags {
  uint32_t w[2];
};

OP_HD GroupFlags group_flags(const int8_t* __restrict__ flags, int row0) {
  const int8_t* f = flags + row0;
  return {{swar::pack(f[0], f[1], f[2], f[3]),
           swar::pack(f[4], f[5], f[6], f[7])}};
}

// Stage local row ``li`` of CTA ``cta`` at segment h for stripe ``sp``: its
// asl segment into its park row, 16 bytes by ``copy(dst, src)`` (cp.async
// on the card: no register holds it).  Step 1 then ticks the parked row in
// place, with its hb segment read from device memory there: the stripe's
// reads split between step 1 and step 2, which writes both lanes.  Step 2
// stages each row for the cluster's next stripe as soon as it has merged
// it.
template <class B, typename Copy16>
OP_HD void stage_row(const int8_t* __restrict__ asl, Stripe sp, Park pk,
                     int cta, int li, int h, Copy16 copy) {
  copy(pk.asl + li * B::kC + 4 * kSeg * h,
       asl + (size_t)global_row<B>(cta, li) * sp.nc + sp.col0 +
           4 * kSeg * h);
}

// Stage the stripe's threshold stack into ``vs`` ([N_VEC, kC]) as thread
// ``t`` of ``nt``.
template <class B, typename Copy16>
OP_HD void stage_stack(const int8_t* __restrict__ vecs, Stripe sp,
                       int8_t* vs, int t, int nt, Copy16 copy) {
  constexpr int kLanes = B::kLanes;
  for (int j = t; j < N_VEC * kLanes; j += nt)
    copy(vs + (j / kLanes) * B::kC + 4 * kSeg * (j % kLanes),
         vecs + (size_t)(j / kLanes) * sp.nc + sp.col0 +
             4 * kSeg * (j % kLanes));
}

// Stage a whole stripe (the cluster's first) as thread ``t`` of ``nt``:
// the rows step 2 will merge, and the stack.
template <class B, typename Copy16>
OP_HD void stage(const int8_t* __restrict__ asl,
                 const int8_t* __restrict__ vecs, Stripe sp, Park pk,
                 int8_t* vs, int cta, int rows, int t, int nt, Copy16 copy) {
  for (int li = t / B::kLanes; li < rows; li += nt / B::kLanes)
    stage_row<B>(asl, sp, pk, cta, li, t % B::kLanes, copy);
  stage_stack<B>(vecs, sp, vs, t, nt, copy);
}

// The SWAR form's tick and view of a word the diagonal crosses, at byte d
// (0..3): the lanes functions with the eye.  Out of line (a few words a
// stripe take it), so that the SWAR step 1, unrolled over its 8 rows,
// keeps to the instruction cache; the 4 stack rows it reads travel as
// words, not as the caller's array.
#if defined(__CUDACC__)
#define OP_COLD __host__ __device__ __noinline__
#else
#define OP_COLD inline
#endif
template <bool kSus>
OP_COLD SwTickView diagonal_word(uint32_t hb, uint32_t asl, int f, bool mute,
                                 int d, uint32_t sa_n, uint32_t sa_all,
                                 uint32_t hi_n, uint32_t thr_g, Knobs kn) {
  SwVec tick;
  tick.v[V_SA_N] = sa_n;
  tick.v[V_SA_ALL] = sa_all;
  tick.v[V_HI_N] = hi_n;
  tick.v[V_THR_G] = thr_g;
  return rr_tick_view_lanes_word<kSus>(
      hb, asl, (f & 1) != 0, (f & 2) != 0, (f & 16) != 0, rr_sends(f, mute),
      d, tick, kn.t_fail, kn.t_cooldown, kn.confirm, kn.confirm_hi);
}

// Step 1 for CTA ``cta`` as thread ``t`` of ``nt`` (a multiple of
// B::kLanes): the thread takes segment t % kLanes of local groups t /
// kLanes, + nt / kLanes, ...: hb from device memory (a row ahead), asl
// from their park rows (stage), with ``fw0`` the flags of the first
// (group_flags).  ``groups`` the CTA's group count (n / 8 / kCtas).  The
// ticked hb goes to the park (kParkHb) or, where the diagonal crosses
// the segment, to the park's diagonal rows.  The sink receives, per
// column of the stripe (0..kC), the detections with the lowest firing
// global row, and the SUSPECT entries; ``put_group(g, h, max)`` (aligned
// forms) takes group g's view max at segment h, for the table (every
// CTA's copy, or g's row of its own split table).
template <class B, bool kSus, bool kFull, bool kMute, bool kSwar,
          typename Sink, typename PutGroup>
OP_HD void step1(const int8_t* __restrict__ hb,
                 const int8_t* __restrict__ flags, const int8_t* vs,
                 Stripe sp, Knobs kn, Park pk, int cta, int groups, int t,
                 int nt, const GroupFlags& fw0, Sink& sink,
                 PutGroup put_group) {
  constexpr int kC = B::kC;
  constexpr int kLanes = B::kLanes;
  constexpr bool kParkHb = park_hb<B>(kFull);
  const int h = t % kLanes;
  SwVec vec[kSeg];
  load_vecs<B, false>(vs, h, vec);
  for (int lg = t / kLanes; lg < groups; lg += nt / kLanes) {
    const int row0 = group_row0<B>(cta, lg);
    const GroupFlags fw = lg == t / kLanes ? fw0 : group_flags(flags, row0);
    // 0/1-per-byte counter words (at most 8 per byte); the first firing
    // row per byte rides a word of row numbers
    uint32_t det[kSeg], ent[kSeg], seen[kSeg], first[kSeg];
    OP_UNROLL
    for (int k = 0; k < kSeg; ++k) det[k] = ent[k] = seen[k] = first[k] = 0;
    SegMax gm(swar::H);
    Seg prev{};
    const int8_t* hrow = hb + (size_t)row0 * sp.nc + sp.col0 + 4 * kSeg * h;
    Seg ih_next = ldg_seg<B>(hrow);
    // the lanes form's tick, unrolled over 8 rows of 16 bytes, outgrows
    // the instruction cache: one row at a time
#if defined(__CUDACC__)
#pragma unroll(kSwar ? kAlign : 1)
#endif
    for (int r = 0; r < kAlign; ++r) {
      const int f = (int)((fw.w[r >> 2] >> (8 * (r & 3))) & 0xFF);
      const bool act = (f & 1) != 0;
      const bool ref = (f & 2) != 0;
      const bool lh = (f & 16) != 0;
      const bool sends = rr_sends(f, kMute);
      const int at = (lg * kAlign + r) * kC + 4 * kSeg * h;
      const Seg ih = ih_next;
      if (r + 1 < kAlign) ih_next = ldg_seg<B>(hrow + (size_t)(r + 1) * sp.nc);
      if constexpr (stubbed(kStubVtick)) {
        // the raw hb row into the park (asl is parked raw already) and the
        // view
        if constexpr (kParkHb) store_seg(pk.hb + at, ih);
        if (kFull) store_seg(pk.view + at, ih);
        continue;
      }
      const Seg ia = load_seg(pk.asl + at);
      // the diagonal's byte in word k of row0 + r is d0 - 4k
      const int d0 = row0 + r - (sp.gcol0 + 4 * kSeg * h);
      Seg th, ta, enc;
      OP_UNROLL
      for (int k = 0; k < kSeg; ++k) {
        const int d = d0 - 4 * k;
        // the word the diagonal crosses takes the lanes functions with the
        // eye at byte d; any other the SWAR tick, or the lanes functions
        // with no eye (d = 4: the bump compiled away)
        const SwTickView tv =
            (unsigned)d < 4u
                ? (kSwar ? diagonal_word<kSus>(
                               ih.w[k], ia.w[k], f, kMute, d, vec[k].v[V_SA_N],
                               vec[k].v[V_SA_ALL], vec[k].v[V_HI_N],
                               vec[k].v[V_THR_G], kn)
                         : rr_tick_view_lanes_word<kSus>(
                               ih.w[k], ia.w[k], act, ref, lh, sends, d,
                               vec[k], kn.t_fail, kn.t_cooldown, kn.confirm,
                               kn.confirm_hi))
            : kSwar ? rr_tick_view_swar<kSus>(
                          ih.w[k], ia.w[k], swar::row(act), swar::row(ref),
                          swar::row(lh), swar::row(sends), vec[k], kn.t_fail,
                          kn.t_cooldown, kn.confirm, kn.confirm_hi)
                    : rr_tick_view_lanes_word<kSus>(
                          ih.w[k], ia.w[k], act, ref, lh, sends, 4, vec[k],
                          kn.t_fail, kn.t_cooldown, kn.confirm,
                          kn.confirm_hi);
        th.w[k] = tv.hb;
        ta.w[k] = tv.asl;
        enc.w[k] = tv.enc;
        det[k] += tv.fail >> 7;
        if (tv.fail) {
          const uint32_t fresh = tv.fail & ~seen[k];
          seen[k] |= tv.fail;
          first[k] = swar::sel(swar::bytes(fresh), swar::word(r), first[k]);
        }
        if (kSus && !stubbed(kStubSus)) ent[k] += tv.entered >> 7;
      }
      if constexpr (kParkHb) {
        store_seg(pk.hb + at, th);
      } else if ((unsigned)d0 < 4u * kSeg) {
        // the one segment of the row whose hb the tick may change
        store_seg(pk.diag + d0 * kC + 4 * kSeg * h, th);
      }
      store_seg(pk.asl + at, ta);
      if (kFull)
        store_seg(pk.view + at, enc);
      else if (stubbed(kStubWmax))
        continue;
      else if (r & 1)
        gm.add2(prev, enc);
      else
        prev = enc;
    }
    if (!kFull && !stubbed(kStubVtick | kStubWmax))
      put_group(lg * B::kCtas + cta, h, gm.seg());
    if (stubbed(kStubEpi)) continue;
    OP_UNROLL
    for (int k = 0; k < kSeg; ++k) {
      if (!(det[k] | ent[k])) continue;
      for (int b = 0; b < 4; ++b) {
        const int s = 8 * b;
        const int c = 4 * (kSeg * h + k) + b;
        const int cd = (int)((det[k] >> s) & 0xFF);
        if (cd) sink.det(c, cd, row0 + (int)((first[k] >> s) & 0xFF));
        const int e = (int)((ent[k] >> s) & 0xFF);
        if (kSus && e) sink.entered(c, e);
      }
    }
  }
}

// A receiver row's inputs to the merge, loaded a row ahead by each of the
// row's kLanes threads: its flags, its arc or group base ``s0`` and match
// mask ``s1``, and for explicit edges the in-edges of the first chunk
// (-1 past the fanout).
template <int kForm>
struct Meta {
  int flags = 0;
  int s0 = 0, s1 = 0;
  int ids[kChunk];
};

template <int kForm>
OP_HD Meta<kForm> load_meta(const int8_t* __restrict__ flags,
                            const int32_t* __restrict__ senders, int row,
                            int width) {
  Meta<kForm> m;
  m.flags = flags[row];
  if (kForm == kFormEdges) {
    OP_UNROLL
    for (int i = 0; i < kChunk; ++i)
      m.ids[i] = i < width ? senders[(size_t)row * width + i] : -1;
  } else if (mutes(kForm)) {
    m.s0 = senders[2 * (size_t)row];
    m.s1 = senders[2 * (size_t)row + 1];
  } else {
    m.s0 = senders[row];
  }
  return m;
}

// What a step-2 thread holds across stripes: nothing (the narrow
// blocking), or (Hold) its first kRows receiver rows' metadata and counts.
struct NoHold {
  static constexpr int kRows = 0;
  static constexpr bool kMeta = false;
};

// A wide-blocking step-2 thread's receiver rows are local rows t, t + nt,
// ... in every stripe (global_row does not depend on it): for the first
// kRows of them it holds in registers, across its cluster's stripes, the
// row's Meta (but explicit edges', whose in-edges it loads a row ahead as
// before), loaded once a launch, and its per-receiver counts (recv_cnt,
// the Lifeguard suspect_cnt) over the stripes, added once after the last
// one (flush) instead of once a stripe.  Row i of the thread is array slot
// i, picked by an unrolled select so the arrays stay in registers.
template <class B, int kForm, bool kLh>
struct Hold {
  static constexpr int kRows = B::kHeld;
  static constexpr bool kMeta = kForm != kFormEdges;
  uint32_t fl[(kRows + 3) / 4];  // the flags, 4 bytes a word
  uint32_t base[kRows];  // the arc or group base, as senders holds it
  uint32_t mask[kRows];  // the edge_filter forms' group-match mask
  uint32_t recv[kRows];
  uint32_t held[kRows];
  // the rows' Meta, zero counts: thread t of nt of CTA ``cta``, ``rows``
  // local rows
  OP_HD void load(const int8_t* __restrict__ flags,
                  const int32_t* __restrict__ senders, int cta, int rows,
                  int t, int nt, int width) {
    OP_UNROLL
    for (int i = 0; i < (kRows + 3) / 4; ++i) fl[i] = 0;
    OP_UNROLL
    for (int i = 0; i < kRows; ++i) {
      recv[i] = held[i] = base[i] = mask[i] = 0;
      const int li = t / B::kLanes + i * (nt / B::kLanes);
      if (!kMeta || li >= rows) continue;
      const Meta<kForm> m =
          load_meta<kForm>(flags, senders, global_row<B>(cta, li), width);
      fl[i / 4] |= (uint32_t)(uint8_t)m.flags << (8 * (i % 4));
      base[i] = (uint32_t)m.s0;
      if (mutes(kForm)) mask[i] = (uint32_t)m.s1;
    }
  }
  template <int K>
  OP_HD static uint32_t pick(const uint32_t (&a)[K], int j) {
    uint32_t v = 0;
    OP_UNROLL
    for (int i = 0; i < K; ++i) v = i == j ? a[i] : v;
    return v;
  }
  OP_HD Meta<kForm> meta(int j) const {
    Meta<kForm> m;
    m.flags = (int)(int8_t)(pick(fl, j / 4) >> (8 * (j % 4)));
    m.s0 = (int)pick(base, j);
    if (mutes(kForm)) m.s1 = (int)pick(mask, j);
    return m;
  }
  OP_HD void count(int j, int listed, int h) {
    OP_UNROLL
    for (int i = 0; i < kRows; ++i) {
      recv[i] += i == j ? (uint32_t)listed : 0u;
      if (kLh) held[i] += i == j ? (uint32_t)h : 0u;
    }
  }
  // the held counts into the sink (``sink.add_row(row, recv, held)``),
  // once, after the cluster's last stripe
  template <typename Sink>
  OP_HD void flush(Sink& sink, int cta, int rows, int t, int nt) const {
    if (stubbed(kStubRcnt | kStubEpi)) return;
    OP_UNROLL
    for (int i = 0; i < kRows; ++i) {
      const int li = t / B::kLanes + i * (nt / B::kLanes);
      if (li < rows && (recv[i] | held[i]))
        sink.add_row(global_row<B>(cta, li), (int)recv[i], (int)held[i]);
    }
  }
};

// The group behind window group ``k`` of an aligned form's receiver, or -1
// (past its F/8 groups, or a group its filter_group mask drops).
template <int kForm>
OP_HD int group_slot(const Meta<kForm>& m, int nb, Knobs kn, int k) {
  if (k >= kn.width || (mutes(kForm) && !((m.s1 >> k) & 1))) return -1;
  const int g = m.s0 / kAlign + k;
  return g >= nb ? g - nb : g;
}

// best over the group maxes of an aligned form's receiver (a live one: a
// dead receiver's best is never read), two groups a step: the max with no
// floor over its F/8 groups, or (filter_group) over the groups its mask
// keeps, from -1.  ``addr(g)`` the address of group g's row at this
// thread's segment (g < 0: a row holding gather_none), ``load(a)`` its 16
// bytes.
template <int kForm, typename RowAddr, typename LoadSeg>
OP_HD Seg gather_groups(const Meta<kForm>& m, int n, Knobs kn, RowAddr addr,
                        LoadSeg load) {
  const int nb = n / kAlign;
  SegMax best(gather_none(kForm));
  for (int k = 0; k < kn.width; k += 2)
    best.add2(load(addr(group_slot<kForm>(m, nb, kn, k))),
              load(addr(group_slot<kForm>(m, nb, kn, k + 1))));
  return best.seg();
}

// The view row behind slot f0 + i of a row-form receiver (its Meta), or
// -1: explicit edges (the first chunk's from the Meta, later ones read
// here), (base + f) mod n for plain arcs and filter_rows, the latter only
// where its mask keeps window group f >> group_shift; a slot past the
// fanout or a sender outside [0, n) is -1.
template <int kForm>
OP_HD int lane_slot(const Meta<kForm>& m, const int32_t* __restrict__ senders,
                    int row, int n, Knobs kn, int f0, int i) {
  const int f = f0 + i;
  if (f >= kn.width) return -1;
  int s;
  if (kForm == kFormEdges) {
    s = f0 == 0 ? m.ids[i] : senders[(size_t)row * kn.width + f];
  } else {
    s = m.s0 + f;
    if (s >= n) s -= n;
    if (kForm == kFormFilterRows && !((m.s1 >> (f >> kn.group_shift)) & 1))
      return -1;
  }
  return (unsigned)s < (unsigned)n ? s : -1;
}

// best over the view rows of a row-form receiver (a live one), kChunk rows
// a batch: every row's address, then every row's 16 bytes, then the byte
// max.  Explicit edges and plain arcs take the max with no floor,
// filter_rows from -1 (a dropped group's contribution).  ``addr(s)`` the
// address of view row s at this thread's segment (s < 0: a row holding
// gather_none), ``load(a)`` its 16 bytes.
template <int kForm, typename RowAddr, typename LoadSeg>
OP_HD Seg gather_rows(const Meta<kForm>& m,
                      const int32_t* __restrict__ senders, int row, int n,
                      Knobs kn, RowAddr addr, LoadSeg load) {
  SegMax best(gather_none(kForm));
  for (int f0 = 0; f0 < kn.width; f0 += kChunk) {
    decltype(addr(0)) a[kChunk];
    OP_UNROLL
    for (int i = 0; i < kChunk; ++i)
      a[i] = addr(lane_slot<kForm>(m, senders, row, n, kn, f0, i));
    Seg v[kChunk];
    OP_UNROLL
    for (int i = 0; i < kChunk; ++i) v[i] = load(a[i]);
    OP_UNROLL
    for (int i = 0; i < kChunk; i += 2) best.add2(v[i], v[i + 1]);
  }
  return best.seg();
}

struct MergeWord {
  uint32_t hb, asl;
  uint32_t listed, held, refuted;  // 0/1 per byte
};

// the merge epilogue on one word of parked (post-tick) lanes and the
// listed / SUSPECT / refuted bytes of its result.  The lanes form runs
// rr_merge_t byte by byte (bytes unpacked and packed by prmt); the listed
// and SUSPECT bytes of either form are read off the merged status word.
template <bool kSus, bool kSwar>
OP_HD MergeWord merge_word(uint32_t hb, uint32_t asl, uint32_t best, bool recv,
                           const SwVec& vec, int age_clamp) {
  MergeWord out{0, 0, 0, 0, 0};
  if (kSwar) {
    const SwMerge m = rr_merge_swar_t<kSus>(hb, asl, best, swar::row(recv),
                                            vec, age_clamp);
    out.hb = m.hb;
    out.asl = m.asl;
    if (kSus) out.refuted = m.refuted & swar::L;
  } else {
    int mh[4], ma[4], mr[4];
    OP_UNROLL
    for (int k = 0; k < 4; ++k) {
      int v[N_VEC] = {};
      OP_UNROLL
      for (int j = 0; j < 8; ++j)
        v[merge_vec(j)] = swar::byte_at(vec.v[merge_vec(j)], k);
      const RrMerge m = rr_merge_t<kSus>(swar::byte_at(hb, k),
                                         swar::byte_at(asl, k),
                                         swar::byte_at(best, k), recv, v,
                                         age_clamp);
      mh[k] = m.hb;
      ma[k] = m.asl;
      mr[k] = m.refuted;
    }
    out.hb = swar::pack(mh[0], mh[1], mh[2], mh[3]);
    out.asl = swar::pack(ma[0], ma[1], ma[2], ma[3]);
    if (kSus) out.refuted = swar::pack(mr[0], mr[1], mr[2], mr[3]);
  }
  const uint32_t st = out.asl & swar::word(3);
  out.listed =
      kSus ? st & swar::L : swar::eq(st, swar::word(RR_MEMBER)) >> 7;
  if (kSus) out.held = swar::eq(st, swar::word(RR_SUSPECT)) >> 7;
  return out;
}

// the epi stub's hold on a value it does not store: on the card an empty
// asm that reads it, so the code computing it stays
OP_HD void keep_live(const Seg& s) {
#if defined(__CUDA_ARCH__)
  asm volatile("" ::"r"(s.w[0]), "r"(s.w[1]), "r"(s.w[2]), "r"(s.w[3]));
#else
  (void)s;
#endif
}

// the sum of a word's bytes (each at most 63)
OP_HD int byte_sum(uint32_t w) { return (int)((w * swar::L) >> 24); }

// Step 2 for CTA ``cta`` as thread ``t`` of ``nt``: segment t % kLanes of
// local rows t / kLanes, + nt / kLanes, ...  ``rows`` the CTA's row count
// (n / kCtas).  The ticked hb comes from the park (kParkHb), else from
// device memory (its pre-tick value, which the tick leaves but on the
// diagonal) or, for a segment the diagonal crosses, the park's diagonal
// rows.  Writes each row's merged segment to hb and asl; the sink
// receives once per loop trip from every thread (valid or not, so a
// warp-wide reduction may run there) the row's listed and SUSPECT counts
// over the segment, and at the end, from every thread, its segment's
// per-column member, refuted and held counter words (0..255 a byte).
// ``gather(meta, row, h)`` is best for a live receiver row at segment h
// (gather_groups or gather_rows over the card's addresses); each row's
// Meta is loaded while the row before it merges; ``restage(li, h)`` runs
// once the row's park segment is read and its outputs stored (stage_row
// for the next stripe, or nothing).  ``hold`` (the wide blocking: a
// Hold) gives the Meta of the thread's first H::kRows rows and takes their
// per-receiver counts in place of the sink.
template <class B, bool kSus, int kForm, bool kSwar, typename Gather,
          typename Sink, typename Restage, typename H = NoHold>
OP_HD void step2(int8_t* __restrict__ hb, int8_t* __restrict__ asl,
                 const int8_t* __restrict__ flags, const int8_t* vs,
                 const int32_t* __restrict__ senders, Stripe sp, Knobs kn,
                 Park pk, int cta, int rows, int t, int nt, Gather gather,
                 Sink& sink, Restage restage, H* hold = nullptr) {
  constexpr int kC = B::kC;
  constexpr int kLanes = B::kLanes;
  constexpr bool kParkHb = park_hb<B>(full_view(kForm));
  const int h = t % kLanes;
  const int col = sp.col0 + 4 * kSeg * h;
  const int step = nt / kLanes;
  // the SWAR form holds the merge's stack rows; the lanes form, short of
  // registers, reads them again each row
  SwVec vec[kSeg];
  if (kSwar) load_vecs<B, true>(vs, h, vec);
  // 0/1-per-byte counter words: at most rows / step per byte
  uint32_t cw[kSeg], rw[kSeg], hw[kSeg];
  OP_UNROLL
  for (int k = 0; k < kSeg; ++k) cw[k] = rw[k] = hw[k] = 0;
  Meta<kForm> next;
  if constexpr (H::kMeta) {
    if (t / kLanes < rows) next = hold->meta(0);
  } else if (t / kLanes < rows) {
    next = load_meta<kForm>(flags, senders, global_row<B>(cta, t / kLanes),
                            kn.width);
  }
  for (int li0 = 0, j = 0; li0 < rows; li0 += step, ++j) {
    const int li = li0 + t / kLanes;
    const bool valid = li < rows;
    const int row = valid ? global_row<B>(cta, li) : 0;
    const Meta<kForm> m = next;
    if constexpr (H::kMeta) {
      if (li + step < rows)
        next = j + 1 < H::kRows
                   ? hold->meta(j + 1)
                   : load_meta<kForm>(flags, senders,
                                      global_row<B>(cta, li + step),
                                      kn.width);
    } else if (li + step < rows) {
      next = load_meta<kForm>(flags, senders,
                              global_row<B>(cta, li + step), kn.width);
    }
    int listed = 0, held = 0;
    if (valid) {
      const bool recv = (m.flags & 4) != 0;
      // without a parked hb: its segment read before the gather, so that
      // the gather's loads cover the read's latency
      Seg hb_seg{};
      if constexpr (!kParkHb) {
        const int d = row - (sp.gcol0 + 4 * kSeg * h);
        hb_seg = (unsigned)d < 4u * kSeg
                     ? load_seg(pk.diag + d * kC + 4 * kSeg * h)
                     : ldg_seg<B>(hb + (size_t)row * sp.nc + col);
      }
      const Seg best = recv ? (stubbed(kStubGather)
                                   ? splat(gather_none(kForm))
                                   : gather(m, row, h))
                            : splat(0xFFFFFFFFu);
      const int at = li * kC + 4 * kSeg * h;
      const Seg ph = kParkHb ? load_seg(pk.hb + at) : hb_seg;
      const Seg pa = load_seg(pk.asl + at);
      if constexpr (stubbed(kStubEpi)) {
        // the parked lanes back as they stand, no count; best stays live,
        // so that the gather is not compiled out with the epilogue
        keep_live(best);
        const size_t off = (size_t)row * sp.nc + col;
        store_seg(hb + off, ph);
        store_seg(asl + off, pa);
        restage(li, h);
        continue;
      }
      if (!kSwar) load_vecs<B, true>(vs, h, vec);
      Seg oh, oa;
      uint32_t ls = 0, hs = 0;
      OP_UNROLL
      for (int k = 0; k < kSeg; ++k) {
        const MergeWord mw = merge_word<kSus, kSwar>(
            ph.w[k], pa.w[k], best.w[k], recv, vec[k], kn.age_clamp);
        oh.w[k] = mw.hb;
        oa.w[k] = mw.asl;
        if (recv) cw[k] += mw.listed;
        ls += mw.listed;
        if (kSus) {
          if (!stubbed(kStubSus)) {
            rw[k] += mw.refuted;
            hw[k] += mw.held;
          }
          hs += mw.held;
        }
      }
      const size_t off = (size_t)row * sp.nc + col;
      store_seg(hb + off, oh);
      store_seg(asl + off, oa);
      restage(li, h);
      listed = byte_sum(ls);
      held = byte_sum(hs);
    }
    if constexpr (H::kRows > 0) {
      // a held row's counts stay in the thread (listed and held are 0
      // past the CTA's rows)
      if (!stubbed(kStubRcnt | kStubEpi)) {
        if (j < H::kRows) hold->count(j, listed, held);
        else sink.row(row, valid, listed, held);
      }
    } else if (!stubbed(kStubRcnt | kStubEpi)) {
      sink.row(row, valid, listed, held);
    }
  }
  if (!stubbed(kStubEpi)) sink.subj(h, cw, rw, hw);
}

// One stripe output: column ``c`` (0..kC) of output stat ``s`` (member_cnt,
// n_det, first_obs, entered, refuted, held) from the cluster's count
// blocks, ``cta_counts(q)`` the block of CTA q: the sum over the CTAs, or
// for the first observer their min (n where no row fired: the blocks start
// there).
template <class B, typename CtaCounts>
OP_HD int finish(int s, int c, CtaCounts cta_counts) {
  if (stubbed(kStubEpi)) return 0;
  if (s == 2) {
    int acc = (int)cta_counts(0)[B::kFobsAt + c];
    for (int q = 1; q < B::kCtas; ++q) {
      const int v = (int)cta_counts(q)[B::kFobsAt + c];
      acc = v < acc ? v : acc;
    }
    return acc;
  }
  const int at = (s < 2 ? s : s - 1) * B::kPairs + c / 2;
  int acc = 0;
  for (int q = 0; q < B::kCtas; ++q)
    acc += (int)((cta_counts(q)[at] >> (16 * (c & 1))) & 0xFFFF);
  return acc;
}

// the shared memory of one CTA for ``n`` rows: parked lanes (both, or asl
// and the diagonal rows), the view, the stripe's threshold stack, the
// gathers' start row and two count blocks.  Cluster8x32: 12N + 1,280 B
// in every form; Cluster16x16: 2N + 896 in the full-view forms, 17N/8 +
// 640 in the aligned ones
template <class B>
OP_HD constexpr long smem_bytes(long n, bool full) {
  return ((park_hb<B>(full) ? 2 : 1) * (n / B::kCtas) +
          view_rows<B>(n, full) + N_VEC + 1 + diag_rows<B>(full)) * B::kC +
         2L * B::kBlockWords * 4;
}

}  // namespace onepass
