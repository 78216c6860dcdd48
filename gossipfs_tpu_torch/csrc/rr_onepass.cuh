// The one-pass resident round's stripe walk (K3 form (f), rr_onepass.cu),
// in __host__ __device__ functions that a host build in the CPU tests
// compiles with g++ (tests/test_torch_onepass_host.py) and replays with the
// thread-block cluster replaced by host arrays, against the plain PyTorch
// version (gossipfs_tpu_torch/ops/merge.py resident_round_plain).
//
// A cluster of kCtas CTAs owns one stripe of kC subject columns over all n
// receiver rows.  Rows go to the CTAs by 8-row sender group, round robin:
// group g (rows [8g, 8g + 8)) lives in CTA g % kCtas at local group
// g / kCtas, so every owner and local index is a shift and a mask.
//
//   step1  each CTA reads its groups' hb and asl for the stripe once,
//          ticks them, parks the ticked lanes in its shared memory and
//          writes its part of the stripe's view: its groups' maxes into
//          every CTA's copy of the whole group-max table G[n/8, kC] (the
//          aligned forms: a PutGroup callable, so step 2 gathers from its
//          own shared memory), or its rows' encoded view into its own
//          (the explicit-edge, plain-arc and filter_rows forms);
//          detections and SUSPECT entries go to a Sink.
//   (the cluster synchronises)
//   step2  each CTA merges its own receiver rows: best gathered from the
//          stripe's view wherever it lives (a Gather callable: the local
//          G, or other CTAs' rows, distributed shared memory on the card,
//          kChunk slots a batch that the row's kWords lanes compute two
//          each and share), the next row's flags and senders loaded while
//          this one merges; the epilogue on the parked lanes,
//          hb and asl written once; per-subject counts accumulate per
//          thread and go to the Sink once, per-receiver counts go to the
//          Sink once a row.
//   finish per column, the cluster's per-CTA counts summed (the first
//          observer: their min) into the stripe's outputs.
//
// Every per-entry formula is rr_elem.cuh's (lanes) or rr_swar.cuh's (SWAR):
// the words the diagonal crosses stay on the lanes functions in the SWAR
// form, as in the two-launch kernel.  The gathers here (gather_groups,
// gather_rows) are what the host build runs; the card runs the same
// functions as rr_onepass.cu's gather_groups_card and gather_rows_cluster
// (lane_slot's slots shared by shuffle, the byte max by DPX), which
// chip_smoke.py holds bit for bit against the plain version.
#pragma once

#include <cstdint>

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

constexpr int kC = 32;             // subject columns per stripe
constexpr int kWords = kC / 4;     // 4-subject words per stripe row
constexpr int kCtasLog = 3;
constexpr int kCtas = 1 << kCtasLog;  // CTAs per cluster
constexpr int kAlign = 8;          // rows per sender group
constexpr int kChunk = 2 * kWords;  // sender rows gathered in one batch

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

// rows of a CTA's count block [kStats][kC]
enum { kMember = 0, kDet, kFobs, kEntered, kRefuted, kHeld, kStatsMax };

// where a full-view sender row ``s`` lives: the CTA and the row inside
// its view slice
struct Where {
  int cta, local;
};

OP_HD Where row_home(int s) {
  return {(s >> 3) & (kCtas - 1), ((s >> (3 + kCtasLog)) << 3) | (s & 7)};
}

// the rows of a CTA's view: its rows' slice (full view) or the whole
// group-max table
OP_HD constexpr long view_rows(long n, bool full) {
  return full ? n / kCtas : n / kAlign;
}

// the global row of a CTA's local row ``li``
OP_HD int global_row(int cta, int li) {
  return ((((li >> 3) << kCtasLog) | cta) << 3) | (li & 7);
}

// the stripe: ``n`` global rows; ``nc`` the lanes' row stride (the block's
// column count); ``col0`` the stripe's first local column and ``gcol0`` its
// global subject id (col_offset + col0)
struct Stripe {
  int n, nc, col0, gcol0;
};

struct Knobs {
  int t_fail, t_cooldown, confirm, confirm_hi, age_clamp;
  int width;        // groups (aligned forms) or rows gathered a receiver
  int group_shift;  // filter_rows: log2(arc_align)
};

// A CTA's shared memory: ticked lanes [rows, kC] of its local rows and its
// view: its rows' slice [rows, kC] (full view), or the whole group-max
// table [n / 8, kC] in global group order (groups).
struct Park {
  int8_t* hb;
  int8_t* asl;
  int8_t* view;
};

OP_HD SwVec load_vec(const int8_t* vecs, int nc, int col) {
  SwVec v;
  for (int i = 0; i < N_VEC; ++i)
    v.v[i] = swar::load(vecs + (size_t)i * nc + col);
  return v;
}

// Step 1 for CTA ``cta`` as thread ``t`` of ``nt`` (a multiple of kWords):
// the thread takes word t % kWords of local groups t / kWords, + nt /
// kWords, ...  ``groups`` the CTA's group count (n / 8 / kCtas).  The
// sink receives, per column of the stripe (0..kC), the detections with
// the lowest firing global row, and the SUSPECT entries;
// ``put_group(g, w, enc)`` (aligned forms) takes group g's kAlign view
// words at word w, for their byte max in every CTA's table.
template <bool kSus, bool kFull, bool kMute, bool kSwar, typename Sink,
          typename PutGroup>
OP_HD void step1(const int8_t* __restrict__ hb, const int8_t* __restrict__ asl,
                 const int8_t* __restrict__ flags,
                 const int8_t* __restrict__ vecs, Stripe sp, Knobs kn,
                 Park pk, int cta, int groups, int t, int nt, Sink& sink,
                 PutGroup put_group) {
  const int w = t % kWords;
  const int col = sp.col0 + 4 * w;
  const SwVec vec = load_vec(vecs, sp.nc, col);
  for (int lg = t / kWords; lg < groups; lg += nt / kWords) {
    const int row0 = (lg * kCtas + cta) * kAlign;
    const size_t off = (size_t)row0 * sp.nc + col;
    // every row's loads before any use: one group in flight per thread
    uint32_t h[kAlign], a[kAlign];
    int f[kAlign];
    OP_UNROLL
    for (int r = 0; r < kAlign; ++r) {
      h[r] = swar::load(hb + off + (size_t)r * sp.nc);
      a[r] = swar::load(asl + off + (size_t)r * sp.nc);
      f[r] = flags[row0 + r];
    }
    uint32_t enc[kAlign];
    uint32_t det = 0, ent = 0, seen = 0, first = 0;
    // the diagonal's byte in the word of row0 + r is d0 + r
    const int d0 = row0 - (sp.gcol0 + 4 * w);
    OP_UNROLL
    for (int r = 0; r < kAlign; ++r) {
      const bool act = (f[r] & 1) != 0;
      const bool ref = (f[r] & 2) != 0;
      const bool lh = (f[r] & 16) != 0;
      const bool sends = rr_sends(f[r], kMute);
      const int d = d0 + r;
      const SwTickView tv =
          (!kSwar || (unsigned)d < 4u)
              ? rr_tick_view_lanes_word<kSus>(h[r], a[r], act, ref, lh, sends,
                                              d, vec, kn.t_fail,
                                              kn.t_cooldown, kn.confirm,
                                              kn.confirm_hi)
              : rr_tick_view_swar<kSus>(h[r], a[r], swar::row(act),
                                        swar::row(ref), swar::row(lh),
                                        swar::row(sends), vec, kn.t_fail,
                                        kn.t_cooldown, kn.confirm,
                                        kn.confirm_hi);
      const int li = lg * kAlign + r;
      swar::store(pk.hb + li * kC + 4 * w, tv.hb);
      swar::store(pk.asl + li * kC + 4 * w, tv.asl);
      if (kFull)
        swar::store(pk.view + li * kC + 4 * w, tv.enc);
      else
        enc[r] = tv.enc;
      // 0/1-per-byte counter words (at most 8 per byte); the first firing
      // row per byte rides a word of row numbers
      det += tv.fail >> 7;
      if (tv.fail) {
        const uint32_t fresh = tv.fail & ~seen;
        seen |= tv.fail;
        first = swar::sel(swar::bytes(fresh), swar::word(r), first);
      }
      if (kSus) ent += tv.entered >> 7;
    }
    if (!kFull) put_group(lg * kCtas + cta, w, enc);
    if (!(det | ent)) continue;
    for (int k = 0; k < 4; ++k) {
      const int s = 8 * k;
      const int c = (int)((det >> s) & 0xFF);
      if (c) sink.det(4 * w + k, c, row0 + (int)((first >> s) & 0xFF));
      const int e = (int)((ent >> s) & 0xFF);
      if (kSus && e) sink.entered(4 * w + k, e);
    }
  }
}

// A receiver row's inputs to the merge, loaded a row ahead by each of the
// row's kWords lanes: its flags, its arc or group base ``s0`` and match
// mask ``s1``, and for explicit edges the in-edges of the lane's two slots
// of the first chunk, f = lane and lane + kWords (-1 past the fanout).
template <int kForm>
struct Meta {
  int flags = 0;
  int s0 = 0, s1 = 0;
  int ids[2] = {-1, -1};
};

template <int kForm>
OP_HD Meta<kForm> load_meta(const int8_t* __restrict__ flags,
                            const int32_t* __restrict__ senders, int row,
                            int width, int lane) {
  Meta<kForm> m;
  m.flags = flags[row];
  if (kForm == kFormEdges) {
    for (int i = 0; i < 2; ++i) {
      const int f = lane + kWords * i;
      if (f < width) m.ids[i] = senders[(size_t)row * width + f];
    }
  } else if (mutes(kForm)) {
    m.s0 = senders[2 * (size_t)row];
    m.s1 = senders[2 * (size_t)row + 1];
  } else {
    m.s0 = senders[row];
  }
  return m;
}

// best over the group maxes of an aligned form's receiver (a live one: a
// dead receiver's best is never read), ``view(g)`` group g of the CTA's
// own table at this thread's word: the max with no floor over its F/8
// groups, or (filter_group) over the groups its mask keeps, from -1.
template <int kForm, typename ViewWord>
OP_HD uint32_t gather_groups(const Meta<kForm>& m, int n, Knobs kn,
                             ViewWord view) {
  const int nb = n / kAlign;
  const int g0 = m.s0 / kAlign;
  uint32_t best = mutes(kForm) ? 0xFFFFFFFFu : swar::H;
  for (int k = 0; k < kn.width; ++k) {
    if (mutes(kForm) && !((m.s1 >> k) & 1)) continue;
    const int g = g0 + k;
    best = swar::maxs(best, view(g >= nb ? g - nb : g));
  }
  return best;
}

// The view row behind slot ``lane + kWords * i`` of the chunk from f0, as
// lane ``lane`` of a row-form receiver's kWords lanes holds it (its own
// Meta), or -1: explicit edges (the first chunk's from the Meta, later
// ones read here), (base + f) mod n for plain arcs and filter_rows, the
// latter only where its mask keeps window group f >> group_shift; a slot
// past the fanout or a sender outside [0, n) is -1.  A lane's two slots
// cover a chunk of kChunk == 2 * kWords senders.
template <int kForm>
OP_HD int lane_slot(const Meta<kForm>& m, const int32_t* __restrict__ senders,
                    int row, int n, Knobs kn, int f0, int lane, int i) {
  const int f = f0 + lane + kWords * i;
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

// best over the view rows of a row-form receiver (a live one), the slots
// taken as the card's kWords lanes share them: slot k of a chunk is lane
// k % kWords's slot k / kWords, from that lane's Meta (loaded here per
// slot; the card shuffles it).  Explicit edges and plain arcs take the max
// with no floor, filter_rows from -1 (a dropped group's contribution).
// ``view(s)`` view row s at this thread's word.
template <int kForm, typename ViewWord>
OP_HD uint32_t gather_rows(const int8_t* __restrict__ flags,
                           const int32_t* __restrict__ senders, int row,
                           int n, Knobs kn, ViewWord view) {
  uint32_t best = mutes(kForm) ? 0xFFFFFFFFu : swar::H;
  for (int f0 = 0; f0 < kn.width; f0 += kChunk)
    for (int k = 0; k < kChunk; ++k) {
      const int lane = k % kWords;
      const Meta<kForm> lm = load_meta<kForm>(flags, senders, row, kn.width,
                                              lane);
      const int s = lane_slot<kForm>(lm, senders, row, n, kn, f0, lane,
                                     k / kWords);
      if (s >= 0) best = swar::maxs(best, view(s));
    }
  return best;
}

struct MergeWord {
  uint32_t hb, asl;
  uint32_t listed, held, refuted;  // 0/1 per byte
};

// the merge epilogue on one word of parked (post-tick) lanes and the
// listed / SUSPECT / refuted bytes of its result
template <bool kSus, bool kSwar>
OP_HD MergeWord merge_word(uint32_t hb, uint32_t asl, uint32_t best, bool recv,
                           const SwVec& vec, int age_clamp) {
  MergeWord out{0, 0, 0, 0, 0};
  if (kSwar) {
    const SwMerge m = rr_merge_swar_t<kSus>(hb, asl, best, swar::row(recv),
                                            vec, age_clamp);
    const uint32_t st = m.asl & swar::word(3);
    out.hb = m.hb;
    out.asl = m.asl;
    out.listed = kSus ? st & swar::L : swar::eq(st, swar::word(RR_MEMBER)) >> 7;
    if (kSus) {
      out.held = swar::eq(st, swar::word(RR_SUSPECT)) >> 7;
      out.refuted = m.refuted & swar::L;
    }
    return out;
  }
  for (int k = 0; k < 4; ++k) {
    int v[N_VEC];
    for (int i = 0; i < N_VEC; ++i) v[i] = swar::byte_at(vec.v[i], k);
    const RrMerge m = rr_merge_t<kSus>(swar::byte_at(hb, k),
                                       swar::byte_at(asl, k),
                                       swar::byte_at(best, k), recv, v,
                                       age_clamp);
    const int s = 8 * k;
    const int st = m.asl & 3;
    out.hb |= (uint32_t)(m.hb & 0xFF) << s;
    out.asl |= (uint32_t)(m.asl & 0xFF) << s;
    out.listed |= (uint32_t)(kSus ? (st & 1) : st == RR_MEMBER) << s;
    if (kSus) {
      out.held |= (uint32_t)(st == RR_SUSPECT) << s;
      out.refuted |= (uint32_t)m.refuted << s;
    }
  }
  return out;
}

// Step 2 for CTA ``cta`` as thread ``t`` of ``nt``: word t % kWords of
// local rows t / kWords, + nt / kWords, ...  ``rows`` the CTA's row count
// (n / kCtas).  Writes each row's merged word to hb and asl; the sink
// receives once per loop trip from every thread (valid or not, so a
// warp-wide reduction may run there) the row's listed and SUSPECT bytes,
// and at the end the thread's per-column member, refuted and held counts.
// ``gather(meta, row, w)`` is best for a live receiver row at word w
// (gather_groups or gather_rows, or the card's form of them); each row's
// Meta is loaded while the row before it merges.
template <bool kSus, int kForm, bool kSwar, typename Gather, typename Sink>
OP_HD void step2(int8_t* __restrict__ hb, int8_t* __restrict__ asl,
                 const int8_t* __restrict__ flags,
                 const int8_t* __restrict__ vecs,
                 const int32_t* __restrict__ senders, Stripe sp, Knobs kn,
                 Park pk, int cta, int rows, int t, int nt, Gather gather,
                 Sink& sink) {
  const int w = t % kWords;
  const int col = sp.col0 + 4 * w;
  const int step = nt / kWords;
  const SwVec vec = load_vec(vecs, sp.nc, col);
  // 0/1-per-byte counter words: at most rows / step per byte
  uint32_t cw = 0, rw = 0, hw = 0;
  Meta<kForm> next;
  if (t / kWords < rows)
    next = load_meta<kForm>(flags, senders, global_row(cta, t / kWords),
                            kn.width, w);
  for (int li0 = 0; li0 < rows; li0 += step) {
    const int li = li0 + t / kWords;
    const bool valid = li < rows;
    const int row = valid ? global_row(cta, li) : 0;
    const Meta<kForm> m = next;
    if (li + step < rows)
      next = load_meta<kForm>(flags, senders, global_row(cta, li + step),
                              kn.width, w);
    int listed = 0, held = 0;
    if (valid) {
      const bool recv = (m.flags & 4) != 0;
      const uint32_t best = recv ? gather(m, row, w) : 0xFFFFFFFFu;
      const MergeWord mw = merge_word<kSus, kSwar>(
          swar::load(pk.hb + li * kC + 4 * w),
          swar::load(pk.asl + li * kC + 4 * w), best, recv, vec,
          kn.age_clamp);
      const size_t off = (size_t)row * sp.nc + col;
      swar::store(hb + off, mw.hb);
      swar::store(asl + off, mw.asl);
      if (recv) cw += mw.listed;
      listed = (int)((mw.listed * swar::L) >> 24);  // the bytes' sum
      if (kSus) {
        rw += mw.refuted;
        hw += mw.held;
        held = (int)((mw.held * swar::L) >> 24);
      }
    }
    sink.row(row, valid, listed, held);
  }
  for (int k = 0; k < 4; ++k) {
    const int s = 8 * k;
    sink.subj(4 * w + k, (int)((cw >> s) & 0xFF), (int)((rw >> s) & 0xFF),
              (int)((hw >> s) & 0xFF));
  }
}

// One stripe output: column ``c`` (0..kC) of stat ``s`` (a row of the
// count block) from the cluster's count blocks, ``cta_counts(q)`` the
// block of CTA q: the sum over the CTAs, or for the first observer their
// min (n where no row fired: the blocks start there).
template <typename CtaCounts>
OP_HD int finish(int s, int c, CtaCounts cta_counts) {
  int acc = cta_counts(0)[s * kC + c];
  for (int q = 1; q < kCtas; ++q) {
    const int v = cta_counts(q)[s * kC + c];
    acc = s == kFobs ? (v < acc ? v : acc) : acc + v;
  }
  return acc;
}

// the shared memory of one CTA for ``n`` rows: parked lanes, the view and
// the count block
OP_HD constexpr long smem_bytes(long n, bool full) {
  return (2 * (n / kCtas) + view_rows(n, full)) * kC +
         (long)kStatsMax * kC * 4;
}

}  // namespace onepass
