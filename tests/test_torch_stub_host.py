"""K3 (f)'s stage stubs, in the host build of its stripe walk.

``csrc/rr_onepass.cuh`` compiles stages out under ``-DRR_STUB=<mask>``
(ops/merge.STUB_STAGES), each an ``if constexpr`` on a constant that is 0
in the default build.  g++ builds the host harness of
tests/test_torch_onepass_host.py (the cluster replayed with host arrays,
the kernel's thread map) once a mask, for the aligned-group form, lanes,
crash-only and suspicion, and here:

* mask 0 is the round, equal to ``resident_round_plain``;
* ``rcnt`` and ``sus`` equal the full round but for their zeroed outputs
  (every per-receiver count; entered, refuted, held), and equal the JAX
  package's stubbed round (``resident_round_blocked(..., interpret=True,
  resident=True, _stub=...)``) at N = 1,024 (the others run at 512);
* ``epi`` writes back the lanes the plain tick gives, every count 0;
* ``gather`` is the round whose every receiver gathers nothing: the plain
  edge_filter round with every group masked off.

The variants on the card are chip_smoke.py phase 50's.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.ops import merge_pallas as mp
from gossipfs_tpu_torch.core.state import SUSPECT
from gossipfs_tpu_torch.ops import merge

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "gossipfs_tpu_torch" / "csrc"
N = 512       # the host rounds
N_JAX = 1024  # the JAX kernel's resident arcs take N % 1,024 == 0
THREADS, CLUSTERS = 512, 3
NAMES = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt",
         "entered", "refuted", "held", "suspect_cnt")
MODES = {"crash-only": dict(t_fail=5),
         "suspicion+lh": dict(t_fail=3, suspect=True, t_suspect=2,
                              lh_multiplier=3)}
MASKS = {"": 0, **merge.STUB_STAGES}

HARNESS = r"""
#include <cstdint>
#include <cstring>
#include <vector>
#include "rr_onepass.cuh"

using namespace onepass;

// the narrow blocking's stage variants (the wide library's run on the card)
using B = Cluster8x32;
constexpr int kC = B::kC, kCtas = B::kCtas, kLanes = B::kLanes;
constexpr int kPairs = B::kPairs, kFobsAt = B::kFobsAt;
constexpr int kBlockWords = B::kBlockWords;

struct TickSink {
  uint32_t* cnt;
  void det(int c, int count, int first_row) {
    cnt[kSumDet * kPairs + c / 2] += pair_addend(c, count);
    if (first_row < (int)cnt[kFobsAt + c]) cnt[kFobsAt + c] = first_row;
  }
  void entered(int c, int count) {
    cnt[kSumEntered * kPairs + c / 2] += pair_addend(c, count);
  }
};

struct MergeSink {
  uint32_t* cnt;
  int32_t* recv;
  int32_t* held;
  void row(int r, bool valid, int listed, int h) {
    if (!valid) return;
    recv[r] += listed;
    if (held) held[r] += h;
  }
  void add(int sum, int h, const uint32_t (&w)[kSeg]) {
    for (int k = 0; k < kSeg; ++k)
      for (int b = 0; b < 4; ++b) {
        const int c = 4 * (kSeg * h + k) + b;
        cnt[sum * kPairs + c / 2] +=
            pair_addend(c, (int)((w[k] >> (8 * b)) & 0xFF));
      }
  }
  void subj(int h, const uint32_t (&member)[kSeg],
            const uint32_t (&refuted)[kSeg], const uint32_t (&held_)[kSeg]) {
    add(kSumMember, h, member);
    add(kSumRefuted, h, refuted);
    add(kSumHeld, h, held_);
  }
};

// the aligned-group form, lanes, over the square [n, n] round, as
// tests/test_torch_onepass_host.py replays it
template <bool kSus>
static void round_t(int n, Knobs kn, int lh, int nt, int clusters,
                    int8_t* hb, int8_t* asl, const int8_t* flags,
                    const int8_t* vecs, const int32_t* senders,
                    int32_t* subj, int32_t* recv) {
  constexpr int kForm = kFormGroup;
  const int nc = n, rows = n / kCtas, groups = rows / kAlign;
  const int stripes = nc / kC;
  const size_t vrows = view_rows<B>(n, false);
  std::vector<int8_t> ph((size_t)kCtas * rows * kC),
      pa((size_t)kCtas * rows * kC), pv(kCtas * vrows * kC),
      vss((size_t)kCtas * N_VEC * kC);
  std::vector<uint32_t> blocks((size_t)kCtas * 2 * kBlockWords);
  std::vector<int8_t> none(kC);
  for (int i = 0; i < kC; i += 4) swar::store(&none[i], gather_none(kForm));
  for (int i = 0; i < (lh ? 2 : 1) * n; ++i) recv[i] = 0;
  auto park = [&](int q) {
    return Park{ph.data() + (size_t)q * rows * kC,
                pa.data() + (size_t)q * rows * kC,
                pv.data() + q * vrows * kC};
  };
  auto view_of = [&](int q) { return pv.data() + q * vrows * kC; };
  auto vs_of = [&](int q) { return vss.data() + (size_t)q * N_VEC * kC; };
  auto block = [&](int q, int it) {
    return blocks.data() + ((size_t)q * 2 + (it & 1)) * kBlockWords;
  };
  auto copy = [](int8_t* dst, const int8_t* src) {
    std::memcpy(dst, src, 16);
  };
  for (int c = 0; c < clusters && c < stripes; ++c) {
    for (int q = 0; q < kCtas; ++q)
      for (int t = 0; t < nt; ++t)
        stage<B>(asl, vecs, stripe_at<B>(n, nc, 0, c), park(q), vs_of(q), q,
                 rows, t, nt, copy);
    for (int q = 0; q < kCtas; ++q)
      for (int i = 0; i < kBlockWords; ++i)
        block(q, 0)[i] = blank_count<B>(i, n);
    for (int stripe = c, it = 0; stripe < stripes;
         stripe += clusters, ++it) {
      const Stripe sp = stripe_at<B>(n, nc, 0, stripe);
      auto put_group = [&](int g, int h, const Seg& v) {
        for (int q = 0; q < kCtas; ++q)
          store_seg(view_of(q) + (size_t)g * kC + 4 * kSeg * h, v);
      };
      for (int q = 0; q < kCtas; ++q) {
        TickSink ts{block(q, it)};
        for (int t = 0; t < nt; ++t) {
          GroupFlags fw{};
          if (t / kLanes < groups)
            fw = group_flags(flags, group_row0<B>(q, t / kLanes));
          step1<B, kSus, false, false, false>(hb, flags, vs_of(q), sp, kn,
                                              park(q), q, groups, t, nt, fw,
                                              ts, put_group);
        }
      }
      for (int q = 0; q < kCtas; ++q) {
        for (int i = 0; i < kBlockWords; ++i)
          block(q, it + 1)[i] = blank_count<B>(i, n);
        auto gather = [&](const Meta<kForm>& m, int row, int h) -> Seg {
          return gather_groups<kForm>(
              m, n, kn,
              [&](int g) -> const int8_t* {
                return g < 0 ? none.data() + 4 * kSeg * h
                             : view_of(q) + (size_t)g * kC + 4 * kSeg * h;
              },
              [](const int8_t* a) { return load_seg(a); });
        };
        MergeSink ms{block(q, it), recv, lh ? recv + n : nullptr};
        const bool more = stripe + clusters < stripes;
        const Stripe next = stripe_at<B>(n, nc, 0, stripe + clusters);
        for (int t = 0; t < nt; ++t)
          step2<B, kSus, kForm, false>(
              hb, asl, flags, vs_of(q), senders, sp, kn, park(q), q, rows, t,
              nt, gather, ms, [&](int li, int h) {
                if (more) stage_row<B>(asl, next, park(q), q, li, h, copy);
              });
        if (more)
          for (int t = 0; t < nt; ++t)
            stage_stack<B>(vecs, next, vs_of(q), t, nt, copy);
      }
      for (int s = 0; s < (kSus ? 6 : 3); ++s)
        for (int cc = 0; cc < kC; ++cc)
          subj[(size_t)s * nc + sp.col0 + cc] = finish<B>(
              s, cc, [&](int q) { return (const uint32_t*)block(q, it); });
    }
  }
}

extern "C" void host_stub_round(int n, int width, int suspect, int lh, int nt,
                                int clusters, int8_t* hb, int8_t* asl,
                                const int8_t* flags, const int8_t* vecs,
                                const int32_t* senders, int t_fail,
                                int t_cooldown, int confirm, int confirm_hi,
                                int age_clamp, int32_t* subj, int32_t* recv) {
  const Knobs kn{t_fail, t_cooldown, confirm, confirm_hi, age_clamp, width,
                 0};
  if (suspect)
    round_t<true>(n, kn, lh, nt, clusters, hb, asl, flags, vecs, senders,
                  subj, recv);
  else
    round_t<false>(n, kn, lh, nt, clusters, hb, asl, flags, vecs, senders,
                   subj, recv);
}
"""


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """One host build a mask, all started together."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host harness")
    d = tmp_path_factory.mktemp("rr_stub")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    procs = {}
    for name, mask in MASKS.items():
        so = d / f"lib{mask}.so"
        procs[name] = (so, subprocess.Popen(
            [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{CSRC}",
             f"-DRR_STUB={mask}", "-o", str(so), str(src)],
            stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err
        out[name] = ctypes.CDLL(str(so))
    return out


def inputs(seed: int, sus: bool, n: int = N):
    """Pre-tick [n, n] lanes over every status (under suspicion MEMBER
    ages up to t_fail + 1 and SUSPECT ages above, where the JAX kernel and the
    port count new suspects alike; ages from 1, where its resident form
    reads detections back), flags over every bit but the mute (bit 3),
    deep shifts, aligned bases."""
    rng = np.random.default_rng(seed)
    hb = rng.integers(-128, 128, (n, n), dtype=np.int8)
    hb[rng.random((n, n)) < 0.05] = -128
    st = rng.integers(0, 4 if sus else 3, (n, n))
    age = rng.integers(1, 64, (n, n))
    if sus:
        age = np.where(st == 1, rng.integers(1, 5, (n, n)),
                       np.where(st == 3, rng.integers(5, 16, (n, n)), age))
    asl = ((age << 2 | st) - 128).astype(np.int8)
    flags = (rng.choice(np.array([0, 1, 2, 4, 5, 6, 7], np.int8), n)
             + 16 * (rng.random(n) < 0.5)).astype(np.int8)
    sa = rng.integers(-260, 60, n).astype(np.int32)
    g = rng.integers(-200, 60, n).astype(np.int32)
    bases = (rng.integers(0, n // 8, n) * 8).astype(np.int32)
    return hb, asl, flags, sa, g, bases


def round_kw(mode: str) -> dict:
    return dict(fanout=16, arc_align=8, t_cooldown=12, **MODES[mode])


def host_round(lib, mode: str, seed: int, n: int = N):
    sus = mode != "crash-only"
    hb, asl, flags, sa, g, bases = inputs(seed, sus, n)
    vecs = merge.threshold_stack(*(torch.from_numpy(v) for v in (sa, sa, g)),
                                 126).numpy()
    kw = round_kw(mode)
    lh = int(kw.get("lh_multiplier", 0) > 0)
    thr, thr_hi = merge._sus_thresholds(kw["t_fail"], sus,
                                        kw.get("t_suspect", 0),
                                        kw.get("lh_multiplier", 0), 63)
    h, a = hb.copy(), asl.copy()
    subj = np.empty((6 if sus else 3, n), np.int32)
    recv = np.empty((1 + lh, n), np.int32)
    args = [n, 16 // 8, int(sus), lh, THREADS, CLUSTERS, h, a, flags, vecs,
            bases, kw["t_fail"], 12, thr, thr_hi, 63, subj, recv]
    lib.host_stub_round(*[x.ctypes.data_as(ctypes.c_void_p)
                          if isinstance(x, np.ndarray) else ctypes.c_int(x)
                          for x in args])
    return [h, a, *subj[:3], recv[0], *subj[3:], *recv[1:]]


def plain_round(mode: str, seed: int, **over):
    hb, asl, flags, sa, g, bases = inputs(seed, mode != "crash-only")
    t = torch.from_numpy
    vecs = merge.threshold_stack(t(sa), t(sa), t(g), 126)
    senders = t(bases)
    kw = dict(round_kw(mode), **over)
    if kw.get("edge_filter"):
        senders = t(np.stack([bases, np.zeros_like(bases)], 1))
    out = merge.resident_round_plain(t(hb.copy()), t(asl.copy()), t(flags),
                                     vecs, senders, **kw)
    return [o.numpy() for o in out]


def jax_round(mode: str, seed: int, stub: str):
    n, cs = N_JAX, N_JAX // mp.LANE
    hb, asl, flags, sa, g, bases = inputs(seed, mode != "crash-only", n)
    to4 = lambda a: jnp.asarray(a.reshape(n, 1, cs, mp.LANE)  # noqa: E731
                                .transpose(1, 0, 2, 3))
    vec4 = lambda a: jnp.asarray(a.reshape(1, cs, mp.LANE))  # noqa: E731
    kw = round_kw(mode)
    sus = kw.pop("suspect", False)
    out = mp.resident_round_blocked(
        jnp.asarray(bases).reshape(n, 1), to4(hb), to4(asl),
        jnp.asarray(np.broadcast_to(flags[:, None], (n, mp.LANE)).copy()),
        vec4(sa), vec4(sa), vec4(g), member=1, unknown=0, failed=2,
        age_clamp=63, window=126, block_r=128, interpret=True,
        resident=True, rcnt_acc=True, suspect=SUSPECT if sus else None,
        _stub=stub, **kw)
    from4 = lambda a: np.asarray(a).transpose(1, 0, 2, 3).reshape(n, n)  # noqa: E731
    return [from4(out[0]), from4(out[1])] + [
        np.asarray(o).astype(np.int32).reshape(n) for o in out[2:]]


def assert_equal(got, want, skip=()):
    assert len(got) == len(want)
    for name, x, y in zip(NAMES, got, want):
        if name not in skip:
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("mode", list(MODES))
def test_mask_zero_is_the_round(libs, mode):
    want = plain_round(mode, 5)
    assert_equal(host_round(libs[""], mode, 5), want)
    assert want[3].sum() > 0 and want[5].sum() > 0


# each stub's zeroed outputs (by name) and the modes it runs in
ZEROED = {"rcnt": (("recv_cnt", "suspect_cnt"), list(MODES)),
          "sus": (("entered", "refuted", "held"), ["suspicion+lh"])}


@pytest.mark.parametrize("stub,mode", [(s, m) for s, (_, ms) in
                                       ZEROED.items() for m in ms])
def test_zeroing_stubs_keep_the_rest_of_the_round(libs, stub, mode):
    zeroed, _ = ZEROED[stub]
    full = host_round(libs[""], mode, 7)
    got = host_round(libs[stub], mode, 7)
    assert_equal(got, full, skip=zeroed)
    for name, x, f in zip(NAMES, got, full):
        if name in zeroed:
            assert not x.any() and f.any(), name


@pytest.mark.parametrize("stub", list(ZEROED))
def test_zeroing_stubs_equal_the_jax_kernels_stub(libs, stub):
    """The JAX kernel's ``_stub="rcnt"`` / ``"sus"`` (merge_pallas.py
    :2522, :2575) in interpret mode, suspicion and the Lifeguard lane on,
    N = 1,024: every output equal, the zeroed ones zero in both."""
    mode = "suspicion+lh"
    got = host_round(libs[stub], mode, 11, N_JAX)
    want = jax_round(mode, 11, stub)
    assert_equal(got, want)
    assert want[3].sum() > 0 and want[6 if stub == "rcnt" else 5].sum() > 0


@pytest.mark.parametrize("mode", list(MODES))
def test_epi_writes_back_the_ticked_lanes(libs, mode):
    """The tick of the plain version (tick_plain / tick_sus_plain) and no
    count: every per-subject and per-receiver output 0."""
    sus = mode != "crash-only"
    hb, asl, flags, sa, g, bases = inputs(13, sus)
    kw = round_kw(mode)
    t = torch.from_numpy
    fl = t(flags).to(torch.int32)
    act, ref, lh = ((fl & b) != 0 for b in (1, 2, 16))
    rows = torch.arange(N)
    eye = rows[:, None] == rows[None, :]
    thr_g = merge.threshold_stack(t(sa), t(sa), t(g), 126)[merge.V_THR_G]
    h, a = t(hb).to(torch.int32), t(asl).to(torch.int32)
    args = (h, a, act[:, None], ref[:, None], eye, thr_g.to(torch.int32))
    if sus:
        thr, thr_hi = merge._sus_thresholds(3, True, 2, 3, 63)
        h, a, *_ = merge.tick_sus_plain(*args[:5], lh[:, None], args[5], 3,
                                        12, thr, thr_hi)
    else:
        h, a, *_ = merge.tick_plain(*args, kw["t_fail"], 12)
    got = host_round(libs["epi"], mode, 13)
    np.testing.assert_array_equal(got[0], h.to(torch.int8).numpy())
    np.testing.assert_array_equal(got[1], a.to(torch.int8).numpy())
    assert not any(x.any() for x in got[2:])
    assert not np.array_equal(got[1], asl)


@pytest.mark.parametrize("mode", list(MODES))
def test_gather_leaves_best_at_the_start_row(libs, mode):
    """Every receiver gathers nothing: the plain round of the edge_filter
    form with every window group masked off (a merge that only ages)."""
    want = plain_round(mode, 17, edge_filter=True)
    assert_equal(host_round(libs["gather"], mode, 17), want)
    assert not np.array_equal(want[1], plain_round(mode, 17)[1])
