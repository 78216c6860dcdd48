"""The resident round: one whole lean gossip round over the packed lanes.

Port of the TPU kernel ``gossipfs_tpu/ops/merge_pallas.py:
resident_round_blocked`` in its merge forms (aligned arcs, explicit
in-edges, plain arcs, and the scenario engine's ``edge_filter`` form of
aligned arcs), crash-only and with the SWIM lifecycle (``suspect=True``).
One round:

1. tick every entry (small-group refresh, diagonal heartbeat bump,
   detection, fresh cooldown stamp, cooldown expiry; under suspicion a
   stale MEMBER enters SUSPECT and a SUSPECT entry past its confirm age,
   stretched on Lifeguard-degraded rows, confirms to FAILED);
2. encode each sender's gossip view of the post-tick lanes; aligned arcs
   take the max over every aligned group of ``arc_align`` sender rows,
   ``G[N/align, N]``, the other forms keep the whole view ``G[N, N]``;
3. merge: receiver ``i`` takes ``best``, the max of its senders' view
   rows: ``max_k G[(bases[i]/align + k) mod N/align]`` over its arc's
   ``fanout/align`` groups (a plain arc is align 1), or ``max_f
   G[edges[i, f]]`` over explicit in-edges, and runs the membership-update
   epilogue (advance / add / rebase / age advance), gated on its alive bit
   (so explicit edges need no remap for dead receivers); under suspicion
   an advance on a SUSPECT entry refutes it.  In the ``edge_filter`` form
   (``senders`` int32 ``[N, 2]``: arc base, group-match bitmask) a sender
   whose flags bit 3 is set is muted: its view row encodes absent to
   everyone while its own tick runs as ever; and receiver ``i`` keeps
   window group ``k`` only where bit ``k`` of its mask is set (a dropped
   group contributes -1, "no sender carried the entry"; a zero mask is a
   merge that only ages);
4. reduce: per subject the post-merge member count over live receivers
   (``member_cnt``), the detections (``n_det``) and the lowest firing
   observer (``first_obs``, N when none fired); per receiver its listed
   count (``recv_cnt``, next round's group-size input).  Under suspicion
   also, per subject, the entries that entered SUSPECT, were refuted, and
   are still SUSPECT after the merge (over all rows), and with the
   Lifeguard lane per receiver its post-merge SUSPECT count
   (``suspect_cnt``, next round's degraded input).

:func:`resident_round_plain` is the function in plain PyTorch, term for
term with the JAX package's packed stages; :func:`resident_round` is the
wrapper that runs it for CPU tensors and launches the CUDA kernel
(``csrc/resident_round.cu``) for CUDA tensors.

Source note.  Replaces ``resident_round_blocked``
(gossipfs_tpu/ops/merge_pallas.py:2611).  Bound on the H100: bytes.  The
floor is each packed lane read and written once, 4 B per entry (0.32 ms at
N = 16,384 and 3.35 TB/s); the arithmetic is a few dozen integer ops per
entry.  The two-launch kernel (``csrc/resident_round.cu``, per-thread
bodies in ``csrc/rr_twopass.cuh``) runs tick + view + group max or whole
view, then merge + reductions, a thread a 16-byte segment of a row, the
merge's blocks resident and walking the round a 1,024-column tile at a
time; it moves about
8.4 B per entry in the aligned form, about 10 B in the others (the whole
view once each way); its times and bounds are in PERF.md (from
chip_smoke.py).  It takes ``N % 4 == 0`` (4-byte words; rows off 16-byte
boundaries move word by word): the round loop sends a ragged N to the
separate-pass round (core/rounds._lean_ok).

All arithmetic is int32 over int8 lane values with an explicit mod-2^8
wrap where a value is compared or stored, so every result is exact: the
kernel, this plain version and the JAX package agree bit for bit.

``col_offset`` is the column-shard form (the JAX kernel's ``col_offset``,
merge_pallas.py:2633): the lanes are a tall-skinny ``[N, C]`` block, all
N receiver and sender rows and the C subjects from global subject
``col_offset`` on (C = N / shards under subject sharding,
``parallel/mesh.py``).  The diagonal sits at row == ``col_offset`` + local
column; per-subject inputs and outputs are the shard's ``[C]``, and the
per-receiver counts (``recv_cnt``, ``suspect_cnt``) are partial, over the
shard's columns: summed across the shards they are the square round's.
The square round is ``col_offset=0``, C = N.

``onepass=True`` runs K3's one-pass form (f) (the JAX kernel's
``resident=True``): ``csrc/rr_onepass.cu``, one kernel launch a round
(after a memset of the per-receiver counts it adds into) in which
persistent thread-block clusters of ``ONEPASS_CTAS`` CTAs each park
``ONEPASS_C``-column stripes of the ticked lanes in shared memory, one
after another, and merge from there, so each packed lane crosses HBM once
each way; ``hb``, ``asl`` and ``vecs`` must start 16-byte aligned (the
kernel moves 16-byte row segments).  It takes the shapes
:func:`onepass_fits` admits (N = 16,384 square and its column blocks; not
N = 65,536); the lean loop routes to it under ``SimConfig.rr_resident``
(core/rounds.onepass).  Its outputs are the two-launch form's bit for bit.

``elementwise="swar"`` is the SWAR form (the JAX package's
``_rr_tick_view_swar``/``_rr_merge_swar``, config ``elementwise="swar"``):
the same round on 4 packed int8 subjects per int32 word (ops/swar.py),
compares and selects as carry-safe byte-SIMD word ops.  The words the
diagonal crosses keep the lanes formulation (the bump needs a per-byte eye
mask), as in the JAX kernel.  Its outputs are the lanes form's, bit for
bit; the kernel's twin is ``csrc/rr_swar.cuh``.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from gossipfs_tpu_torch.config import AGE_CLAMP
from gossipfs_tpu_torch.core.state import FAILED, MEMBER, SUSPECT, UNKNOWN
from gossipfs_tpu_torch.ops import swar

# rows of the per-subject int8 threshold stack (csrc/rr_elem.cuh has the
# same enumeration)
(V_SA_N, V_SA_ALL, V_HI_N, V_THR_G, V_CMP_DEEP, V_D8, V_UP_DEEP,
 V_KEEP_THR, V_HI_THR, V_HAS_HI, V_SB8) = range(11)
N_VEC = 11

# the CUDA kernel's fixed geometry: 8-row sender groups, 4-byte words
KERNEL_ALIGN = 8
KERNEL_VEC = 4

# the group-match bitmask of the ``edge_filter`` form is one int32 per
# receiver: at most this many window groups (fanout / arc_align)
ARC_MATCH_MAX_GROUPS = 31

# the kernel's merge forms (csrc/resident_round.cu rr_round's ``form``)
FORMS = ("aligned_group", "edges", "arc", "filter_group", "filter_rows")
ELEMENTWISE = ("lanes", "swar")
# the SWAR form of each merge form, by its launch-count name
SWAR_FORMS = tuple(f + "/swar" for f in FORMS)
# the one-pass form (f) of each, lanes and SWAR (csrc/rr_onepass.cu)
ONEPASS_FORMS = tuple(f + "/onepass" for f in FORMS + SWAR_FORMS)

# The one-pass kernel's geometry: a cluster of ONEPASS_CTAS CTAs owns a
# stripe of ONEPASS_C subject columns over all N rows at a time, each CTA
# parking its N / ONEPASS_CTAS rows of the ticked lanes and an
# [N / 8, ONEPASS_C] view (its rows' slice, or the whole group-max table) in
# shared memory, at most ONEPASS_SMEM bytes a CTA (the H100's 227 KB a
# block may use).  csrc/rr_onepass.cuh smem_bytes is the same sum.
ONEPASS_C = 32
ONEPASS_CTAS = 8
ONEPASS_SMEM = 232_448
# a CTA's two count blocks (five sums as 16-bit column pairs, the first
# observers as int32), and the stripe's 11-row threshold stack with the row
# of the gathers' start value
ONEPASS_COUNT_BYTES = 2 * (5 * ONEPASS_C // 2 + ONEPASS_C) * 4
ONEPASS_STACK_BYTES = 12 * ONEPASS_C
# the one-pass kernel's optional timeline: globaltimer stamps a CTA and
# stripe (start, step 1 done, view ready, step 2 done, end)
ONEPASS_STAMPS = 5
# the merge forms that gather other CTAs' sender rows (the others gather
# 8-row group maxes from a whole table each CTA holds)
FULL_VIEW_FORMS = ("edges", "arc", "filter_rows")


def kernel_form(fanout: int | None, arc_align: int,
                edge_filter: bool = False, elementwise: str = "lanes") -> str:
    """The merge form the CUDA kernel runs: ``aligned_group`` for arc bases
    aligned to its 8-row sender groups, ``arc`` for any other arc bases
    (F consecutive sender rows), ``edges`` for explicit in-edges (``fanout``
    None).  Under ``edge_filter`` (aligned arcs with a group-match mask):
    ``filter_group``, the masked max over the 8-row group maxes, for
    ``arc_align`` 8; ``filter_rows`` for any other alignment, the masked
    max over the arc's F view rows, row ``f`` kept iff bit ``f //
    arc_align`` is set (the max over a group is the max over its rows).
    Under ``elementwise="swar"`` the name gains ``/swar``: the same merge
    form on packed words (``aligned_group/swar``)."""
    if fanout is None:
        form = "edges"
    elif edge_filter:
        form = "filter_group" if arc_align == KERNEL_ALIGN else "filter_rows"
    else:
        form = "aligned_group" if arc_align == KERNEL_ALIGN else "arc"
    return form + "/swar" if elementwise == "swar" else form


# launches of each kernel wrapper (plain-version calls do not count):
# this module's resident round, ops/merge_update's three merge kernels and
# ops/fanout_max's gather-max
LAUNCH_COUNTS = {"resident_round": 0, "fused_merge_update": 0,
                 "arc_merge_update": 0, "stripe_merge_update": 0,
                 "fanout_max_merge": 0}
# the resident round's launches again, by the merge form launched (the
# SWAR and one-pass forms under their own names)
FORM_LAUNCHES = dict.fromkeys(FORMS + SWAR_FORMS + ONEPASS_FORMS, 0)
_launch_events: list | None = None


def reset_launch_counts() -> None:
    for counts in (LAUNCH_COUNTS, FORM_LAUNCHES):
        for k in counts:
            counts[k] = 0


def launch_snapshot() -> tuple[dict, dict]:
    """Copies of :data:`LAUNCH_COUNTS` and :data:`FORM_LAUNCHES`, for
    :func:`launches_since`."""
    return dict(LAUNCH_COUNTS), dict(FORM_LAUNCHES)


def launches_since(before: tuple[dict, dict]) -> tuple[dict, dict]:
    """The kernel launches and the resident round's launches by form
    since ``before`` (a :func:`launch_snapshot`), the counts that moved
    only."""
    counts, forms = before
    return ({k: v - counts.get(k, 0) for k, v in LAUNCH_COUNTS.items()
             if v != counts.get(k, 0)},
            {k: v - forms.get(k, 0) for k, v in FORM_LAUNCHES.items()
             if v != forms.get(k, 0)})


@contextlib.contextmanager
def counted_launch(name: str, stream, form: str | None = None):
    """Wrap one kernel wrapper's launch on ``stream``: on success, add one
    to its count (and to its merge ``form``'s, for the resident round)
    and, inside :func:`record_launch_events`, record the CUDA event pair
    around it."""
    start = None
    if _launch_events is not None:
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
    yield
    LAUNCH_COUNTS[name] += 1
    if form is not None:
        FORM_LAUNCHES[form] += 1
    if start is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        _launch_events.append((start, end))


def check_rc(name: str, rc: int) -> None:
    """Raise when a kernel's C launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


@contextlib.contextmanager
def record_launch_events():
    """Record a CUDA event pair around every kernel launch in the block:
    yields the list of ``(start, end)`` pairs (device time per launch)."""
    global _launch_events
    _launch_events = []
    try:
        yield _launch_events
    finally:
        _launch_events = None


def wrap8(x: torch.Tensor) -> torch.Tensor:
    """int8 wrap (mod 2^8) of int32 values, kept int32."""
    return ((x + 128) & 255) - 128


def pack_age_status(age: torch.Tensor, status: torch.Tensor) -> torch.Tensor:
    """age (6 bits) | status (2 bits) as one biased int8:
    ``((age << 2) | status) - 128``, for age <= AGE_CLAMP."""
    p = (age.to(torch.int32) << 2) | status.to(torch.int32)
    return (p - 128).to(torch.int8)


def unpack_age_status(asl: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_age_status`; returns int32 (age, status)."""
    p = asl.to(torch.int32) + 128
    return p >> 2, p & 3


def threshold_stack(sa: torch.Tensor, sb: torch.Tensor, g: torch.Tensor,
                    window: int) -> torch.Tensor:
    """The per-subject int8 ``[11, N]`` threshold stack the round consumes.

    ``sa``/``sb``/``g`` are int32 ``[N]``: the view shift, the store shift
    and the grace threshold, relative to each subject's stored base.  Every
    saturation threshold of the narrow int8 arithmetic is precomputed here
    once per subject, so the per-entry stages compare and select only."""
    sa, sb, g = (t.to(torch.int32) for t in (sa, sb, g))
    d = sa - sb
    rows = [
        wrap8(sa),                                  # V_SA_N
        (sa < -128).to(torch.int32),                # V_SA_ALL
        torch.clamp(sa + window, -128, 127),        # V_HI_N
        torch.clamp(g + 1, -128, 127),              # V_THR_G
        torch.clamp(-129 - sa, -2, 127),            # V_CMP_DEEP
        wrap8(d),                                   # V_D8
        torch.clamp(-129 - d, -2, 127),             # V_UP_DEEP
        torch.clamp(sb - 129, -128, 127),           # V_KEEP_THR
        torch.clamp(sb + 128, -128, 127),           # V_HI_THR
        (sb < 0).to(torch.int32),                   # V_HAS_HI
        wrap8(sb),                                  # V_SB8
    ]
    return torch.stack(rows).to(torch.int8)


def tick_plain(hb, asl, act, ref, eye, thr_g, t_fail: int, t_cooldown: int):
    """The heartbeat tick over int32 hb and packed asl (csrc/rr_elem.cuh
    rr_tick).  Returns (hb, asl, fail, elig)."""
    st = asl & 3
    st_mem = st == MEMBER
    nsent = hb != -128
    asl = torch.where(ref & st_mem, st - 128, asl)
    bump = eye & act & st_mem & nsent
    hb = torch.where(bump, wrap8(hb + 1), hb)
    asl = torch.where(bump, st - 128, asl)
    past = (hb >= thr_g) & nsent
    fail = act & st_mem & past & (asl > ((t_fail << 2) | MEMBER) - 128)
    asl = torch.where(fail, FAILED - 128, asl)
    expire = ((asl & 3) == FAILED) & (
        asl > ((t_cooldown << 2) | FAILED) - 128)
    asl = torch.where(expire, asl & -4, asl)
    return hb, asl, fail, st_mem & ~fail


def tick_sus_plain(hb, asl, act, ref, eye, lh, thr_g, t_fail: int,
                   t_cooldown: int, confirm_thr: int, confirm_thr_hi: int):
    """The tick's SWIM form over int32 hb and packed asl (csrc/rr_elem.cuh
    rr_tick_sus): refresh also reverts SUSPECT, a stale MEMBER enters
    SUSPECT (status bit 1), a SUSPECT entry past its confirm age (the
    ``confirm_thr_hi`` one on ``lh`` rows) confirms to FAILED.  Returns
    (hb, asl, fail, elig, entered)."""
    st = asl & 3
    st_mem = st == MEMBER
    st_sus = st == SUSPECT
    nsent = hb != -128
    asl = torch.where(ref & (st_mem | st_sus), MEMBER - 128, asl)
    bump = eye & act & st_mem & nsent
    hb = torch.where(bump, wrap8(hb + 1), hb)
    asl = torch.where(bump, MEMBER - 128, asl)
    past = (hb >= thr_g) & nsent
    stale = act & st_mem & past & (asl > ((t_fail << 2) | MEMBER) - 128)
    thr_b = torch.where(lh, ((confirm_thr_hi << 2) | SUSPECT) - 128,
                        ((confirm_thr << 2) | SUSPECT) - 128)
    confirm = act & st_sus & (asl > thr_b)
    asl = torch.where(stale, asl | 2, asl)
    asl = torch.where(confirm, FAILED - 128, asl)
    expire = ((asl & 3) == FAILED) & (
        asl > ((t_cooldown << 2) | FAILED) - 128)
    asl = torch.where(expire, asl & -4, asl)
    return hb, asl, confirm, (st_mem | st_sus) & ~confirm, stale


def view_plain(hb, elig, act, sa_n, sa_all, hi_n):
    """Wrapped gossip-view value of post-tick entries; -1 when absent
    (csrc/rr_elem.cuh rr_view)."""
    goss = (elig & act & ((hb >= sa_n) | (sa_all != 0)) & (hb <= hi_n)
            & (hb != -128))
    return wrap8(torch.where(goss, hb - sa_n, -1))


def merge_plain(hb, asl, best, recv, v, age_clamp: int,
                suspect: bool = False):
    """Merge epilogue on post-tick entries (csrc/rr_elem.cuh rr_merge_t);
    ``v`` is the int32 threshold stack, broadcast over rows.  Returns
    (hb, asl, refuted), ``refuted`` (advances on SUSPECT entries) None
    without ``suspect``."""
    st = asl & 3
    any_m = best >= 0
    lst = ((st & 1) == 1) if suspect else (st == MEMBER)
    advance = (recv & lst & any_m & (best > v[V_CMP_DEEP])
               & (wrap8(best + v[V_SA_N]) > hb))
    upd = advance | (recv & (st == UNKNOWN) & any_m)
    up_val = torch.where(best <= v[V_UP_DEEP], -128, best + v[V_D8])
    keep_val = torch.where((v[V_HAS_HI] != 0) & (hb >= v[V_HI_THR]), 127,
                           hb - v[V_SB8])
    keep_val = torch.where(hb <= v[V_KEEP_THR], -128, keep_val)
    new_hb = wrap8(torch.where(upd, up_val, keep_val))
    base = torch.where(upd, MEMBER - 128, asl)
    new_asl = torch.where(base >= (age_clamp << 2) - 128, base, base + 4)
    refuted = (advance & (st == SUSPECT)) if suspect else None
    return new_hb, new_asl, refuted


def tick_view_swar_plain(hbw, aslw, act, ref, sends, vw, t_fail: int,
                         t_cooldown: int, suspect: bool = False, lh=None,
                         confirm_thr: int = 0, confirm_thr_hi: int = 0):
    """The eye-free tick and view encode over packed words
    (csrc/rr_swar.cuh rr_tick_view_swar; the JAX package's
    ``_rr_tick_view_swar``), for words the diagonal does not cross.
    ``hbw``/``aslw`` int32 words; ``act``/``ref``/``sends``/``lh`` row
    masks as words (-1/0, ops/swar.bool_mask); ``vw`` the packed threshold
    stack.  Returns (hbw, aslw, fail, entered, enc): ``fail`` (the
    confirmations under ``suspect``) and ``entered`` (None without
    ``suspect``) hmasks, ``enc`` the view words (-1 where absent)."""
    w = swar.word
    st = aslw & w(3)
    stm = swar.eq(st, w(MEMBER))
    nsent = swar.ne(hbw, swar.H)
    if suspect:
        sus_pre = swar.eq(st, w(SUSPECT))
        # listed refreshers land at (MEMBER, age 0), SUSPECT reverted
        aslw = swar.sel(swar.to_bytes(ref & (stm | sus_pre)),
                        w(MEMBER - 128), aslw)
    else:
        aslw = swar.sel(swar.to_bytes(ref & stm), st | swar.H, aslw)
    past = swar.ges(hbw, vw[V_THR_G]) & nsent
    stale = (act & stm & past
             & swar.gts(aslw, w(((t_fail << 2) | MEMBER) - 128)))
    entered = None
    if suspect:
        thr = w(((confirm_thr << 2) | SUSPECT) - 128)
        if lh is not None:
            thr = swar.sel(lh, w(((confirm_thr_hi << 2) | SUSPECT) - 128),
                           thr)
        fail = act & sus_pre & swar.gts(aslw, thr)
        # MEMBER -> SUSPECT is status bit 1; the age keeps running
        aslw = aslw | (swar.to_bytes(stale) & w(2))
        elig = (stm | sus_pre) & ~fail
        entered = stale
    else:
        fail = stale
        elig = stm & ~fail
    aslw = swar.sel(swar.to_bytes(fail), w(FAILED - 128), aslw)
    expire = (swar.eq(aslw & w(3), w(FAILED))
              & swar.gts(aslw, w(((t_cooldown << 2) | FAILED) - 128)))
    aslw = swar.sel(swar.to_bytes(expire), aslw & w(0xFC), aslw)
    goss = (elig & sends
            & (swar.ges(hbw, vw[V_SA_N]) | swar.ne(vw[V_SA_ALL], 0))
            & swar.les(hbw, vw[V_HI_N]) & nsent)
    enc = swar.sel(swar.to_bytes(goss), swar.sub(hbw, vw[V_SA_N]), -1)
    return hbw, aslw, fail, entered, enc


def merge_swar_plain(hbw, aslw, best, recv, vw, age_clamp: int,
                     suspect: bool = False):
    """The merge epilogue over packed words (csrc/rr_swar.cuh
    rr_merge_swar_t; the JAX package's ``_rr_merge_swar``, and term for
    term its separate-pass ``_membership_update_swar``).  ``best`` the
    merged view words, ``recv`` the receiver row mask (-1/0), ``vw`` the
    packed threshold stack.  Returns (hbw, aslw, refuted), ``refuted`` a
    full-byte mask of the advances on SUSPECT entries (None without
    ``suspect``)."""
    w = swar.word
    st = aslw & w(3)
    anym = ~best & swar.H                       # best >= 0
    lst = swar.ne(st & swar.L, 0) if suspect else swar.eq(st, w(MEMBER))
    adv = recv & swar.to_bytes(
        lst & anym & swar.gts(best, vw[V_CMP_DEEP])
        & swar.gts(swar.add(best, vw[V_SA_N]), hbw))
    add = recv & swar.to_bytes(swar.eq(st, w(UNKNOWN)) & anym)
    upd = adv | add
    up_val = swar.sel(swar.to_bytes(swar.les(best, vw[V_UP_DEEP])), swar.H,
                      swar.add(best, vw[V_D8]))
    keep_val = swar.sel(
        swar.to_bytes(swar.ne(vw[V_HAS_HI], 0) & swar.ges(hbw, vw[V_HI_THR])),
        w(127), swar.sub(hbw, vw[V_SB8]))
    keep_val = swar.sel(swar.to_bytes(swar.les(hbw, vw[V_KEEP_THR])),
                        swar.H, keep_val)
    new_hb = swar.sel(upd, up_val, keep_val)
    # every update lands at (MEMBER, age 0); then the saturating age step
    base = swar.sel(upd, w(MEMBER - 128), aslw)
    new_asl = swar.sel(
        swar.to_bytes(swar.ges(base, w((age_clamp << 2) - 128))), base,
        swar.add(base, w(4)))
    refuted = (adv & swar.to_bytes(swar.eq(st, w(SUSPECT)))
               if suspect else None)
    return new_hb, new_asl, refuted


def group_max_swar(enc: torch.Tensor, align: int) -> torch.Tensor:
    """Byte max over each aligned group of ``align`` rows of view words
    ``[r, C]`` -> ``[r / align, C]`` (one ``swar.maxs`` per word and row)."""
    g = enc.reshape(enc.shape[0] // align, align, -1)
    out = g[:, 0]
    for j in range(1, align):
        out = swar.maxs(out, g[:, j])
    return out


def masked_group_window_max_swar(gw: torch.Tensor, edges2: torch.Tensor,
                                 nw: int, align: int) -> torch.Tensor:
    """:func:`masked_group_window_max` over group-max words ``gw``
    ``[N/align, C/4]``: a dropped group contributes -1 in every byte."""
    nb = gw.shape[0]
    g = edges2[:, 0].to(torch.int64) // align
    best = None
    for k in range(nw):
        keep = ((edges2[:, 1] >> k) & 1) != 0
        v = torch.where(keep[:, None], gw[(g + k) % nb], -1)
        best = v if best is None else swar.maxs(best, v)
    return best


def masked_group_window_max(gmax: torch.Tensor, edges2: torch.Tensor,
                            nw: int, align: int) -> torch.Tensor:
    """``best[i, :] = max_{k < nw} (bit k of mask[i] ? gmax[(base[i] /
    align + k) mod len(gmax)] : -1)`` for the receivers of ``edges2``
    (int32 ``[r, 2]``: arc base, match bitmask) over the group maxes
    ``gmax`` ``[N/align, C]``.  A dropped group contributes the absent
    encoding -1, what "no sender carried the entry" gives."""
    nb = gmax.shape[0]
    g = edges2[:, 0].to(torch.int64) // align
    best = None
    for k in range(nw):
        keep = ((edges2[:, 1] >> k) & 1) != 0
        v = torch.where(keep[:, None], gmax[(g + k) % nb], -1)
        best = v if best is None else torch.maximum(best, v)
    return best


def arc_group_window_max(view: torch.Tensor, edges2: torch.Tensor,
                         fanout: int, align: int) -> torch.Tensor:
    """Scenario-filtered aligned-arc merge in plain PyTorch (the JAX
    package's ``arc_group_window_max_xla``): the max over each aligned
    group of ``align`` view rows, then :func:`masked_group_window_max` over
    each receiver's ``fanout / align`` window groups.  ``view`` ``[N, C]``;
    ``edges2`` int32 ``[N, 2]`` (scenarios.tensor.arc_match_edges).
    Returns the view's dtype."""
    gm = view.reshape(view.shape[0] // align, align, -1).amax(dim=1)
    return masked_group_window_max(gm, edges2, fanout // align, align)


def onepass_smem(n: int, form: str) -> int:
    """Shared memory a CTA of the one-pass kernel needs for ``n`` rows in
    merge ``form``: both ticked lanes of its ``n / ONEPASS_CTAS`` rows over
    the stripe, its view (its rows' slice in the full-view forms, the
    stripe's whole 8-row group-max table in the aligned ones), the stripe's
    11-row threshold stack, the gathers' start row and its two count
    blocks."""
    rows = n // ONEPASS_CTAS
    view = rows if form in FULL_VIEW_FORMS else n // KERNEL_ALIGN
    return ((2 * rows + view) * ONEPASS_C + ONEPASS_STACK_BYTES
            + ONEPASS_COUNT_BYTES)


def onepass_fits(n: int, c: int, form: str,
                 elementwise: str = "lanes") -> bool:
    """Whether K3's one-pass form (f) runs a round of ``n`` rows over ``c``
    subject columns (``c == n`` square, or a column block) in merge
    ``form`` (one of :data:`FORMS`), either ``elementwise`` form: the
    cluster's row split and the stripe width must divide the shape, and a
    CTA's shared memory (:func:`onepass_smem`) must fit the card's: up to
    N = 19,264 (197,888 B a CTA at N = 16,384), so N = 65,536 takes the
    two-launch form."""
    if form not in FORMS:
        raise ValueError(f"onepass_fits: form must be one of {FORMS}, got "
                         f"{form!r}")
    if elementwise not in ELEMENTWISE:
        raise ValueError(f"onepass_fits: elementwise must be one of "
                         f"{ELEMENTWISE}, got {elementwise!r}")
    return (n % (ONEPASS_CTAS * KERNEL_ALIGN) == 0 and 0 < c <= n
            and c % ONEPASS_C == 0
            and onepass_smem(n, form) <= ONEPASS_SMEM)


def onepass_refusal(n: int, c: int, form: str,
                    elementwise: str = "lanes") -> str | None:
    """Why K3's one-pass form (f) cannot run a round of ``n`` rows over
    ``c`` subject columns in merge ``form``: None where
    :func:`onepass_fits` holds the shape, else the limits it breaks."""
    if onepass_fits(n, c, form, elementwise):
        return None
    return (f"the one-pass resident round does not hold [{n}, {c}] in the "
            f"{form} form (ops/merge.onepass_fits: N % "
            f"{ONEPASS_CTAS * KERNEL_ALIGN} == 0, C % {ONEPASS_C} == 0, "
            f"{onepass_smem(n, form)} B of shared memory a CTA against "
            f"{ONEPASS_SMEM} B)")


def _row_chunk(n: int, c: int, align: int) -> int:
    """Rows per plain-version chunk of ``[n, c]`` lanes: ~16M entries,
    whole sender groups."""
    rows = max(align, (1 << 24) // c // align * align)
    return min(rows, n)


def _sus_thresholds(t_fail: int, suspect: bool, t_suspect: int,
                    lh_multiplier: int, age_clamp: int) -> tuple[int, int]:
    """(confirm_thr, confirm_thr_hi): the confirm ages of a healthy and a
    Lifeguard-degraded receiver; checks the suspicion arguments as the JAX
    kernel's wrapper does."""
    if not suspect:
        if lh_multiplier:
            raise ValueError("resident_round: lh_multiplier > 0 (the "
                             "Lifeguard lane) needs suspect=True")
        return 0, 0
    hi = t_fail + t_suspect * (1 + lh_multiplier)
    if t_suspect < 1 or hi >= age_clamp:
        raise ValueError(
            f"resident_round: t_suspect >= 1 and t_fail + t_suspect * (1 + "
            f"lh_multiplier) < age_clamp ({age_clamp}) needed, the age lane "
            f"being the suspicion clock (got t_fail={t_fail}, "
            f"t_suspect={t_suspect}, lh_multiplier={lh_multiplier})")
    return t_fail + t_suspect, hi


def _tick_view_lanes(h, a, rows, c, vc, act, ref, lh, sends, t_fail: int,
                     t_cooldown: int, suspect: bool, thr: int, thr_hi: int):
    """Pass A's tick and view encode in the lanes form over int32 ``h``/``a``
    at columns ``c`` (``[1, C]``, or ``[r, k]`` per row), ``vc`` the int32
    stack at those columns, the row masks ``[r, 1]``.  Returns (hb, asl,
    fail, entered, enc), ``entered`` None without ``suspect``."""
    eye = rows[:, None] == c
    entered = None
    if suspect:
        h, a, fail, elig, entered = tick_sus_plain(
            h, a, act, ref, eye, lh, vc[V_THR_G], t_fail, t_cooldown, thr,
            thr_hi)
    else:
        h, a, fail, elig = tick_plain(h, a, act, ref, eye, vc[V_THR_G],
                                      t_fail, t_cooldown)
    enc = view_plain(h, elig, sends, vc[V_SA_N], vc[V_SA_ALL], vc[V_HI_N])
    return h, a, fail, entered, enc


def _tick_view_swar_rows(hb, asl, r0: int, r1: int, v, vw, masks,
                         t_fail: int, t_cooldown: int, suspect: bool,
                         thr: int, thr_hi: int, col_offset: int = 0):
    """Pass A over rows ``r0..r1`` in the SWAR form: the eye-free word
    tick everywhere, then the words the diagonal crosses (row ``i``'s word
    holding global column ``i``, on the rows whose diagonal lies in the
    shard's columns) recomputed in the lanes form.  ``masks`` the bool row
    masks (act, ref, lh, sends).  Writes the post-tick lanes; returns
    (fail, entered, enc words)."""
    dev = hb.device
    c = hb.shape[1]
    rows = torch.arange(r0, r1, device=dev)
    loc = rows - col_offset
    on = ((loc >= 0) & (loc < c)).nonzero().squeeze(1)  # chunk-row indices
    dcols = (loc[on] // 4 * 4)[:, None] + torch.arange(4, device=dev)[None]
    act, ref, lh, sends = (m[r0:r1, None] for m in masks)
    # the diagonal words' pre-tick bytes, before any write
    diag = _tick_view_lanes(
        hb[r0:r1][on].gather(1, dcols).to(torch.int32),
        asl[r0:r1][on].gather(1, dcols).to(torch.int32), rows[on],
        dcols + col_offset, v[:, dcols], act[on], ref[on], lh[on], sends[on],
        t_fail, t_cooldown, suspect, thr, thr_hi)
    hw, aw, fail_h, ent_h, enc = tick_view_swar_plain(
        swar.pack(hb[r0:r1]).clone(), swar.pack(asl[r0:r1]),
        swar.bool_mask(act), swar.bool_mask(ref), swar.bool_mask(sends), vw,
        t_fail, t_cooldown, suspect, swar.bool_mask(lh), thr, thr_hi)
    fail = swar.unpack(fail_h) != 0
    entered = swar.unpack(ent_h) != 0 if suspect else None
    for full, part in zip((swar.unpack(hw), swar.unpack(aw), fail, entered,
                           swar.unpack(enc)), diag):
        if full is not None:
            full[on] = full[on].scatter(1, dcols, part.to(full.dtype))
    hb[r0:r1] = swar.unpack(hw)
    asl[r0:r1] = swar.unpack(aw)
    return fail, entered, enc


def resident_round_plain(hb, asl, flags, vecs, senders, *,
                         fanout: int | None = None, arc_align: int = 1,
                         t_fail: int, t_cooldown: int,
                         age_clamp: int = AGE_CLAMP, suspect: bool = False,
                         t_suspect: int = 0, lh_multiplier: int = 0,
                         edge_filter: bool = False,
                         elementwise: str = "lanes", col_offset: int = 0):
    """One round in plain PyTorch (the function the kernel computes).

    ``hb``/``asl`` int8 ``[N, C]`` pre-tick lanes, updated in place (C = N,
    or a column shard from global subject ``col_offset``); ``flags`` int8
    ``[N]`` (bit 0 active sender, bit 1 small-group refresher, bit 2
    alive, bit 4 Lifeguard-degraded receiver); ``vecs`` the int8 ``[11,
    C]`` :func:`threshold_stack`; ``senders`` the round's
    in-edges as the JAX kernel takes them: int32 ``[N]`` arc starts,
    multiples of ``arc_align``, with ``fanout`` the arc length, or int32
    ``[N, F]`` explicit edges with ``fanout`` None; with ``edge_filter``
    int32 ``[N, 2]`` (arc start, group-match bitmask) and flags bit 3 the
    muted senders (read in this form only, as in the JAX kernel).
    ``elementwise="swar"`` computes it on packed words (C % 4 == 0).
    Returns (hb, asl, member_cnt, n_det, first_obs, recv_cnt), int32
    ``[C]`` per subject but ``recv_cnt`` ``[N]`` per receiver (partial over
    the C columns); with ``suspect`` then (entered, refuted, held) per
    subject, and with ``lh_multiplier > 0`` last ``suspect_cnt`` per
    receiver (partial too).  Works in row chunks, so its temporaries stay
    small at any N."""
    n, c = hb.shape
    dev = hb.device
    thr, thr_hi = _sus_thresholds(t_fail, suspect, t_suspect, lh_multiplier,
                                  age_clamp)
    sw = _swar(elementwise, c)
    v = vecs.to(torch.int32)
    vw = swar.pack(vecs) if sw else None
    fl = flags.to(torch.int32)
    act, ref, recv = (fl & 1) != 0, (fl & 2) != 0, (fl & 4) != 0
    lh = (fl & 16) != 0
    # a muted sender ticks as ever; its view row encodes absent
    sends = act & ((fl & 8) == 0) if edge_filter else act
    edges = fanout is None
    align = 1 if edges else arc_align
    nb = n // align
    step = _row_chunk(n, c, align)
    cols = col_offset + torch.arange(c, device=dev)   # global subject ids
    i32 = dict(dtype=torch.int32, device=dev)
    sus_out = torch.zeros((3, c), **i32)          # entered, refuted, held
    suspect_cnt = (torch.zeros(n, **i32) if lh_multiplier > 0 else None)

    # tick, view encode, aligned group max (align 1: the whole view) and
    # the detection reductions
    gmax = torch.empty((nb, c), dtype=torch.int8, device=dev)
    n_det = torch.zeros(c, **i32)
    first_obs = torch.full((c,), n, **i32)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        rows = torch.arange(r0, r1, device=dev)
        if sw:
            fail, entered, enc = _tick_view_swar_rows(
                hb, asl, r0, r1, v, vw, (act, ref, lh, sends), t_fail,
                t_cooldown, suspect, thr, thr_hi, col_offset)
            gmax[r0 // align:r1 // align] = swar.unpack(
                group_max_swar(enc, align))
        else:
            h, a, fail, entered, enc = _tick_view_lanes(
                hb[r0:r1].to(torch.int32), asl[r0:r1].to(torch.int32), rows,
                cols[None, :], v, act[r0:r1, None], ref[r0:r1, None],
                lh[r0:r1, None], sends[r0:r1, None], t_fail, t_cooldown,
                suspect, thr, thr_hi)
            hb[r0:r1] = h.to(torch.int8)
            asl[r0:r1] = a.to(torch.int8)
            gmax[r0 // align:r1 // align] = (
                enc.reshape(-1, align, c).amax(dim=1).to(torch.int8))
        if suspect:
            sus_out[0] += entered.sum(dim=0, dtype=torch.int32)
        n_det += fail.sum(dim=0, dtype=torch.int32)
        first = torch.where(fail, rows[:, None].to(torch.int32), n)
        first_obs = torch.minimum(first_obs, first.amin(dim=0))

    # merge epilogue and the membership reductions
    member_cnt = torch.zeros(c, **i32)
    recv_cnt = torch.empty(n, **i32)
    src = swar.pack(gmax) if sw else gmax
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        if edge_filter:
            masked = masked_group_window_max_swar if sw else (
                masked_group_window_max)
            best = masked(src, senders[r0:r1], fanout // align, align)
        else:
            g = senders[r0:r1].to(torch.int64)
            if edges:
                parts = [src[g[:, f]] for f in range(g.shape[1])]
            else:
                g = g // align
                parts = [src[(g + k) % nb] for k in range(fanout // align)]
            best = parts[0]
            for p in parts[1:]:
                best = swar.maxs(best, p) if sw else torch.maximum(best, p)
        rv = recv[r0:r1, None]
        if sw:
            h, a, refuted = merge_swar_plain(
                swar.pack(hb[r0:r1]), swar.pack(asl[r0:r1]), best,
                swar.bool_mask(rv), vw, age_clamp, suspect)
            hb[r0:r1] = swar.unpack(h)
            asl[r0:r1] = swar.unpack(a)
            a = asl[r0:r1].to(torch.int32)
            if suspect:
                refuted = swar.unpack(refuted) != 0
        else:
            h, a, refuted = merge_plain(
                hb[r0:r1].to(torch.int32), asl[r0:r1].to(torch.int32),
                best.to(torch.int32), rv, v[:, None, :], age_clamp, suspect)
            hb[r0:r1] = h.to(torch.int8)
            asl[r0:r1] = a.to(torch.int8)
        st = a & 3
        lst = ((st & 1) == 1) if suspect else (st == MEMBER)
        member_cnt += (lst & rv).sum(dim=0, dtype=torch.int32)
        recv_cnt[r0:r1] = lst.sum(dim=1, dtype=torch.int32)
        if suspect:
            held = st == SUSPECT
            sus_out[1] += refuted.sum(dim=0, dtype=torch.int32)
            sus_out[2] += held.sum(dim=0, dtype=torch.int32)
            if suspect_cnt is not None:
                suspect_cnt[r0:r1] = held.sum(dim=1, dtype=torch.int32)
    out = (hb, asl, member_cnt, n_det, first_obs, recv_cnt)
    if not suspect:
        return out
    out += tuple(sus_out)
    return out + (suspect_cnt,) if suspect_cnt is not None else out


def _swar(elementwise: str, c: int) -> bool:
    """Whether the round runs the SWAR form over ``c`` subject columns;
    checks the argument."""
    if elementwise not in ELEMENTWISE:
        raise ValueError(f"resident_round: elementwise must be one of "
                         f"{ELEMENTWISE}, got {elementwise!r}")
    if elementwise == "swar" and c % 4:
        raise ValueError(f"resident_round: the SWAR form packs 4 subjects "
                         f"per word, N % 4 == 0 needed (a column shard's "
                         f"C % 4 == 0; got {c} columns)")
    return elementwise == "swar"


def _check_inputs(hb, asl, flags, vecs, senders, fanout, arc_align,
                  edge_filter=False, col_offset=0):
    n, c = hb.shape if hb.dim() == 2 else (-1, -1)
    if not (0 < c <= n and 0 <= col_offset <= n - c):
        raise ValueError(
            f"resident_round: hb must be an [N, C] column block with its "
            f"columns inside [0, N): got {tuple(hb.shape)} at col_offset="
            f"{col_offset}")
    if edge_filter:
        if fanout is None or arc_align <= 1:
            raise ValueError(
                "resident_round: edge_filter (the scenario-armed masked "
                "gather) requires the aligned-arc topology; explicit-edge "
                "scenarios rewrite the sampled [N, F] edges instead "
                "(scenarios/tensor.py)")
        if fanout // arc_align > ARC_MATCH_MAX_GROUPS:
            raise ValueError(
                "resident_round: edge_filter packs the per-receiver "
                "group-match mask into an int32: fanout/arc_align must be "
                f"<= {ARC_MATCH_MAX_GROUPS} (got {fanout // arc_align})")
    want = {
        "hb": (hb, torch.int8, (n, c)),
        "asl": (asl, torch.int8, (n, c)),
        "flags": (flags, torch.int8, (n,)),
        "vecs": (vecs, torch.int8, (N_VEC, c)),
    }
    if fanout is None:
        f = senders.shape[1] if senders.dim() == 2 else -1
        want["edges"] = (senders, torch.int32, (n, max(f, 1)))
    elif edge_filter:
        want["(base, match-mask) edges"] = (senders, torch.int32, (n, 2))
    else:
        want["bases"] = (senders, torch.int32, (n,))
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"resident_round: {name} must be {dtype} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"resident_round: {name} must be contiguous")
        if t.device != hb.device:
            raise ValueError(f"resident_round: {name} is on {t.device}, "
                             f"hb on {hb.device}")
    if fanout is not None and (arc_align < 1 or n % arc_align
                               or fanout % arc_align or not 0 < fanout <= n):
        raise ValueError(f"resident_round: arc_align={arc_align} must divide "
                         f"n={n} and fanout={fanout} (0 < fanout <= n)")


def resident_round(hb, asl, flags, vecs, senders, *,
                   fanout: int | None = None, arc_align: int = 1,
                   t_fail: int, t_cooldown: int, age_clamp: int = AGE_CLAMP,
                   suspect: bool = False, t_suspect: int = 0,
                   lh_multiplier: int = 0, edge_filter: bool = False,
                   elementwise: str = "lanes", col_offset: int = 0,
                   onepass: bool = False,
                   timeline: torch.Tensor | None = None):
    """One round: :func:`resident_round_plain` for CPU tensors, the CUDA
    kernel for CUDA tensors (same contract, in the :func:`kernel_form` the
    senders and ``elementwise`` ask for, over ``[N, C]`` lanes from global
    subject ``col_offset``; raises what it cannot run).  ``onepass`` runs
    K3's one-pass form (f), ``csrc/rr_onepass.cu``, counted under the
    form's ``/onepass`` name; it raises ``ValueError`` where
    :func:`onepass_fits` refuses the shape or where ``hb``, ``asl`` or
    ``vecs`` does not start on a 16-byte boundary (the kernel moves 16-byte
    row segments), on any device.  ``timeline`` (one-pass, CUDA only):
    an int64 ``[C / 32, ONEPASS_CTAS, ONEPASS_STAMPS]`` tensor each CTA
    writes its stripe's step times into (:func:`onepass_timeline_split`)."""
    _check_inputs(hb, asl, flags, vecs, senders, fanout, arc_align,
                  edge_filter, col_offset)
    n, c = hb.shape
    sw = _swar(elementwise, c)
    form = kernel_form(fanout, arc_align, edge_filter, elementwise)
    base_form = form.split("/")[0]
    if timeline is not None and not onepass:
        raise ValueError("resident_round: the timeline is a one-pass option "
                         "(onepass=True)")
    why = onepass_refusal(n, c, base_form, elementwise) if onepass else None
    if why is not None:
        raise ValueError(f"resident_round: {why}")
    for name, t in (("hb", hb), ("asl", asl), ("vecs", vecs)):
        if onepass and t.data_ptr() % 16:
            raise ValueError(
                f"resident_round: the one-pass form moves {name} in 16-byte "
                f"row segments, so its data must start on a 16-byte boundary "
                f"(it starts {t.data_ptr() % 16} B past one)")
    kw = dict(fanout=fanout, arc_align=arc_align, t_fail=t_fail,
              t_cooldown=t_cooldown, age_clamp=age_clamp, suspect=suspect,
              t_suspect=t_suspect, lh_multiplier=lh_multiplier,
              edge_filter=edge_filter, elementwise=elementwise,
              col_offset=col_offset)
    if hb.device.type == "cpu":
        if timeline is not None:
            raise ValueError("resident_round: the timeline records the CUDA "
                             "kernel's steps; the plain version has none")
        return resident_round_plain(hb, asl, flags, vecs, senders, **kw)
    if hb.device.type != "cuda":
        raise ValueError(f"resident_round: no kernel for {hb.device}")
    thr, thr_hi = _sus_thresholds(t_fail, suspect, t_suspect, lh_multiplier,
                                  age_clamp)
    if n % KERNEL_VEC or c % KERNEL_VEC:
        raise NotImplementedError(
            f"the CUDA resident round takes N % {KERNEL_VEC} == 0 and C % "
            f"{KERNEL_VEC} == 0 (got N={n}, C={c}); the round loop runs "
            "such a shape through the separate-pass round")
    from gossipfs_tpu_torch.ops import _build

    width = senders.shape[1] if fanout is None else fanout
    lh = int(suspect and lh_multiplier > 0)
    if onepass:
        return _launch_onepass(hb, asl, flags, vecs, senders, width,
                               base_form, arc_align, t_fail, t_cooldown,
                               age_clamp, suspect, lh, thr, thr_hi, sw,
                               col_offset, form, timeline)
    lib = _build.load("resident_round")
    with torch.cuda.device(hb.device):
        g_rows = (n // KERNEL_ALIGN
                  if base_form in ("aligned_group", "filter_group") else n)
        gmax = torch.empty((g_rows, c), dtype=torch.int8, device=hb.device)
        # per subject [C] (member_cnt, n_det, first_obs; entered, refuted,
        # held), per receiver [N] (recv_cnt; suspect_cnt)
        subj = torch.empty((6 if suspect else 3, c), dtype=torch.int32,
                           device=hb.device)
        recv = torch.empty((1 + lh, n), dtype=torch.int32, device=hb.device)
        stream = torch.cuda.current_stream(hb.device)
        with counted_launch("resident_round", stream, form):
            check_rc("resident_round", lib.rr_round(
                hb.data_ptr(), asl.data_ptr(), flags.data_ptr(),
                vecs.data_ptr(), senders.data_ptr(), gmax.data_ptr(),
                subj.data_ptr(), recv.data_ptr(), n, c, col_offset, width,
                FORMS.index(base_form), arc_align, t_fail, t_cooldown,
                age_clamp, int(suspect), lh, thr, thr_hi, int(sw),
                stream.cuda_stream))
    return (hb, asl, *subj[:3], recv[0], *subj[3:], *recv[1:])


def _launch_onepass(hb, asl, flags, vecs, senders, width: int,
                    base_form: str, arc_align: int, t_fail: int,
                    t_cooldown: int, age_clamp: int, suspect: bool, lh: int,
                    thr: int, thr_hi: int, sw: bool, col_offset: int,
                    form: str, timeline):
    """Launch ``csrc/rr_onepass.cu`` for :func:`resident_round`."""
    from gossipfs_tpu_torch.ops import _build

    n, c = hb.shape
    shape = (c // ONEPASS_C, ONEPASS_CTAS, ONEPASS_STAMPS)
    if timeline is not None and (
            timeline.dtype != torch.int64 or tuple(timeline.shape) != shape
            or timeline.device != hb.device
            or not timeline.is_contiguous()):
        raise ValueError(f"resident_round: timeline must be a contiguous "
                         f"int64 {shape} tensor on {hb.device}")
    lib = _build.load("rr_onepass")
    dev = hb.device
    with torch.cuda.device(dev):
        subj = torch.empty((6 if suspect else 3, c), dtype=torch.int32,
                           device=dev)
        recv = torch.empty((1 + lh, n), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev)
        with counted_launch("resident_round", stream, form + "/onepass"):
            check_rc("rr_onepass", lib.rr_onepass(
                hb.data_ptr(), asl.data_ptr(), flags.data_ptr(),
                vecs.data_ptr(), senders.data_ptr(), subj.data_ptr(),
                recv.data_ptr(), None if timeline is None else timeline.data_ptr(),
                n, c, col_offset, width, FORMS.index(base_form), arc_align,
                t_fail, t_cooldown, age_clamp, int(suspect), lh, thr, thr_hi,
                int(sw), stream.cuda_stream))
    return (hb, asl, *subj[:3], recv[0], *subj[3:], *recv[1:])


def onepass_timeline_split(timeline: torch.Tensor) -> dict:
    """Median microseconds a stripe spends in each step of the one-pass
    kernel, from a ``timeline`` :func:`resident_round` filled (stamps of
    each stripe's CTA 0): ``step1`` (the previous stripe's counts
    reduced, then tick, park, view), ``sync`` (the cluster barrier),
    ``step2`` (gather, merge, write, the next stripe's lanes staged),
    ``tail`` (the last barrier and the next stripe's stack staged),
    ``stripe`` (the whole) and ``span`` (the first stripe's start to the
    last one's end: the launch, as its clusters walk their stripes)."""
    t = timeline[:, 0, :].double().cpu() / 1e3
    med = (t[:, 1:] - t[:, :-1]).median(dim=0).values.tolist()
    return dict(step1=med[0], sync=med[1], step2=med[2], tail=med[3],
                stripe=float((t[:, -1] - t[:, 0]).median()),
                span=float(t[:, -1].max() - t[:, 0].min()))


def onepass_info(n: int, c: int, form: str, *, fanout: int,
                 arc_align: int = 1, suspect: bool = False, lh: bool = False,
                 elementwise: str = "lanes", col_offset: int = 0) -> dict:
    """The one-pass instantiation a round of this shape and merge ``form``
    launches, on the current card: ``clusters``
    (``cudaOccupancyMaxActiveClusters``: how many stripe clusters run at
    once), ``smem`` (the dynamic shared memory a CTA its launcher asks
    for, csrc/rr_onepass.cuh ``smem_bytes``) and ``smem_attr`` (the
    kernel's opt-in maximum, as ``cudaFuncGetAttributes`` reports it after
    the launcher raised it).  Launches nothing."""
    from gossipfs_tpu_torch.ops import _build

    out = (ctypes.c_int * 3)()
    check_rc("rr_onepass_clusters", _build.load("rr_onepass")
             .rr_onepass_clusters(n, c, col_offset, fanout,
                                  FORMS.index(form), arc_align, int(suspect),
                                  int(lh), int(elementwise == "swar"), out))
    return dict(clusters=out[0], smem=out[1], smem_attr=out[2])


def onepass_clusters(n: int, c: int, form: str, **kw) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the one-pass instantiation a
    round of this shape and merge ``form`` launches (:func:`onepass_info`,
    same keywords)."""
    return onepass_info(n, c, form, **kw)["clusters"]
