"""The merge kernels of the separate-pass round: gather-max plus the
membership-update epilogue, over a gossip view that is already built.

Three kernels, each with its plain PyTorch version beside it:

* :func:`fused_merge_update` (K2) takes explicit in-edges ``[N, F]``:
  ``best[i, :] = max_f view[edges[i, f], :]``.  Port of
  ``gossipfs_tpu/ops/merge_pallas.py: fused_merge_update_blocked``; the
  ``random`` and ``ring`` topologies run it.
* :func:`stripe_merge_update` (K5) is K2's function over an int8 view with
  another memory strategy: a cluster of blocks parks a stripe of view
  columns for every receiver in shared memory, so the view crosses device
  memory once per round.  Port of ``stripe_merge_update_blocked``; the
  explicit-edge rounds of ``pallas_stripe``/``pallas_rr`` configurations
  run it where it admits the shape (:func:`stripe_admits`).
* :func:`arc_merge_update` (K4) takes arc bases ``[N]``: the window max
  ``W[r, :] = max_{k<F} view[(r + k) mod N, :]`` once, then
  ``best[i, :] = W[bases[i], :]``.  Port of ``arc_merge_update_blocked``;
  every ``random_arc`` round off the lean loop runs it.

All run the same epilogue on each entry (``_epilogue_and_count`` of
the JAX package, in its int32 + clip form): advance a listed entry whose
best view value is fresher, add an UNKNOWN one that some sender carried,
renormalise every stored value to this round's base (``shift_a`` maps the
stored encoding to the view's, ``shift_b`` the old stored base to the
new), clip to the lane dtype, and age every entry by one (saturating at
``age_clamp``), all gated on the receiver being alive.  They reduce per
subject: ``cnt_incl`` (live receivers listing it after the merge, self
included), and with ``detect_stats`` this round's detections ``n_det``
and the lowest firing receiver ``first_obs`` (N where none fired), read
off the post-tick lanes as FAILED at age 0 (valid under the crash-only,
fresh-cooldown, gossip-only fault model).  Without ``detect_stats`` both
are zeros, as in the JAX kernels.

``suspect=True`` is the SWIM form (the JAX kernels' ``suspect=``): a
SUSPECT entry is listed, an advance on it is the refutation (every update
writes MEMBER), the counts include suspects, and two more per-subject
reductions come back: ``refuted`` (advances on SUSPECT entries) and
``held`` (entries still SUSPECT after the merge, over all rows, dead
receivers included).  They give the round's suspicion observables with no
``[N, N]`` snapshot.

The lanes are the port's: ``hb`` in int8, int16 or int32, ``asl`` the
packed age|status byte, updated IN PLACE.  They and the view may be a
column block ``[N, C]`` (all N receiver and sender rows, C subject
columns: C = N on one device, N / shards on a subject shard,
``parallel/mesh.py``): the function is columnwise, so output column j
reads only column j of the view and the lanes.  The per-subject vectors
(``shift_a``, ``shift_b``, the outputs) are then ``[C]``; ``alive`` and the
senders stay ``[N]`` / ``[N, F]``, and an unset ``first_obs`` is N, the
global row count.  On a CPU tensor a wrapper runs
the plain version; on a CUDA tensor it launches its kernel
(``csrc/fused_merge.cu``, ``csrc/stripe_merge.cu``, ``csrc/arc_merge.cu``)
or raises.  All the arithmetic is int32 over the widened lane values, so
kernel, plain version and the JAX package agree bit for bit.
"""

from __future__ import annotations

import torch

from gossipfs_tpu_torch.config import AGE_CLAMP
from gossipfs_tpu_torch.core.state import (
    FAILED, HB_DTYPES, MEMBER, SUSPECT, UNKNOWN, listed, swar_lanes_ok)
from gossipfs_tpu_torch.ops import merge, swar

VIEW_DTYPES = (torch.int8, torch.int16)
# K2's fanout range on the card, 1 to this: its launcher's contract (the
# ring walks a row's senders 8 at a time, so no buffer bounds F)
MAX_KERNEL_FANOUT = 512
# K5's limit on the ROWS (a subject shard keeps every row, so sharding the
# columns does not lift it): the N the route has admitted since K5's first
# kernel, whose [N, 8] strip filled one block's shared memory.  The present
# kernel's park (csrc/merge_stripe.cuh: a cluster of 16 CTAs, each holding
# N / 16 rows of a 64-byte view stripe at this N, 111 KB) holds it with
# room; the route keeps its limit.
STRIPE_MAX_N = 28_416


def stripe_admits(n: int, view_dtype: str) -> bool:
    """Whether K5 takes a view of ``n`` rows of ``view_dtype`` (``[N, N]``,
    or an ``[N, N / shards]`` column block: the bound is on rows): int8,
    and N <= :data:`STRIPE_MAX_N`."""
    return view_dtype == "int8" and n <= STRIPE_MAX_N


# The shared memory the merge kernels ask for, as the budget functions of
# their csrc headers compute it (the analyzer's smem-budget probe holds
# each pair equal, and the card's attributes to both): K5's park
# (merge_stripe.cuh smem_bytes at stripe_row_bytes), K4's window tile
# (tile_smem_bytes), K2's and K1's ring (gather_ring.cuh ring_bytes, K2
# adding its staged sender ids; max_smem_bytes the opt-in maximum).  A
# block's opt-in limit on the card is merge.ONEPASS_SMEM.
STRIPE_CTAS = 16                  # CTAs a K5 cluster
STRIPE_THREADS = 512              # threads a K5 CTA
SEG_BYTES = 16                    # a thread's bytes of a row piece
ROW_BYTES = 128                   # park, tile and view row pieces, at most
COUNT_BLOCK_BYTES = 5 * 128 * 4   # a CTA's count block: int32 [5, 128]
MAX_SWEEP = 255                   # rows a K5 thread sweeps a stripe, most
ARC_TILE_ROWS = 512               # rows a K4 window tile
RING_THREADS = 256                # threads a K2/K1 block
RING_DEPTH = 2                    # ring stages
RING_SLOTS = 8                    # a stage's slots a thread, at most
RING_STEP_ROWS = RING_THREADS // (ROW_BYTES // SEG_BYTES)
RING_SMEM_MAX = (RING_DEPTH * RING_SLOTS * SEG_BYTES * RING_THREADS
                 + 4 * RING_STEP_ROWS * MAX_KERNEL_FANOUT)


def stripe_cta_rows(n: int) -> int:
    """The most receiver rows a K5 CTA parks: ceil(n / STRIPE_CTAS)."""
    return -(-n // STRIPE_CTAS)


def stripe_park_smem(park_rows: int, row_bytes: int) -> int:
    """A K5 CTA's shared memory: the park, one row of absent bytes and two
    count blocks."""
    return park_rows * row_bytes + ROW_BYTES + 2 * COUNT_BLOCK_BYTES


def stripe_row_bytes(n: int) -> int:
    """K5's park row bytes at ``n`` rows: the widest of 128, 64 and 32
    whose park fits a CTA and keeps a thread's sweep to its byte
    counters, else 0 (K5 cannot hold the shape)."""
    rows = stripe_cta_rows(n)
    for rb in (128, 64, 32):
        if (stripe_park_smem(rows, rb) <= merge.ONEPASS_SMEM
                and rows <= MAX_SWEEP * (STRIPE_THREADS // (rb // SEG_BYTES))):
            return rb
    return 0


def stripe_smem(n: int) -> int:
    """The dynamic shared memory a K5 CTA asks for at ``n`` rows."""
    return stripe_park_smem(stripe_cta_rows(n), stripe_row_bytes(n))


def arc_tile_smem(fanout: int) -> int:
    """K4's window tile a block: ARC_TILE_ROWS rows and the F - 1 after
    them, in 128-byte rows (the van Herk window where it does not fit)."""
    return (ARC_TILE_ROWS + fanout - 1) * ROW_BYTES


def arc_tile_fits(fanout: int) -> bool:
    return arc_tile_smem(fanout) <= merge.ONEPASS_SMEM


def ring_smem(fanout: int) -> int:
    """K2's and K1's ring a block at ``fanout``: RING_DEPTH stages of a
    chunk's slots a thread (a row's senders in the fewest chunks of at
    most RING_SLOTS, evenly sized); K2 adds its staged ids behind it."""
    chunks = -(-fanout // RING_SLOTS)
    chunk = -(-fanout // chunks)
    return RING_DEPTH * chunk * SEG_BYTES * RING_THREADS


def row_chunks(n: int, cols: int):
    """Row ranges of ~16M entries: the temporaries of the plain versions
    (and of the round's torch stages) stay small at any N."""
    step = max(1, (1 << 24) // max(cols, 1))
    for r0 in range(0, n, step):
        yield r0, min(n, r0 + step)


def epilogue_plain(best, hb, asl, recv, sa, sb, lo: int, hi: int,
                   age_clamp: int, suspect: bool = False):
    """The per-entry merge epilogue over int32 tensors (``best``, ``hb``,
    ``asl`` the widened biased byte, all ``[r, C]``; ``recv`` bool
    ``[r, 1]``; ``sa``/``sb`` int32 ``[C]``).  Returns (hb, asl, listed,
    fresh, refuted, held), the last four bool: the entry is listed after
    the merge, the detector fired on it this round (FAILED at age 0 before
    it), and under ``suspect`` an advance refuted its suspicion / it is
    still SUSPECT (None without ``suspect``).  Term for term
    ``_epilogue_and_count`` of the JAX package."""
    p = asl + 128
    st, age = p & 3, p >> 2
    any_m = best >= 0
    advance = recv & any_m & listed(st, suspect) & (best > hb - sa)
    add = recv & any_m & (st == UNKNOWN)
    upd = advance | add
    new_hb = torch.where(upd, best + (sa - sb), hb - sb).clamp(lo, hi)
    new_age = torch.clamp(torch.where(upd, 0, age) + 1, max=age_clamp)
    new_st = torch.where(upd, MEMBER, st)
    new_asl = ((new_age << 2) | new_st) - 128
    fresh = recv & (st == FAILED) & (age == 0)
    refuted = held = None
    if suspect:
        refuted = advance & (st == SUSPECT)
        held = new_st == SUSPECT
    return new_hb, new_asl, listed(new_st, suspect), fresh, refuted, held


def membership_update_swar(bestw, hbw, aslw, recv, vw, age_clamp: int,
                           suspect: bool = False):
    """:func:`epilogue_plain` on packed words over int8 lanes (the JAX
    package's ``_membership_update_swar``, its all-int8 epilogue under
    ``elementwise="swar"``): ``bestw``/``hbw``/``aslw`` int32 words
    ``[r, C/4]``, ``recv`` the receiver row mask (-1/0), ``vw`` the packed
    ``ops.merge.threshold_stack`` of the round's shifts (its saturation
    thresholds are the narrow epilogue's clips).  The word arithmetic is
    ``ops.merge.merge_swar_plain``, K3's SWAR epilogue.  Returns (hbw,
    aslw, listed, fresh, refuted, held), the last four bool ``[r, C]`` as
    :func:`epilogue_plain` gives them."""
    fresh = (swar.unpack(swar.eq(aslw, swar.word(FAILED - 128)) & recv)
             != 0)
    hbw, aslw, refuted = merge.merge_swar_plain(hbw, aslw, bestw, recv, vw,
                                                age_clamp, suspect)
    st = swar.unpack(aslw) & 3
    held = None
    if suspect:
        refuted = swar.unpack(refuted) != 0
        held = st == SUSPECT
    return hbw, aslw, listed(st, suspect), fresh, refuted, held


def fanout_max_merge_plain(view: torch.Tensor, edges: torch.Tensor):
    """``best[i, :] = max_f view[edges[i, f], :]`` as int32 ``[len(edges),
    C]`` (the JAX package's ``fanout_max_merge_xla``)."""
    e = edges.to(torch.int64)
    best = view[e[:, 0]].to(torch.int32)
    for f in range(1, e.shape[1]):
        best = torch.maximum(best, view[e[:, f]].to(torch.int32))
    return best


def window_max_plain(view: torch.Tensor, fanout: int) -> torch.Tensor:
    """``W[r, :] = max_{k<F} view[(r + k) mod N, :]`` in the view's dtype,
    by shift doubling over row chunks (the JAX package's
    ``arc_window_max_xla`` before its gather)."""
    n = view.shape[0]
    w = torch.empty_like(view)
    p = 1 << (fanout.bit_length() - 1)    # largest power of two <= F
    for r0, r1 in row_chunks(n, view.shape[1]):
        ext = view[torch.arange(r0, r1 + fanout - 1, device=view.device) % n]
        length, s = ext.shape[0], 1
        while s < p:
            # ext[r] = max over rows r..r+2s-1 after the step with shift s
            ext = torch.maximum(ext[:length - s], ext[s:length])
            length -= s
            s *= 2
        rows = r1 - r0
        if p != fanout:
            # two overlapping p-windows cover the F-window exactly
            ext = torch.maximum(ext[:rows], ext[fanout - p:fanout - p + rows])
        w[r0:r1] = ext[:rows]
    return w


def arc_window_max_plain(view: torch.Tensor, bases: torch.Tensor,
                         fanout: int) -> torch.Tensor:
    """``best[i, :] = W[bases[i], :]`` over :func:`window_max_plain`'s W
    (the JAX package's ``arc_window_max_xla``)."""
    return window_max_plain(view, fanout)[bases.to(torch.int64)]


def _merge_rows_plain(rows_best, hb, asl, shift_a, shift_b, alive,
                      detect_stats: bool, suspect: bool, age_clamp: int,
                      swar_form: bool = False):
    """The epilogue and reductions over every receiver row, in row chunks;
    ``rows_best(r0, r1)`` gives the int32 best rows of receivers
    ``r0..r1-1`` (with ``swar_form`` the packed best words, run through
    :func:`membership_update_swar`).  Updates ``hb``/``asl`` in place."""
    n, c = hb.shape
    dev = hb.device
    info = torch.iinfo(hb.dtype)
    sa = shift_a.to(torch.int32)
    sb = shift_b.to(torch.int32)
    recv_all = alive.to(torch.bool)
    i32 = dict(dtype=torch.int32, device=dev)
    out = torch.zeros((5 if suspect else 3, c), **i32)
    cnt, n_det, first_obs = out[0], out[1], out[2]
    if detect_stats:
        first_obs.fill_(n)
    if swar_form:
        vw = swar.pack(merge.threshold_stack(sa, sb, torch.zeros_like(sa), 0))
    for r0, r1 in row_chunks(n, c):
        recv = recv_all[r0:r1, None]
        if swar_form:
            h, a, lst, fresh, refuted, held = membership_update_swar(
                rows_best(r0, r1), swar.pack(hb[r0:r1]), swar.pack(asl[r0:r1]),
                swar.bool_mask(recv), vw, age_clamp, suspect)
            h, a = swar.unpack(h), swar.unpack(a)
        else:
            h, a, lst, fresh, refuted, held = epilogue_plain(
                rows_best(r0, r1), hb[r0:r1].to(torch.int32),
                asl[r0:r1].to(torch.int32), recv, sa, sb, info.min, info.max,
                age_clamp, suspect)
        hb[r0:r1] = h.to(hb.dtype)
        asl[r0:r1] = a.to(torch.int8)
        cnt += (lst & recv).sum(dim=0, dtype=torch.int32)
        if detect_stats:
            n_det += fresh.sum(dim=0, dtype=torch.int32)
            rows = torch.arange(r0, r1, **i32)[:, None]
            torch.minimum(first_obs, torch.where(fresh, rows, n).amin(dim=0),
                          out=first_obs)
        if suspect:
            out[3] += refuted.sum(dim=0, dtype=torch.int32)
            out[4] += held.sum(dim=0, dtype=torch.int32)
    return (hb, asl, *out)


def fused_merge_update_plain(view, edges, hb, asl, shift_a, shift_b, alive,
                             *, detect_stats: bool = False,
                             suspect: bool = False,
                             age_clamp: int = AGE_CLAMP):
    """K2 in plain PyTorch (see module docstring).  Returns (hb, asl,
    cnt_incl, n_det, first_obs), the last three int32 ``[N]``, then
    (refuted, held) under ``suspect``."""
    return _merge_rows_plain(
        lambda r0, r1: fanout_max_merge_plain(view, edges[r0:r1]),
        hb, asl, shift_a, shift_b, alive, detect_stats, suspect, age_clamp)


def stripe_merge_update_plain(view, edges, hb, asl, shift_a, shift_b, alive,
                              *, detect_stats: bool = False,
                              suspect: bool = False,
                              age_clamp: int = AGE_CLAMP):
    """K5 in plain PyTorch: K2's function, computed as the kernel walks it.
    For each strip of subject columns (~16M entries), the strip of the
    view is gathered for every receiver at once, the epilogue runs on the
    strip of the lanes, and the strip's reductions are complete (no sum
    carries from one strip to the next).  Same outputs as
    :func:`fused_merge_update_plain`."""
    n, c = hb.shape
    dev = hb.device
    info = torch.iinfo(hb.dtype)
    e = edges.to(torch.int64)
    recv = alive.to(torch.bool)[:, None]
    rows = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    out = torch.zeros((5 if suspect else 3, c), dtype=torch.int32,
                      device=dev)
    for c0, c1 in row_chunks(c, n):          # column strips of ~16M entries
        strip = view[:, c0:c1]
        best = strip[e[:, 0]].to(torch.int32)
        for f in range(1, e.shape[1]):
            best = torch.maximum(best, strip[e[:, f]].to(torch.int32))
        h, a, lst, fresh, refuted, held = epilogue_plain(
            best, hb[:, c0:c1].to(torch.int32), asl[:, c0:c1].to(torch.int32),
            recv, shift_a[c0:c1].to(torch.int32),
            shift_b[c0:c1].to(torch.int32), info.min, info.max, age_clamp,
            suspect)
        hb[:, c0:c1] = h.to(hb.dtype)
        asl[:, c0:c1] = a.to(torch.int8)
        out[0, c0:c1] = (lst & recv).sum(dim=0, dtype=torch.int32)
        if detect_stats:
            out[1, c0:c1] = fresh.sum(dim=0, dtype=torch.int32)
            out[2, c0:c1] = torch.where(fresh, rows, n).amin(dim=0)
        if suspect:
            out[3, c0:c1] = refuted.sum(dim=0, dtype=torch.int32)
            out[4, c0:c1] = held.sum(dim=0, dtype=torch.int32)
    return (hb, asl, *out)


def arc_merge_update_plain(view, bases, hb, asl, shift_a, shift_b, alive,
                           *, fanout: int, detect_stats: bool = False,
                           suspect: bool = False,
                           age_clamp: int = AGE_CLAMP):
    """K4 in plain PyTorch (see module docstring); same outputs as K2."""
    w = window_max_plain(view, fanout)
    b = bases.to(torch.int64)
    return _merge_rows_plain(
        lambda r0, r1: w[b[r0:r1]].to(torch.int32),
        hb, asl, shift_a, shift_b, alive, detect_stats, suspect, age_clamp)


def arc_group_merge_update(view, edges2, hb, asl, shift_a, shift_b, alive,
                           *, fanout: int, align: int,
                           detect_stats: bool = False, suspect: bool = False,
                           age_clamp: int = AGE_CLAMP,
                           elementwise: str = "lanes"):
    """The scenario-filtered aligned-arc merge of the separate-pass round:
    ``best`` from ``ops.merge.arc_group_window_max`` (``edges2`` int32
    ``[N, 2]``: arc base, group-match bitmask), then K2's epilogue and
    reductions; same outputs as K2.  Plain PyTorch on any device and no
    kernel launch: the JAX package runs this case in XLA too, outside any
    Pallas kernel (its arc kernels fuse the unfiltered window max), and
    the lean loop has the fused form (ops.merge.resident_round with
    ``edge_filter``).  Under ``elementwise="swar"`` over int8 lanes that
    pack (the JAX package's dispatch), the group max, the masked gather
    and the epilogue (:func:`membership_update_swar`) run on packed
    words."""
    n = view.shape[0]
    if (elementwise == "swar" and swar_lanes_ok(hb)
            and view.dtype == torch.int8):
        gw = merge.group_max_swar(swar.pack(view), align)  # once per round
        return _merge_rows_plain(
            lambda r0, r1: merge.masked_group_window_max_swar(
                gw, edges2[r0:r1], fanout // align, align),
            hb, asl, shift_a, shift_b, alive, detect_stats, suspect,
            age_clamp, swar_form=True)
    gm = view.reshape(n // align, align, -1).amax(dim=1)  # once per round
    return _merge_rows_plain(
        lambda r0, r1: merge.masked_group_window_max(
            gm, edges2[r0:r1], fanout // align, align).to(torch.int32),
        hb, asl, shift_a, shift_b, alive, detect_stats, suspect, age_clamp)


def _check_inputs(name, view, senders, hb, asl, shift_a, shift_b, alive,
                  age_clamp):
    n, c = hb.shape if hb.dim() == 2 else (-1, -1)
    if not 0 < c <= n:
        raise ValueError(f"{name}: hb must be an [N, C] block with 0 < C <= "
                         f"N, got {tuple(hb.shape)}")
    want = {
        "view": (view, VIEW_DTYPES, (n, c)),
        "hb": (hb, tuple(HB_DTYPES.values()), (n, c)),
        "asl": (asl, (torch.int8,), (n, c)),
        "shift_a": (shift_a, (torch.int32,), (c,)),
        "shift_b": (shift_b, (torch.int32,), (c,)),
        "alive": (alive, (torch.bool,), (n,)),
    }
    want.update(senders)
    for arg, (t, dtypes, shape) in want.items():
        if t.dtype not in dtypes or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {dtypes} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.device != hb.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, hb on "
                             f"{hb.device}")
    if hb.dtype != torch.int32 and view.element_size() > hb.element_size():
        raise ValueError(f"{name}: a {view.dtype} view over {hb.dtype} lanes")
    if not 0 <= age_clamp <= AGE_CLAMP:
        raise ValueError(f"{name}: age_clamp must be in [0, {AGE_CLAMP}] "
                         "(the packed age is 6 bits)")


def _launch(name: str, source: str, fn: str, view, senders, hb, asl,
            shift_a, shift_b, alive, fanout: int, detect_stats: bool,
            suspect: bool, age_clamp: int, scratch=None, init: bool = True):
    """Launch kernel ``name`` (C function ``fn`` of ``csrc/<source>.cu``)
    on hb's device and current stream; ``scratch``: a tensor whose pointer
    the C function takes; ``init``: the kernel adds into its outputs
    (zeros, first_obs N), else it writes every entry."""
    if hb.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {hb.device}")
    from gossipfs_tpu_torch.ops import _build

    lib = _build.load(source)
    n, c = hb.shape
    # vector loads need C % 4 == 0 and 16-byte aligned rows of every lane
    ptrs = [t.data_ptr() for t in (view, hb, asl)]
    aligned = int(c % 4 == 0 and all(p % 16 == 0 for p in ptrs))
    with torch.cuda.device(hb.device):
        out = (torch.zeros if init else torch.empty)(
            (5 if suspect else 3, c), dtype=torch.int32, device=hb.device)
        if init and detect_stats:
            out[2].fill_(n)
        stream = torch.cuda.current_stream(hb.device)
        args = [view.data_ptr(), senders.data_ptr(), hb.data_ptr(),
                asl.data_ptr(), shift_a.data_ptr(), shift_b.data_ptr(),
                alive.data_ptr()]
        if scratch is not None:
            args.append(scratch.data_ptr())
        args += [out.data_ptr(), n, c, fanout, view.element_size(),
                 hb.element_size(), int(detect_stats), int(suspect),
                 age_clamp, aligned, stream.cuda_stream]
        with merge.counted_launch(name, stream):
            merge.check_rc(name, getattr(lib, fn)(*args))
    return (hb, asl, *out)


def _check_edges(name, view, edges, hb, asl, shift_a, shift_b, alive,
                 age_clamp) -> int:
    n = hb.shape[0] if hb.dim() == 2 else -1
    f = edges.shape[1] if edges.dim() == 2 else -1
    _check_inputs(name, view, {"edges": (edges, (torch.int32,), (n, f))}, hb,
                  asl, shift_a, shift_b, alive, age_clamp)
    if f < 1:
        raise ValueError(f"{name}: edges need fanout >= 1")
    return f


def fused_merge_update(view, edges, hb, asl, shift_a, shift_b, alive, *,
                       detect_stats: bool = False, suspect: bool = False,
                       age_clamp: int = AGE_CLAMP):
    """K2: :func:`fused_merge_update_plain` for CPU tensors, the CUDA
    kernel for CUDA tensors (same contract; raises what it cannot run).
    ``view`` int8/int16 ``[N, C]``; ``edges`` int32 ``[N, F]`` in
    ``[0, N)``; ``hb`` int8/16/32 and ``asl`` int8 ``[N, C]``, updated in
    place; ``shift_a``/``shift_b`` int32 ``[C]``; ``alive`` bool ``[N]``.
    C = N on one device, the shard's columns under subject sharding."""
    f = _check_edges("fused_merge_update", view, edges, hb, asl, shift_a,
                     shift_b, alive, age_clamp)
    if hb.device.type == "cpu":
        return fused_merge_update_plain(
            view, edges, hb, asl, shift_a, shift_b, alive,
            detect_stats=detect_stats, suspect=suspect, age_clamp=age_clamp)
    if f > MAX_KERNEL_FANOUT:
        raise NotImplementedError(
            f"fused_merge_update: the CUDA kernel takes fanout <= "
            f"{MAX_KERNEL_FANOUT}, got {f}")
    return _launch("fused_merge_update", "fused_merge", "fm_merge", view,
                   edges, hb, asl, shift_a, shift_b, alive, f, detect_stats,
                   suspect, age_clamp)


def stripe_merge_update(view, edges, hb, asl, shift_a, shift_b, alive, *,
                        detect_stats: bool = False, suspect: bool = False,
                        age_clamp: int = AGE_CLAMP):
    """K5: :func:`stripe_merge_update_plain` for CPU tensors, the CUDA
    kernel for CUDA tensors.  Takes an int8 view only, and on the card
    N <= :data:`STRIPE_MAX_N` (:func:`stripe_admits`); the rest as
    :func:`fused_merge_update`."""
    f = _check_edges("stripe_merge_update", view, edges, hb, asl, shift_a,
                     shift_b, alive, age_clamp)
    if view.dtype != torch.int8:
        raise ValueError(f"stripe_merge_update: the view must be int8, got "
                         f"{view.dtype}")
    if hb.device.type == "cpu":
        return stripe_merge_update_plain(
            view, edges, hb, asl, shift_a, shift_b, alive,
            detect_stats=detect_stats, suspect=suspect, age_clamp=age_clamp)
    n = hb.shape[0]
    if n > STRIPE_MAX_N:   # rows: a column shard does not lift it
        raise NotImplementedError(
            f"stripe_merge_update: the CUDA kernel takes N <= "
            f"{STRIPE_MAX_N}; got N={n}")
    # every stripe's sweep reads every receiver's edges: the kernel takes
    # them as int16 (N <= STRIPE_MAX_N fits), half the bytes
    return _launch("stripe_merge_update", "stripe_merge", "sm_merge", view,
                   edges.to(torch.int16), hb, asl, shift_a, shift_b, alive,
                   f, detect_stats, suspect, age_clamp, init=False)


def arc_merge_update(view, bases, hb, asl, shift_a, shift_b, alive, *,
                     fanout: int, detect_stats: bool = False,
                     suspect: bool = False, age_clamp: int = AGE_CLAMP):
    """K4: :func:`arc_merge_update_plain` for CPU tensors, the CUDA kernel
    for CUDA tensors.  ``bases`` int32 ``[N]`` in ``[0, N)``; the rest as
    :func:`fused_merge_update`.  The kernel writes the window max to a
    scratch buffer of the view's shape and dtype."""
    n = hb.shape[0] if hb.dim() == 2 else -1
    _check_inputs("arc_merge_update", view,
                  {"bases": (bases, (torch.int32,), (n,))}, hb, asl,
                  shift_a, shift_b, alive, age_clamp)
    if not 1 <= fanout < n:
        raise ValueError(f"arc_merge_update: fanout must be in [1, N), got "
                         f"{fanout}")
    if hb.device.type == "cpu":
        return arc_merge_update_plain(
            view, bases, hb, asl, shift_a, shift_b, alive, fanout=fanout,
            detect_stats=detect_stats, suspect=suspect, age_clamp=age_clamp)
    return _launch("arc_merge_update", "arc_merge", "am_merge", view, bases,
                   hb, asl, shift_a, shift_b, alive, fanout, detect_stats,
                   suspect, age_clamp, scratch=torch.empty_like(view))
