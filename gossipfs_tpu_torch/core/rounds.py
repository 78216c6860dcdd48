"""The round loops: ``run_rounds`` and the single-round ``gossip_round``.

Two loops, picked from the configuration and the fault model
(:func:`route`):

* the LEAN loop, the port of the JAX package's rr scan
  (``core/rounds.py: _scan_rounds_rr_packed``) for its production
  profiles: gossip-only dissemination with fresh cooldown, all-int8 lanes
  and no matrix events (crash-stop faults only), with or without the SWIM
  lifecycle and its Lifeguard lane, over the aligned-arc headline topology
  or, under a ``pallas_rr`` merge kernel, over explicit random edges
  (``SimConfig.packed_rr``/``suspicion_rr``) and plain arcs.  Each round
  is one call of the resident round (ops/merge.resident_round), which
  ticks, builds the gossip view, merges and reduces in place over the
  packed lanes: on the card in K3's one-pass form (f) where
  ``SimConfig.rr_resident`` and its fit take it (:func:`onepass`), else
  in the two-launch form.  Arc bases and churn draws for the whole
  horizon come in one batched pass before the loop, explicit edges one
  round at a time,
  and the per-round metrics stay on the device until the end.
  :func:`run_lean_packed` is the loop's core, which takes and returns the
  carried per-receiver counts (the detectors thread them between calls).
* the SEPARATE-PASS loop, the port of the JAX package's general scan
  (``_scan_rounds`` off the rr path, with ``_round_core``), for everything
  else: ring edges, the other merge kernels' random edges and arcs,
  int16/int32 lanes, REMOVE broadcast, the reference cooldown, rounds
  with matrix events (LEAVE broadcast, joins through the introducer), each
  with or without suspicion.  Each round runs the events, the tick and the
  gossip-view build as PyTorch stages over row chunks of the lanes, in
  place, then one merge kernel (ops/merge_update), picked by
  :func:`merge_kernel`: K4 for arcs, K5 for the explicit edges of
  ``pallas_stripe``/``pallas_rr`` configurations it admits, K2 for the
  other explicit edges.

Both loops replay the JAX package bit for bit: the same threefry keys per
round (``k = fold_in(key, round)``, ``(k_edge, k_churn) = split(k)``) and
integer arithmetic throughout (the Lifeguard compare is the JAX package's
float32 one).  The configuration picks the kernel, and the tensors'
device picks kernel or plain version.

Both loops run on a column shard too (``ctx``, a :class:`ShardCtx`; the
JAX package's subject-axis ``shard_map``, ``parallel/mesh.py``): a rank
holds every receiver row of the ``[N, N]`` lanes for its contiguous block
of ``nloc`` subject columns, so the sender-row gather stays on the rank.
The diagonal sits at global row ``offset + j`` of local column ``j``; the
per-subject vectors (``hb_base``, the carry) are the shard's ``[nloc]``,
while ``alive``, the round counter, the edges, the arc bases and the
churn draws are replicated (every rank draws them from the same key).
The only per-round communication is the sum of the per-receiver counts
(listed, and SUSPECT on the Lifeguard lane); the round metrics are summed
once, after the loop.

Both loops take a fault scenario (``scenario=``, a compiled
``scenarios.tensor.TensorScenario``: partitions, link loss, slow and
flapping senders, rack outages).  Faults touch transport only: explicit
edges (random, ring) are rewritten by ``filter_edges`` before the merge
(a dropped message's edge points at the receiver, a no-op merge), with
the loss draws from ``k_scn = fold_in(k, 0x5CE)``; aligned arcs take
``arc_match_edges``' (base, group-match mask) pairs and ``sends_mask``'s
sender mute: on the lean loop through the resident round's
``edge_filter`` form (the mute on flags bit 3), on the separate-pass loop
through the masked group max ``ops.merge.arc_group_window_max`` in torch
ops (the JAX package runs that case in XLA, outside any Pallas kernel).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import (
    AGE_CLAMP, INT8_REBASE_WINDOW, REBASE_WINDOW, SimConfig)
from gossipfs_tpu_torch.core import topology
from gossipfs_tpu_torch.core.state import (
    FAILED, HB_DTYPES, MEMBER, SUSPECT, UNKNOWN, RoundEvents, SimState,
    init_state, listed, member_counts, suspect_counts, swar_lanes_ok)
from gossipfs_tpu_torch.ops import merge, merge_update, swar
from gossipfs_tpu_torch.ops.merge_update import row_chunks
from gossipfs_tpu_torch.scenarios import tensor as scn


# the shards' all-reduces since the last reset: how many, and their host
# seconds (a rank waits there for the slowest rank too)
COLLECTIVES = {"calls": 0, "seconds": 0.0}


class ShardCtx(NamedTuple):
    """Where a rank's lanes sit under subject-axis (column) sharding (the
    JAX package's ``ShardCtx``, core/rounds.py:69).

    ``offset`` is the shard's first global subject, ``nloc`` its column
    count (None: all N, one device), ``group`` the ``torch.distributed``
    process group the shards sum over (None: local, nothing to sum)."""

    offset: int = 0
    nloc: int | None = None
    group: object = None

    def cols(self, n: int) -> int:
        """The shard's column count in an N-node cluster."""
        return n if self.nloc is None else self.nloc

    def slice_cols(self, v: torch.Tensor) -> torch.Tensor:
        """This shard's slice of a replicated per-subject vector (its last
        axis)."""
        if self.nloc is None:
            return v
        return v[..., self.offset:self.offset + self.nloc]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum a per-shard partial (an int32 tensor) over the shards, in
        place; the identity when local."""
        if self.group is None:
            return x
        t0 = time.perf_counter()
        if x.is_cuda and dist.get_backend(self.group) == "gloo":
            # ranks sharing one card run gloo, which reduces host buffers
            # (its CUDA path stages through the host as well): move the
            # vector through the host explicitly
            h = x.cpu()
            t0 = time.perf_counter()    # after the copy's wait for the card
            dist.all_reduce(h, group=self.group)
            x.copy_(h)
        else:
            dist.all_reduce(x, group=self.group)
        COLLECTIVES["calls"] += 1
        COLLECTIVES["seconds"] += time.perf_counter() - t0
        return x


LOCAL_CTX = ShardCtx()


def _diag(x: torch.Tensor, ctx: ShardCtx = LOCAL_CTX) -> torch.Tensor:
    """Each local subject's own entry (receiver == subject): ``x[offset +
    j, j]`` of ``[N, C]`` lanes (the JAX package's ``_diag``)."""
    return torch.diagonal(x[ctx.offset:ctx.offset + x.shape[1]])


class RoundMetrics(NamedTuple):
    """Per-round scalar observables, stacked over the horizon (int32 [R]).

    Under suspicion ``true_detections``/``false_positives`` count SUSPECT ->
    FAILED confirmations and the three suspicion counters are live; with
    suspicion off they are zeros."""

    true_detections: torch.Tensor   # detector fired on an actually-dead subject
    false_positives: torch.Tensor   # detector fired on a live subject
    n_alive: torch.Tensor
    suspects_entered: torch.Tensor  # entries newly marked SUSPECT this round
    refutations: torch.Tensor       # SUSPECT entries refuted (-> MEMBER)
    fp_suppressed: torch.Tensor     # refutations of actually-alive subjects


class MetricsCarry(NamedTuple):
    """Per-subject first-detection / convergence rounds (int32 [N], -1
    until the event happens), carried across rounds and across calls.

    ``first_observer`` is the lowest-index observer whose detector fired
    in the first detecting round; ``converged`` the first round every live
    observer had dropped the subject (a SUSPECT holder has not);
    ``first_suspect`` the first round of the suspicion episode some
    observer holds the subject SUSPECT in (-1 while suspicion is off).  All
    four reset to -1 when the subject rejoins."""

    first_detect: torch.Tensor
    first_observer: torch.Tensor
    converged: torch.Tensor
    first_suspect: torch.Tensor

    @staticmethod
    def init(n: int, device="cuda") -> "MetricsCarry":
        neg = torch.full((n,), -1, dtype=torch.int32, device=device)
        return MetricsCarry(neg, neg.clone(), neg.clone(), neg.clone())


def _round_stats(n_det: torch.Tensor, alive: torch.Tensor,
                 sus: tuple | None = None,
                 ctx: ShardCtx = LOCAL_CTX) -> tuple:
    """One round's six RoundMetrics scalars: true/false detections and
    n_alive, then the suspicion counters ``sus`` = (per-subject entered,
    per-subject refuted) reduced here (zeros without suspicion).  On a
    shard every count but ``n_alive`` covers the shard's subjects only:
    :func:`_stack_metrics` sums them over the shards."""
    z = n_det.new_zeros(())
    alive_l = ctx.slice_cols(alive)
    stats = (torch.where(alive_l, z, n_det).sum(dtype=torch.int32),
             torch.where(alive_l, n_det, z).sum(dtype=torch.int32),
             alive.sum(dtype=torch.int32))
    if sus is None:
        return stats + (z, z, z)
    entered, refuted = sus
    return stats + (entered.sum(dtype=torch.int32),
                    refuted.sum(dtype=torch.int32),
                    torch.where(alive_l, refuted, z).sum(dtype=torch.int32))


def _update_carry(carry: MetricsCarry, alive: torch.Tensor,
                  any_fail: torch.Tensor, first_obs_now: torch.Tensor,
                  round_idx: int, member_col: torch.Tensor,
                  rejoined: torch.Tensor | None = None,
                  any_suspect: torch.Tensor | None = None,
                  ctx: ShardCtx = LOCAL_CTX) -> MetricsCarry:
    """Fold one round into the carry (per local subject, like its
    inputs; ``alive`` and ``rejoined`` are the replicated ``[N]`` masks).
    ``member_col`` is the per-subject count of live non-self observers
    still listing the subject; ``rejoined`` the joins that took effect
    this round (a new incarnation starts a new clock), None when the round
    had no matrix events; ``any_suspect`` (suspicion runs) whether some
    observer holds the subject SUSPECT after the merge."""
    first_detect, first_observer, converged, first_suspect = carry
    alive = ctx.slice_cols(alive)
    if rejoined is not None:
        rejoined = ctx.slice_cols(rejoined)
        first_detect, first_observer, converged, first_suspect = (
            torch.where(rejoined, -1, f) for f in carry)
    fresh = (first_detect < 0) & any_fail
    first_observer = torch.where(fresh, first_obs_now, first_observer)
    first_detect = torch.where(fresh, round_idx, first_detect)
    if any_suspect is not None:
        # episode semantics: a suspicion that cleared with no confirm
        # (every observer refuted) ends its episode and resets the clock;
        # after a confirm (first_detect set just above) the stamp freezes
        first_suspect = torch.where((first_detect < 0) & ~any_suspect, -1,
                                    first_suspect)
        first_suspect = torch.where((first_suspect < 0) & any_suspect,
                                    round_idx, first_suspect)
    all_dropped = (member_col == 0) & ~alive
    converged = torch.where((converged < 0) & all_dropped, round_idx,
                            converged)
    return MetricsCarry(first_detect, first_observer, converged, first_suspect)


def _rebase_shifts_vec(hb_dtype: torch.dtype, basec: torch.Tensor,
                       config: SimConfig, colmax_est: torch.Tensor):
    """Per-subject (shift_a, shift_b, store_base), int32 [N]: ``shift_a``
    maps the stored encoding to the view's, ``shift_b`` the old stored base
    to this round's.  Both bases follow ``colmax_est`` (the subject's own
    counter + 1), down too after a rejoin; int32 lanes store true counters
    (base 0)."""
    view_base = torch.clamp(colmax_est - config.rebase_window, min=0)
    if hb_dtype == torch.int32:
        store_base = torch.zeros_like(basec)
    else:
        window = REBASE_WINDOW if hb_dtype == torch.int16 else INT8_REBASE_WINDOW
        store_base = torch.clamp(colmax_est - window, min=0)
    return view_base - basec, store_base - basec, store_base


def rr_packed_init(config: SimConfig, member_mask=None, device="cuda"):
    """Fully-joined packed initial state in the lean loop's own layout:
    (hb, asl, alive, hb_base, round, counts), ``counts`` the per-receiver
    listed counts.  Nodes outside ``member_mask`` start dead and unknown
    everywhere."""
    st = init_state(config, member_mask, device=device)
    n_live = st.alive.sum(dtype=torch.int32)
    counts = torch.where(st.alive, n_live, 0).to(torch.int32)
    return st.hb, st.asl, st.alive, st.hb_base, st.round, counts


def _lean_ok(config: SimConfig, matrix_events: bool, scenario=None,
             nloc: int | None = None) -> bool:
    """Whether ``run_rounds`` takes the lean resident-round loop: the JAX
    package's rr gate (``_use_rr``, less its TPU admissibility: a
    ``pallas_rr`` merge kernel, ``fused_tick="auto"``, random edges or
    arcs) or the aligned-arc headline profile, each with all-int8 lanes,
    fresh cooldown, no REMOVE broadcast and no matrix events.  The CUDA
    resident round takes ``C % 4 == 0`` over its C subject columns (``N``
    on one device, a shard's ``nloc``: the JAX package's ``_use_rr(config,
    n, nloc)``), so a ragged width runs the separate-pass round (same
    outputs).  Under a ``scenario`` an arc run stays only where the
    ``edge_filter`` form exists: aligned arcs of at most
    ``merge.ARC_MATCH_MAX_GROUPS`` window groups (the JAX package's
    ``_rr_scan_eligible``)."""
    cols = config.n if nloc is None else nloc
    if (matrix_events or config.hb_dtype != "int8"
            or not config.fresh_cooldown or config.remove_broadcast
            or config.n % merge.KERNEL_VEC or cols % merge.KERNEL_VEC):
        return False
    if scenario is not None and config.topology == "random_arc":
        return (config.arc_align > 1 and config.fanout // config.arc_align
                <= merge.ARC_MATCH_MAX_GROUPS)
    if config.topology == "random_arc" and config.arc_align > 1:
        return True
    return (config.merge_kernel.startswith("pallas_rr")
            and config.fused_tick == "auto"
            and config.topology in ("random", "random_arc"))


def _lean_form(config: SimConfig, scenario=None) -> str:
    """The resident round's merge form on the lean loop
    (ops/merge.kernel_form): an armed arc run takes an ``edge_filter``
    form, an armed explicit-edge run the ``edges`` form on rewritten
    edges; ``elementwise="swar"`` adds ``/swar``."""
    arc = config.topology == "random_arc"
    return merge.kernel_form(config.fanout if arc else None,
                             config.arc_align, scenario is not None and arc,
                             config.elementwise)


def onepass_refusal(config: SimConfig, scenario=None,
                    nloc: int | None = None) -> str | None:
    """Why K3's one-pass form (f) cannot run the lean rounds of ``config``
    over ``nloc`` subject columns (None: all N) under ``scenario``: None
    where it can, and where the configuration takes no lean round."""
    if not _lean_ok(config, False, scenario, nloc):
        return None
    form = _lean_form(config, scenario).split("/")[0]
    cols = config.n if nloc is None else nloc
    return merge.onepass_refusal(config.n, cols, form, config.elementwise)


def onepass(config: SimConfig, scenario=None,
            nloc: int | None = None) -> bool:
    """Whether the lean loop runs its rounds of ``config`` on K3's one-pass
    form (f) (the JAX package's ``resident`` gate,
    gossipfs_tpu/core/rounds.py:1848):
    ``rr_resident="auto"`` wherever ops/merge.onepass_fits holds the
    shape, ``"on"`` always (``ValueError`` where it does not: no round
    routed to (f) quietly runs the two-launch form), ``"off"`` never."""
    if config.rr_resident == "off":
        return False
    why = onepass_refusal(config, scenario, nloc)
    if why is not None and config.rr_resident == "on":
        raise ValueError(f"rr_resident='on': {why}")
    return why is None


def route(config: SimConfig, matrix_events: bool = False,
          scenario=None, nloc: int | None = None) -> tuple[str, str]:
    """The loop ``run_rounds`` takes and the kernel it launches on the
    card, from the configuration, whether a ``scenario`` is armed and the
    shard's column count ``nloc`` (None: one device, all N):
    ``("lean", form)`` with the resident round's merge form
    (:func:`_lean_form`), ``/onepass`` appended where :func:`onepass`
    takes K3's one-pass form (``aligned_group/swar/onepass``), or
    ``("separate", name)`` with the merge of :func:`merge_kernel`."""
    if _lean_ok(config, matrix_events, scenario, nloc):
        form = _lean_form(config, scenario)
        if onepass(config, scenario, nloc):
            form += "/onepass"
        return "lean", form
    return "separate", merge_kernel(config, scenario is not None)


def run_rounds(state: SimState, config: SimConfig, num_rounds: int,
               key: torch.Tensor, events: RoundEvents | None = None,
               crash_rate: float = 0.0, rejoin_rate: float = 0.0,
               churn_ok: torch.Tensor | None = None,
               mcarry0: MetricsCarry | None = None,
               crash_only_events: bool = False, scenario=None,
               plain: bool = False, ctx: ShardCtx = LOCAL_CTX):
    """Run ``num_rounds`` gossip rounds on the state's device.

    The JAX package's ``run_rounds`` contract: ``events`` are scheduled
    ``[R, N]`` masks (crash, LEAVE broadcast, join through the
    introducer); ``crash_rate``/``rejoin_rate`` add random crash-stop and
    rejoin churn (``churn_ok`` masks who may churn); ``mcarry0`` continues
    a carry from an earlier call.  ``crash_only_events=True`` promises a
    schedule without joins (leave bits then mean silent death) and keeps
    the lean fault model; a join bit under it raises.  ``scenario`` is a
    compiled ``scenarios.tensor.TensorScenario`` (or None): the run keeps
    its configured loop and kernel, and only the capability matrix is
    checked first (``scenarios.tensor.require_scenario_config``).
    ``plain=True`` runs every kernel through its plain PyTorch version on
    any device: the reference the CUDA kernels are held against.  ``ctx``
    runs the rounds on one column shard (``parallel/mesh.py``
    ``run_rounds_sharded`` is the entry point): the state's lanes are then
    ``[N, nloc]`` and its ``hb_base`` ``[nloc]``, and the carry comes back
    per local subject.

    The lanes of ``state`` are updated IN PLACE; the returned state shares
    them.  Returns (state, MetricsCarry, RoundMetrics).
    """
    if scenario is not None:
        scn.require_scenario_config(config, scenario)
    n = config.n
    if state.hb.shape != (n, ctx.cols(n)):
        raise ValueError(f"state is {tuple(state.hb.shape)}, config n={n}, "
                         f"shard columns {ctx.cols(n)}")
    if state.hb.dtype != HB_DTYPES[config.hb_dtype]:
        raise ValueError(f"state hb is {state.hb.dtype}, config hb_dtype="
                         f"{config.hb_dtype!r}")
    if events is not None:
        if events.crash.shape != (num_rounds, n):
            raise ValueError(f"events must be [{num_rounds}, {n}]")
        if crash_only_events and bool(events.join.any()):
            raise ValueError(
                "crash_only_events=True ignores events.join, but the "
                "schedule contains join bits: drop the flag or the joins")
    # joins and LEAVE broadcasts rewrite whole rows and columns
    matrix_events = ((events is not None and not crash_only_events)
                     or rejoin_rate > 0.0)
    lean = _lean_ok(config, matrix_events, scenario, ctx.nloc)
    run = _run_lean if lean else _run_general
    return run(state, config, num_rounds, key, events, crash_rate,
               rejoin_rate, churn_ok, mcarry0, matrix_events, plain,
               scenario, ctx)


# ---------------------------------------------------------------------------
# The lean loop (resident round)
# ---------------------------------------------------------------------------


def _run_lean(state, config, num_rounds, key, events, crash_rate,
              rejoin_rate, churn_ok, mcarry0, matrix_events, plain,
              scenario=None, ctx: ShardCtx = LOCAL_CTX):
    crash = None
    if events is not None:
        # crash-only: a leave bit is a silent death
        crash = events.crash | events.leave
    hb, asl, alive, hb_base, rnd, _, _, mc, metrics = run_lean_packed(
        state.hb, state.asl, state.alive, state.hb_base, int(state.round),
        config, key, num_rounds, crash=crash, crash_rate=crash_rate,
        churn_ok=churn_ok, mcarry0=mcarry0, plain=plain, scenario=scenario,
        ctx=ctx)
    out = SimState(hb=hb, asl=asl, alive=alive, round=rnd, hb_base=hb_base)
    return out, mc, metrics


def run_lean_packed(hb, asl, alive0, hb_base0, round0: int,
                    config: SimConfig, key: torch.Tensor, num_rounds: int,
                    crash: torch.Tensor | None = None,
                    crash_rate: float = 0.0,
                    churn_ok: torch.Tensor | None = None,
                    mcarry0: MetricsCarry | None = None,
                    counts0: torch.Tensor | None = None,
                    sus_counts0: torch.Tensor | None = None,
                    plain: bool = False, scenario=None,
                    ctx: ShardCtx = LOCAL_CTX) -> tuple:
    """The lean loop's core over the packed lanes (the JAX package's
    ``_scan_rounds_rr_packed``), for a configuration :func:`_lean_ok`
    admits.

    ``hb``/``asl`` int8 ``[N, N]`` lanes, updated IN PLACE; ``alive0``,
    ``hb_base0`` and ``round0`` the rest of the state; ``crash`` an
    optional bool ``[num_rounds, N]`` schedule of silent deaths;
    ``crash_rate``/``churn_ok`` random crash-stop churn.  ``counts0`` is
    the carried per-receiver listed count and, on the Lifeguard lane,
    ``sus_counts0`` the carried SUSPECT count: each round's post-merge
    counts are the next round's pre-tick ones, so a caller that advances
    round by round threads them back in; None recounts them from the
    lanes (one ``[N, N]`` pass).  Returns (hb, asl, alive, hb_base, round,
    counts, sus_counts, MetricsCarry, RoundMetrics), ``sus_counts`` None
    off the Lifeguard lane.

    ``scenario`` (a ``TensorScenario``): explicit edges are rewritten by
    ``filter_edges`` block by block as they are drawn; aligned arcs run
    the resident round's ``edge_filter`` form on ``arc_match_edges``'
    (base, mask) pairs with ``~sends_mask`` on flags bit 3.  The rule
    table depends only on the round number, so the masks and mutes of
    the whole horizon come from one batched pass, like the bases.

    ``ctx`` (a column shard): ``hb``/``asl`` are ``[N, nloc]``,
    ``hb_base0``/``mcarry0`` the shard's per-subject slices, ``counts0`` and
    ``sus_counts0`` whole (summed over the shards).  The resident round
    runs its column-shard form (``col_offset``), its per-receiver counts
    are the shard's partials, and one all-reduce a round sums them before
    the next round's small-group and Lifeguard flags (the JAX package's
    ``ctx.psum`` of ``rcnt``, core/rounds.py:1999, :2005)."""
    n, dev = config.n, hb.device
    explicit = config.topology == "random"
    if crash is not None:
        crash = crash.to(device=dev, dtype=torch.bool)

    # per round k = fold_in(key, round), (k_edge, k_churn) = split(k): arc
    # bases and churn uniforms for the whole horizon in one batched pass,
    # explicit [N, F] edges in blocks of rounds (a horizon of them at
    # N = 16,384 would be hundreds of MB)
    rnds = torch.arange(round0, round0 + num_rounds, dtype=torch.int64,
                        device=dev)
    kr = trandom.fold_in(key.to(dev), rnds)
    ks = trandom.split(kr)
    muted_all = None
    if explicit:
        senders_all = _edge_blocks(config, ks[:, 0], scenario, rnds, kr)
    else:
        bases_all = topology.in_edges(config, ks[:, 0])      # int32 [R, N]
        if scenario is not None:
            bases_all = scn.arc_match_edges(
                scenario, bases_all, rnds, config.fanout, config.arc_align)
            muted_all = ~scn.sends_mask(scenario, n, rnds)   # bool [R, N]
        senders_all = iter(bases_all)
    crash_u = None
    if crash_rate > 0.0:
        churn_keys = trandom.split(ks[:, 1])
        crash_u = trandom.uniform(churn_keys[:, 0], (n,))    # f32 [R, N]
        rate = torch.tensor(crash_rate, dtype=torch.float32, device=dev)
        if churn_ok is not None:
            churn_ok = churn_ok.to(device=dev, dtype=torch.bool)

    alive = alive0.to(device=dev, dtype=torch.bool)
    hb_base = hb_base0.to(device=dev, dtype=torch.int32)
    sus = config.suspicion
    lh = sus is not None and sus.lh_multiplier > 0
    lanes = SimState(hb=hb, asl=asl, alive=alive, round=round0,
                     hb_base=hb_base)
    counts = (counts0 if counts0 is not None
              else member_counts(lanes, sus is not None, ctx))
    sus_counts = None
    sus_kw = {}
    if sus is not None:
        sus_kw = dict(suspect=True, t_suspect=sus.t_suspect,
                      lh_multiplier=sus.lh_multiplier)
    if lh:
        sus_counts = (sus_counts0 if sus_counts0 is not None
                      else suspect_counts(lanes, ctx))
        lh_frac = torch.tensor(sus.lh_frac, dtype=torch.float32, device=dev)
    mc = (mcarry0 if mcarry0 is not None
          else MetricsCarry.init(hb.shape[1], dev))
    round_fn = merge.resident_round_plain if plain else merge.resident_round
    senders_kw = (dict() if explicit
                  else dict(fanout=config.fanout, arc_align=config.arc_align,
                            edge_filter=scenario is not None))
    # _lean_ok's C % 4 == 0 and int8 lanes are what the SWAR form packs
    senders_kw.update(elementwise=config.elementwise, col_offset=ctx.offset)
    if not plain:
        senders_kw.update(onepass=onepass(config, scenario, ctx.nloc))
    per_round = []
    for r in range(num_rounds):
        dead = None
        if crash is not None:
            dead = crash[r]
        if crash_u is not None:
            c2 = alive & (crash_u[r] < rate)
            if churn_ok is not None:
                c2 = c2 & churn_ok
            dead = c2 if dead is None else dead | c2
        if dead is not None:
            alive = alive & ~dead
        small = counts < config.min_group
        active = alive & ~small
        refresher = alive & small
        colmax_est = _diag(hb, ctx).to(torch.int32) + hb_base + 1
        sa, sb, store_base = _rebase_shifts_vec(hb.dtype, hb_base, config,
                                                colmax_est)
        vecs = merge.threshold_stack(sa, sb, config.hb_grace - hb_base,
                                     config.rebase_window)
        flags = (active.to(torch.int8) + refresher.to(torch.int8) * 2
                 + alive.to(torch.int8) * 4)
        if lh:
            # Lifeguard: the JAX package's float32 compare over the
            # carried (pre-tick) counts, riding flags bit 4
            degraded = sus_counts.float() > lh_frac * counts.float()
            flags = flags + degraded.to(torch.int8) * 16
        if muted_all is not None:
            # scenario mute: the sender's view row encodes absent, its
            # own tick (and its receiving) runs as ever
            flags = flags + muted_all[r].to(torch.int8) * 8
        senders = next(senders_all)
        res = round_fn(
            hb, asl, flags, vecs, senders, t_fail=config.t_fail,
            t_cooldown=config.t_cooldown, age_clamp=AGE_CLAMP, **senders_kw,
            **sus_kw)
        cnt_incl, n_det, first_obs, counts = res[2:6]
        any_sus = None
        if sus is not None:
            entered, refuted, held = res[6:9]
            any_sus = held > 0
            if lh:
                sus_counts = res[9]
        if ctx.group is not None:
            # the round's one collective: the per-receiver partials
            if lh:
                both = ctx.psum(torch.cat([counts, sus_counts]))
                counts, sus_counts = both[:n], both[n:]
            else:
                counts = ctx.psum(counts)
        per_round.append(_round_stats(
            n_det, alive, None if sus is None else (entered, refuted), ctx))
        # the diagonal is never SUSPECT: the MEMBER test is the listed one
        self_member = (ctx.slice_cols(alive)
                       & ((_diag(asl, ctx) & 3) == MEMBER))
        member_col = cnt_incl - self_member.to(torch.int32)
        mc = _update_carry(mc, alive, n_det > 0, first_obs, round0 + r,
                           member_col, any_suspect=any_sus, ctx=ctx)
        hb_base = store_base

    return (hb, asl, alive, hb_base, round0 + num_rounds, counts,
            sus_counts, mc, _stack_metrics(per_round, dev, ctx))


# explicit edges drawn per block of rounds: one batch of threefry ops for
# up to this many edges (16 MB of int32, 32 MB per int64 temporary)
EDGE_BLOCK = 1 << 22


# the scenario engine's per-round key: k_scn = fold_in(k, 0x5CE)
SCN_FOLD = 0x5CE


def _edge_blocks(config: SimConfig, keys: torch.Tensor, scenario=None,
                 rnds: torch.Tensor | None = None,
                 round_keys: torch.Tensor | None = None):
    """Each round's int32 ``[N, F]`` random in-edges for the edge keys
    ``[R, 2]``, drawn a block of rounds at a time: the same draws as one
    ``topology.in_edges`` call per round, with the draw's launches shared
    by the block.  Under a ``scenario`` each block is rewritten by
    ``filter_edges`` (rounds ``rnds`` ``[R]``, the loss draws keyed off
    the per-round keys ``round_keys`` ``[R, 2]``) before it is handed
    out."""
    per = max(1, EDGE_BLOCK // (config.n * config.fanout))
    for r0 in range(0, keys.shape[0], per):
        edges = topology.in_edges(config, keys[r0:r0 + per])
        if scenario is not None:
            k_scn = trandom.fold_in(round_keys[r0:r0 + per], SCN_FOLD)
            edges = scn.filter_edges(scenario, edges, rnds[r0:r0 + per],
                                     k_scn)
        yield from edges


def _stack_metrics(per_round: list, dev,
                   ctx: ShardCtx = LOCAL_CTX) -> RoundMetrics:
    """The horizon's RoundMetrics from the per-round scalars; on a shard
    the per-subject counts (every field but ``n_alive``, which is
    replicated) are summed over the shards here, in one all-reduce."""
    if not per_round:
        return RoundMetrics(*(torch.zeros((0,), dtype=torch.int32,
                                          device=dev) for _ in range(6)))
    m = torch.stack([torch.stack(c) for c in zip(*per_round)])   # [6, R]
    if ctx.group is not None:
        part = [i for i, f in enumerate(RoundMetrics._fields)
                if f != "n_alive"]
        m[part] = ctx.psum(m[part].contiguous())
    return RoundMetrics(*m)


# ---------------------------------------------------------------------------
# The separate-pass round: events, tick and view as PyTorch stages over row
# chunks of the lanes (in place, so the temporaries stay a few chunks of
# int32 at any N), then one merge kernel.  Each stage runs inside a
# ``record_function`` range named in STAGES, so a ``torch.profiler`` trace
# splits the round's device time by stage (chip_smoke.py phases 10-11).
# ---------------------------------------------------------------------------

STAGES = ("round.events", "round.tick", "round.edges", "round.view",
          "round.merge", "round.carry")


def _wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Wrap int32 values to the signed ``bits``-bit range (mod 2^bits),
    kept int32: the narrow lanes' arithmetic, made explicit."""
    if bits >= 32:
        return x
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def _unpack(asl_rows: torch.Tensor):
    """(status, age) int32 of packed rows."""
    p = asl_rows.to(torch.int32) + 128
    return p & 3, p >> 2


def _pack(status: torch.Tensor, age: torch.Tensor) -> torch.Tensor:
    return (((age << 2) | status) - 128).to(torch.int8)


def _apply_events(state: SimState, crash, leave, join,
                  config: SimConfig, ctx: ShardCtx = LOCAL_CTX) -> SimState:
    """Crash, LEAVE broadcast and join through the introducer, before the
    tick (the JAX package's ``_apply_events`` with matrix events).

    A leaver is marked FAILED by every live receiver listing it, suspects
    included under suspicion (keeping its age unless ``fresh_cooldown``).
    An effective join (the node is down and the introducer up) is appended
    by the introducer, added by every live receiver that does not hold it
    (a FAILED entry keeps it out), and takes the introducer's post-append
    list as its own fresh table (its MEMBER entries), its self entry
    included.  Narrow lanes first rebase the joiner's
    column to base 0, so its fresh heartbeat 0 is representable.  Rows are
    rewritten in place, chunk by chunk; the joiner template is taken from
    the introducer's row before any write.  On a column shard a joiner's
    row is rewritten over the shard's columns, and its column (and its
    rebase) on the shard that holds it only (the JAX package's
    ``_sj``/``ctx.slice_cols``, core/rounds.py:319-346)."""
    hb, asl, alive, hb_base = state.hb, state.asl, state.alive, state.hb_base
    n, c = hb.shape
    dev = hb.device
    info = torch.iinfo(hb.dtype)
    lo, hi = info.min, info.max
    narrow = hb.dtype != torch.int32
    sus_on = config.suspicion is not None
    leave = leave & alive
    alive_post = alive & ~(crash | leave)
    intro = config.introducer
    eff = join & ~alive_post & alive_post[intro]
    if not bool((leave | eff).any()):
        return state._replace(alive=alive_post)
    # the per-subject (column) views of the replicated masks
    leave_c, eff_c = ctx.slice_cols(leave), ctx.slice_cols(eff)
    new_base = torch.where(eff_c, 0, hb_base) if narrow else hb_base
    renorm = eff_c & (hb_base != 0)
    # the stored encoding of "true heartbeat 0" per subject
    hz = torch.clamp(-new_base, lo, 0)
    intro_add = eff.clone()
    intro_add[intro] = False
    intro_add = ctx.slice_cols(intro_add)
    cols = ctx.offset + torch.arange(c, device=dev)     # global subject ids
    row_ids = torch.arange(n, device=dev)

    def rows(r0: int, r1: int):
        h = hb[r0:r1].to(torch.int32)
        st, age = _unpack(asl[r0:r1])
        mark = alive[r0:r1, None] & listed(st, sus_on) & leave_c[None]
        st = torch.where(mark, FAILED, st)
        if config.fresh_cooldown:
            age = torch.where(mark, 0, age)
        if narrow:
            # old-incarnation lanes renormalise to base 0, clipped;
            # floor sentinels stay sentinels
            h = torch.where(renorm[None] & (h != lo),
                            torch.clamp(h + hb_base[None], lo, hi), h)
        if r0 <= intro < r1:
            k = intro - r0
            st[k] = torch.where(intro_add, MEMBER, st[k])
            h[k] = torch.where(intro_add, hz, h[k])
            age[k] = torch.where(intro_add, 0, age[k])
        add = alive_post[r0:r1, None] & (st == UNKNOWN) & eff_c[None]
        st = torch.where(add, MEMBER, st)
        h = torch.where(add, hz[None], h)
        age = torch.where(add, 0, age)
        return h, st, age

    h_i, st_i, _ = rows(intro, intro + 1)
    j_member = st_i[0] == MEMBER
    j_st = torch.where(j_member, MEMBER, UNKNOWN)
    j_h = torch.where(j_member, h_i[0], hz)
    for r0, r1 in row_chunks(n, c):
        h, st, age = rows(r0, r1)
        joiner = eff[r0:r1, None]
        st = torch.where(joiner, j_st[None], st)
        h = torch.where(joiner, j_h[None], h)
        age = torch.where(joiner, 0, age)
        self_entry = joiner & (cols[None] == row_ids[r0:r1, None])
        st = torch.where(self_entry, MEMBER, st)
        h = torch.where(self_entry, hz[None], h)
        hb[r0:r1] = h.to(hb.dtype)
        asl[r0:r1] = _pack(st, age)
    return state._replace(alive=alive_post | eff, hb_base=new_base)


def _pre_tick(state: SimState, config: SimConfig,
              ctx: ShardCtx = LOCAL_CTX):
    """(active, refresher, colmax_est, degraded): senders vs small-group
    refreshers from the receivers' list sizes, each subject's post-bump
    counter bound (its own diagonal + 1), the anchor of this round's
    rebase, and on the Lifeguard lane the receivers whose lists hold more
    than ``lh_frac`` of their listed entries SUSPECT (the JAX package's
    float32 compare; None off the lane).  Every count reads the whole
    row, so a shard sums its partials (one all-reduce)."""
    sus = config.suspicion
    lh = sus is not None and sus.lh_multiplier > 0
    counts = member_counts(state, sus is not None)
    if lh:
        counts = torch.cat([counts, suspect_counts(state)])
    counts = ctx.psum(counts)
    n = state.alive.shape[0]
    small = counts[:n] < config.min_group
    active = state.alive & ~small
    refresher = state.alive & small
    colmax_est = _diag(state.hb, ctx).to(torch.int32) + state.hb_base + 1
    degraded = None
    if lh:
        lh_frac = torch.tensor(sus.lh_frac, dtype=torch.float32,
                               device=counts.device)
        degraded = counts[n:].float() > lh_frac * counts[:n].float()
    return active, refresher, colmax_est, degraded


def _tick(state: SimState, config: SimConfig, active, refresher,
          stats: bool, degraded=None, ctx: ShardCtx = LOCAL_CTX):
    """The heartbeat tick, in place: small-group refresh, the
    sentinel-sticky self bump, detection (member, not self, past the
    grace, silent more than ``t_fail`` rounds), the REMOVE broadcast, and
    cooldown expiry.

    Under suspicion (the JAX package's SWIM branch) the refresh also
    reverts SUSPECT -> MEMBER, a stale MEMBER enters SUSPECT instead of
    failing, and a SUSPECT entry silent past ``t_fail + t_suspect * (1 +
    lh)`` confirms to FAILED; both masks read the pre-write status and the
    FAILED write lands last.  ``lh`` is the Lifeguard multiplier on the
    ``degraded`` rows (:func:`_pre_tick`: their pre-tick lists hold more
    than ``lh_frac`` of their listed entries SUSPECT; counted here when
    not given).

    Returns (n_det, first_obs, entered): with ``stats`` this round's
    detections (confirmations) per subject and the first firing receiver
    (0 where none fired, as ``argmax`` gives), else (None, None); under
    suspicion the per-subject count of entries that entered SUSPECT, else
    None.  The REMOVE broadcast needs every receiver's detections before
    any mark, so it takes a second pass over the chunks.

    ``config.elementwise="swar"`` runs :func:`_tick_swar` where the lanes
    pack (``swar_lanes_ok``: int8, N % 4 == 0), as the JAX package
    dispatches; a ragged N takes this lanes form."""
    sus = config.suspicion
    if degraded is None and sus is not None and sus.lh_multiplier > 0:
        degraded = _pre_tick(state, config, ctx)[3]
    if config.elementwise == "swar" and swar_lanes_ok(state.hb):
        return _tick_swar(state, config, active, refresher, stats, degraded,
                          ctx)
    hb, asl, alive, basec = state.hb, state.asl, state.alive, state.hb_base
    n, c = hb.shape
    dev = hb.device
    info = torch.iinfo(hb.dtype)
    lo, hi = info.min, info.max
    bits = hb.element_size() * 8
    narrow = hb.dtype != torch.int32
    if narrow:
        # hb > grace over true values, as a compare in the stored
        # encoding against a threshold clipped into the lane range
        thr = torch.clamp(config.hb_grace - basec + 1, lo, hi)
    else:
        thr = config.hb_grace - basec
    cols = ctx.offset + torch.arange(c, device=dev)     # global subject ids
    row_ids = torch.arange(n, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    removed = torch.zeros(c, dtype=torch.bool, device=dev)
    n_det = torch.zeros(c, **i32)
    fobs = torch.full((c,), n, **i32)
    entered = None
    if sus is not None:
        entered = torch.zeros(c, **i32)
        confirm_thr = config.t_fail + sus.t_suspect
    for r0, r1 in row_chunks(n, c):
        h = hb[r0:r1].to(torch.int32)
        st, age = _unpack(asl[r0:r1])
        rows = row_ids[r0:r1, None]
        eye = rows == cols[None]
        act = active[r0:r1, None]
        if degraded is not None:
            # Lifeguard: the stretched confirm age on degraded rows
            confirm_thr = (config.t_fail + sus.t_suspect * (
                1 + torch.where(degraded[r0:r1], sus.lh_multiplier,
                                0)))[:, None]
        ref_rows = refresher[r0:r1, None]
        age = torch.where(ref_rows & listed(st, sus is not None), 0, age)
        if sus is not None:
            st = torch.where(ref_rows & (st == SUSPECT), MEMBER, st)
        bump = eye & act & (st == MEMBER)
        if narrow:
            bump = bump & (h != lo)
        h = torch.where(bump, _wrap(h + 1, bits), h)
        age = torch.where(bump, 0, age)
        past = ((h >= thr[None]) & (h != lo)) if narrow else (h > thr[None])
        stale = act & ~eye & past & (age > config.t_fail)
        if sus is None:
            fail = stale & (st == MEMBER)
            st = torch.where(fail, FAILED, st)
        else:
            suspect_new = stale & (st == MEMBER)
            fail = act & ~eye & (st == SUSPECT) & (age > confirm_thr)
            st = torch.where(suspect_new, SUSPECT, st)
            st = torch.where(fail, FAILED, st)
            entered += suspect_new.sum(dim=0, dtype=torch.int32)
        if config.fresh_cooldown:
            age = torch.where(fail, 0, age)
        if config.remove_broadcast:
            removed |= fail.any(dim=0)
        else:
            st = torch.where((st == FAILED) & (age > config.t_cooldown),
                             UNKNOWN, st)
        if stats:
            n_det += fail.sum(dim=0, dtype=torch.int32)
            fobs = torch.minimum(
                fobs, torch.where(fail, rows.to(torch.int32), n).amin(dim=0))
        hb[r0:r1] = h.to(hb.dtype)
        asl[r0:r1] = _pack(st, age)
    if config.remove_broadcast:
        for r0, r1 in row_chunks(n, c):
            st, age = _unpack(asl[r0:r1])
            mark = alive[r0:r1, None] & (st == MEMBER) & removed[None]
            st = torch.where(mark, FAILED, st)
            if config.fresh_cooldown:
                age = torch.where(mark, 0, age)
            st = torch.where((st == FAILED) & (age > config.t_cooldown),
                             UNKNOWN, st)
            asl[r0:r1] = _pack(st, age)
    if not stats:
        return None, None, entered
    return n_det, torch.where(n_det > 0, fobs, 0), entered


def _eye_words(r0: int, r1: int, c: int, device,
               offset: int = 0) -> torch.Tensor:
    """Packed-word diagonal mask of rows ``r0..r1`` over ``c`` columns
    from global subject ``offset``: int32 ``[r, C/4]``, byte 0xFF where
    receiver == subject (byte k of word w is subject offset + 4w + k),
    from 4 word-width compares (the JAX package's ``_eye_words``)."""
    rows = torch.arange(r0, r1, dtype=torch.int32, device=device)[:, None]
    colw = torch.arange(offset, offset + c, 4, dtype=torch.int32,
                        device=device)[None]
    out = None
    for k, bm in enumerate(swar.BYTE):
        m = torch.where(rows == colw + k, bm, 0).to(torch.int32)
        out = m if out is None else out | m
    return out


def _tick_swar(state: SimState, config: SimConfig, active, refresher,
               stats: bool, degraded=None, ctx: ShardCtx = LOCAL_CTX):
    """:func:`_tick` on packed words (the JAX package's ``_tick_swar``): 4
    subjects per int32 op, the same bytes.  The JAX package keeps age and
    status in separate lanes; here both ride the packed age|status byte
    ``((age << 2) | status) - 128``, so every age threshold becomes one
    signed compare of that byte against ``((t << 2) | status) - 128``
    where the status is known (MEMBER for detection, SUSPECT for the
    confirm, FAILED for the expiry), and a status write keeps or zeroes
    the age bits.  Row masks (active, refresher, alive, the Lifeguard
    threshold) are uniform across a word; per-subject thresholds pack 4 to
    a word; only the diagonal differs per byte (:func:`_eye_words`).  The
    reductions (detections, first observer, suspects entered, the REMOVE
    broadcast's OR over receivers) read the masks back as bytes.  Same
    contract as :func:`_tick`."""
    hb, asl, alive, basec = state.hb, state.asl, state.alive, state.hb_base
    n, c = hb.shape
    dev = hb.device
    sus = config.suspicion
    if degraded is None and sus is not None and sus.lh_multiplier > 0:
        degraded = _pre_tick(state, config, ctx)[3]
    w = swar.word
    mem0, fail0 = w(MEMBER - 128), w(FAILED - 128)
    det_thr = w(((config.t_fail << 2) | MEMBER) - 128)
    cool_thr = w(((config.t_cooldown << 2) | FAILED) - 128)
    thrw = swar.pack(torch.clamp(config.hb_grace - basec + 1, -128, 127)
                     .to(torch.int8))
    i32 = dict(dtype=torch.int32, device=dev)
    removed = torch.zeros(c, dtype=torch.bool, device=dev)
    n_det = torch.zeros(c, **i32)
    fobs = torch.full((c,), n, **i32)
    entered = None
    if sus is not None:
        entered = torch.zeros(c, **i32)
        confirm_w = w(((config.t_fail + sus.t_suspect) << 2 | SUSPECT) - 128)

    def failed_word(aslw):
        # FAILED: the fresh cooldown stamps age 0, else the age is kept
        if config.fresh_cooldown:
            return fail0
        return (aslw & w(0xFC)) | w(FAILED)

    def expire(aslw):
        # cooldown expiry -> UNKNOWN (status bits 0), age kept
        exp = swar.eq(aslw & w(3), w(FAILED)) & swar.gts(aslw, cool_thr)
        return swar.sel(swar.to_bytes(exp), aslw & w(0xFC), aslw)

    for r0, r1 in row_chunks(n, c):
        hbw = swar.pack(hb[r0:r1])
        aslw = swar.pack(asl[r0:r1])
        act = swar.bool_mask(active[r0:r1])[:, None]
        ref = swar.bool_mask(refresher[r0:r1])[:, None]
        eye = _eye_words(r0, r1, c, dev, ctx.offset)
        st = aslw & w(3)
        stm = swar.eq(st, w(MEMBER))
        if sus is None:
            aslw = swar.sel(ref & swar.to_bytes(stm), st | swar.H, aslw)
        else:
            sus_pre = swar.eq(st, w(SUSPECT))
            if degraded is not None:
                # Lifeguard: the stretched confirm age on degraded rows
                age_thr = config.t_fail + sus.t_suspect * (
                    1 + torch.where(degraded[r0:r1], sus.lh_multiplier, 0))
                confirm_w = swar.splat((age_thr << 2 | SUSPECT) - 128)[:, None]
            # the refresh also reverts SUSPECT -> MEMBER
            aslw = swar.sel(ref & swar.to_bytes(stm | sus_pre), mem0, aslw)
        # the sentinel-sticky diagonal bump and its stamp
        bump = eye & act & swar.to_bytes(stm & swar.ne(hbw, swar.H))
        hbw = swar.add(hbw, bump & swar.L)
        aslw = swar.sel(bump, mem0, aslw)
        past = swar.ges(hbw, thrw) & swar.ne(hbw, swar.H)
        stale = act & ~eye & stm & past & swar.gts(aslw, det_thr)
        if sus is None:
            fail = stale
        else:
            fail = act & ~eye & sus_pre & swar.gts(aslw, confirm_w)
            aslw = aslw | (swar.to_bytes(stale) & w(2))   # -> SUSPECT
            entered += (swar.unpack(stale) != 0).sum(dim=0,
                                                     dtype=torch.int32)
        aslw = swar.sel(swar.to_bytes(fail), failed_word(aslw), aslw)
        fail_rows = swar.unpack(fail) != 0
        if config.remove_broadcast:
            removed |= fail_rows.any(dim=0)
        else:
            aslw = expire(aslw)
        if stats:
            n_det += fail_rows.sum(dim=0, dtype=torch.int32)
            rows = torch.arange(r0, r1, **i32)[:, None]
            fobs = torch.minimum(
                fobs, torch.where(fail_rows, rows, n).amin(dim=0))
        hb[r0:r1] = swar.unpack(hbw)
        asl[r0:r1] = swar.unpack(aslw)
    if config.remove_broadcast:
        # one detection removes the subject at every live receiver
        removed_w = swar.pack(torch.where(removed, -1, 0).to(torch.int8))
        for r0, r1 in row_chunks(n, c):
            aslw = swar.pack(asl[r0:r1])
            mark = (swar.bool_mask(alive[r0:r1])[:, None] & removed_w
                    & swar.to_bytes(swar.eq(aslw & w(3), w(MEMBER))))
            aslw = swar.sel(mark, failed_word(aslw), aslw)
            asl[r0:r1] = swar.unpack(expire(aslw))
    if not stats:
        return None, None, entered
    return n_det, torch.where(n_det > 0, fobs, 0), entered


def _gossip_view(state: SimState, senders, shift_a, config: SimConfig):
    """What each sender's datagram holds: its listed entries (MEMBER, and
    SUSPECT under suspicion) within the rebase window, encoded relative to
    ``shift_a``, -1 where absent, as an ``[N, C]`` tensor of the view
    dtype (C the lanes' subject columns).  Narrow lanes compare in the
    stored encoding against thresholds clipped into their range and wrap
    as the JAX package's narrow arithmetic does; int32 lanes compare true
    values."""
    hb, asl = state.hb, state.asl
    n, c = hb.shape
    vdt = torch.int8 if config.view_dtype == "int8" else torch.int16
    vbits = 8 if vdt == torch.int8 else 16
    view = torch.empty((n, c), dtype=vdt, device=hb.device)
    info = torch.iinfo(hb.dtype)
    lo, hi = info.min, info.max
    narrow = hb.dtype != torch.int32
    window = config.rebase_window
    if narrow:
        sa_n = _wrap(shift_a, hb.element_size() * 8)[None]
        # a shift below the lane range admits every stored value
        sa_all = (shift_a < lo)[None]
        # lanes above the subject's own counter are old-incarnation zombies
        hi_n = torch.clamp(shift_a + window, lo, hi)[None]
    for r0, r1 in row_chunks(n, c):
        h = hb[r0:r1].to(torch.int32)
        elig = (listed(asl[r0:r1] & 3, config.suspicion is not None)
                & senders[r0:r1, None])
        if narrow:
            goss = (elig & ((h >= sa_n) | sa_all) & (h <= hi_n)
                    & (h != lo))
            v = torch.where(goss, h - sa_n, -1)
        else:
            rel = h - shift_a[None]
            v = torch.where(elig & (rel >= 0) & (rel <= window), rel, -1)
        view[r0:r1] = _wrap(v, vbits).to(vdt)
    return view


def merge_kernel(config: SimConfig, armed: bool = False) -> str:
    """The merge kernel the separate-pass round launches, by the launch
    counters' names (ops/merge.LAUNCH_COUNTS), decided from the
    configuration, N and whether a scenario is ``armed``, before any
    launch:

    * ``arc_group_merge_update`` for ``random_arc`` under a scenario: the
      masked group max and the epilogue in torch ops on any device, no
      kernel launch (the JAX package runs these rounds in XLA: its arc
      kernels fuse the unfiltered window max);
    * ``arc_merge_update`` (K4) for any other ``random_arc`` round;
    * ``stripe_merge_update`` (K5) for ``random`` (explicit edges) when
      ``merge_kernel`` names the stripe family (``pallas_stripe*``,
      ``pallas_rr*``: the JAX package's ``_merge`` sends these rounds to its
      stripe kernel) and K5 admits the shape (an int8 view, N <=
      ``merge_update.STRIPE_MAX_N``: a bound on rows, which a column
      shard keeps whole, so sharding does not change the pick);
    * ``fused_merge_update`` (K2) for every other explicit-edge round:
      ``ring``, other ``merge_kernel`` values, int16 views, larger N.

    The three compute the same function; the plain versions follow the
    same rule.  Explicit edges are rewritten before the merge, so an
    armed run of them keeps its kernel."""
    if config.topology == "random_arc":
        return "arc_group_merge_update" if armed else "arc_merge_update"
    if (config.topology == "random"
            and config.merge_kernel.startswith(("pallas_stripe", "pallas_rr"))
            and merge_update.stripe_admits(config.n, config.view_dtype)):
        return "stripe_merge_update"
    return "fused_merge_update"


def _merge(state: SimState, edges, senders, colmax_est, config: SimConfig,
           detect_stats: bool, plain: bool, arc_match=None):
    """Rebase shifts, the gossip view, and the merge kernel in place on the
    lanes (:func:`merge_kernel`; arcs pass bases as ``edges``, or under a
    scenario ``arc_match``, the ``[N, 2]`` (base, match mask) pairs of the
    masked group form).  Returns
    (cnt_incl, n_det, first_obs, refuted, held, store_base), the suspicion
    reductions ``refuted``/``held`` None with suspicion off."""
    with record_function("round.view"):
        sa, sb, store_base = _rebase_shifts_vec(
            state.hb.dtype, state.hb_base, config, colmax_est)
        view = _gossip_view(state, senders, sa, config)
    args = (view, edges, state.hb, state.asl, sa, sb, state.alive)
    suspect = config.suspicion is not None
    kw = dict(detect_stats=detect_stats, suspect=suspect)
    name = merge_kernel(config, arc_match is not None)
    if name == "arc_merge_update":
        kw["fanout"] = config.fanout
    if name == "arc_group_merge_update":
        # torch ops whatever the device: there is no kernel to pick
        args = (view, arc_match) + args[2:]
        kw.update(fanout=config.fanout, align=config.arc_align,
                  elementwise=config.elementwise)
        fn = merge_update.arc_group_merge_update
    else:
        fn = getattr(merge_update, name + ("_plain" if plain else ""))
    with record_function("round.merge"):
        out = fn(*args, **kw)
    cnt_incl, n_det, first_obs = out[2:5]
    refuted, held = out[5:] if suspect else (None, None)
    return cnt_incl, n_det, first_obs, refuted, held, store_base


def _round_core(state: SimState, crash, leave, join, edges,
                config: SimConfig, matrix_events: bool, plain: bool,
                edge_filter=None, sends=None, arc_match=None,
                ctx: ShardCtx = LOCAL_CTX):
    """One separate-pass round (the JAX package's ``_round_core``).
    ``edge_filter`` rewrites explicit edges the caller has not filtered
    yet (the ring's, derived here from the post-tick tables);
    ``sends``/``arc_match`` are the aligned-arc scenario form: the sender
    mute (a muted sender's view row encodes absent) and the (base, match
    mask) pairs.
    Returns (state, n_det, stats, first_obs, member_col, rejoined,
    any_sus): ``n_det`` this round's detections per subject, ``stats`` the
    six RoundMetrics scalars, ``rejoined`` None without
    matrix events, ``any_sus`` (whether an observer still holds the
    subject SUSPECT after the merge) None with suspicion off.  The
    suspicion counters come from the tick (entered) and the merge kernel
    (refuted, held), with no ``[N, N]`` snapshot.  ``ctx``: one column
    shard; the per-subject outputs are the shard's, the scalars partial
    (:func:`_stack_metrics` sums them)."""
    alive_before = state.alive
    with record_function("round.events"):
        if matrix_events:
            state = _apply_events(state, crash, leave, join, config, ctx)
        else:
            state = state._replace(alive=state.alive & ~(crash | leave))
    # crash-only, fresh cooldown, gossip-only: this round's detections are
    # the post-tick FAILED entries at age 0, which the merge kernel counts
    det_ok = (not matrix_events and config.fresh_cooldown
              and not config.remove_broadcast)
    sus_on = config.suspicion is not None
    with record_function("round.tick"):
        active, refresher, colmax_est, degraded = _pre_tick(state, config,
                                                            ctx)
        n_det, first_obs, entered = _tick(state, config, active, refresher,
                                          not det_ok, degraded, ctx)
    if config.topology == "ring":
        with record_function("round.edges"):
            edges = topology.ring_edges_from_status(state.asl & 3, sus_on)
    if edge_filter is not None:
        with record_function("round.edges"):
            edges = edge_filter(edges)
    senders = active if sends is None else active & sends
    cnt_incl, k_ndet, k_fobs, refuted, held, store_base = _merge(
        state, edges, senders, colmax_est, config, det_ok, plain, arc_match)
    if det_ok:
        n_det, first_obs = k_ndet, k_fobs
    state = state._replace(hb_base=store_base, round=state.round + 1)
    # the diagonal is never SUSPECT: the MEMBER test is the listed one
    self_member = (ctx.slice_cols(state.alive)
                   & ((_diag(state.asl, ctx) & 3) == MEMBER))
    member_col = cnt_incl - self_member.to(torch.int32)
    rejoined = None
    if matrix_events:
        # joins lost to a dead introducer start no new clock
        rejoined = join & ~alive_before & state.alive
    stats = _round_stats(n_det, state.alive,
                         (entered, refuted) if sus_on else None, ctx)
    any_sus = held > 0 if sus_on else None
    return state, n_det, stats, first_obs, member_col, rejoined, any_sus


def gossip_round(state: SimState, events: RoundEvents, edges,
                 config: SimConfig, plain: bool = False):
    """Advance the whole cluster by one heartbeat period.

    ``events`` holds one round's bool ``[N]`` masks; ``edges`` are the
    round's in-edges: explicit ``[N, F]`` for ``random``, arc bases
    ``[N]`` for ``random_arc``, None for ``ring`` (derived from the
    post-tick tables).  Lanes are updated in place.  Returns (state,
    RoundMetrics of scalars, any_fail [N], first_obs [N]), ``first_obs``
    the lowest firing observer where ``any_fail``."""
    dev = state.hb.device
    crash, leave, join = (m.to(device=dev, dtype=torch.bool) for m in events)
    if edges is not None:
        edges = edges.to(device=dev, dtype=torch.int32)
    state, n_det, stats, first_obs, _, _, _ = _round_core(
        state, crash, leave, join, edges, config, True, plain)
    return state, RoundMetrics(*stats), n_det > 0, first_obs


def gossip_round_scenario(state: SimState, events: RoundEvents, edges,
                          config: SimConfig, tsc, key: torch.Tensor,
                          plain: bool = False):
    """One interactive round under an armed fault scenario: the contract
    of :func:`gossip_round`, plus ``tsc`` (a
    ``scenarios.tensor.TensorScenario``) and the round's key for the
    Bernoulli loss draws.  Aligned arcs take the group-granular form
    (sender mute and masked group max); explicit edges, the ring's
    included, are rewritten per edge."""
    dev = state.hb.device
    crash, leave, join = (m.to(device=dev, dtype=torch.bool) for m in events)
    rnd = int(state.round)
    if config.topology == "random_arc":
        bases = edges.to(device=dev, dtype=torch.int32)
        kw = dict(sends=scn.sends_mask(tsc, config.n, rnd),
                  arc_match=scn.arc_match_edges(tsc, bases, rnd,
                                                config.fanout,
                                                config.arc_align))
        edges = bases
    else:
        if edges is not None:
            edges = edges.to(device=dev, dtype=torch.int32)
        kw = dict(edge_filter=lambda e: scn.filter_edges(tsc, e, rnd, key))
    state, n_det, stats, first_obs, _, _, _ = _round_core(
        state, crash, leave, join, edges, config, True, plain, **kw)
    return state, RoundMetrics(*stats), n_det > 0, first_obs


def _run_general(state, config, num_rounds, key, events, crash_rate,
                 rejoin_rate, churn_ok, mcarry0, matrix_events, plain,
                 scenario=None, ctx: ShardCtx = LOCAL_CTX):
    n, dev = config.n, state.hb.device
    r0 = int(state.round)
    rnds = torch.arange(r0, r0 + num_rounds, dtype=torch.int64, device=dev)
    kr = trandom.fold_in(key.to(dev), rnds)                  # [R, 2]
    ks = trandom.split(kr)                                   # [R, 2, 2]
    bases_all = sends_all = match_all = k_scn = None
    if config.topology == "random_arc":
        bases_all = topology.in_edges(config, ks[:, 0])      # int32 [R, N]
        if scenario is not None:
            # the aligned-arc scenario form, the whole horizon at once
            sends_all = scn.sends_mask(scenario, n, rnds)
            match_all = scn.arc_match_edges(
                scenario, bases_all, rnds, config.fanout, config.arc_align)
    elif scenario is not None:
        k_scn = trandom.fold_in(kr, SCN_FOLD)                # [R, 2]
    churn = crash_rate > 0.0 or rejoin_rate > 0.0
    if churn:
        ck = trandom.split(ks[:, 1])
        crash_u = trandom.uniform(ck[:, 0], (n,))            # f32 [R, N]
        join_u = trandom.uniform(ck[:, 1], (n,))
        f32 = dict(dtype=torch.float32, device=dev)
        crash_p = torch.tensor(crash_rate, **f32)
        join_p = torch.tensor(rejoin_rate, **f32)
        if churn_ok is not None:
            churn_ok = churn_ok.to(device=dev, dtype=torch.bool)
    if events is not None:
        events = RoundEvents(*(m.to(device=dev, dtype=torch.bool)
                               for m in events))
    none = torch.zeros(n, dtype=torch.bool, device=dev)

    state = state._replace(alive=state.alive.to(torch.bool),
                           hb_base=state.hb_base.to(torch.int32))
    mc = (mcarry0 if mcarry0 is not None
          else MetricsCarry.init(state.hb.shape[1], dev))
    per_round = []
    for r in range(num_rounds):
        with record_function("round.events"):
            crash = leave = join = none
            if events is not None:
                crash, leave, join = (events.crash[r], events.leave[r],
                                      events.join[r])
            if churn:
                c2 = state.alive & (crash_u[r] < crash_p)
                j2 = ~state.alive & (join_u[r] < join_p)
                if churn_ok is not None:
                    c2, j2 = c2 & churn_ok, j2 & churn_ok
                crash = crash | c2
                if rejoin_rate > 0.0:
                    join = join | j2
        scn_kw = {}
        with record_function("round.edges"):
            if config.topology == "random":
                edges = topology.in_edges(config, ks[r, 0])  # int32 [N, F]
                if scenario is not None:
                    edges = scn.filter_edges(scenario, edges, r0 + r,
                                             k_scn[r])
            elif config.topology == "ring":
                edges = None
                if scenario is not None:
                    # the ring's edges derive from the post-tick tables
                    # inside the round: filtered there
                    scn_kw = dict(edge_filter=lambda e, r=r: scn.filter_edges(
                        scenario, e, r0 + r, k_scn[r]))
            else:
                edges = bases_all[r]
                if scenario is not None:
                    scn_kw = dict(sends=sends_all[r], arc_match=match_all[r])
        state, n_det, stats, first_obs, member_col, rejoined, any_sus = (
            _round_core(state, crash, leave, join, edges, config,
                        matrix_events, plain, ctx=ctx, **scn_kw))
        with record_function("round.carry"):
            per_round.append(stats)
            mc = _update_carry(mc, state.alive, n_det > 0, first_obs, r0 + r,
                               member_col, rejoined, any_sus, ctx)
    return state, mc, _stack_metrics(per_round, dev, ctx)
