"""Tensor-sim backend of the scenario engine: edge filters on the
sampled topology.

The port of the JAX package's ``scenarios/tensor.py``.  The round is
receiver-centric: ``edges[i, f]`` is the f-th sender whose row receiver
*i* max-merges this round (core/topology.py).  A dropped message is
therefore an EDGE REWRITE: the filtered edge points at the receiver
itself, and a self-edge merge is a no-op (the gossip view is built from
the same ticked state the receiver holds, so the strict ``advance``
compare rejects every value).  Nothing else about the round changes:
nodes keep ticking, bumping and detecting; only which rows reach which
receivers does.

Capability matrix, as in the JAX package:

* every merge path consumes filtered edges: the separate-pass kernels
  (K2, K5) and the resident round's explicit-edge form take the rewritten
  ``[N, F]`` edges as they are;
* ``random_arc`` with ``arc_align > 1``: partitions and the sender-global
  rules (slow and flapping senders) compose at GROUP granularity: an
  aligned arc is ``F/align`` whole groups, so align-group-closed
  partition sides give exactly per-edge semantics.
  :func:`arc_match_edges` builds the per-receiver group match masks,
  :func:`sends_mask` the sender mute.  Correlated outages compose exactly
  with no group-closure requirement: the rule splits into a sender-global
  mute (src in group, on :func:`sends_mask`) and a receiver-global one
  (dst in group: the receiver's match mask goes to zero).  Bernoulli loss
  draws are per edge and stay a ``random``-topology (or ring) capability:
  :func:`require_scenario_config` enforces the matrix per scenario;
* ``remove_broadcast`` must be off: the broadcast is an instantaneous
  column OR, not transport messages, so a partition could not filter it.

Scenario round numbers are relative to ARMING: :class:`TensorScenario`
carries ``round0`` (the absolute sim round at arming) and the filters
subtract it, so a scenario loaded mid-run keeps its schedule.

Every filter takes a BATCH of rounds (any leading shape on ``rnd``,
``edges``/``bases`` and ``key``), like the draws of
``gossipfs_tpu_torch.random``: the rule loops depend only on the round
number and the rule table, so the round loops evaluate them for a block
of rounds in one pass of a few device ops per rule, with no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.scenarios.schedule import FaultScenario


class TensorScenario(NamedTuple):
    """The compiled (device-tensor) form the filters consume.

    Rule counts are the leading shapes; an empty rule kind compiles to a
    zero-length leading axis and its loop runs no time.  The leaves and
    their dtypes are the JAX package's ``TensorScenario``'s.
    """

    round0: torch.Tensor       # int32 scalar: absolute round the scenario armed
    part_start: torch.Tensor   # int32 [P]
    part_end: torch.Tensor     # int32 [P]
    part_pid: torch.Tensor     # int32 [P, N]
    loss_start: torch.Tensor   # int32 [L]
    loss_end: torch.Tensor     # int32 [L]
    loss_rate: torch.Tensor    # float32 [L]
    loss_src: torch.Tensor     # bool [L, N]
    loss_dst: torch.Tensor     # bool [L, N]
    slow_start: torch.Tensor   # int32 [S]
    slow_end: torch.Tensor     # int32 [S]
    slow_stride: torch.Tensor  # int32 [S]
    slow_nodes: torch.Tensor   # bool [S, N]
    flap_start: torch.Tensor   # int32 [K]
    flap_end: torch.Tensor     # int32 [K]
    flap_up: torch.Tensor      # int32 [K]
    flap_period: torch.Tensor  # int32 [K]  (up + down)
    flap_nodes: torch.Tensor   # bool [K, N]
    out_start: torch.Tensor    # int32 [O]
    out_end: torch.Tensor      # int32 [O]
    out_nodes: torch.Tensor    # bool [O, N]


def compile_tensor(scenario: FaultScenario, round0: int = 0,
                   device="cuda") -> TensorScenario:
    """Compile a declarative scenario to the rule table on ``device``."""
    n = scenario.n

    def vec(values, dtype) -> torch.Tensor:
        return torch.tensor(list(values), dtype=dtype, device=device)

    def masks(node_sets) -> torch.Tensor:
        m = np.zeros((len(node_sets), n), dtype=bool)
        for row, nodes in zip(m, node_sets):
            row[list(nodes)] = True
        return torch.from_numpy(m).to(device)

    parts = scenario.partitions
    losses = scenario.link_faults
    slows = scenario.slow_nodes
    flaps = scenario.flapping
    outs = scenario.outages
    i32, f32 = torch.int32, torch.float32
    pids = (np.stack([p.pid(n) for p in parts], axis=0) if parts
            else np.zeros((0, n), np.int32))
    return TensorScenario(
        round0=torch.tensor(round0, dtype=i32, device=device),
        part_start=vec((p.start for p in parts), i32),
        part_end=vec((p.end for p in parts), i32),
        part_pid=torch.from_numpy(pids).to(device),
        loss_start=vec((f.start for f in losses), i32),
        loss_end=vec((f.end for f in losses), i32),
        loss_rate=vec((f.rate for f in losses), f32),
        loss_src=masks([f.src for f in losses]),
        loss_dst=masks([f.dst for f in losses]),
        slow_start=vec((s.start for s in slows), i32),
        slow_end=vec((s.end for s in slows), i32),
        slow_stride=vec((max(s.stride, 1) for s in slows), i32),
        slow_nodes=masks([s.nodes for s in slows]),
        flap_start=vec((f.start for f in flaps), i32),
        flap_end=vec((f.end for f in flaps), i32),
        flap_up=vec((f.up for f in flaps), i32),
        flap_period=vec((f.up + f.down for f in flaps), i32),
        flap_nodes=masks([f.nodes for f in flaps]),
        out_start=vec((o.start for o in outs), i32),
        out_end=vec((o.end for o in outs), i32),
        out_nodes=masks([o.nodes for o in outs]),
    )


def _rel(tsc: TensorScenario, rnd) -> torch.Tensor:
    """Armed-relative round(s), int32 on the table's device; ``rnd`` an
    int or an int tensor of any shape (a batch of rounds)."""
    rnd = torch.as_tensor(rnd, device=tsc.round0.device).to(torch.int32)
    return rnd - tsc.round0


def _in_window(rel, start, end) -> torch.Tensor:
    return (rel >= start) & (rel < end)


def _slow_muted(tsc: TensorScenario, s: int, rel) -> torch.Tensor:
    """bool [...]: slow rule ``s`` holds its senders back at ``rel`` (``%``
    is the floored remainder, as ``jnp``'s, for a negative ``rel``)."""
    return (_in_window(rel, tsc.slow_start[s], tsc.slow_end[s])
            & (rel % tsc.slow_stride[s] != 0))


def _flap_dark(tsc: TensorScenario, k: int, rel) -> torch.Tensor:
    """bool [...]: flap rule ``k`` is in its dark phase at ``rel``
    (schedule.Flapping.down_at)."""
    return (_in_window(rel, tsc.flap_start[k], tsc.flap_end[k])
            & ((rel - tsc.flap_start[k]) % tsc.flap_period[k]
               >= tsc.flap_up[k]))


def filter_edges(tsc: TensorScenario, edges: torch.Tensor, rnd,
                 key: torch.Tensor) -> torch.Tensor:
    """Apply the rule table to explicit in-edges.

    ``edges`` int32 ``[..., N, F]`` (sender ids per receiver; ring mode's
    ``[N, 3]`` included), ``rnd`` the absolute round(s) ``[...]``, ``key``
    the per-round key(s) ``[..., 2]`` (the loss draws fold the rule index
    in, so several loss rules draw independently).  Returns the edges with
    every dropped message's edge rewritten to the receiver (a no-op
    merge).
    """
    n, f = edges.shape[-2:]
    dev = edges.device
    rel = _rel(tsc, rnd)[..., None, None]
    recv = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    src = edges.to(torch.int64)
    drop = torch.zeros(edges.shape, dtype=torch.bool, device=dev)
    for p in range(tsc.part_start.shape[0]):
        active = _in_window(rel, tsc.part_start[p], tsc.part_end[p])
        pid = tsc.part_pid[p]
        drop |= active & (pid[src] != pid[:, None])
    for s in range(tsc.slow_start.shape[0]):
        drop |= _slow_muted(tsc, s, rel) & tsc.slow_nodes[s][src]
    for k in range(tsc.flap_start.shape[0]):
        drop |= _flap_dark(tsc, k, rel) & tsc.flap_nodes[k][src]
    for o in range(tsc.out_start.shape[0]):
        active = _in_window(rel, tsc.out_start[o], tsc.out_end[o])
        grp = tsc.out_nodes[o]
        # blackout: src in group OR dst in group (rack-wide, both ways)
        drop |= active & (grp[src] | grp[:, None])
    for l in range(tsc.loss_start.shape[0]):  # noqa: E741
        active = _in_window(rel, tsc.loss_start[l], tsc.loss_end[l])
        u = trandom.uniform(trandom.fold_in(key.to(dev), l), (n, f))
        drop |= (active & tsc.loss_src[l][src] & tsc.loss_dst[l][:, None]
                 & (u < tsc.loss_rate[l]))
    return torch.where(drop, recv, edges)


def sends_mask(tsc: TensorScenario, n: int, rnd) -> torch.Tensor:
    """bool ``[..., N]``: which nodes get their datagrams out.

    The SENDER-side rules as a node mask, for merge forms with no per-edge
    rewrite (aligned arcs): a muted node's gossip-view row encodes absent
    everywhere, which drops every out-edge at once while its own tick
    (bump, detect) runs untouched: the per-edge rewrite's effect for
    sender-global rules.  Correlated outages contribute their src-side
    half here; the dst-side half rides :func:`arc_match_edges`'s receiver
    zero mask.
    """
    rel = _rel(tsc, rnd)[..., None]
    send = torch.ones(rel.shape[:-1] + (n,), dtype=torch.bool,
                      device=rel.device)
    for s in range(tsc.slow_start.shape[0]):
        send &= ~(_slow_muted(tsc, s, rel) & tsc.slow_nodes[s])
    for k in range(tsc.flap_start.shape[0]):
        send &= ~(_flap_dark(tsc, k, rel) & tsc.flap_nodes[k])
    for o in range(tsc.out_start.shape[0]):
        active = _in_window(rel, tsc.out_start[o], tsc.out_end[o])
        send &= ~(active & tsc.out_nodes[o])
    return send


def arc_match_edges(tsc: TensorScenario, bases: torch.Tensor, rnd,
                    fanout: int, align: int) -> torch.Tensor:
    """Aligned-arc partition filter as (base, group-match bitmask) pairs.

    int32 ``[..., N, 2]``: row i carries its arc base and a bitmask whose
    bit k keeps window group k (the ``align`` senders at rows ``(base +
    k*align) .. + align``), kept iff NO active partition rule separates
    the group from receiver i.  Valid when every partition side is
    align-group-closed (:func:`require_scenario_config` checks), so one
    representative node decides for the whole group.  A receiver inside an
    active outage zeroes its whole mask (every in-edge drops at once).
    Consumed by the resident round's ``edge_filter`` form and by
    ``ops.merge.arc_group_window_max``.
    """
    n = bases.shape[-1]
    nb, nw = n // align, fanout // align
    dev = bases.device
    rel = _rel(tsc, rnd)[..., None]
    g = bases.to(torch.int64) // align
    mask = torch.zeros(bases.shape, dtype=torch.int32, device=dev)
    for k in range(nw):
        rep = ((g + k) % nb) * align  # group representative node
        ok = torch.ones(bases.shape, dtype=torch.bool, device=dev)
        for p in range(tsc.part_start.shape[0]):
            active = _in_window(rel, tsc.part_start[p], tsc.part_end[p])
            pid = tsc.part_pid[p]
            ok &= ~active | (pid[rep] == pid)
        mask |= ok.to(torch.int32) << k
    for o in range(tsc.out_start.shape[0]):
        active = _in_window(rel, tsc.out_start[o], tsc.out_end[o])
        mask = torch.where(active & tsc.out_nodes[o], 0, mask)
    return torch.stack([bases.to(torch.int32), mask], dim=-1)


def require_scenario_config(config: SimConfig, scenario=None) -> None:
    """Reject protocol/scenario combinations no transport form can honor.

    * ``remove_broadcast`` is an instantaneous column OR over the whole
      matrix, not a set of messages: a partition could not filter it;
      gossip-only dissemination is the transport-faithful mode.
    * ``random_arc``: aligned arcs (arc_align > 1) take partitions with
      align-group-closed sides, slow and flapping senders and correlated
      outages; Bernoulli loss draws are per edge and need ``random`` (or
      ring).  Unaligned arcs (arc_align == 1) have no group form at all.

    ``scenario``: the :class:`TensorScenario` (or the declarative
    ``FaultScenario``) when available: the arc capability checks need the
    rule tables; with ``None`` only the config-level requirements are
    checked.  The messages are the JAX package's.
    """
    if config.remove_broadcast:
        raise ValueError(
            "scenario runs require remove_broadcast=False: the sim's REMOVE "
            "broadcast is an instantaneous tensor reduction, not transport "
            "messages, so partitions/link faults cannot filter it "
            "(use gossip-only dissemination + fresh_cooldown)"
        )
    if not config.fresh_cooldown:
        raise ValueError(
            "scenario runs require fresh_cooldown=True: in gossip-only "
            "dissemination the faithful stale-timestamp fail list gives "
            "removed entries a ~zero cooldown and zombie re-add cycles "
            "(config.py fresh_cooldown notes) — a partitioned run would "
            "then never reconverge after heal, misattributing the "
            "protocol pathology to the injected fault"
        )
    if config.topology == "random_arc":
        if config.arc_align <= 1:
            raise ValueError(
                "scenario runs on random_arc need arc_align > 1 (whole "
                "sender groups are the drop unit); unaligned arcs have no "
                "per-edge form — use topology='random'"
            )
        if scenario is not None:
            _require_arc_scenario(scenario, config)


def _require_arc_scenario(scenario, config: SimConfig) -> None:
    """Concrete aligned-arc capability checks (rule tables in hand)."""
    from gossipfs_tpu_torch.ops.merge import ARC_MATCH_MAX_GROUPS

    align = config.arc_align
    if isinstance(scenario, TensorScenario):
        n_loss = int(scenario.loss_start.shape[0])
        pids = scenario.part_pid.cpu().numpy()
    else:  # declarative FaultScenario
        n_loss = len(scenario.link_faults)
        pids = (
            np.stack([p.pid(config.n) for p in scenario.partitions])
            if scenario.partitions else np.zeros((0, config.n), np.int32)
        )
    if n_loss:
        raise ValueError(
            "Bernoulli loss rules draw per (sender, receiver) edge and "
            "have no group form: run loss scenarios on topology='random' "
            "(or ring); aligned arcs take partitions, slow/flapping "
            "senders and correlated outages"
        )
    if config.fanout // align > ARC_MATCH_MAX_GROUPS:
        raise ValueError(
            "aligned-arc scenarios pack the group-match mask into an "
            f"int32: fanout/arc_align must be <= {ARC_MATCH_MAX_GROUPS} "
            f"(got {config.fanout // align})"
        )
    if pids.size:
        grouped = pids.reshape(pids.shape[0], -1, align)
        if (grouped != grouped[:, :, :1]).any():
            raise ValueError(
                "aligned-arc scenarios need align-group-closed partition "
                f"sides: every group of {align} consecutive nodes must "
                "sit on one side (then group-granular filtering IS "
                "per-edge filtering); regroup the partition or use "
                "topology='random'"
            )
