"""Global simulation state: every node's membership table as one tensor.

Row ``i`` of each ``[N, N]`` lane is node ``i``'s view of every peer ``j``
(receiver rows, subject columns, row-major):

  ``hb[i, j]``   heartbeat count ``i`` knows for ``j``, in the config's
                 ``hb_dtype`` (int8, int16 or int32).  Narrow lanes store
                 it relative to the per-subject origin ``hb_base[j]`` (the
                 true counter is ``hb + hb_base``), and their minimum is
                 the "never sent" floor sentinel; int32 lanes hold the
                 true counter (``hb_base`` stays 0)
  ``asl[i, j]``  int8 age|status byte, ``((age << 2) | status) - 128``
                 (ops/merge.pack_age_status): ``age`` counts rounds since
                 the entry was last refreshed, saturating at AGE_CLAMP;
                 ``status`` is UNKNOWN / MEMBER / FAILED, and SUSPECT under
                 the SWIM lifecycle (``SimConfig.suspicion``)

plus ground truth ``alive[j]`` and the round counter.  Under subject-axis
sharding (``parallel/mesh.py``) a rank holds a column block: every row,
its ``nloc`` subjects from global subject ``offset`` (``[N, nloc]`` lanes,
``hb_base`` ``[nloc]``; :func:`init_shard`).  The two bytes per
entry are the whole state the lean round loop moves; the JAX package's
separate ``age``/``status`` lanes are the unpacked view of ``asl``
(:meth:`SimState.age`, :meth:`SimState.status`).  The packing is lossless
for every ``hb_dtype``: the age saturates at AGE_CLAMP = 63 (6 bits).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gossipfs_tpu_torch.config import SimConfig

# status codes (2 bits: they pack beside the age in one byte)
UNKNOWN = 0   # j not in i's membership list
MEMBER = 1    # j in i's list (alive as far as i knows)
FAILED = 2    # j removed by i, still on the fail-list cooldown
SUSPECT = 3   # SWIM suspicion: still listed, pending refute or confirm

HB_DTYPES = {"int8": torch.int8, "int16": torch.int16, "int32": torch.int32}


class SimState(NamedTuple):
    """The packed simulation state (see module docstring)."""

    hb: torch.Tensor       # int8 / int16 / int32 [N, N]
    asl: torch.Tensor      # int8 [N, N] packed age|status
    alive: torch.Tensor    # bool [N]
    round: int             # rounds simulated so far (host integer)
    hb_base: torch.Tensor  # int32 [N] per-subject heartbeat origin

    @property
    def n(self) -> int:
        return self.hb.shape[0]

    @property
    def age(self) -> torch.Tensor:
        return ((self.asl.to(torch.int32) + 128) >> 2).to(torch.int8)

    @property
    def status(self) -> torch.Tensor:
        # the bias (128) is a multiple of 4: the low two bits are the status
        return self.asl & 3


class RoundEvents(NamedTuple):
    """Scheduled per-round events, each bool ``[R, N]`` over a horizon."""

    crash: torch.Tensor   # die silently this round
    leave: torch.Tensor   # leave (silent death on the crash-only loop)
    join: torch.Tensor    # (re)join through the introducer

    @staticmethod
    def none(num_rounds: int, n: int, device="cuda") -> "RoundEvents":
        z = torch.zeros((num_rounds, n), dtype=torch.bool, device=device)
        return RoundEvents(crash=z, leave=z, join=z)


def _init_block(config: SimConfig, offset: int, cols: int, member_mask,
                device) -> SimState:
    """The fully-joined initial state's columns ``offset..offset+cols``."""
    n = config.n
    asl = torch.full((n, cols), MEMBER - 128, dtype=torch.int8,
                     device=device)
    if member_mask is None:
        member_mask = torch.ones((n,), dtype=torch.bool, device=device)
    else:
        # i knows j iff both are initial members: the rows and columns of
        # the others are unknown (two index writes, no [N, N] mask)
        member_mask = member_mask.to(device=device, dtype=torch.bool)
        out = ~member_mask
        asl[out] = UNKNOWN - 128
        asl[:, out[offset:offset + cols]] = UNKNOWN - 128
    return SimState(
        hb=torch.zeros((n, cols), dtype=HB_DTYPES[config.hb_dtype],
                       device=device),
        asl=asl,
        alive=member_mask.clone(),
        round=0,
        hb_base=torch.zeros((cols,), dtype=torch.int32, device=device),
    )


def init_state(config: SimConfig, member_mask: torch.Tensor | None = None,
               device="cuda") -> SimState:
    """Fully-joined initial cohort: every node in ``member_mask`` (default
    all N) starts with every other member listed at heartbeat 0, age 0."""
    return _init_block(config, 0, config.n, member_mask, device)


def init_shard(config: SimConfig, ctx, member_mask: torch.Tensor | None = None,
               device="cuda") -> SimState:
    """One column shard of :func:`init_state` (``ctx`` a
    ``core.rounds.ShardCtx``): ``[N, nloc]`` lanes built in place, equal to
    ``init_state(config)`` sliced to the shard's columns, with no
    ``[N, N]`` tensor on the way (the JAX package builds its shards in
    place through ``out_shardings`` for the same reason)."""
    return _init_block(config, ctx.offset, ctx.cols(config.n), member_mask,
                       device)


def listed(status: torch.Tensor, suspicion: bool = False) -> torch.Tensor:
    """bool mask of entries in the membership list: MEMBER, and SUSPECT
    under the SWIM lifecycle (a suspect still gossips, counts toward
    min_group and is marked by LEAVE, pending refute or confirm).  In the
    0..3 encoding the listed statuses are the odd ones."""
    if suspicion:
        return (status & 1) == 1
    return status == MEMBER


def _row_counts(state: SimState, pick, ctx=None) -> torch.Tensor:
    """Per-row count (int32 [N]) of the entries whose status ``pick``
    selects.  The status is the low two bits of the biased byte (the bias,
    128, is a multiple of 4), so no widening is needed; rows go in chunks,
    which keeps the temporaries small at any N.  A row's count reads every
    column: on a column shard (``ctx``, a ``core.rounds.ShardCtx``) the
    shards' partials are summed (``ctx.psum``)."""
    asl = state.asl
    n, cols = asl.shape
    out = torch.empty(n, dtype=torch.int32, device=asl.device)
    step = max(1, (1 << 26) // cols)
    for r0 in range(0, n, step):
        out[r0:r0 + step] = pick(asl[r0:r0 + step] & 3).sum(
            dim=1, dtype=torch.int32)
    return out if ctx is None else ctx.psum(out)


def member_counts(state: SimState, suspicion: bool = False,
                  ctx=None) -> torch.Tensor:
    """Size of each node's membership list (int32 [N]), suspects included
    under ``suspicion``."""
    return _row_counts(state, lambda st: listed(st, suspicion), ctx)


def suspect_counts(state: SimState, ctx=None) -> torch.Tensor:
    """SUSPECT entries of each node's list (int32 [N]): the Lifeguard
    local-health input."""
    return _row_counts(state, lambda st: st == SUSPECT, ctx)


def swar_lanes_ok(hb: torch.Tensor) -> bool:
    """Whether the SWAR elementwise form (``config.elementwise="swar"``,
    ops/swar.py: 4 subjects per int32 word) can pack these lanes: int8
    storage and a minor (subject) axis divisible by the 4-byte word.  A
    ragged N takes the lanes form, as in the JAX package."""
    return hb.dtype == torch.int8 and hb.shape[-1] % 4 == 0
