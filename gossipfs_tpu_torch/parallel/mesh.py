"""Subject-axis (column) sharding of the simulation state over ranks.

The port of ``gossipfs_tpu/parallel/mesh.py``.  The per-round merge
gathers whole sender ROWS of the gossip view, so the state is sharded on
its subject (column) axis: every rank holds all N receiver rows of the
``[N, N]`` lanes for its contiguous block of ``nloc = N / world``
subjects, and the row gather never leaves the rank.  What crosses ranks
is the per-receiver ``[N]`` counts (listed, and SUSPECT on the Lifeguard
lane), summed once a round, and the round metrics, summed once after the
run (``core/rounds.ShardCtx``).  Every rank draws the replicated inputs
(alive, the edges, the arc bases, the churn) from the same key, so the
sharded run is bit-identical to the single-device one.

* :func:`shard_ctx` takes the place of the JAX package's
  ``make_mesh``/``state_shardings``: the rank's column block in a process
  group (``parallel/distributed.py``);
* :func:`shard_state` slices a whole state to a rank's block
  (``core/state.init_shard`` builds one in place, with no ``[N, N]``
  tensor); :func:`gather_state` / :func:`gather_carry` collect the blocks
  on rank 0 through the host, after a run;
* :func:`run_rounds_sharded` is ``core.rounds.run_rounds`` on a shard,
  with the JAX package's checks (no ring, N divisible by the ranks, the
  crash-only promise, the scenario capability matrix).

The JAX package's ``rr_shard_admissible`` (TPU VMEM arithmetic) has no
twin: the port's shard gate is ``core/rounds._lean_ok(..., nloc)``, the
resident round's ``nloc % 4 == 0``.  ``donate`` has none either: the port
updates its lanes in place.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.core import rounds
from gossipfs_tpu_torch.core.rounds import LOCAL_CTX, MetricsCarry, ShardCtx
from gossipfs_tpu_torch.core.state import SimState, init_shard
from gossipfs_tpu_torch.scenarios import tensor as scn


def shard_ctx(group, n: int) -> ShardCtx:
    """This rank's column block of an N-node state in ``group`` (None: a
    single process, the whole state)."""
    if group is None:
        return LOCAL_CTX
    world = dist.get_world_size(group)
    if n % world:
        raise ValueError(f"n={n} must divide over {world} ranks")
    nloc = n // world
    return ShardCtx(offset=dist.get_rank(group) * nloc, nloc=nloc,
                    group=group)


def shard_state(state: SimState, ctx: ShardCtx) -> SimState:
    """A whole state's column block for ``ctx`` (copies)."""
    if ctx.nloc is None:
        return state
    sl = slice(ctx.offset, ctx.offset + ctx.nloc)
    return SimState(hb=state.hb[:, sl].contiguous(),
                    asl=state.asl[:, sl].contiguous(),
                    alive=state.alive.clone(), round=state.round,
                    hb_base=state.hb_base[sl].contiguous())


def _gather_cols(t: torch.Tensor, ctx: ShardCtx):
    """Rank 0: the ranks' blocks of ``t`` joined along the last axis, on
    the host; other ranks: None."""
    if ctx.group is None:
        return t.cpu()
    world = dist.get_world_size(ctx.group)
    rank = dist.get_rank(ctx.group)
    dtype = t.dtype
    t = t.contiguous()
    if dist.get_backend(ctx.group) == "gloo":
        t = t.cpu()        # gloo moves host buffers
    if dtype == torch.int16:
        # neither gloo nor NCCL has int16: int16 lanes travel as their
        # bytes (a row's block of 2-byte values stays whole)
        t = t.view(torch.uint8)
    parts = [torch.empty_like(t) for _ in range(world)] if rank == 0 else None
    dist.gather(t, parts, dst=0, group=ctx.group)
    if rank != 0:
        return None
    return torch.cat([p.cpu() for p in parts], dim=-1).view(dtype)


def gather_state(state: SimState, ctx: ShardCtx) -> SimState | None:
    """The whole state on rank 0's host (None elsewhere); every rank
    calls it."""
    hb, asl, base = (_gather_cols(t, ctx)
                     for t in (state.hb, state.asl, state.hb_base))
    if hb is None:
        return None
    return SimState(hb=hb, asl=asl, alive=state.alive.cpu(),
                    round=state.round, hb_base=base)


def gather_carry(carry: MetricsCarry, ctx: ShardCtx) -> MetricsCarry | None:
    """The whole carry on rank 0's host (None elsewhere)."""
    parts = [_gather_cols(t, ctx) for t in carry]
    return None if parts[0] is None else MetricsCarry(*parts)


def run_rounds_sharded(state: SimState, config, num_rounds: int,
                       key: torch.Tensor, ctx: ShardCtx, events=None,
                       crash_rate: float = 0.0, rejoin_rate: float = 0.0,
                       churn_ok: torch.Tensor | None = None,
                       crash_only_events: bool = False, scenario=None):
    """``core.rounds.run_rounds`` on this rank's column shard (the JAX
    package's ``run_rounds_sharded``).  Every rank calls it with the same
    arguments but its own ``state`` block (:func:`shard_state`,
    ``core.state.init_shard``) on its own device; ``events``,
    ``churn_ok`` and ``scenario`` are whole (replicated).  Returns (the
    shard's state, its ``[nloc]`` MetricsCarry, the RoundMetrics summed
    over the shards), bit-identical to the single-device run's column
    block.  Ring topology derives its edges from whole rows of the
    tables and is refused, as in the JAX package."""
    n = config.n
    world = 1 if ctx.group is None else dist.get_world_size(ctx.group)
    if config.topology == "ring":
        raise ValueError("ring topology derives edges from the full table; "
                         "use run_rounds instead")
    if n % world:
        raise ValueError(f"n={n} must divide over {world} ranks")
    if crash_only_events and events is not None and bool(events.join.any()):
        raise ValueError(
            "crash_only_events=True ignores events.join, but the schedule "
            "contains join bits: drop the flag or the joins")
    if scenario is not None:
        scn.require_scenario_config(config, scenario)
    return rounds.run_rounds(state, config, num_rounds, key, events=events,
                             crash_rate=crash_rate, rejoin_rate=rejoin_rate,
                             churn_ok=churn_ok,
                             crash_only_events=crash_only_events,
                             scenario=scenario, ctx=ctx)


def run_jobs(rank: int, world: int, device, jobs: list) -> list:
    """:func:`run_job` for each of ``jobs`` in turn, in one process group
    (one launch for a batch of runs)."""
    return [run_job(rank, world, device, job) for job in jobs]


def _to_device(x, dev):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return type(x)(*(t.to(dev) for t in x))


def run_job(rank: int, world: int, device, job: dict) -> dict:
    """One rank of a sharded run (a :func:`distributed.launch` target).

    ``job``: ``config``, ``rounds``, ``seed`` (the threefry key), and
    optionally ``events``, ``crash_rate``, ``rejoin_rate``, ``churn_ok``,
    ``crash_only_events``, ``scenario`` (host tensors, whole), ``warm``
    (one untimed run first).  Each rank builds its block in place
    (``init_shard``) and runs :func:`run_rounds_sharded`.  Returns the
    rank's route, launch counts, host seconds of the timed run, the
    collectives' count and seconds, and peak device memory; rank 0 adds
    the gathered ``state`` and ``carry`` and the ``metrics``, on the
    host."""
    from gossipfs_tpu_torch.ops import merge

    cfg = job["config"]
    ctx = shard_ctx(
        dist.group.WORLD if dist.is_initialized() else None, cfg.n)
    kw = dict(events=_to_device(job.get("events"), device),
              crash_rate=job.get("crash_rate", 0.0),
              rejoin_rate=job.get("rejoin_rate", 0.0),
              churn_ok=_to_device(job.get("churn_ok"), device),
              crash_only_events=job.get("crash_only_events", False),
              scenario=_to_device(job.get("scenario"), device))
    key = trandom.PRNGKey(job["seed"], device=device)
    cuda = device.type == "cuda"

    def run():
        state = init_shard(cfg, ctx, device=device)
        if cuda:
            torch.cuda.synchronize(device)
        if ctx.group is not None:
            dist.barrier(ctx.group)
        merge.reset_launch_counts()
        rounds.COLLECTIVES.update(calls=0, seconds=0.0)
        t0 = time.perf_counter()
        out = run_rounds_sharded(state, cfg, job["rounds"], key, ctx, **kw)
        if cuda:
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    if job.get("warm"):
        run()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    (state, carry, metrics), seconds = run()
    matrix = ((kw["events"] is not None and not kw["crash_only_events"])
              or kw["rejoin_rate"] > 0.0)
    res = {"rank": rank, "world": world, "nloc": ctx.cols(cfg.n),
           "route": rounds.route(cfg, matrix, kw["scenario"], ctx.nloc),
           "launches": dict(merge.LAUNCH_COUNTS),
           "forms": {k: v for k, v in merge.FORM_LAUNCHES.items() if v},
           "seconds": seconds,
           "backend": (None if ctx.group is None
                       else dist.get_backend(ctx.group)),
           "collectives": dict(rounds.COLLECTIVES),
           "peak_bytes": (torch.cuda.max_memory_allocated(device) if cuda
                          else None)}
    full = gather_state(state, ctx)
    full_carry = gather_carry(carry, ctx)
    if full is not None:
        res.update(state=full, carry=full_carry,
                   metrics=rounds.RoundMetrics(*(m.cpu() for m in metrics)))
    return res
