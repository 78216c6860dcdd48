"""Benchmark runner for the five BASELINE configurations, on the card.

The port of the JAX package's ``bench/run.py``.  It turns a
``models.presets.Scenario`` into the north-star numbers, simulated gossip
rounds/s plus the time-to-detect and false-positive-rate report:

  python -m gossipfs_tpu_torch.run --scenario sim-1k
  python -m gossipfs_tpu_torch.run --scenario sim-10k-crash --n 2048 \
      --rounds 60
  python -m gossipfs_tpu_torch.run --scenario sim-100k --devices 2

Each run injects ``track`` tracked deterministic crashes at round
``crash_at`` on top of the scenario's random churn, so the time-to-detect
distribution is measured against known crash rounds; it runs the rounds
once to warm up (the kernels' build and load) and once timed, each from a
fresh state (``bench.timed_run``), and prints one JSON document.  The
timed window holds the ``run_rounds`` call alone (the state's and key's
set-up excluded): on the card CUDA events, on the CPU (``--device cpu``,
the plain versions) the host clock.

``--devices K`` shards the state's subject axis over K rank processes
(``parallel.mesh.run_rounds_sharded``, started as ``full_scale.py`` starts
them; ranks sharing one card run gloo through the host, so their rounds/s
is not a multi-GPU speed).  A ring configuration runs in one process, as
in the JAX package.  ``sim-100k`` at N = 131,072 does not fit one card: cut
it with ``--n`` or shard it with ``--devices``.  Config 5
(``sim-100k-sdfs``) adds the SDFS co-simulation (:func:`run_cosim`):
after the detector's timed run, the SDFS control plane consumes the
master's membership row every 8 rounds; with ``--devices K`` its chunks
run on the ranks too (:func:`run_cosim_job`), the control plane on
rank 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.bench import timed_run, tracked_crash_events
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core.rounds import run_rounds
from gossipfs_tpu_torch.core.state import MEMBER, SimState, init_state
from gossipfs_tpu_torch.metrics.detection import summarize
from gossipfs_tpu_torch.models import presets
from gossipfs_tpu_torch.ops import merge

#: a sharded run's ranks: the launch's time limit, seconds
RANK_TIMEOUT = 1800.0


def _sharded_run(cfg: SimConfig, rounds: int, seed: int, events, sc,
                 churn_ok, devices: int, device):
    """The timed run over ``devices`` rank processes
    (``parallel.mesh.run_job``: a warm-up run, then a timed one, each from
    a fresh block, host clock ending in a device synchronize).  Returns
    rank 0's gathered (state, MetricsCarry, RoundMetrics, seconds, its
    timed run's kernel launches) on the host, and for config 5 the ranks'
    co-simulation results (:func:`run_cosim_job`, in the same launch;
    None for the other scenarios)."""
    from gossipfs_tpu_torch.parallel import distributed, mesh

    job = dict(config=cfg, rounds=rounds, seed=seed, events=events,
               crash_rate=sc.crash_rate, rejoin_rate=sc.rejoin_rate,
               churn_ok=churn_ok, crash_only_events=True, warm=True)
    threads = max(1, (os.cpu_count() or 1) // devices)
    kw = dict(timeout=RANK_TIMEOUT, device=device, threads=threads)
    cosim = None
    if sc.sdfs_cosim:
        cosim_job = dict(scenario=sc, config=cfg, rounds=rounds, seed=seed)
        ranks = distributed.launch(config5_ranks, devices, (job, cosim_job),
                                   **kw)
        heads, cosim = [r[0] for r in ranks], [r[1] for r in ranks]
        for h, c in zip(heads, cosim):
            c["detector_peak_bytes"] = h["peak_bytes"]
    else:
        heads = distributed.launch(mesh.run_job, devices, (job,), **kw)
    head = heads[0]
    launches = {k: v for k, v in head["launches"].items() if v}
    return (head["state"], head["carry"], head["metrics"], head["seconds"],
            launches, cosim)


class ControlPlane:
    """Config 5's SDFS control plane: the cluster with its ``n_files``
    puts, and its reaction to each chunk's membership (rank 0 holds it in
    a sharded run).  Shared by :func:`run_cosim` and
    :func:`run_cosim_job`, so that the two runners react alike."""

    def __init__(self, sc: presets.Scenario, cfg: SimConfig, seed: int):
        from gossipfs_tpu_torch.sdfs.cluster import SDFSCluster

        self.n_files = sc.n_files
        self.cluster = SDFSCluster(cfg.n, seed=seed,
                                   introducer=cfg.introducer)
        for f in range(sc.n_files):
            self.cluster.put(f"file{f}.txt", b"payload-%d" % f, now=0)
        self.repairs = 0
        self.elections = 0
        self.alive: list[int] = []

    def observer(self, alive_mask: np.ndarray, now: int) -> int | None:
        """The node whose MEMBER row this chunk's reaction reads, from the
        ground-truth ``alive_mask``: -1 when no node answers (no
        reaction), None when the cluster is empty (stop; the empty
        membership is fed first, so the closing durability check cannot
        satisfy quorum against the stores of dead nodes)."""
        from gossipfs_tpu_torch.cosim import select_observer

        self.alive = np.nonzero(alive_mask)[0].tolist()
        if not self.alive:
            self.cluster.update_membership([], reachable=[], now=now)
            return None
        observer = select_observer(self.cluster.live, set(self.alive),
                                   self.cluster.master_node)
        return -1 if observer is None else observer

    def react(self, row: np.ndarray, now: int) -> None:
        """Consume the observer's MEMBER row (bool ``[N]``): membership,
        election, repair planning."""
        view = np.nonzero(row)[0]
        old_master = self.cluster.master_node
        self.cluster.update_membership(view.tolist(), reachable=self.alive,
                                       now=now)
        if self.cluster.master_node != old_master:
            self.elections += 1
        self.repairs += len(self.cluster.fail_recover())

    def report(self, rounds: int, elapsed: float) -> dict:
        """The JAX package's ``cosim`` dict; durability is how many files
        still answer a quorum read at the end."""
        readable = sum(
            1 for f in range(self.n_files)
            if self.cluster.get(f"file{f}.txt") is not None)
        return {
            "rounds": rounds,
            "elapsed_s": round(elapsed, 3),
            "rounds_per_sec": round(rounds / elapsed, 2) if elapsed else None,
            "files": self.n_files,
            "files_readable": readable,
            "repair_plans": self.repairs,
            "elections": self.elections,
            "final_alive": len(self.alive),
        }


def cosim_churn(cfg: SimConfig, device="cuda") -> torch.Tensor:
    """Config 5's churn mask: random churn spares the introducer (see
    bench.tracked_crash_events): with it dead no rejoin can ever land and
    the population decays."""
    return torch.arange(cfg.n, device=device) != cfg.introducer


def run_cosim(sc: presets.Scenario, cfg: SimConfig, rounds: int,
              seed: int, device="cuda", plain: bool = False,
              churn_ok: torch.Tensor | None = None) -> dict:
    """Config 5's co-simulation: the SDFS control plane consuming the
    simulated membership, in chunks of ``RECOVERY_DELAY`` rounds (8
    heartbeats, the sleep in Fail_recover, slave.go:1123).  Between
    chunks the master's own membership row feeds placement and repair
    planning, as in the JAX package's ``bench/run.run_cosim``: the same
    key for every chunk (its rounds fold in their own indices), the
    ground-truth alive mask and the observer's row read back as one
    packet a chunk, the same reaction and the same report.
    ``churn_ok`` replaces the churn mask (:func:`cosim_churn`, which
    spares the introducer, so the cluster never empties): no scenario
    sets it; it is the one way to reach the empty-cluster stop, which the
    tests hold against :func:`run_cosim_job`'s.

    The JAX runner pipelines: it dispatches chunk k+1 before reacting to
    chunk k, and when the observer changed it refetches that observer's
    row from chunk k's state.  The port's rounds update the lanes in
    place, so chunk k's state is gone once chunk k+1 runs; this runner
    reacts to chunk k before it runs chunk k+1 instead.  The reaction
    never feeds back into the detector, so the outputs are the same; only
    the host's reaction is no longer overlapped with the device's next
    chunk.  When the cluster empties, the JAX runner had already
    run the next chunk and counts it: so does this one."""
    from gossipfs_tpu_torch.sdfs.types import RECOVERY_DELAY

    dev = torch.device(device)
    n = cfg.n

    def membership_packet(state: SimState, observer: int) -> np.ndarray:
        """alive mask + observer's MEMBER row in one host transfer."""
        row = (state.asl[observer] & 3) == MEMBER
        return torch.cat([state.alive, row]).cpu().numpy()

    plane = ControlPlane(sc, cfg, seed)
    key = trandom.PRNGKey(seed, device=dev)
    churn_ok = (cosim_churn(cfg, dev) if churn_ok is None
                else churn_ok.to(dev))
    chunk = RECOVERY_DELAY
    n_chunks = max(1, -(-rounds // chunk))

    def run_chunk(st: SimState) -> SimState:
        return run_rounds(st, cfg, chunk, key, crash_rate=sc.crash_rate,
                          rejoin_rate=sc.rejoin_rate, churn_ok=churn_ok,
                          plain=plain)[0]

    # warm up the chunk's kernels and the packet read on a state of its
    # own (the port's rounds update their lanes in place), then start the
    # run from a fresh one, out of the timed window
    warm = run_chunk(init_state(cfg, device=dev))
    membership_packet(warm, plane.cluster.master_node)
    del warm
    state = init_state(cfg, device=dev)
    done = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(n_chunks):
        state = run_chunk(state)
        done += chunk
        fetched_for = plane.cluster.master_node
        packet = membership_packet(state, fetched_for)
        observer = plane.observer(packet[:n], done)
        if observer is None:
            if i + 1 < n_chunks:
                # the pipelined reference had dispatched the next chunk
                state = run_chunk(state)
                done += chunk
            break
        if observer < 0:
            continue
        row = packet[n:]
        if observer != fetched_for:
            # never consume a dead master's frozen view
            row = membership_packet(state, observer)[n:]
        plane.react(row, done)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return plane.report(done, time.perf_counter() - t0)


def _broadcast(t: torch.Tensor, ctx) -> torch.Tensor:
    """Rank 0's ``t`` on every rank (through the host under gloo)."""
    if dist.get_backend(ctx.group) == "gloo":
        dist.broadcast(t, src=0, group=ctx.group)
        return t
    d = t.to(torch.device("cuda", torch.cuda.current_device()))
    dist.broadcast(d, src=0, group=ctx.group)
    return d.cpu()


def run_cosim_job(rank: int, world: int, device, job: dict) -> dict:
    """One rank of config 5's co-simulation over subject-axis shards (a
    ``parallel.distributed.launch`` target): the sharded twin of
    :func:`run_cosim`, as the JAX package runs its co-sim under a mesh.

    ``job``: ``scenario``, ``config``, ``rounds``, ``seed`` and optionally
    ``churn_ok`` (whole, on the host; as in :func:`run_cosim`, only to
    reach the empty-cluster stop).  Every rank builds its column block
    in place (``init_shard``) and runs the ``RECOVERY_DELAY``-round chunks
    through ``parallel.mesh.run_rounds_sharded``, with one untimed warm-up
    chunk first.  The control plane lives on rank 0 only.  After each
    chunk rank 0 picks the observer off its replicated ``alive`` and
    broadcasts ``[continue, observer]``; every rank then sends its block
    of the observer's MEMBER row to rank 0 (as uint8: gloo has no bool),
    which reacts before the next chunk runs.  So every rank takes part in
    every collective, and on an empty cluster they all stop after the
    same chunk (the one the pipelined reference had already run counted,
    as in :func:`run_cosim`).  Returns the rank's launches (its warm-up
    chunk included), host seconds, peak device memory, collectives'
    count; rank 0 adds the ``cosim`` report."""
    from gossipfs_tpu_torch.core import rounds as core_rounds
    from gossipfs_tpu_torch.core.state import init_shard
    from gossipfs_tpu_torch.parallel import mesh
    from gossipfs_tpu_torch.sdfs.types import RECOVERY_DELAY

    sc, cfg = job["scenario"], job["config"]
    ctx = mesh.shard_ctx(
        dist.group.WORLD if dist.is_initialized() else None, cfg.n)
    if ctx.group is None:
        raise ValueError("run_cosim_job runs over a process group of ranks")
    key = trandom.PRNGKey(job["seed"], device=device)
    churn_ok = job.get("churn_ok")
    churn_ok = (cosim_churn(cfg, device) if churn_ok is None
                else churn_ok.to(device))
    plane = ControlPlane(sc, cfg, job["seed"]) if rank == 0 else None
    chunk = RECOVERY_DELAY
    n_chunks = max(1, -(-job["rounds"] // chunk))
    cuda = device.type == "cuda"

    def run_chunk(st: SimState) -> SimState:
        return mesh.run_rounds_sharded(
            st, cfg, chunk, key, ctx, crash_rate=sc.crash_rate,
            rejoin_rate=sc.rejoin_rate, churn_ok=churn_ok)[0]

    def exchange(st: SimState, now: int, warm: bool = False) -> bool:
        """Rank 0's decision on every rank, then the observer's row to
        rank 0 and its reaction (none for the ``warm`` exchange, which
        reads the introducer's row); False: stop."""
        ctrl = torch.tensor([1, cfg.introducer], dtype=torch.int64)
        if plane is not None and not warm:
            observer = plane.observer(st.alive.cpu().numpy(), now)
            ctrl[0] = observer is not None
            ctrl[1] = -1 if observer is None else observer
        go, observer = _broadcast(ctrl, ctx).tolist()
        if go and observer >= 0:
            block = ((st.asl[observer] & 3) == MEMBER).to(torch.uint8)
            row = mesh.gather_cols(block, ctx)
            if plane is not None and not warm:
                plane.react(row.numpy().astype(bool), now)
        return bool(go)

    merge.reset_launch_counts()
    # the warm-up chunk and one exchange on a block of their own (the
    # lanes move in place), out of the timed window
    warm = run_chunk(init_shard(cfg, ctx, device=device))
    exchange(warm, chunk, warm=True)
    del warm
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    state = init_shard(cfg, ctx, device=device)
    if cuda:
        torch.cuda.synchronize(device)
    dist.barrier(ctx.group)
    core_rounds.COLLECTIVES.update(calls=0, seconds=0.0)
    done = 0
    t0 = time.perf_counter()
    for i in range(n_chunks):
        state = run_chunk(state)
        done += chunk
        if not exchange(state, done):
            if i + 1 < n_chunks:
                state = run_chunk(state)
                done += chunk
            break
    if cuda:
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    res = {"rank": rank, "world": world, "nloc": ctx.cols(cfg.n),
           "launches": {k: v for k, v in merge.LAUNCH_COUNTS.items() if v},
           "seconds": elapsed, "rounds": done,
           "backend": dist.get_backend(ctx.group),
           "collectives": dict(core_rounds.COLLECTIVES),
           "peak_bytes": (torch.cuda.max_memory_allocated(device) if cuda
                          else None)}
    if plane is not None:
        res["cosim"] = plane.report(done, elapsed)
    return res


def config5_ranks(rank: int, world: int, device, job: dict,
                  cosim_job: dict) -> tuple[dict, dict]:
    """Config 5 over ranks in one launch: the detector's timed run
    (``parallel.mesh.run_job``), then the co-simulation
    (:func:`run_cosim_job`)."""
    from gossipfs_tpu_torch.parallel import mesh

    return (mesh.run_job(rank, world, device, job),
            run_cosim_job(rank, world, device, cosim_job))


def scenario_config(sc: presets.Scenario,
                    n_override: int | None = None) -> SimConfig:
    """The scenario's configuration, with N overridden (fanout rescaled to
    log2 N for random topologies), as the JAX package's runner does."""
    cfg = sc.config
    if n_override is not None and n_override != cfg.n:
        fanout = (cfg.fanout if cfg.topology == "ring"
                  else SimConfig.log_fanout(n_override))
        cfg = dataclasses.replace(cfg, n=n_override, fanout=fanout)
    return cfg


def run_scenario(sc: presets.Scenario | str, *,
                 n_override: int | None = None,
                 rounds_override: int | None = None, seed: int = 0,
                 track: int = 4, crash_at: int = 10, devices: int = 1,
                 device="cuda", plain: bool = False,
                 return_outputs: bool = False):
    """Run one BASELINE scenario and return its report dict.

    ``n_override`` shrinks (or grows) the member count (fanout rescaled
    for random topologies), so the 100k presets run on one card or the
    CPU.  ``devices`` > 1 shards the state over that many rank processes
    (ring configurations run in one).  ``device`` is where the rounds run
    (rank r on ``cuda:(r % device_count)`` when sharded);
    ``plain=True`` runs the plain versions of the kernels (one process
    only).  The report holds the JAX package's fields, ``platform``
    ``"gpu"`` or ``"cpu"``, plus ``device`` (the card's name) and
    ``launches`` (the timed run's kernel launches; rank 0's when
    sharded); config 5 adds the JAX package's ``cosim`` report
    (:func:`run_cosim`) and ``cosim_launches``, the launches of its
    chunks (rank 0's when sharded, where ``cosim_ranks`` adds each rank's
    launches, seconds and peak device memory).  ``return_outputs``
    returns (report, (final state, MetricsCarry, RoundMetrics)) instead.
    """
    if isinstance(sc, str):
        sc = presets.ALL[sc]
    cfg = scenario_config(sc, n_override)
    rounds = rounds_override or sc.rounds
    dev = torch.device(device)
    sharded = devices > 1 and cfg.topology != "ring"
    if plain and sharded:
        raise ValueError("plain=True runs in one process (devices=1)")
    events, crash_rounds, churn_ok = tracked_crash_events(
        cfg, rounds, track, crash_at,
        device="cpu" if sharded else dev)
    if sharded:
        final, carry, per_round, elapsed, launches, cosim = _sharded_run(
            cfg, rounds, seed, events, sc, churn_ok, devices, device)
    else:
        # a warm-up run (the kernels' build and load), then the timed
        # one, each from a fresh state: the port updates its lanes in
        # place, so a second run of one state would start at round
        # ``rounds``.  tracked_crash_events schedules crashes only: the
        # promise keeps the crash-only event path
        kw = dict(seed=seed, crash_rate=sc.crash_rate, device=dev,
                  events=events, rejoin_rate=sc.rejoin_rate,
                  churn_ok=churn_ok, crash_only_events=True, plain=plain)
        timed_run(cfg, rounds, **kw)
        before = merge.launch_snapshot()
        elapsed, (final, carry, per_round) = timed_run(cfg, rounds, **kw)
        launches, _ = merge.launches_since(before)
    report = summarize(carry, per_round, crash_rounds)
    on_card = dev.type == "cuda"
    result = {
        "scenario": sc.name,
        "n": cfg.n,
        "topology": cfg.topology,
        "fanout": cfg.fanout,
        "rounds": rounds,
        "crash_rate": sc.crash_rate,
        "rejoin_rate": sc.rejoin_rate,
        "platform": "gpu" if on_card else "cpu",
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "devices": devices,
        "elapsed_s": round(elapsed, 4),
        "rounds_per_sec": round(rounds / elapsed, 2),
        # the reference advances 1 round per wall-clock second
        "speedup_vs_realtime": round(rounds / elapsed, 2),
        "launches": launches,
        "detection": report.as_dict(),
    }
    if sc.sdfs_cosim and sharded:
        # rank 0's control plane and launches; each rank's own figures
        result["cosim"] = cosim[0]["cosim"]
        result["cosim_launches"] = cosim[0]["launches"]
        result["cosim_ranks"] = [
            {k: v for k, v in r.items() if k != "cosim"} for r in cosim]
    elif sc.sdfs_cosim:
        before = merge.launch_snapshot()
        result["cosim"] = run_cosim(sc, cfg, rounds, seed, device=dev,
                                    plain=plain)
        # the co-simulation's chunks (its warm-up chunk included)
        result["cosim_launches"], _ = merge.launches_since(before)
    if return_outputs:
        return result, (final, carry, per_round)
    return result


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scenario", choices=sorted(presets.ALL),
                   default="sim-1k")
    p.add_argument("--n", type=int, default=None,
                   help="override member count")
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--track", type=int, default=4,
                   help="tracked crashes for TTD")
    p.add_argument("--devices", type=int, default=1,
                   help="shard over this many rank processes")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out", type=str, default=None,
                   help="also write JSON here")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.run needs a CUDA device "
                         "(or --device cpu)")
    result = run_scenario(args.scenario, n_override=args.n,
                          rounds_override=args.rounds, seed=args.seed,
                          track=args.track, devices=args.devices,
                          device=args.device)
    doc = json.dumps(result)
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    return result


if __name__ == "__main__":
    main()
