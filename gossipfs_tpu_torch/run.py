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
master's membership row every 8 rounds, in one process (with
``--devices K`` it raises).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

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
    timed run's kernel launches) on the host."""
    from gossipfs_tpu_torch.parallel import distributed, mesh

    job = dict(config=cfg, rounds=rounds, seed=seed, events=events,
               crash_rate=sc.crash_rate, rejoin_rate=sc.rejoin_rate,
               churn_ok=churn_ok, crash_only_events=True, warm=True)
    threads = max(1, (os.cpu_count() or 1) // devices)
    head = distributed.launch(mesh.run_job, devices, (job,),
                              timeout=RANK_TIMEOUT, device=device,
                              threads=threads)[0]
    launches = {k: v for k, v in head["launches"].items() if v}
    return (head["state"], head["carry"], head["metrics"], head["seconds"],
            launches)


def run_cosim(sc: presets.Scenario, cfg: SimConfig, rounds: int,
              seed: int, device="cuda", plain: bool = False) -> dict:
    """Config 5's co-simulation: the SDFS control plane consuming the
    simulated membership, in chunks of ``RECOVERY_DELAY`` rounds (8
    heartbeats, the sleep in Fail_recover, slave.go:1123).  Between
    chunks the master's own membership row feeds placement and repair
    planning, as in the JAX package's ``bench/run.run_cosim``: the same
    key for every chunk (its rounds fold in their own indices), the
    ground-truth alive mask and the observer's row read back as one
    packet a chunk, the same reaction and the same report.

    The JAX runner pipelines: it dispatches chunk k+1 before reacting to
    chunk k, and when the observer changed it refetches that observer's
    row from chunk k's state.  The port's rounds update the lanes in
    place, so chunk k's state is gone once chunk k+1 runs; this runner
    reacts to chunk k before it runs chunk k+1 instead.  The reaction
    never feeds back into the detector, so the outputs are the same; only
    the host's reaction is no longer overlapped with the device's next
    chunk.  When the cluster empties, the JAX runner had already
    run the next chunk and counts it: so does this one."""
    from gossipfs_tpu_torch.cosim import select_observer
    from gossipfs_tpu_torch.sdfs.cluster import SDFSCluster
    from gossipfs_tpu_torch.sdfs.types import RECOVERY_DELAY

    dev = torch.device(device)
    n = cfg.n

    def membership_packet(state: SimState, observer: int) -> np.ndarray:
        """alive mask + observer's MEMBER row in one host transfer."""
        row = (state.asl[observer] & 3) == MEMBER
        return torch.cat([state.alive, row]).cpu().numpy()

    cluster = SDFSCluster(n, seed=seed, introducer=cfg.introducer)
    for f in range(sc.n_files):
        cluster.put(f"file{f}.txt", b"payload-%d" % f, now=0)
    key = trandom.PRNGKey(seed, device=dev)
    # random churn spares the introducer (see bench.tracked_crash_events):
    # with it dead no rejoin can ever land and the population decays
    churn_ok = torch.arange(n, device=dev) != cfg.introducer
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
    membership_packet(warm, cluster.master_node)
    del warm
    state = init_state(cfg, device=dev)
    repairs = 0
    elections = 0
    done = 0
    alive: list[int] = []

    def react(packet: np.ndarray, now: int, state: SimState) -> bool:
        """One control-plane reaction off the chunk's packet (its row read
        for the master); False when the cluster is empty (stop)."""
        nonlocal repairs, elections, alive
        alive_mask, row = packet[:n], packet[n:]
        alive = np.nonzero(alive_mask)[0].tolist()
        if not alive:
            # feed the empty membership so the closing durability check
            # can't satisfy quorum against stores of dead nodes
            cluster.update_membership([], reachable=[], now=now)
            return False
        observer = select_observer(cluster.live, set(alive),
                                   cluster.master_node)
        if observer is None:
            return True
        if observer != cluster.master_node:
            # never consume a dead master's frozen view
            row = membership_packet(state, observer)[n:]
        view = np.nonzero(row)[0]
        old_master = cluster.master_node
        cluster.update_membership(view.tolist(), reachable=alive, now=now)
        if cluster.master_node != old_master:
            elections += 1
        repairs += len(cluster.fail_recover())
        return True

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(n_chunks):
        state = run_chunk(state)
        done += chunk
        if not react(membership_packet(state, cluster.master_node), done,
                     state):
            if i + 1 < n_chunks:
                # the pipelined reference had dispatched the next chunk
                state = run_chunk(state)
                done += chunk
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    # durability: how many files still answer a quorum read at the end
    readable = sum(
        1 for f in range(sc.n_files)
        if cluster.get(f"file{f}.txt") is not None)
    return {
        "rounds": done,
        "elapsed_s": round(elapsed, 3),
        "rounds_per_sec": round(done / elapsed, 2) if elapsed else None,
        "files": sc.n_files,
        "files_readable": readable,
        "repair_plans": repairs,
        "elections": elections,
        "final_alive": len(alive),
    }


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
    chunks.  ``return_outputs``
    returns (report, (final state, MetricsCarry, RoundMetrics)) instead.
    """
    if isinstance(sc, str):
        sc = presets.ALL[sc]
    cfg = scenario_config(sc, n_override)
    rounds = rounds_override or sc.rounds
    dev = torch.device(device)
    sharded = devices > 1 and cfg.topology != "ring"
    if sc.sdfs_cosim and sharded:
        # refuse before the detector's run, whose report it would extend
        raise NotImplementedError(
            f"scenario {sc.name!r} over {devices} rank processes: the "
            "co-simulation's chunks run in one process; its sharded form "
            "waits for ROADMAP Queue 1 item 2")
    if plain and sharded:
        raise ValueError("plain=True runs in one process (devices=1)")
    events, crash_rounds, churn_ok = tracked_crash_events(
        cfg, rounds, track, crash_at,
        device="cpu" if sharded else dev)
    if sharded:
        final, carry, per_round, elapsed, launches = _sharded_run(
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
    if sc.sdfs_cosim:
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
