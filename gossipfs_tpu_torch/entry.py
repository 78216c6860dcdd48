"""Entry points of the port: one flagship step, and a multi-rank dry run.

The port of the JAX package's ``__graft_entry__.py``.  The flagship
"model" is the batched gossip-protocol simulator: one step advances all N
nodes' membership tables by one heartbeat round.

* :func:`entry` returns ``(step, (state, events, edges))``: one
  ``gossip_round`` on the flagship configuration (N = 256, random edges at
  fanout log2 N, gossip-only with fresh cooldown, an int8 view and int16
  heartbeats, the explicit-edge merge: K2 on the card).  The port updates
  its lanes in place, so ``step`` advances ``state`` itself.
* :func:`dryrun_multichip` runs the JAX package's three sharded checks
  over rank processes (``parallel.mesh.run_rounds_sharded``, started by
  ``parallel.distributed.launch``): the random configuration, the random
  configuration at 128 columns a rank, and the aligned-arc resident-round
  configuration over 2 ranks.

Both run on the card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import torch

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core.rounds import gossip_round
from gossipfs_tpu_torch.core.state import RoundEvents, init_state
from gossipfs_tpu_torch.core.topology import random_in_edges

#: a dry run's ranks: the launch's time limit, seconds
DRYRUN_TIMEOUT = 300.0


def _require_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return dev


def flagship_config() -> SimConfig:
    """The flagship configuration (the JAX package's ``entry()``'s)."""
    return SimConfig(
        n=256,
        topology="random",
        fanout=SimConfig.log_fanout(256),
        remove_broadcast=False,
        fresh_cooldown=True,
        merge_kernel="pallas",
        view_dtype="int8",
        hb_dtype="int16",
    )


def entry(device="cuda", plain: bool = False):
    """(step, (state, events, edges)): one gossip round on the flagship
    configuration, on ``device``.  ``step(state, events, edges)`` returns
    (state, RoundMetrics); ``plain=True`` runs the merge's plain version
    (the reference the kernel is held against on the card)."""
    dev = _require_device(device)
    cfg = flagship_config()
    state = init_state(cfg, device=dev)
    quiet = torch.zeros(cfg.n, dtype=torch.bool, device=dev)
    events = RoundEvents(crash=quiet, leave=quiet, join=quiet)
    edges = random_in_edges(trandom.PRNGKey(0, device=dev), cfg.n,
                            cfg.fanout)

    def step(state, events, edges):
        new_state, metrics, _any_fail, _first_obs = gossip_round(
            state, events, edges, cfg, plain=plain)
        return new_state, metrics

    return step, (state, events, edges)


def dryrun_configs(n_devices: int) -> list[tuple[str, SimConfig, int, int]]:
    """The dry run's checks: (name, configuration, rounds, ranks), the JAX
    package's ``dryrun_multichip`` configurations."""
    return [
        ("sharded", SimConfig(n=16 * n_devices, topology="random", fanout=4,
                              remove_broadcast=False, fresh_cooldown=True),
         3, n_devices),
        ("shard_map", SimConfig(n=128 * n_devices, topology="random",
                                fanout=4), 3, n_devices),
        # the resident round's column-shard form on tile-aligned arcs
        ("sharded-rr", SimConfig(
            n=2048, topology="random_arc", fanout=16, arc_align=8,
            remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
            view_dtype="int8", hb_dtype="int8", merge_block_c=1024,
            merge_kernel="pallas_rr"), 2, 2),
    ]


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the three sharded checks over rank processes on ``device``
    (rank r on ``cuda:(r % device_count)``, or the CPU).  Returns, by
    check name, rank 0's gathered outputs (``state``, ``carry``,
    ``metrics``, on the host) and its launches; prints one line a check.
    The checks of one rank count share a launch, which has a finite time
    limit."""
    from gossipfs_tpu_torch.parallel import distributed, mesh

    _require_device(device)
    crash = {"sharded": 0.02, "shard_map": 0.02, "sharded-rr": 0.01}
    checks = dryrun_configs(n_devices)
    out = {}
    for world in sorted({c[3] for c in checks}):
        mine = [c for c in checks if c[3] == world]
        jobs = [dict(config=cfg, rounds=rounds, seed=0,
                     crash_rate=crash[name])
                for name, cfg, rounds, _ in mine]
        heads = distributed.launch(
            mesh.run_jobs, world, (jobs,), timeout=DRYRUN_TIMEOUT,
            device=device, threads=1 if str(device) == "cpu" else None)[0]
        for (name, cfg, _, _), head in zip(mine, heads):
            assert tuple(head["state"].hb.shape) == (cfg.n, cfg.n)
            print(f"dryrun {name} ok: {world} ranks, N={cfg.n}, "
                  f"{head['nloc']} columns a rank, route {head['route']}, "
                  f"backend {head['backend']}")
            out[name] = head
    return out
