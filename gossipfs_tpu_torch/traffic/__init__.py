"""SDFS traffic plane: open-loop load + tensorized placement/repair planning.

The port of the JAX package's ``gossipfs_tpu/traffic/``:

  * ``workload.py`` — a deterministic OPEN-LOOP generator (arrivals keep
    coming whether or not the system keeps up): put/get/delete mixes at a
    controlled per-round rate, Zipf or uniform key popularity, file-size
    distribution mirroring the reference's ~3-4 MB Wikipedia shards; the
    driver for the interactive CoSim (the shim's waits for the shim:
    ROADMAP Queue 1 item 7), and ``quantiles``.
  * ``planner.py`` — placement and repair planning TENSORIZED against the
    live [N] alive mask on the device: thousands of placements per round
    and the whole repair set (replicas-lost x under-replicated-files) as
    one masked top k, with a per-round repair budget (the repair-storm
    scheduler).  Quorum arithmetic is imported from ``sdfs/quorum.py``.
  * ``harness.py`` + ``audit.py`` — latency/throughput/durability runs
    (steady state, churn, a write burst racing a timed partition, a
    rack-kill repair storm), every op and repair flight-recorded so
    ``obs/timeline.py`` re-derives the durability facts from events
    alone.
"""

from gossipfs_tpu_torch.traffic.workload import Workload, WorkloadSpec  # noqa: F401
