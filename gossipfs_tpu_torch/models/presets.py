"""Named protocol models: the five BASELINE.json benchmark configurations.

The port's own copy of the JAX package's presets, built on the port's
``SimConfig`` (field for field the same configurations).  "Models" are
protocol configurations of the gossip simulator (the sim *is* the model of
the distributed system), the way the reference's "model" is its hardcoded
constant block (slave/slave.go:21-29).  ``merge_kernel`` and the tiling
knobs keep the JAX package's values so the configurations compare equal;
the port picks its kernel from the topology and ignores them.
"""

from __future__ import annotations

import dataclasses

from gossipfs_tpu_torch.config import SimConfig


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A benchmark scenario: protocol config + fault schedule + horizon."""

    name: str
    config: SimConfig
    rounds: int
    crash_rate: float = 0.0
    rejoin_rate: float = 0.0
    sdfs_cosim: bool = False
    n_files: int = 0


def reference_parity_10() -> Scenario:
    """Config 1: 10 nodes, ring fanout 3 — the reference's real deployment
    shape (use detector/udp.py for actual sockets, this for the sim twin)."""
    return Scenario(name="parity-10", config=SimConfig(n=10), rounds=120)


def sim_1k() -> Scenario:
    """Config 2: 1k nodes, ring fanout 3, no churn (CPU-feasible)."""
    return Scenario(name="sim-1k", config=SimConfig(n=1024), rounds=120)


def sim_10k_crash() -> Scenario:
    """Config 3: 10k nodes, 1% crash-stop churn.

    Random log-N fanout with gossip-only dissemination and a real cooldown:
    at 10k the ring's freshness diameter dwarfs t_fail, so ring mode would be
    one continuous false-positive storm (see
    tests/test_rounds.py::test_emergent_false_positives_beyond_reference_scale).

    N is 10,240 ("10k-class"): lane-aligned (N % 128 == 0), the width the
    JAX package's TPU kernel needs; the port runs it through the explicit-
    edge merge kernel (ops/merge_update.fused_merge_update).
    """
    n = 10_240
    return Scenario(
        name="sim-10k-crash",
        config=SimConfig(
            n=n,
            topology="random",
            fanout=SimConfig.log_fanout(n),
            remove_broadcast=False,
            fresh_cooldown=True,
            t_cooldown=12,
            # int8 gossip view, int16 relative heartbeat storage
            merge_kernel="pallas",
            view_dtype="int8",
            hb_dtype="int16",
            merge_block_c=16_384,
        ),
        rounds=120,
        crash_rate=0.01,
    )


def sim_100k() -> Scenario:
    """Config 4: 100k nodes, fanout log N, 5% churn + preemption (v5e-8).

    N is 131,072 (2^17, "100k-class").  Its lanes alone (int16 hb, the
    packed age|status byte and the int8 view) take 68.7 GB, beyond one
    80 GB card with any temporaries: the port's single-card runs cut N.
    """
    n = 131_072
    return Scenario(
        name="sim-100k",
        config=SimConfig(
            n=n,
            topology="random",
            fanout=SimConfig.log_fanout(n),
            remove_broadcast=False,
            fresh_cooldown=True,
            t_cooldown=12,
            merge_kernel="pallas",
            view_dtype="int8",
            hb_dtype="int16",
            merge_block_c=16_384,
        ),
        rounds=60,
        crash_rate=0.05,
        rejoin_rate=0.05,
    )


def sim_100k_sdfs() -> Scenario:
    """Config 5: config 4 plus SDFS replica re-placement consuming the sim
    membership view (the SDFS co-simulation is not ported yet)."""
    sc = sim_100k()
    return dataclasses.replace(sc, name="sim-100k-sdfs", sdfs_cosim=True, n_files=1000)


ALL = {
    s.name: s
    for s in (
        reference_parity_10(),
        sim_1k(),
        sim_10k_crash(),
        sim_100k(),
        sim_100k_sdfs(),
    )
}
