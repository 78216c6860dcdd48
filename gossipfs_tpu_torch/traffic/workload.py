"""Latency rollups of the traffic plane.

The port's copy of ``quantiles`` from the JAX package's
``gossipfs_tpu/traffic/workload.py``: the one nearest-rank convention
every ``client_op`` consumer uses (the streaming monitor's summary, the
analyzer's stream rollup).  The open-loop generator and its drivers
(``WorkloadSpec``, ``drive_cosim``, ``drive_shim``) are not ported yet
(ROADMAP Queue 1, item 7).
"""

from __future__ import annotations


def quantiles(vals: list[float]) -> dict:
    """Nearest-rank p50/p95/max rollup for latency lists — the ONE
    convention every client_op consumer uses (the drivers' window
    summaries, obs/timeline.py's stream rollup)."""
    if not vals:
        return {"p50_ms": None, "p95_ms": None, "max_ms": None}
    s = sorted(vals)
    return {
        "p50_ms": round(s[len(s) // 2], 4),
        "p95_ms": round(s[min(len(s) - 1, int(len(s) * 0.95))], 4),
        "max_ms": round(s[-1], 4),
    }
