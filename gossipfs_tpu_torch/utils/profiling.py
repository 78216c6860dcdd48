"""Profiling: device traces of the round loop and a slope round timer.

The port of the JAX package's ``utils/profiling.py``, on ``torch.profiler``.

* :func:`trace` wraps ``torch.profiler.profile`` (CPU activities, and CUDA
  ones where a card is present) and writes its Chrome trace into a
  directory (open it in Perfetto or ``chrome://tracing``);
* :func:`op_breakdown` parses that trace and sums the device events by
  name: the kernels of ``csrc/`` (launched through ctypes, named as CUPTI
  reports them) beside torch's own;
* :func:`time_rounds` is the slope timer: two run lengths, timed once each
  after a warm-up, their difference over the rounds between them, which
  is free of the fixed cost of a call.

The round loops update their lanes in place, so each run of
:func:`time_rounds` starts from a fresh copy of the state, made outside
the timed window (the JAX package re-runs one immutable state).

    python -m gossipfs_tpu_torch.utils.profiling TRACE_DIR   # a table
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Iterator

import torch

from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core.rounds import run_rounds
from gossipfs_tpu_torch.core.state import SimState, init_state

TRACE_SUFFIX = ".pt.trace.json"
# device rows of a torch.profiler trace: the processes named for a device,
# and the device event categories (kernels, copies, sets)
DEVICE_PROCESS = ("GPU", "TPU")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str | pathlib.Path) -> Iterator[object]:
    """``with trace(dir) as prof:`` profiles the block and writes its
    Chrome trace to ``dir/<n>.pt.trace.json`` (``n`` counts the traces
    already there)."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len(list(log_dir.glob("*" + TRACE_SUFFIX)))
    prof.export_chrome_trace(str(log_dir / f"{n:04d}{TRACE_SUFFIX}"))


def latest_trace(log_dir: str | pathlib.Path) -> pathlib.Path:
    """The newest :func:`trace` file under ``log_dir``."""
    paths = sorted(pathlib.Path(log_dir).glob("*" + TRACE_SUFFIX))
    if not paths:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} under {log_dir}")
    return paths[-1]


def op_breakdown(log_dir: str | pathlib.Path, top: int = 20) -> list[dict]:
    """Device-event time breakdown from a :func:`trace` capture.

    Keeps the complete (``"ph": "X"``) events of the device: those of a
    process named or labelled for a device, or of a device category
    (kernel, memcpy, memset), and sums their durations by name.  Returns
    ``[{"name", "total_ms", "count"}]`` sorted by total, the ``top``
    first."""
    import collections
    import json

    with open(latest_trace(log_dir), encoding="utf-8") as f:
        tr = json.load(f)
    events = tr["traceEvents"] if isinstance(tr, dict) else tr
    # a device's process says so in its name or its labels ("GPU 0")
    dev = {
        e.get("pid") for e in events
        if e.get("ph") == "M"
        and e.get("name") in ("process_name", "process_labels")
        and any(d in str(v) for v in e.get("args", {}).values()
                for d in DEVICE_PROCESS)
    }
    durs: dict[str, float] = collections.defaultdict(float)
    counts: dict[str, int] = collections.Counter()
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("pid") in dev or e.get("cat") in DEVICE_CATS:
            durs[e["name"]] += float(e.get("dur", 0))
            counts[e["name"]] += 1
    return [
        {"name": name, "total_ms": round(d / 1e3, 3), "count": counts[name]}
        for name, d in sorted(durs.items(), key=lambda kv: -kv[1])[:top]
    ]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_rounds(state: SimState | None, config: SimConfig,
                key: torch.Tensor, *, short: int = 2, long: int = 10,
                crash_rate: float = 0.0, rejoin_rate: float = 0.0) -> dict:
    """Slope-timed cost of a round: (T(long) - T(short)) / (long - short).

    Each run length runs once untimed (the kernels' build and load), then
    once timed on the host clock, ending in a device synchronize on the
    card.  Every run starts from a fresh copy of ``state`` (None: a fresh
    ``init_state(config)`` on the key's device), made outside the timed
    window; ``state`` itself is left as it was.  Returns seconds a round,
    rounds/s and the fixed cost a call."""
    device = key.device

    def fresh() -> SimState:
        if state is None:
            return init_state(config, device=device)
        return state._replace(hb=state.hb.clone(), asl=state.asl.clone(),
                              alive=state.alive.clone(),
                              hb_base=state.hb_base.clone())

    def run(k: int) -> float:
        run_rounds(fresh(), config, k, key, crash_rate=crash_rate,
                   rejoin_rate=rejoin_rate)
        st = fresh()
        _sync(device)
        t0 = time.perf_counter()
        run_rounds(st, config, k, key, crash_rate=crash_rate,
                   rejoin_rate=rejoin_rate)
        _sync(device)
        return time.perf_counter() - t0

    t_short, t_long = run(short), run(long)
    per_round = max((t_long - t_short) / (long - short), 1e-9)
    return {
        "seconds_per_round": per_round,
        "rounds_per_sec": 1.0 / per_round,
        "dispatch_overhead_s": max(t_short - short * per_round, 0.0),
    }


if __name__ == "__main__":
    import sys

    for row in op_breakdown(sys.argv[1] if len(sys.argv) > 1 else "trace"):
        print(f"{row['total_ms']:10.2f} ms  x{row['count']:<5d} "
              f"{row['name'][:90]}")
