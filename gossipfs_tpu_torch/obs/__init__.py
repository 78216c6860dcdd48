"""Observability: one event schema, a flight recorder, a streaming monitor.

The port's copy of the JAX package's ``gossipfs_tpu/obs/``:

* ``obs/schema.py`` — the versioned record shape, the kind registry and
  the uniform vitals field set;
* ``obs/recorder.py`` — the flight recorder: the post-run decoder over
  the round loops' existing outputs (no new device work) and the
  ``FlightRecorder`` that ``SimDetector.attach_recorder`` takes;
* ``obs/monitor.py`` — the online health plane: a streaming invariant
  monitor (incremental TTD/FPR/durability estimators + the declarative
  invariant table) that rides ``attach_recorder`` via ``MonitorRecorder``
  and must agree with ``obs/timeline.py``'s post-hoc derivation exactly;
* ``obs/timeline.py`` — the analyzer: merges streams, reconstructs
  per-subject timelines and re-derives TTD/FPR from events alone.

The recorder and monitor exports resolve LAZILY (module ``__getattr__``),
as in the JAX package: ``obs.schema`` imports without numpy.
"""

from gossipfs_tpu_torch.obs.schema import (
    EVENT_KINDS,
    SCHEMA,
    VITALS_FIELDS,
    Event,
    render_vitals,
)

_RECORDER_EXPORTS = ("FlightRecorder", "decode_scan", "load_stream",
                     "write_trace")
_MONITOR_EXPORTS = ("INVARIANTS", "MonitorParams", "MonitorRecorder",
                    "StreamMonitor", "estimator_parity", "monitor_verdict")

__all__ = [
    "EVENT_KINDS",
    "SCHEMA",
    "VITALS_FIELDS",
    "Event",
    "render_vitals",
    *_RECORDER_EXPORTS,
    *_MONITOR_EXPORTS,
]


def __getattr__(name: str):
    if name in _RECORDER_EXPORTS:
        from gossipfs_tpu_torch.obs import recorder

        return getattr(recorder, name)
    if name in _MONITOR_EXPORTS:
        from gossipfs_tpu_torch.obs import monitor

        return getattr(monitor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
