"""The flight recorder: one schema, JSONL out.

The port's copy of the JAX package's ``gossipfs_tpu/obs/recorder.py``:

* :func:`decode_scan` expands a finished run's EXISTING outputs (the
  stacked ``RoundMetrics`` and the final ``MetricsCarry`` of
  ``core/rounds.run_rounds`` or ``run_lean_packed``) into schema events on
  the host, after the run returns.  No device work is added: the kernels
  and the rounds are the same with or without recording.  The fields may
  be torch tensors on any device or numpy arrays; each is moved to the
  host once.
* :class:`FlightRecorder` accumulates events (``SimDetector.
  attach_recorder`` takes one) and mirrors them to a JSONL file.
* :func:`write_trace` is the one-call form behind the ``--trace`` flags of
  ``bench.py``, ``frontier.py`` and ``curves.py``.

This module imports numpy only (not torch): a tensor is recognised by its
``cpu`` method.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from gossipfs_tpu_torch.obs import schema
from gossipfs_tpu_torch.obs.schema import Event


def _host(x) -> np.ndarray:
    """One host copy of a tensor (``x.cpu().numpy()``) or an array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def load_stream(path) -> tuple[dict | None, list[Event]]:
    """One JSONL stream -> (header row or None, schema events).

    THE one reader of the ``gossipfs-obs/v1`` line format — the
    post-hoc analyzer (``obs/timeline.py``) and the streaming monitor
    (``obs/monitor.py feed_jsonl``) both parse through here, so the two
    derivations the ``monitor_parity`` oracle compares can never read a
    stream differently.  Tolerates deploy node logs (no header;
    ``node`` names the observer) and skips rows carrying no schema kind
    (free-text legacy lines, campaign-ledger metadata).
    """
    header = None
    events: list[Event] = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # free-text line in a legacy log
            if i == 0 and schema.is_header(rec):
                header = rec
                continue
            if rec.get("kind") in schema.EVENT_KINDS:
                events.append(Event.from_record(rec))
    return header, events


class FlightRecorder:
    """Accumulates schema events, optionally mirrored to a JSONL file.

    The header row is written on construction; events append in arrival
    order.  ``events`` is always available in memory (the parity tests
    and the timeline selfcheck read it without touching disk).
    """

    def __init__(self, path: str | pathlib.Path | None = None,
                 source: str = "sim", n: int | None = None, **meta):
        self.header = schema.header(source, n=n, **meta)
        self.events: list[Event] = []
        self._fh = None
        if path is not None:
            self._fh = open(path, "w", encoding="utf-8")
            self._fh.write(schema.dumps(self.header) + "\n")

    def emit(self, ev: Event) -> None:
        self.events.append(ev)
        if self._fh is not None:
            self._fh.write(schema.dumps(ev.to_record()) + "\n")

    def extend(self, events) -> None:
        for ev in events:
            self.emit(ev)

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # convenience for tests / the analyzer
    def kinds(self, subject: int | None = None) -> list[str]:
        return [e.kind for e in self.events
                if subject is None or e.subject == subject]


def decode_scan(
    per_round,
    mcarry,
    *,
    n: int,
    start_round: int = 0,
    crash_rounds: dict[int, int] | None = None,
    alive=None,
    suspicion: bool = False,
    n_effective: int | None = None,
) -> list[Event]:
    """Expand a finished scan's outputs into schema events (host-side).

    ``per_round``: the stacked ``RoundMetrics`` over the horizon;
    ``mcarry``: the final ``MetricsCarry``; ``start_round``: the state's
    round counter when the scan began (events stamp absolute rounds);
    ``crash_rounds``: {node: round} for scheduled/tracked faults (emits
    ground-truth ``crash`` + ``hb_freeze`` rows); ``alive``: final
    ground-truth liveness [N] — when given, ``confirm`` events carry
    ``detail.false_positive`` exactly like the interactive path's
    DetectionEvents.  ``suspicion``: whether the SWIM lifecycle was
    armed (gates the per-subject ``suspect`` rows and the suspicion
    counters in ``round_tick``).  ``n_effective``: live-cohort size for
    PADDED runs (bench/frontier.py's literal-N padding) — permanently
    dead alignment pads past it "converge" at the scan's first round,
    and without the mask each would export a phantom ``remove`` row.

    Consumes arrays the run already returned: each field is one host
    transfer of data the caller's ``summarize`` reads anyway.
    """
    events: list[Event] = []
    tp = _host(per_round.true_detections)
    fp = _host(per_round.false_positives)
    na = _host(per_round.n_alive)
    se = _host(per_round.suspects_entered)
    rf = _host(per_round.refutations)
    fs = _host(per_round.fp_suppressed)
    rounds = len(tp)

    # ground-truth fault rows first (they precede everything they cause)
    for node, r0 in sorted((crash_rounds or {}).items()):
        events.append(Event(round=int(r0), observer=-1, subject=int(node),
                            kind="crash", detail={"scheduled": True}))
        events.append(Event(round=int(r0), observer=-1, subject=int(node),
                            kind="hb_freeze"))

    # one round_tick per round — the RoundMetrics row as an event.  Every
    # round is emitted (not just eventful ones): the analyzer's FPR
    # denominator needs n_alive for the whole horizon.
    for i in range(rounds):
        detail = {
            "n_alive": int(na[i]),
            "true_detections": int(tp[i]),
            "false_positives": int(fp[i]),
        }
        if suspicion:
            detail.update(suspects_entered=int(se[i]),
                          refutations=int(rf[i]),
                          fp_suppressed=int(fs[i]))
        events.append(Event(round=start_round + i, observer=-1, subject=-1,
                            kind="round_tick", detail=detail))

    first = _host(mcarry.first_detect)
    obs_v = _host(mcarry.first_observer)
    conv = _host(mcarry.converged)
    first_sus = _host(mcarry.first_suspect)
    alive_h = None if alive is None else _host(alive)
    end = start_round + rounds

    n_eff = n if n_effective is None else n_effective

    def window(v: np.ndarray) -> np.ndarray:
        # subjects whose event landed in THIS scan's horizon — nonzero
        # over the vector, so a quiet N=100k trace costs O(events) python.
        # Alignment pads (subjects >= n_eff) never export: they were
        # never members, so their carries are artifacts, not lifecycle.
        in_w = (v >= start_round) & (v < end)
        in_w[n_eff:] = False
        return np.nonzero(in_w)[0]

    if suspicion:
        for j in window(first_sus):
            events.append(Event(round=int(first_sus[j]), observer=-1,
                                subject=int(j), kind="suspect"))
    for j in window(first):
        detail = {}
        if alive_h is not None:
            detail["false_positive"] = bool(alive_h[j])
        events.append(Event(round=int(first[j]), observer=int(obs_v[j]),
                            subject=int(j), kind="confirm", detail=detail))
    for j in window(conv):
        events.append(Event(round=int(conv[j]), observer=-1,
                            subject=int(j), kind="remove"))
    events.sort(key=lambda e: e.round)
    return events


def write_trace(
    path: str | pathlib.Path,
    per_round,
    mcarry,
    *,
    n: int,
    source: str,
    start_round: int = 0,
    crash_rounds: dict[int, int] | None = None,
    alive=None,
    suspicion: bool = False,
    n_effective: int | None = None,
    **meta,
) -> int:
    """One-call trace emission for the bench ``--trace PATH`` flags.

    Decodes the scan and writes header + events; returns the event
    count.  ``crash_rounds`` lands in the header too, so the analyzer
    can compute TTD without re-deriving the fault schedule, and
    ``n_effective`` both masks the pad subjects out of the decode and
    names the FPR cohort in the header.
    """
    if crash_rounds:
        meta["crash_rounds"] = {str(k): int(v)
                                for k, v in sorted(crash_rounds.items())}
    if n_effective is not None:
        meta["n_effective"] = int(n_effective)
    rec = FlightRecorder(path, source=source, n=n,
                         start_round=start_round, suspicion=suspicion,
                         **meta)
    try:
        rec.extend(decode_scan(
            per_round, mcarry, n=n, start_round=start_round,
            crash_rounds=crash_rounds, alive=alive, suspicion=suspicion,
            n_effective=n_effective,
        ))
    finally:
        rec.close()
    return len(rec.events)
