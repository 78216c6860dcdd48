"""The port's streaming invariant monitor against the JAX package's.

The synthetic streams of the JAX package's monitor tests (no confirm
without a suspect, acked-write loss, the reconvergence bound and its
episodes, the durability gate, the edge-triggered FPR storm, a deploy
log tail) go through both monitors: equal ``summary()``, ``verdict()``
and violation events.  ``MonitorRecorder`` (inline) equals a fresh
monitor replaying its written stream through ``feed_jsonl``, and
``monitor_verdict`` / ``estimator_parity`` agree with the JAX package's.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from types import SimpleNamespace

import pytest

from gossipfs_tpu.obs import monitor as jmon
from gossipfs_tpu.obs import recorder as jrec
from gossipfs_tpu.obs import schema as jschema
from gossipfs_tpu_torch.obs import monitor as tmon
from gossipfs_tpu_torch.obs import recorder as trec
from gossipfs_tpu_torch.obs import schema as tschema
from gossipfs_tpu_torch.obs import timeline

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX = SimpleNamespace(mon=jmon, E=jschema.Event)
PORT = SimpleNamespace(mon=tmon, E=tschema.Event)


def tick(E, r, fp=0, alive=32, sus=None):
    detail = {"n_alive": alive, "true_detections": 0, "false_positives": fp}
    if sus is not None:
        detail.update(suspects_entered=sus, refutations=0, fp_suppressed=0)
    return E(round=r, observer=-1, subject=-1, kind="round_tick",
             detail=detail)


def put(E, r, name, reps):
    return E(round=r, observer=0, subject=-1, kind="replica_put",
             detail={"file": name, "version": 1, "replicas": reps})


def ev(E, r, subject, kind, observer=-1, **detail):
    return E(round=r, observer=observer, subject=subject, kind=kind,
             detail=detail)


def confirm_without_suspect(E):
    return dict(n=32), [
        tick(E, 0, sus=0),
        ev(E, 2, 5, "suspect"),
        ev(E, 4, 5, "confirm", observer=1),
        ev(E, 5, 9, "confirm", observer=2),     # no preceding suspect
    ]


def acked_write_lost(E):
    return dict(n=8), [put(E, 1, "a.txt", [1, 2]), put(E, 1, "b.txt", [3]),
                       ev(E, 3, 3, "crash")]


def rejoin_heals(E):
    return dict(n=8), [put(E, 1, "b.txt", [3]), ev(E, 3, 3, "crash"),
                       ev(E, 6, 3, "join")]


def reconverge(tail):
    def script(E):
        base = [ev(E, 2, 4, "crash"), *[tick(E, r) for r in range(20)]]
        return (dict(n=16, params={"reconverge_bound": 8}),
                base + tail(E))
    return script


def episodes(E):
    return dict(n=16, params={"reconverge_bound": 8}), [
        ev(E, 2, 4, "crash"),
        *[tick(E, r) for r in range(40)],
        ev(E, 20, 4, "remove"),
        ev(E, 20, 4, "remove", observer=1),
        ev(E, 21, 4, "remove", observer=2),
        ev(E, 25, 4, "join"),
        ev(E, 30, 4, "crash"),
        ev(E, 36, 4, "remove"),
    ]


def repair_only_tail(E):
    return {}, [tick(E, 0), E(round=1, observer=0, subject=-1,
                              kind="replica_repair",
                              detail={"file": "a", "version": 1,
                                      "targets": [2]})]


def fpr_storm(E):
    return dict(n=32, params={"fpr_threshold": 1e-3, "fpr_window": 4}), (
        [tick(E, r) for r in range(6)]
        + [tick(E, 6, fp=8), tick(E, 7, fp=8)]
        + [tick(E, r) for r in range(8, 14)]
        + [tick(E, 14, fp=9)])


def suspicion_stream(E):
    return dict(n=32, params={"reconverge_bound": 6}), [
        ev(E, 1, 7, "crash"), ev(E, 1, 7, "hb_freeze"),
        tick(E, 0, sus=0), tick(E, 1, sus=2), tick(E, 2, sus=1, fp=1),
        ev(E, 3, 7, "suspect"), ev(E, 4, 7, "confirm", observer=3,
                                   false_positive=False),
        ev(E, 4, 11, "suspect"), ev(E, 5, 11, "refute"),
        ev(E, 6, 12, "confirm", observer=0, false_positive=True),
        tick(E, 7, sus=0), ev(E, 9, 7, "remove"),
        E(round=9, observer=-1, subject=-1, kind="client_op",
          detail={"op": "put", "file": "f", "bytes": 3, "ms": 1.5,
                  "ok": True}),
        E(round=10, observer=-1, subject=-1, kind="client_op",
          detail={"op": "get", "file": "f", "bytes": 3, "ms": 0.25,
                  "ok": False}),
        ev(E, 12, 13, "crash"),
        *[tick(E, r) for r in range(8, 22)],
    ]


SCRIPTS = {
    "confirm_without_suspect": confirm_without_suspect,
    "acked_write_lost": acked_write_lost,
    "rejoin_heals": rejoin_heals,
    "reconverge_in_time": reconverge(
        lambda E: [ev(E, 9, 4, "remove")]),
    "reconverge_never": reconverge(lambda E: []),
    "reconverge_after_clear": reconverge(lambda E: [
        ev(E, 14, -1, "scenario_clear"), ev(E, 18, 4, "remove")]),
    "episodes": episodes,
    "repair_only_tail": repair_only_tail,
    "fpr_storm": fpr_storm,
    "suspicion_stream": suspicion_stream,
}


def monitored(side, script):
    kw, events = script(side.E)
    params = kw.pop("params", None)
    if params is not None:
        kw["params"] = side.mon.MonitorParams(**params)
    mon = side.mon.StreamMonitor(**kw)
    raised = mon.feed(events) + mon.finish()
    return mon, raised, events


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_monitor_matches_jax(name):
    (jm, jraised, jev), (tm, traised, tev) = (
        monitored(side, SCRIPTS[name]) for side in (JAX, PORT))
    assert tm.summary() == jm.summary()
    assert tm.verdict() == jm.verdict()
    assert ([v.to_record() for v in traised]
            == [v.to_record() for v in jraised])
    assert ([v.to_record() for v in tm.violations]
            == [v.to_record() for v in jm.violations])
    assert tm.crash_rounds == jm.crash_rounds
    # the post-hoc analyzer agrees with the streaming estimators
    doc = timeline.analyze([], tev)
    assert (tmon.estimator_parity(doc, tm.summary())
            == jmon.estimator_parity(doc, jm.summary()))
    assert (tmon.monitor_verdict(tev, n=tm.n or 1, params=tm.params)
            == jmon.monitor_verdict(jev, n=jm.n or 1, params=jm.params))


def test_scripts_cover_every_invariant():
    fired = set()
    for script in SCRIPTS.values():
        mon, _, _ = monitored(PORT, script)
        fired |= set(mon.verdict()["by_invariant"])
    assert fired == set(tmon.INVARIANTS)
    assert tmon.INVARIANTS == jmon.INVARIANTS
    assert tmon.PARITY_FIELDS == jmon.PARITY_FIELDS


def test_monitor_params_round_trip():
    p = tmon.MonitorParams(fpr_threshold=None, reconverge_bound=9,
                           clock_floor=4, expect_suspicion=True)
    assert p.to_json() == jmon.MonitorParams(
        fpr_threshold=None, reconverge_bound=9, clock_floor=4,
        expect_suspicion=True).to_json()
    assert tmon.MonitorParams.from_dict(json.loads(p.to_json())) == p


@pytest.mark.parametrize("name", ["fpr_storm", "suspicion_stream",
                                  "episodes"])
def test_monitor_recorder_inline_equals_replay(name, tmp_path):
    """The inline monitor stamps its violations into the written stream;
    a fresh monitor replaying the file re-derives (not double-counts)
    them, and the JAX package's does the same on the same file."""
    kw, events = SCRIPTS[name](tschema.Event)
    params = tmon.MonitorParams(**kw.get("params", {}))
    path = tmp_path / "inline.jsonl"
    rec = tmon.MonitorRecorder(path, source="sim", n=kw.get("n"),
                               params=params)
    rec.extend(events)
    rec.close()
    inline = [e for e in rec.events if e.kind == "invariant_violation"]
    assert inline == rec.monitor.violations
    replays = []
    for mod in (tmon, jmon):
        mon = mod.StreamMonitor(params=mod.MonitorParams(
            **kw.get("params", {})))
        mon.feed_jsonl(path)
        mon.finish()
        replays.append(mon)
    tm, jm = replays
    assert ([v.to_record() for v in tm.violations]
            == [v.to_record() for v in inline])
    assert tm.summary() == jm.summary() and tm.verdict() == jm.verdict()
    doc = timeline.analyze(*timeline.merge([str(path)]))
    assert doc["invariant_violations"] == len(inline)


def test_deploy_log_tail_mode(tmp_path):
    """feed_jsonl over a deploy-style node log (no header, ``node``
    names the observer, a free-text line)."""
    p = tmp_path / "node1.log"
    p.write_text(
        json.dumps({"round": 1, "node": 1, "kind": "suspect",
                    "subject": 3}) + "\n"
        + "free text line survives\n"
        + json.dumps({"round": 3, "node": 1, "kind": "confirm",
                      "subject": 3}) + "\n"
        + json.dumps({"round": 4, "node": 1, "kind": "confirm",
                      "subject": 5}) + "\n")
    out = []
    for mod in (tmon, jmon):
        mon = mod.StreamMonitor(
            params=mod.MonitorParams(expect_suspicion=True), n=5)
        viol = mon.feed_jsonl(p)
        out.append(([v.to_record() for v in viol], mon.summary()))
    assert out[0] == out[1]
    assert [r["subject"] for r in out[0][0]] == [5]
    assert (trec.load_stream(p)[1][0].to_record()
            == jrec.load_stream(p)[1][0].to_record())


def test_analyzer_merges_streams_like_jax(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "timeline_tool", REPO / "tools" / "timeline.py")
    jt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jt)
    paths = []
    for i, name in enumerate(("suspicion_stream", "episodes")):
        _, events = SCRIPTS[name](tschema.Event)
        rec = trec.FlightRecorder(tmp_path / f"s{i}.jsonl", source="sim",
                                  n=32)
        rec.extend(events)
        rec.close()
        paths.append(str(tmp_path / f"s{i}.jsonl"))
    th, tev = timeline.merge(paths)
    jh, jev = jt.merge(paths)
    assert th == jh
    assert [e.to_record() for e in tev] == [e.to_record() for e in jev]
    assert timeline.analyze(th, tev) == jt.analyze(jh, jev)
