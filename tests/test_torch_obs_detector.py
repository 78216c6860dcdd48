"""The port's ``SimDetector`` recorder seam against the JAX package's.

The detector scripts of the JAX package's observability tests,
run through both packages' ``SimDetector`` on the same seed with a
``FlightRecorder`` (or a ``MonitorRecorder``) attached: identical event
streams, record for record.

* a crash / leave / join / crash script with SWIM suspicion (N = 64,
  random edges), advanced interactively, in one bulk call each step and
  in chunked bulk calls (``snapshot_every``);
* bulk advancement: the confirm rows carry the drained detection events'
  (round, observer, subject) triples, and the verbs become ground-truth
  rows;
* no refute for a suspect that leaves; suspect -> refute when a
  partition heals inside the SUSPECT window; ``scenario_arm`` and
  ``scenario_clear`` rows, interactive and bulk;
* a ``MonitorRecorder`` on a flapping scenario (its FPR-storm violation
  inline) and on bulk runs;
* within the port: interactive and bulk streams of one script agree on
  the ground-truth rows and on the first confirm per subject.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.detector.sim import SimDetector as JaxDetector
from gossipfs_tpu.obs import monitor as jmon
from gossipfs_tpu.obs import recorder as jrec
from gossipfs_tpu.scenarios import FaultScenario as JaxScenario
from gossipfs_tpu.scenarios import Flapping as JaxFlapping
from gossipfs_tpu.scenarios import split_halves as jax_split
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.detector.sim import SimDetector
from gossipfs_tpu_torch.obs import monitor as tmon
from gossipfs_tpu_torch.obs import recorder as trec
from gossipfs_tpu_torch.scenarios import FaultScenario, Flapping, split_halves
from gossipfs_tpu_torch.suspicion import SuspicionParams

torch.set_num_threads(1)

SIDES = {
    "jax": dict(config=JaxConfig, detector=JaxDetector, rec=jrec, mon=jmon,
                sus=JaxSus, split=jax_split, scenario=JaxScenario,
                flapping=JaxFlapping, kw={}),
    "torch": dict(config=SimConfig, detector=SimDetector, rec=trec,
                  mon=tmon, sus=SuspicionParams, split=split_halves,
                  scenario=FaultScenario, flapping=Flapping,
                  kw={"device": "cpu"}),
}
SCRIPT = dict(n=64, topology="random", fanout=6, remove_broadcast=False,
               fresh_cooldown=True, t_fail=3, t_cooldown=6,
               view_dtype="int8", hb_dtype="int16")
BULK = dict(n=32, topology="random", fanout=5, remove_broadcast=False,
            fresh_cooldown=True, t_cooldown=12, merge_kernel="xla")
TEN = dict(n=10, remove_broadcast=False, fresh_cooldown=True, t_cooldown=6,
           t_fail=3)


def detector(side, cfg_kw, t_suspect=None, seed=0, monitor=None):
    s = SIDES[side]
    cfg = s["config"](**cfg_kw)
    if t_suspect is not None:
        cfg = dataclasses.replace(
            cfg, suspicion=s["sus"](t_suspect=t_suspect))
    det = s["detector"](cfg, seed=seed, **s["kw"])
    if monitor is None:
        rec = s["rec"].FlightRecorder(source="sim", n=cfg.n)
    else:
        rec = s["mon"].MonitorRecorder(
            source="sim", n=cfg.n, params=s["mon"].MonitorParams(**monitor))
    det.attach_recorder(rec)
    return det, rec


def advance_fn(mode):
    if mode == "interactive":
        return lambda d, r: d.advance(r)
    if mode == "bulk":
        return lambda d, r: d.advance_bulk(r)
    return lambda d, r: d.advance_bulk(r, snapshot_every=3)


def both(script):
    """Run ``script(side)`` -> (recorder, detection triples) per side and
    check the streams and triples are identical; returns the port's."""
    out = {side: script(side) for side in SIDES}
    (jr, jev), (tr, tev) = out["jax"], out["torch"]
    assert [e.to_record() for e in tr.events] == [
        e.to_record() for e in jr.events]
    assert tev == jev
    return tr, tev


def triples(det):
    return [(e.round, e.observer, e.subject, e.false_positive)
            for e in det.drain_events()]


@pytest.mark.parametrize("mode", ["interactive", "bulk", "chunked"])
def test_script_stream_matches_jax(mode):
    adv = advance_fn(mode)

    def script(side):
        d, rec = detector(side, SCRIPT, t_suspect=2, seed=5)
        adv(d, 2)
        d.crash(5)
        d.leave(9)
        adv(d, 8)
        d.join(5)
        adv(d, 4)
        d.crash(20)
        adv(d, 7)
        return rec, triples(d)

    rec, events = both(script)
    kinds = set(rec.kinds())
    assert {"crash", "hb_freeze", "leave", "join", "round_tick", "suspect",
            "confirm", "remove"} <= kinds
    # each stream's confirm rows are its own drained detection events
    assert [(e.round, e.observer, e.subject, e.detail["false_positive"])
            for e in rec.events if e.kind == "confirm"] == events


def test_bulk_recorder_matches_drained_events():
    def script(side):
        d, rec = detector(side, BULK)
        d.advance_bulk(2)  # past the hb<=1 detection grace
        d.crash(3)
        d.crash(17)
        d.advance_bulk(20)
        return rec, triples(d)

    rec, events = both(script)
    assert {e[2] for e in events} == {3, 17}
    assert {(e.round, e.observer, e.subject) for e in rec.events
            if e.kind == "confirm"} == {e[:3] for e in events}
    assert sum(e.kind == "round_tick" for e in rec.events) == 22
    assert {e.subject for e in rec.events if e.kind == "crash"} == {3, 17}


def test_no_refute_on_leave():
    def script(side):
        d, rec = detector(side, TEN, t_suspect=12)
        d.load_scenario(SIDES[side]["split"](10, start=2, end=40))
        d.advance(10)
        victim = next(e.subject for e in rec.events if e.kind == "suspect")
        d.clear_scenario()
        d.leave(victim)
        d.advance(1)
        return rec, (victim, triples(d))

    rec, (victim, _) = both(script)
    kinds = rec.kinds(subject=victim)
    assert "leave" in kinds and "refute" not in kinds
    assert {"scenario_arm", "scenario_clear"} <= set(rec.kinds())


def test_refute_on_heal():
    def script(side):
        d, rec = detector(side, TEN, t_suspect=8)
        d.load_scenario(SIDES[side]["split"](10, start=3, end=10))
        d.advance(25)
        return rec, triples(d)

    rec, _ = both(script)
    kinds = rec.kinds()
    assert "scenario_arm" in kinds and "refute" in kinds
    assert "confirm" not in kinds


def test_scenario_rows_around_bulk_runs():
    def script(side):
        d, rec = detector(side, SCRIPT, t_suspect=2, seed=3)
        d.advance(2)
        d.load_scenario(SIDES[side]["split"](64, start=1, end=6))
        d.crash(40)
        d.advance_bulk(9, snapshot_every=4)
        got = triples(d)     # joins the bulk run and decodes it
        d.clear_scenario()
        d.advance_bulk(5)
        return rec, got + triples(d)

    rec, _ = both(script)
    arm, clear = (next(e for e in rec.events if e.kind == k)
                  for k in ("scenario_arm", "scenario_clear"))
    assert (arm.round, clear.round) == (2, 11)
    assert arm.detail["horizon"] == 6


def test_monitor_recorder_flap_storm():
    def script(side):
        s = SIDES[side]
        d, rec = detector(side, dict(TEN, n=24, merge_kernel="xla"),
                          monitor=dict(fpr_threshold=1e-3, fpr_window=6))
        d.load_scenario(s["scenario"](
            name="flap", n=24, flapping=(s["flapping"](
                start=2, end=40, up=2, down=5, nodes=(3, 4)),)))
        d.advance(40)
        rec.close()
        return rec, rec.monitor.verdict()

    rec, verdict = both(script)
    inline = [e for e in rec.events if e.kind == "invariant_violation"]
    assert inline and inline[0].detail["invariant"] == "fpr_storm"
    assert verdict["by_invariant"]["fpr_storm"] == len(inline)


def test_bulk_decode_feeds_monitor():
    def script(side):
        d, rec = detector(side, BULK, monitor={})
        d.advance_bulk(2)
        d.crash(3)
        d.advance_bulk(20)
        d.drain_events()
        rec.finish()
        return rec, rec.monitor.summary()

    rec, summary = both(script)
    assert rec.monitor.rounds == 22 and rec.monitor.crash_rounds == {3: 2}
    assert summary["invariant_violations"] == 0
    assert summary["ttd_converged"][3] >= 0


@pytest.mark.parametrize("mode", ["bulk", "chunked"])
def test_interactive_and_bulk_agree_on_faults_and_first_confirms(mode):
    """Config 3's shape at N = 256, one seed, two port detectors: after
    the two-round grace, four crashes and a leave, then 30 rounds
    interactively or in bulk.  The ground-truth rows and the first
    confirm per subject (its round and first observer) agree between the
    interactive stream and the bulk decode."""
    cfg = dict(n=256, topology="random", fanout=SimConfig.log_fanout(256),
               remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
               merge_kernel="pallas", view_dtype="int8", hb_dtype="int16")

    def stream(adv):
        d, rec = detector("torch", cfg, seed=1)
        d.advance(2)
        for node in (5, 44, 77, 123):
            d.crash(node)
        d.leave(200)
        adv(d, 30)
        d.drain_events()
        return rec.events

    inter = stream(advance_fn("interactive"))
    bulk = stream(advance_fn(mode))

    def faults(events):
        return sorted((e.round, e.kind, e.subject) for e in events
                      if e.kind in ("crash", "hb_freeze", "leave"))

    def first_confirms(events):
        out = {}
        for e in events:
            if e.kind == "confirm":
                out.setdefault(e.subject, (e.round, e.observer))
        return out

    assert faults(inter) == faults(bulk)
    assert len(faults(inter)) == 9
    assert first_confirms(inter) == first_confirms(bulk)
    assert {5, 44, 77, 123} <= set(first_confirms(inter))
