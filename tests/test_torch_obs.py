"""The port's flight recorder, analyzer and event-side audit against the
JAX package's.

One churn run in the analyzer's selfcheck shape (N = 256, random edges,
the XLA merge on the JAX side and the separate-pass round on the CPU
here, t_fail 3, t_suspect 2, 1 % churn, 8 tracked crashes, 40 rounds,
the same key) goes through both packages:

* ``decode_scan`` gives the same records, ``write_trace`` byte-identical
  files, and the analyzers (``tools/timeline.py`` and
  ``gossipfs_tpu_torch.obs.timeline``) equal documents;
* the port's ``selfcheck`` passes (events reproduce ``summarize``, and
  the streaming monitor equals the post-hoc analyzer);
* a padded run (``n_effective``) decodes to the same records, with no
  pad subject;
* the schema, the durability replay and ``quantiles`` agree on the same
  inputs.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from gossipfs_tpu.bench.run import tracked_crash_events as jax_tracked
from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core.rounds import run_rounds as jax_run_rounds
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu.obs import recorder as jrec
from gossipfs_tpu.obs import schema as jschema
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu.suspicion import with_suspicion
from gossipfs_tpu.traffic import audit as jaudit
from gossipfs_tpu.traffic.workload import quantiles as jquantiles
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.bench import tracked_crash_events
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core.rounds import run_rounds
from gossipfs_tpu_torch.core.state import init_state
from gossipfs_tpu_torch.obs import recorder as trec
from gossipfs_tpu_torch.obs import schema as tschema
from gossipfs_tpu_torch.obs import timeline
from gossipfs_tpu_torch.suspicion import SuspicionParams
from gossipfs_tpu_torch.traffic import audit as taudit
from gossipfs_tpu_torch.traffic.workload import quantiles

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
N, ROUNDS, SEED = 256, 40, 0
KW = dict(n=N, topology="random", fanout=SimConfig.log_fanout(N),
          remove_broadcast=False, fresh_cooldown=True, t_fail=3,
          t_cooldown=12, merge_kernel="xla")


def jax_timeline():
    spec = importlib.util.spec_from_file_location(
        "timeline_tool", REPO / "tools" / "timeline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def records(events) -> list[dict]:
    return [e.to_record() for e in events]


@pytest.fixture(scope="module")
def runs():
    """The selfcheck run through both packages: {side: (final, carry,
    per_round, crash_rounds)}."""
    jcfg = with_suspicion(JaxConfig(**KW), JaxSus(t_suspect=2))
    ev, crash_rounds, ok = jax_tracked(jcfg, ROUNDS, 8, 10)
    jout = jax_run_rounds(jax_init_state(jcfg), jcfg, ROUNDS,
                          jax.random.PRNGKey(SEED), events=ev,
                          crash_rate=0.01, churn_ok=ok,
                          crash_only_events=True)
    tcfg = dataclasses.replace(SimConfig(**KW),
                               suspicion=SuspicionParams(t_suspect=2))
    tev, tcr, tok = tracked_crash_events(tcfg, ROUNDS, 8, 10, device="cpu")
    tout = run_rounds(init_state(tcfg, device="cpu"), tcfg, ROUNDS,
                      trandom.PRNGKey(SEED, device="cpu"), events=tev,
                      crash_rate=0.01, churn_ok=tok, crash_only_events=True)
    assert tcr == crash_rounds
    return {"jax": (*jout, crash_rounds), "torch": (*tout, tcr)}


def decode(mod, run, **kw):
    final, carry, per_round, crash_rounds = run
    return mod.decode_scan(per_round, carry, n=N, crash_rounds=crash_rounds,
                           alive=final.alive, suspicion=True, **kw)


@pytest.mark.parametrize("start_round", [0, 7])
def test_decode_scan_matches_jax(runs, start_round):
    want = records(decode(jrec, runs["jax"], start_round=start_round))
    got = records(decode(trec, runs["torch"], start_round=start_round))
    assert got == want
    kinds = {r["kind"] for r in got}
    assert {"crash", "hb_freeze", "round_tick", "suspect", "confirm",
            "remove"} <= kinds


def test_write_trace_and_analyze_match_jax(runs, tmp_path):
    paths = {}
    for side, mod in (("jax", jrec), ("torch", trec)):
        final, carry, per_round, crash_rounds = runs[side]
        paths[side] = tmp_path / f"{side}.jsonl"
        mod.write_trace(paths[side], per_round, carry, n=N, source="sel",
                        crash_rounds=crash_rounds, alive=final.alive,
                        suspicion=True, topology="random")
    assert paths["torch"].read_bytes() == paths["jax"].read_bytes()
    jt = jax_timeline()
    want = jt.analyze(*jt.merge([str(paths["jax"])]))
    got = timeline.analyze(*timeline.merge([str(paths["torch"])]))
    assert got == want
    assert got["detected"] == 8 and got["fp_suppressed"] > 0
    # the per-subject lifecycle sequences, as the analyzers render them
    _, jevents = jt.merge([str(paths["jax"])])
    _, tevents = timeline.merge([str(paths["torch"])])
    for subj in sorted(runs["torch"][3]):
        assert (timeline.kind_sequence(tevents, subj)
                == jt.kind_sequence(jevents, subj))
        assert (timeline.render_timeline(tevents, subj)
                == jt.render_timeline(jevents, subj))


def test_port_selfcheck_passes():
    out = timeline.selfcheck(n=N, rounds=ROUNDS, seed=SEED, monitor=True,
                             device="cpu")
    assert out["ok"], out
    assert out["monitor_parity"] and out["monitor_violations"] == 0


def test_timeline_cli_matches_jax(runs, tmp_path, capsys):
    final, carry, per_round, crash_rounds = runs["torch"]
    path = tmp_path / "t.jsonl"
    trec.write_trace(path, per_round, carry, n=N, source="cli",
                     crash_rounds=crash_rounds, alive=final.alive,
                     suspicion=True)
    assert timeline.main([str(path), "--json", "--monitor"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_timeline().main([str(path), "--json", "--monitor"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert got == want and got["monitor_parity"]["ok"]


def test_padded_decode_matches_jax():
    """Permanently dead alignment pads past ``n_effective`` export no
    rows on either side."""
    n_pad, n_eff = 64, 48
    kw = dict(n=n_pad, topology="random", fanout=5, remove_broadcast=False,
              fresh_cooldown=True, t_cooldown=12, merge_kernel="xla")
    mask = np.arange(n_pad) < n_eff
    jcfg = JaxConfig(**kw)
    jfinal, jcarry, jper = jax_run_rounds(
        jax_init_state(jcfg, member_mask=mask), jcfg, 10,
        jax.random.PRNGKey(0))
    tcfg = SimConfig(**kw)
    tfinal, tcarry, tper = run_rounds(
        init_state(tcfg, torch.from_numpy(mask), device="cpu"), tcfg, 10,
        trandom.PRNGKey(0, device="cpu"))
    want = records(jrec.decode_scan(jper, jcarry, n=n_pad,
                                    alive=jfinal.alive, n_effective=n_eff))
    got = records(trec.decode_scan(tper, tcarry, n=n_pad,
                                   alive=tfinal.alive, n_effective=n_eff))
    assert got == want
    assert all(r["subject"] < n_eff for r in got)
    unmasked = trec.decode_scan(tper, tcarry, n=n_pad, alive=tfinal.alive)
    assert any(e.subject >= n_eff for e in unmasked)


def test_schema_is_the_jax_schema():
    for name in ("SCHEMA", "ROUNDPROF_SCHEMA", "EVENT_KINDS",
                 "LIFECYCLE_KINDS", "VITALS_FIELDS", "SCAN_FIELD_MAP",
                 "SCAN_UNEXPORTED", "LOG_KIND_MAP", "UNEXPORTED_LOG_KINDS"):
        assert getattr(tschema, name) == getattr(jschema, name), name
    doc = {"engine": "sim", "round": 3, "detections": 1}
    assert tschema.render_vitals(doc) == jschema.render_vitals(doc)
    head = tschema.header("sim", n=8, crash_rounds={"3": 1})
    assert head == jschema.header("sim", n=8, crash_rounds={"3": 1})
    assert tschema.dumps(head) == jschema.dumps(head)
    ev = tschema.Event(round=7, observer=2, subject=5, kind="confirm",
                       detail={"false_positive": False})
    assert tschema.Event.from_record(ev.to_record()) == ev
    assert ev.to_record() == jschema.Event.from_record(
        ev.to_record()).to_record()


def traffic_stream(mod):
    E = mod.Event
    return [
        E(round=1, observer=0, subject=-1, kind="replica_put",
          detail={"file": "a", "version": 1, "replicas": [1, 2]}),
        E(round=1, observer=0, subject=-1, kind="replica_put",
          detail={"file": "b", "version": 1, "replicas": [3]}),
        E(round=2, observer=0, subject=-1, kind="stripe_put",
          detail={"file": "s", "version": 1, "k": 2,
                  "fragments": [4, 5, 6]}),
        E(round=3, observer=-1, subject=3, kind="crash"),
        E(round=3, observer=-1, subject=5, kind="crash"),
        E(round=3, observer=0, subject=-1, kind="replica_repair",
          detail={"file": "a", "version": 1, "targets": [7]}),
        E(round=4, observer=-1, subject=4, kind="crash"),
        E(round=5, observer=0, subject=-1, kind="stripe_repair",
          detail={"file": "s", "version": 1, "slots": [0],
                  "targets": [8]}),
        E(round=6, observer=-1, subject=3, kind="join"),
        E(round=6, observer=0, subject=-1, kind="replica_put",
          detail={"file": "c", "version": 2, "replicas": [9]}),
        E(round=7, observer=-1, subject=9, kind="crash"),
        E(round=8, observer=0, subject=-1, kind="replica_delete",
          detail={"file": "a"}),
    ]


@pytest.mark.parametrize("cut", [3, 6, 9, 12])
def test_durability_replay_matches_jax(cut):
    jev, tev = traffic_stream(jschema)[:cut], traffic_stream(tschema)[:cut]
    jrep, trep = jaudit.DurabilityReplay(), taudit.DurabilityReplay()
    for a, b in zip(jev, tev):
        jrep.observe(a)
        trep.observe(b)
        assert trep.facts() == jrep.facts()
    assert (taudit.durability_from_events(tev[::-1])
            == jaudit.durability_from_events(jev[::-1]))


@pytest.mark.parametrize("vals", [[], [3.0], [5.5, 1.25, 9.0, 2.0],
                                  [float(x % 17) / 3 for x in range(101)]])
def test_quantiles_match_jax(vals):
    assert quantiles(vals) == jquantiles(vals)
