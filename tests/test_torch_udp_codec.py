"""The port's socket-engine codecs and host helpers against the JAX
package's, bit for bit.

* the asyncio engine's wire codec (``UdpNode._encode``, ``_encode_delta``,
  ``_decode``) gives the same strings and entries in both packages over a
  seeded member table, a sequence of delta frames, and the malformed
  chunks the native engine's tests feed it; the C++ codec (built by the
  port, ``native.codec_encode`` / ``codec_decode``) reads and writes the
  same entries;
* ``native.compile_native_scenario`` gives equal gate tables (or the same
  refusal) for every committed campaign case and every conformance family
  schedule at seeds 0-2;
* ``native._parse_obs_lines`` and ``latency_histogram`` give equal events
  and histograms;
* the conformance ``_Injector`` puts the same datagrams on the wire.
"""

from __future__ import annotations

import json
import pathlib
import random
import socket

import pytest

from gossipfs_tpu import native as jnative   # pure-python parts only
from gossipfs_tpu.conformance import harness as jharness
from gossipfs_tpu.conformance import schedules as jschedules
from gossipfs_tpu.detector import udp as judp
from gossipfs_tpu.scenarios.schedule import FaultScenario as JScenario
from gossipfs_tpu_torch import native
from gossipfs_tpu_torch.conformance import harness
from gossipfs_tpu_torch.detector import udp as tudp
from gossipfs_tpu_torch.scenarios.schedule import FaultScenario as TScenario

REPO = pathlib.Path(__file__).resolve().parents[1]
E, F = tudp.ENTRY_SEP, tudp.FIELD_SEP


class _Host:
    """The attributes a node reads from its cluster while encoding."""
    delta_entries = 4


def _table(seed: int, n: int = 12) -> list[tuple[str, int, float]]:
    rng = random.Random(seed)
    return [(f"127.0.0.1:{20_000 + i}", rng.randrange(0, 10_000),
             rng.uniform(0, 2e9)) for i in range(n)]


def _node(udp, entries):
    node = udp.UdpNode(_Host(), 0, 20_000)
    node.members = {a: udp._Member(hb, ts, ver)
                    for ver, (a, hb, ts) in enumerate(entries)}
    node._ver = len(entries)
    return node


def test_separators_match_jax():
    assert (tudp.ENTRY_SEP, tudp.FIELD_SEP, tudp.CMD_SEP, tudp.DELTA_MARK) \
        == (judp.ENTRY_SEP, judp.FIELD_SEP, judp.CMD_SEP, judp.DELTA_MARK)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_and_delta_frames_match_jax(seed):
    entries = _table(seed)
    a, b = _node(judp, entries), _node(tudp, entries)
    assert b._encode() == a._encode()
    assert tudp.UdpNode._decode(b._encode()) == \
        judp.UdpNode._decode(a._encode())
    peer = "127.0.0.1:20005"
    for step in range(8):
        # change a few entries between frames: changed-first picks, then
        # the round-robin tail
        for node in (a, b):
            r = random.Random(seed * 1000 + step)
            for _ in range(r.randrange(0, 6)):
                addr = sorted(node.members)[r.randrange(len(node.members))]
                node.members[addr].hb += 1
                node.members[addr].ver = node._bump()
        frame = b._encode_delta(peer)
        assert frame == a._encode_delta(peer)
        assert b._refresh_pos == a._refresh_pos
        assert b._sent_ver == a._sent_ver
        if step:
            assert frame.startswith(tudp.DELTA_MARK)


MALFORMED = [
    f"good{F}5{F}1.0{E}bad-no-fields{E}x{F}NaNish",
    f"a{F}7{E}b{F}8{F}{E}c{F}9{F}not-a-ts",
    f"{E}{E}{F}{F}{E}z{F}1e3{F}2.5",
    f"only-addr{E}{F}{E}q{F}-3{F}-1.5",
    f"t{F}12.9{F}inf{E}u{F}nan{F}1",
    "",
]


@pytest.mark.parametrize("wire", MALFORMED)
def test_decode_malformed_matches_jax(wire):
    got = tudp.UdpNode._decode(wire)
    assert got == judp.UdpNode._decode(wire)
    # the C++ codec skips the same bad entries; an unparsable ts is
    # "absent" (None) in the Python codec and 0.0 in the C++ one
    cpp = native.codec_decode(wire)
    assert [(a, hb) for a, hb, _ in cpp] == [(a, hb) for a, hb, _ in got]
    assert [ts if ts is not None else 0.0 for _, _, ts in got] == \
        [ts for _, _, ts in cpp]


@pytest.mark.parametrize("seed", [0, 1])
def test_cpp_codec_speaks_both_python_codecs(seed):
    entries = _table(seed)
    wire = native.codec_encode(entries)
    assert tudp.UdpNode._decode(wire) == judp.UdpNode._decode(wire) \
        == entries
    py_wire = _node(tudp, entries)._encode()
    assert native.codec_decode(py_wire) == entries
    assert native.codec_decode(wire) == entries


def _campaign_scenarios():
    out = []
    for p in sorted((REPO / "regressions").glob("*.json")):
        doc = json.loads(p.read_text())
        if "scenario" in doc and doc.get("family") != "rack_kill":
            out.append((p.stem, json.dumps(doc["scenario"])))
    return out


def _conformance_scenarios():
    out = []
    for fam in jschedules.FAMILIES:
        for seed in (0, 1, 2):
            sc = jharness.case_scenario(jschedules.generate(fam, seed))
            if sc is not None:
                out.append((f"{fam}-{seed}", sc.to_json()))
    return out


SCENARIOS = _campaign_scenarios() + _conformance_scenarios() + [
    ("loss", json.dumps({"name": "loss", "n": 8, "link_faults": [
        {"start": 0, "end": 5, "rate": 0.5, "src": [1], "dst": [2]}]})),
    ("partition", json.dumps({"name": "split", "n": 8, "partitions": [
        {"start": 1, "end": 9, "groups": [[0, 1, 2], [3, 4, 5, 6, 7]]}],
        "slow_nodes": [{"start": 0, "end": 4, "stride": 3,
                        "nodes": [5]}]})),
]


def test_scenarios_cover_the_committed_cases():
    names = [s[0] for s in SCENARIOS]
    assert "outage_storm_n256" in names and "flap_storm_n256" in names
    assert any(n.startswith("refute_race") for n in names)


@pytest.mark.parametrize("name,text", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_compile_native_scenario_matches_jax(name, text):
    try:
        want = jnative.compile_native_scenario(JScenario.from_json(text))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            native.compile_native_scenario(TScenario.from_json(text))
        assert str(got.value) == str(e)
        return
    assert native.compile_native_scenario(TScenario.from_json(text)) == want


OBS_TEXT = "\n".join([
    "round_tick 3 -1 -1 n_alive=24 true_detections=0 false_positives=1 "
    "tick_ms=0.25",
    "confirm 4 2 7 false_positive=1",
    "suspect 4 2 7",
    "remove 5 2 7 false_positive=0 scheduled=0 why=stale",
    "short line",
    "round_tick 4 -1 -1 tick_ms=12.5 n_alive=23",
    "round_tick 5 -1 -1 tick_ms=400",
    "round_tick 6 -1 -1 tick_ms=0.05",
    "scenario_arm 0 -1 -1 name=outage-size=4 horizon=30",
])


def test_obs_lines_and_histogram_match_jax():
    got = native._parse_obs_lines(OBS_TEXT)
    want = jnative._parse_obs_lines(OBS_TEXT)
    assert [e.to_record() for e in got] == [e.to_record() for e in want]
    assert len(got) == 8
    assert native.latency_histogram(got) == jnative.latency_histogram(want)
    assert native.latency_histogram(got)["count"] == 4
    assert native.latency_histogram([]) == jnative.latency_histogram([])


def _received(injector_cls, payloads) -> list[bytes]:
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5)
    base = rx.getsockname()[1] - 2     # the receiver is node 2
    inj = injector_cls(base)
    try:
        for payload, copies in payloads:
            inj.send(2, payload, copies=copies)
        total = sum(c for _, c in payloads)
        return [rx.recv(65_536) for _ in range(total)]
    finally:
        inj.close()
        rx.close()


def test_injector_datagrams_match_jax():
    about = "127.0.0.1:31000"
    payloads = [(harness.wire_verb("SUSPECT", about), 2),
                (harness.wire_verb("REFUTE", about, hb=1), 1)]
    for style in ("garbage", "empty_hb", "bad_hb", "unknown_verb",
                  "mixed_refresh", "truncated_delta", "delta_refresh",
                  "stale_full_replay"):
        want = jharness.malformed_payload(style, about_addr=about, hb=9)
        got = harness.malformed_payload(style, about_addr=about, hb=9)
        assert got == want
        payloads.append((got, 1))
    assert _received(harness._Injector, payloads) == \
        _received(jharness._Injector, payloads)
