"""The port's socket engines in the slow lane (``-m slow``).

Twins of the JAX package's slow socket tests, and the campaign runs over
real sockets.  Slow because these engines run on the wall clock: each
case boots real clusters (the deployment spawns an OS process per node),
and a loaded host stretches the periods until staleness windows cross
rounds early, so they are run alone, not beside the tier-1 workers.

* the per-process deployment (``deploy/``): kill -9 detection, repair and
  a byte-identical get; a master kill and the election; the write-conflict
  confirmation across processes; the reference's 10-node workflow
  (``ref_workflow.run``);
* the native conformance column (``confirm_expiry`` and the committed
  malformed-codec repro), and the four-column ``verdict.run_case`` with
  the tensor column on the CPU;
* ``run_case_engine`` over the udp engine (the mild case, its delta twin,
  the committed n = 64 absorption twin), the native engine (the mild
  case, and ``outage_storm_n256`` at its committed n) and the deploy
  engine (the mild case scaled to n = 8), each verdict required to agree
  with the tensor replay on the CPU;
* ``native_rt.run``: a crash detected at real-time speed;
* the campaign CLI's ``--matrix`` (every committed gossip case over the
  native engine at its committed n and the udp engine, each cell in a
  fresh interpreter, the tensor side on the CPU): ``all_agree``.
"""

from __future__ import annotations

import os
import pathlib
import time

import pytest

from gossipfs_tpu_torch import campaigns
from gossipfs_tpu_torch.conformance import harness, schedules, verdict
from gossipfs_tpu_torch.deploy.launcher import Cluster
from gossipfs_tpu_torch.obs.recorder import load_stream

pytestmark = pytest.mark.slow

REPO = pathlib.Path(__file__).resolve().parents[1]
MILD_UDP_CASE = REPO / "regressions" / "outage_mild_udp_n24.json"
MILD_DELTA_UDP_CASE = REPO / "regressions" / "outage_mild_delta_udp_n24.json"
N = 5
PERIOD = 0.1


@pytest.fixture
def cluster(tmp_path):
    c = Cluster(N, period=PERIOD, root=str(tmp_path))
    c.start(timeout=60.0)
    yield c
    c.stop()


def test_deploy_kill9_detection_repair_and_get(cluster):
    data = os.urandom(64 * 1024)
    assert cluster.client(1).put("wiki.txt", data)
    holders = cluster.client(1).ls("wiki.txt")
    assert len(holders) == 4
    victim = next(h for h in holders if h != 0)
    observer = next(i for i in range(N) if i not in (victim, 0))
    cluster.kill9(victim)
    assert cluster.wait_detected(victim, observer, timeout=30.0) < 20.0
    assert cluster.wait_repaired("wiki.txt", observer, 4,
                                 timeout=60.0) < 40.0
    healed = set(cluster.client(observer).ls("wiki.txt"))
    assert victim not in healed and len(healed) == 4
    assert cluster.client(observer).get("wiki.txt") == data
    hits = []
    for i in range(N):
        if i != victim:
            hits += cluster.client(i).call(
                "Grep", pattern="re_replicate|reput").get("lines") or []
    assert hits


def test_deploy_master_kill9_election_and_writes_resume(cluster):
    data = b"survives the master" * 100
    assert cluster.client(2).put("meta.txt", data)
    cluster.kill9(0)
    cluster.wait_new_master(2, 0, timeout=120.0)
    assert cluster.client(2).get("meta.txt") == data
    winners = []
    for i in range(1, N):
        winners += cluster.client(i).call(
            "Grep", pattern="became master").get("lines") or []
    assert len({w["node"] for w in winners}) == 1


def test_deploy_write_conflict_confirmation_crosses_processes(cluster):
    assert cluster.client(1).put("c.txt", b"first")
    assert cluster.client(3).put("c.txt", b"second")
    time.sleep(PERIOD * 2)
    assert cluster.client(2).get("c.txt") == b"second"


def test_deploy_reference_10node_workflow():
    import grpc

    from gossipfs_tpu_torch.ref_workflow import run

    try:
        out = run(n=10, mb5=5, mb10=10, period=0.5, timeout=180.0)
    except (RuntimeError, TimeoutError, grpc.RpcError):
        # one retry, for boot/convergence/RPC-deadline failures only, as
        # the JAX package's twin does; wrong bytes are never retried
        time.sleep(5.0)
        out = run(n=10, mb5=5, mb10=10, period=0.5, timeout=180.0)
    assert out["ok"] and out["post_repair_byte_identical"]


def test_native_conformance_smoke():
    case = schedules.generate("confirm_expiry", seed=0)
    ref = harness.run_case_reference(case)
    row = verdict.compare(case, ref, harness.run_case_native(case))
    assert row["ok"], row["checks"]


def test_native_conformance_repro_agrees():
    case = schedules.parse(
        (REPO / "regressions" / "conformance_malformed_udp.json").read_text(
            encoding="utf-8"))
    ref = harness.run_case_reference(case)
    row = verdict.compare(case, ref, harness.run_case_native(case))
    assert row["ok"], row["checks"]


def test_four_column_run_case_on_the_cpu():
    case = schedules.generate("leave_broadcast", seed=0)
    rows = verdict.run_case(
        case, engines=("reference", "tensor", "udp", "native"), device="cpu")
    assert [r["engine"] for r in rows] == ["reference", "tensor", "udp",
                                           "native"]
    for row in rows:
        assert row["ok"], (row["engine"], row["checks"])


def _stream_kinds(out) -> set[str]:
    _, events = load_stream(out["engine_row"]["trace"])
    return {e.kind for e in events}


def test_udp_engine_campaign_smoke():
    out = campaigns.run_case_engine(MILD_UDP_CASE, engine="udp",
                                    period=0.05, device="cpu")
    assert out["reproduced"], out
    assert out["engine_verdict"] == out["tensor_verdict"] == "pass"
    assert {"round_tick", "crash"} <= _stream_kinds(out)


def test_udp_engine_delta_campaign_smoke():
    out = campaigns.run_case_engine(MILD_DELTA_UDP_CASE, engine="udp",
                                    period=0.05, device="cpu")
    assert out["reproduced"], out
    wire = out["engine_row"]["wire"]
    assert wire["frames_delta"] > 0 and wire["frames_full"] > 0, wire


def test_udp_engine_absorbs_committed_twin():
    out = campaigns.run_case_engine(
        REPO / "regressions" / "outage_absorbed_udp_n64.json",
        engine="udp", period=0.1, device="cpu")
    assert out["reproduced"], out
    assert out["engine_verdict"] == out["tensor_verdict"] == "pass"
    assert "no_confirm_without_suspect" in out["agreement"]["compared"]


def test_native_engine_campaign_smoke():
    out = campaigns.run_case_engine(MILD_UDP_CASE, engine="native",
                                    device="cpu")
    assert out["reproduced"], out
    assert out["engine_verdict"] == out["tensor_verdict"] == "pass"
    assert "fpr_storm" in out["agreement"]["compared"]
    assert {"round_tick", "crash", "confirm", "remove",
            "scenario_arm"} <= _stream_kinds(out)
    assert out["engine_row"]["tick_ms"]["count"] > 0


def test_native_engine_cohort_exact_storm():
    out = campaigns.run_case_engine(
        REPO / "regressions" / "outage_storm_n256.json", engine="native",
        device="cpu")
    assert out["reproduced"], out
    assert out["n"] == 256 and out["engine_verdict"] == "violated"


def test_deploy_engine_campaign_runner():
    out = campaigns.run_case_engine(MILD_UDP_CASE, engine="deploy",
                                    scale_n=8, period=0.1, device="cpu")
    assert out["agreement"]["match"], out["agreement"]
    assert "fpr_storm" not in out["agreement"]["compared"]
    assert out["engine_row"]["observed_round_ticks"] == 0
    _, events = load_stream(out["engine_row"]["trace"])
    assert events


def test_native_rt_detects_at_speed():
    from gossipfs_tpu_torch.native_rt import run

    out = run(n=16, period=0.01, rounds=60)
    assert 0 <= out["detection_rounds"] <= 15, out
    assert out["rounds_per_sec"] > 1.0


def test_campaign_matrix_cli_all_agree(tmp_path, capsys):
    import json

    from gossipfs_tpu_torch.campaigns import __main__ as cli

    out = tmp_path / "matrix.json"
    rc = cli.main(["--matrix", "--device", "cpu", "--out", str(out)])
    doc = json.loads(out.read_text())
    assert rc == 0 and doc["all_agree"], doc["cases"]
    assert doc["native_cohort_max_n"] == 1024
    assert sorted(doc["cases"]) == [
        "flap_storm_n256.json", "outage_absorbed_n256.json",
        "outage_absorbed_udp_n64.json", "outage_mild_delta_native_n1024.json",
        "outage_mild_delta_udp_n24.json", "outage_mild_udp_n24.json",
        "outage_storm_n256.json"]
    capsys.readouterr()
