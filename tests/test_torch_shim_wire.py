"""The port's shim on the wire, on the CPU.

``tools/gossipfs_sh_client.sh`` (protoc + curl, no Python and no gRPC
runtime) drives the port's server from either package's copy of
``gossipfs.proto``; and ``wire_ops.run``, the multi-MB put/overwrite/read
runner with its crash -> detect -> re-replicate repair, gives the JAX
package's ``bench/wire_ops.run`` untimed fields on the same seeded
payloads.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gossipfs_tpu.bench import wire_ops as jwire_ops
from gossipfs_tpu_torch import cosim as tcosim
from gossipfs_tpu_torch import wire_ops
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.shim.service import ShimServer

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "tools" / "gossipfs_sh_client.sh"
PROTO_DIRS = {"reference proto": None,
              "port proto": ROOT / "gossipfs_tpu_torch" / "shim"}


def sh_call(address: str, method: str, req_type: str, resp_type: str,
            textproto: str, proto_dir) -> str:
    env = None
    if proto_dir is not None:
        import os

        env = dict(os.environ, GOSSIPFS_PROTO_DIR=str(proto_dir))
    out = subprocess.run([str(SCRIPT), address, method, req_type, resp_type],
                         input=textproto.encode(), capture_output=True,
                         timeout=60, env=env)
    assert out.returncode == 0, out.stderr.decode()
    return out.stdout.decode()


def members(text: str) -> list[int]:
    return [int(x.split(":")[1]) for x in text.splitlines()
            if x.startswith("members:")]


@pytest.mark.parametrize("proto", sorted(PROTO_DIRS))
def test_shell_client_drives_the_port_server(proto):
    if shutil.which("protoc") is None or shutil.which("curl") is None:
        pytest.skip("protoc + curl required")
    proto_dir = PROTO_DIRS[proto]
    sim = tcosim.CoSim(SimConfig(n=8), seed=1, device="cpu")
    server = ShimServer(sim, port=0).start()
    try:
        def call(*a):
            return sh_call(server.address, *a, proto_dir=proto_dir)

        assert "round: 5" in call("Advance", "AdvanceRequest",
                                  "AdvanceReply", "rounds: 5")
        call("Crash", "NodeRequest", "OkReply", "node: 6")
        call("Advance", "AdvanceRequest", "AdvanceReply", "rounds: 10")
        lsm = members(call("Lsm", "LsmRequest", "LsmReply", "observer: 0"))
        assert 6 not in lsm and 0 in lsm
        call("Join", "NodeRequest", "OkReply", "node: 6")
        call("Advance", "AdvanceRequest", "AdvanceReply", "rounds: 3")
        lsm = members(call("Lsm", "LsmRequest", "LsmReply", "observer: 0"))
        assert 6 in lsm
        assert sim.round == 18
    finally:
        server.stop()


TIMED = ("_ms_min", "_ms_median")


def untimed(doc: dict) -> dict:
    rows = [{k: v for k, v in r.items() if not k.endswith(TIMED)}
            for r in doc["rows"]]
    return {"nodes": doc["nodes"], "rows": rows, "repair": doc["repair"]}


def payloads(tmp_path, sizes=(262_144, 209_715)) -> list[str]:
    """Seeded stand-ins for the reference's shards (256 KB and the
    4.0 : 3.2 ratio of file5.txt : file10.txt)."""
    rng = np.random.default_rng(16)
    paths = []
    for i, size in enumerate(sizes):
        p = tmp_path / f"file{5 + 5 * i}.bin"
        p.write_bytes(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        paths.append(str(p))
    return paths


def test_wire_ops_matches_the_reference(tmp_path):
    files = payloads(tmp_path)
    got = wire_ops.run(files, n=16, reps=2, device="cpu")
    want = jwire_ops.run(files, n=16, reps=2)
    assert untimed(got) == untimed(want)
    assert got["device"] == "cpu"
    rep = got["repair"]
    assert rep["healed"] and rep["bytes_identical_after_repair"]
    assert rep["re_replications_logged"] >= 1
    assert [r["size_bytes"] for r in got["rows"]] == [262_144, 209_715]
    for r in got["rows"]:
        assert all(r[k + t] >= 0 for k in ("insert", "update", "read")
                   for t in TIMED)


def test_wire_ops_main_on_the_cpu(tmp_path, capsys):
    files = payloads(tmp_path, sizes=(65_536,))
    out = tmp_path / "wire_ops.json"
    wire_ops.main(["--files", *files, "--n", "12", "--reps", "1",
                   "--device", "cpu", "--out", str(out)])
    doc = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == doc
    assert doc["nodes"] == 12 and doc["repair"]["healed"]
