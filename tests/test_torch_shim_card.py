"""The port's shim on the card against the same shim on the CPU (needs a
CUDA device; skips without one).  ``chip_smoke.py`` phase 46 runs the
full-width form of this check."""

from __future__ import annotations

import pytest
import torch

from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.cosim import CoSim
from gossipfs_tpu_torch.shim.client import ShimClient
from gossipfs_tpu_torch.shim.service import ShimServer, build_kernels


def script(device: str) -> list:
    cfg = SimConfig(n=256, topology="random",
                    fanout=SimConfig.log_fanout(256))
    build_kernels(cfg, device)
    sim = CoSim(cfg, seed=2, device=device)
    server = ShimServer(sim, port=0).start()
    client = ShimClient(server.address, timeout=60.0)
    replies = []
    try:
        replies.append(client.call("Advance", rounds=3))
        replies.append(client.call("Put", file="a.txt", data_b64="YWJj"))
        for node in (5, 77, 200):
            client.crash(node)
        replies.append(client.call("Advance", rounds=12))
        for method, req in (("Lsm", {"observer": 0}), ("AliveNodes", {}),
                            ("Ls", {"file": "a.txt"}),
                            ("Get", {"file": "a.txt"}), ("Events", {}),
                            ("Vitals", {})):
            replies.append(client.call(method, **req))
    finally:
        client.close()
        server.stop()
    return replies


@pytest.mark.cuda
def test_shim_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    assert script("cuda") == script("cpu")
