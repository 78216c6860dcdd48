"""The CLI's ``--packed`` capacity mode, the port against the JAX package,
on the CPU.

Both ``CoSim`` objects run over a ``PackedDetector`` built from one
``SimConfig.packed_rr(1024, fanout=8, interpret=True)``, seed 3: the JAX
package's in its ``pallas_rr_interpret`` form (the resident-round kernel
in Pallas interpret mode, the form it admits on the CPU), the port's on
K3's plain version.  The same REPL script (puts, three crash batches with
the introducer among them, a join, reads) goes through both ``dispatch``
functions: the printed text, the event logs, the detections and the
vitals are equal after every line.
"""

from __future__ import annotations

import io

import torch

from gossipfs_tpu import cosim as jcosim
from gossipfs_tpu.config import SimConfig as JConfig
from gossipfs_tpu.detector.sim import PackedDetector as JPacked
from gossipfs_tpu.shim import cli as jcli
from gossipfs_tpu_torch import cosim as tcosim
from gossipfs_tpu_torch.config import SimConfig as TConfig
from gossipfs_tpu_torch.detector.sim import PackedDetector as TPacked
from gossipfs_tpu_torch.shim import cli as tcli

torch.set_num_threads(1)
N = 1024


def test_packed_cli_script_matches_the_reference(tmp_path):
    jcfg = JConfig.packed_rr(N, fanout=8, interpret=True)
    tcfg = TConfig.packed_rr(N, fanout=8, interpret=True)
    jsim = jcosim.CoSim(jcfg, seed=3, detector=JPacked(jcfg, seed=3))
    tsim = tcosim.CoSim(tcfg, seed=3,
                        detector=TPacked(tcfg, seed=3, device="cpu"))
    srcs = []
    for i in range(4):
        src = tmp_path / f"f{i}.txt"
        src.write_bytes(bytes([i]) * (1000 + 97 * i))
        srcs.append(src)
    script = [
        "advance 2",
        *(f"put {s} f{i}.txt" for i, s in enumerate(srcs)),
        "crash 0", "crash 17", "crash 512",
        "advance 4",
        "crash 900", "crash 1023",
        "advance 10",
        "lsm 0", "lsm 1", "IP",
        "ls f0.txt", "ls f3.txt",
        f"put {srcs[0]} late.txt",
        "get f1.txt {dst}",
        "join 17",
        "crash 5", "crash 6", "crash 7",
        "advance 8",
        "lsm 17", "show_metadata", "metrics", "traffic status", "events",
        "grep Elected", "grep Re-replicated",
    ]
    for line in script:
        texts = []
        for sim, mod, tag in ((jsim, jcli, "j"), (tsim, tcli, "t")):
            out = io.StringIO()
            assert mod.dispatch(sim, line.format(
                dst=tmp_path / f"out_{tag}.txt"), out=out)
            texts.append(out.getvalue())
        assert texts[1] == texts[0], line
        assert tsim.log.entries == jsim.log.entries, line
        assert [(e.round, e.observer, e.subject, e.false_positive)
                for e in tsim.events] == \
            [(e.round, e.observer, e.subject, e.false_positive)
             for e in jsim.events], line
        assert tsim.vitals() == jsim.vitals(), line
    assert tsim.round == 24
    assert any(e.subject == 0 for e in tsim.events)
    assert tsim.cluster.master_node != 0
    assert (tmp_path / "out_t.txt").read_bytes() == srcs[1].read_bytes()
