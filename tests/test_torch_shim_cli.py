"""The port's interactive CLI (``shim/cli.py``) against the JAX package's,
on the CPU.

Each script feeds the same lines to both packages' ``dispatch`` over their
own ``CoSim`` (same config, same seed; the port's rounds on K2's plain
version) and the printed text must be equal line for line: the twins of
``tests/test_shim.py`` and of the CLI verbs that ``test_obs.py``,
``test_scenarios.py``, ``test_suspicion.py``, ``test_erasure.py``,
``test_traffic.py`` and ``test_review_fixes.py`` drive.  A real CLI
process (``python -m gossipfs_tpu_torch.shim.cli --device cpu``) with a
silent stdin rejects the conflicting put after its timeout; without a
card the CLI, the service and ``wire_ops`` refuse to start unless asked
for the CPU.
"""

from __future__ import annotations

import dataclasses
import io
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from gossipfs_tpu import cosim as jcosim
from gossipfs_tpu import scenarios as jscn
from gossipfs_tpu.config import SimConfig as JConfig
from gossipfs_tpu.obs.monitor import MonitorRecorder as JMonitor
from gossipfs_tpu.shim import cli as jcli
from gossipfs_tpu.suspicion import SuspicionParams as JSus
from gossipfs_tpu.traffic.harness import traffic_config as jtraffic
from gossipfs_tpu_torch import cosim as tcosim
from gossipfs_tpu_torch import scenarios as tscn
from gossipfs_tpu_torch import wire_ops
from gossipfs_tpu_torch.config import SimConfig as TConfig
from gossipfs_tpu_torch.obs.monitor import MonitorRecorder as TMonitor
from gossipfs_tpu_torch.shim import cli as tcli
from gossipfs_tpu_torch.shim import service as tservice
from gossipfs_tpu_torch.suspicion import SuspicionParams as TSus
from gossipfs_tpu_torch.traffic.harness import traffic_config as ttraffic

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class CliPair:
    """Both packages' REPLs over CoSims built from ``make(pkg)``, where
    ``pkg`` is ``"jax"`` or ``"port"``."""

    def __init__(self, make):
        self.jsim = make("jax")
        self.tsim = make("port")

    def run(self, *lines, answers: str | None = None, **fmt) -> str:
        """Dispatch each line in both; ``{name}`` fields are filled from
        ``fmt`` (a pair ``(jax, port)`` gives each package its own).
        Returns the port's text, equal to the JAX package's."""
        texts = []
        for i, (sim, mod) in enumerate(((self.jsim, jcli),
                                        (self.tsim, tcli))):
            out = io.StringIO()
            kw = {k: v[i] if isinstance(v, tuple) else v
                  for k, v in fmt.items()}
            for line in lines:
                stream = io.StringIO(answers) if answers is not None else None
                assert mod.dispatch(sim, line.format(**kw), out=out,
                                    in_stream=stream)
            texts.append(out.getvalue())
        assert texts[1].splitlines() == texts[0].splitlines()
        return texts[1]


def plain_pair(n: int = 8, seed: int = 0, **cfg) -> CliPair:
    def make(pkg):
        if pkg == "jax":
            return jcosim.CoSim(JConfig(n=n, **cfg), seed=seed)
        return tcosim.CoSim(TConfig(n=n, **cfg), seed=seed, device="cpu")

    return CliPair(make)


GOSSIP = dict(remove_broadcast=False, fresh_cooldown=True)


class TestCli:
    def test_membership_verbs(self):
        out = plain_pair().run("advance 2", "lsm 0", "IP")
        assert "round=2" in out and "[0, 1, 2, 3, 4, 5, 6, 7]" in out

    def test_crash_then_lsm_shrinks(self):
        p = plain_pair()
        p.run("advance 2", "crash 5", "advance 10")
        out = p.run("lsm 0", "IP", "events", "grep Failure")
        assert "5" not in out.splitlines()[0].replace("15", "")
        assert "Failure Detected" in out

    def test_put_get_roundtrip_via_files(self, tmp_path):
        src = tmp_path / "local.txt"
        src.write_bytes(b"cli payload")
        dst = (tmp_path / "out_j.txt", tmp_path / "out_t.txt")
        out = plain_pair().run(
            "advance 2", "put {src} remote.txt", "ls remote.txt",
            "show_metadata", "check", "get remote.txt {dst}", "store 0",
            "delete remote.txt", "ls remote.txt", src=src, dst=dst)
        assert "ok" in out and "remote.txt: v1" in out
        assert dst[1].read_bytes() == dst[0].read_bytes() == b"cli payload"

    def test_delete_missing_unknown_and_quit(self, tmp_path):
        p = plain_pair()
        out = p.run("advance 2", "get nope.txt {dst}", "delete nope.txt",
                    "frobnicate", dst=tmp_path / "x")
        assert out.count("No File Found") == 2 and "unknown command" in out
        assert not tcli.dispatch(p.tsim, "quit", out=io.StringIO())
        assert tcli.dispatch(p.tsim, "   ", out=io.StringIO())

    def test_bad_node_id_and_bad_regex(self):
        out = plain_pair().run("crash 999", "advance 2", "grep (", "lsm x",
                               "join")
        assert "error:" in out and "round=2" in out

    def test_join_leave_rejoin(self):
        p = plain_pair(10, **GOSSIP)
        out = p.run("advance 3", "leave 4", "crash 7", "advance 12",
                    "lsm 0", "join 7", "advance 4", "lsm 0", "lsm 7",
                    "events", "metrics")
        assert "round=19" in out


class TestConfirmPrompt:
    def _pair(self, tmp_path):
        p = plain_pair()
        src = tmp_path / "f.txt"
        src.write_bytes(b"v1")
        p.run("advance 2", "put {src} wiki.txt", src=src)
        return p, src

    def test_prompt_accepts_yes(self, tmp_path):
        p, src = self._pair(tmp_path)
        out = p.run("put {src} wiki.txt", answers="y\n", src=src)
        assert "Overwrite?" in out and "ok" in out
        assert p.tsim.cluster.master.file_info("wiki.txt")[1] == 2

    def test_prompt_rejects_no_and_default(self, tmp_path):
        p, src = self._pair(tmp_path)
        for answer in ("n\n", "\n", "nope\n"):
            out = p.run("put {src} wiki.txt", answers=answer, src=src)
            assert "Write-Write conflicts!" in out
        assert p.tsim.cluster.master.file_info("wiki.txt")[1] == 1

    def test_no_prompt_outside_conflict_window(self, tmp_path):
        p, src = self._pair(tmp_path)
        p.run("advance 61")
        out = p.run("put {src} wiki.txt", src=src)
        assert "Overwrite?" not in out and "ok" in out

    def test_prompt_timeout_rejects_subprocess(self, tmp_path):
        """A real port CLI process on the CPU with a silent stdin hits the
        timeout path and rejects (the reference's 30 s default-deny)."""
        src = tmp_path / "f.txt"
        src.write_bytes(b"v1")
        proc = subprocess.Popen(
            [sys.executable, "-m", "gossipfs_tpu_torch.shim.cli", "--n",
             "8", "--confirm-timeout", "0.6", "--device", "cpu"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=REPO)
        lines: list[str] = []
        reader = threading.Thread(
            target=lambda: lines.extend(iter(proc.stdout.readline, "")),
            daemon=True)
        reader.start()
        try:
            proc.stdin.write(
                f"advance 2\nput {src} wiki.txt\nput {src} wiki.txt\n")
            proc.stdin.flush()
            deadline = time.time() + 60
            while time.time() < deadline:
                if any("confirmation timed out" in ln for ln in lines):
                    break
                time.sleep(0.1)
            proc.stdin.write("show_metadata\nquit\n")
            proc.stdin.flush()
            proc.stdin.close()
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        reader.join(timeout=10)
        out = "".join(lines)
        assert proc.returncode == 0
        assert out.startswith("gossipfs sim: 8 nodes, ring topology.")
        assert "round=2" in out
        assert "Overwrite?" in out and "confirmation timed out" in out
        assert "Write-Write conflicts!" in out
        assert "wiki.txt: v1" in out


class TestPerNodeLogs:
    def _pair(self):
        p = plain_pair(10)
        p.run("advance 2", "crash 6", "crash 2", "advance 12")
        detections = p.tsim.log.grep("Failure Detected")
        assert len({e["node"] for e in detections}) >= 2
        return p, detections

    def test_cli_grep_node_arg(self):
        p, detections = self._pair()
        obs = detections[0]["node"]
        out = p.run(f"grep --node {obs} Failure Detected", "grep of node 6",
                    "grep --node x --node", "grep -- --node")
        assert "Failure Detected" in out
        assert "Failure Detected of node 6" in out
        assert p.tsim.log.node_view(obs) == p.jsim.log.node_view(obs)


class TestVerbsOfTheSubsystems:
    def test_metrics_and_traffic_status(self):
        p = plain_pair(8, **GOSSIP)
        out = p.run("advance 2", "metrics", "traffic status",
                    "traffic bogus", "suspicion status", "suspicion bogus",
                    "scenario status", "scenario bogus")
        assert "engine=sim" in out and "n_alive=8" in out
        assert "fp_suppressed=n/a" in out
        assert "invariant_violations=n/a" in out
        assert "unknown traffic verb" in out and "no suspicion armed" in out

    def test_metrics_counts_traffic(self, tmp_path):
        src = tmp_path / "t.txt"
        src.write_bytes(b"bytes")
        out = plain_pair(8, topology="ring", fanout=3).run(
            "put {src} t.txt", "get t.txt {dst}", "traffic status",
            "metrics", src=src, dst=tmp_path / "o")
        assert "ops issued=2 acked=2" in out and "ops_issued=2" in out

    def test_monitor_vitals_live_when_attached(self):
        def make(pkg):
            if pkg == "jax":
                sim = jcosim.CoSim(JConfig(n=8, **GOSSIP), seed=0)
                sim.attach_recorder(JMonitor(source="sim", n=8))
            else:
                sim = tcosim.CoSim(TConfig(n=8, **GOSSIP), seed=0,
                                   device="cpu")
                sim.attach_recorder(TMonitor(source="sim", n=8))
            return sim

        out = CliPair(make).run("advance 2", "metrics", "traffic status")
        assert "invariant_violations=0" in out

    def test_suspicion_status_and_lsm_marks(self):
        def make(pkg):
            cfg, sus = (JConfig, JSus) if pkg == "jax" else (TConfig, TSus)
            kw = dict(n=16, topology="random", fanout=cfg.log_fanout(16),
                      t_cooldown=6, t_fail=3,
                      suspicion=sus(t_suspect=10), **GOSSIP)
            if pkg == "jax":
                return jcosim.CoSim(cfg(**kw), seed=0)
            return tcosim.CoSim(cfg(**kw), seed=0, device="cpu")

        p = CliPair(make)
        for sim, scn in ((p.jsim, jscn), (p.tsim, tscn)):
            sim.load_scenario(scn.FaultScenario(
                name="blackout", n=16,
                link_faults=(scn.LinkFault(start=2, end=40, rate=1.0,
                                           src=(3,),
                                           dst=tuple(range(16))),)))
            sim.tick(9)
        out = p.run("suspicion status", "lsm 0", "metrics", "advance 12",
                    "suspicion status", "lsm 0", "events")
        assert "refutations=" in out and "suspect entries now" in out
        assert "3?" in out

    def test_scenario_load_status_clear(self, tmp_path):
        path = tmp_path / "split.json"
        path.write_text(tscn.split_halves(10, 2, 20).to_json())
        out = plain_pair(10, **GOSSIP).run(
            "scenario load {path}", "advance 3", "scenario status",
            "lsm 0", "scenario clear", "scenario status", path=path)
        assert "armed 'halves'" in out and "ACTIVE" in out
        assert "no scenario armed" in out

    def test_scenario_load_on_broadcast_config_reports_error(self, tmp_path):
        path = tmp_path / "split.json"
        path.write_text(tscn.split_halves(10, 2, 20).to_json())
        out = plain_pair(10).run("scenario load {path}",
                                 "scenario load /nonexistent.json",
                                 path=path)
        assert "error:" in out and "remove_broadcast" in out

    def test_traffic_status_replica_and_stripe(self, tmp_path):
        src = tmp_path / "v.txt"
        src.write_bytes(b"x" * 64)
        for kw in ({}, dict(redundancy="stripe", rack_size=8)):
            def make(pkg, kw=kw):
                if pkg == "jax":
                    return jcosim.CoSim(jtraffic(16), seed=0, **kw)
                return tcosim.CoSim(ttraffic(16), seed=0, device="cpu", **kw)

            out = CliPair(make).run("put {src} v.txt", "traffic status",
                                    "show_metadata", "ls v.txt", src=src)
            if kw:
                assert "stripes degraded=0" in out
            else:
                assert "stripes degraded=n/a" in out


class TestParserAndMain:
    def test_parser_is_the_reference_plus_device(self):
        def opts(parser):
            return {a.dest: (a.option_strings, a.default)
                    for a in parser._actions}

        got, want = opts(tcli.make_parser()), opts(jcli.make_parser())
        assert got.pop("device") == (["--device"], "cuda")
        assert got == want
        args = tcli.make_parser().parse_args(
            ["--n", "8", "--gossip-only", "--t-suspect", "4"])
        assert args.gossip_only and args.t_suspect == 4

    def test_packed_t_suspect_composes(self):
        args = tcli.make_parser().parse_args(
            ["--n", "2048", "--packed", "--t-suspect", "2"])
        cfg = dataclasses.replace(TConfig.packed_rr(args.n),
                                  suspicion=TSus(t_suspect=args.t_suspect))
        assert cfg.merge_kernel == "pallas_rr"
        assert cfg.suspicion.t_suspect == 2

    @pytest.mark.parametrize("main,argv", [
        (tcli.main, ["--n", "8"]),
        (tservice.main, ["--n", "8", "--port", "0"]),
        (wire_ops.main, ["--files", __file__]),
    ], ids=["cli", "service", "wire_ops"])
    def test_entry_points_need_a_card_unless_asked_for_the_cpu(
            self, monkeypatch, main, argv):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            main(argv)

    @pytest.mark.parametrize("argv,want", [
        (["--n", "16"], lambda C, S: C(n=16, topology="ring", fanout=3)),
        (["--n", "32", "--topology", "random", "--fanout", "5",
          "--gossip-only", "--t-suspect", "3"],
         lambda C, S: C(n=32, topology="random", fanout=5,
                        suspicion=S(t_suspect=3), **GOSSIP)),
        (["--n", "2048", "--packed"], lambda C, S: C.packed_rr(2048)),
        (["--n", "2048", "--packed", "--t-suspect", "2"],
         lambda C, S: dataclasses.replace(C.packed_rr(2048),
                                          suspicion=S(t_suspect=2))),
        (["--n", "4096", "--packed", "--arc-align", "8"],
         lambda C, S: C.packed_rr(4096, topology="random_arc", arc_align=8,
                                  fanout=16)),
    ], ids=["ring", "gossip-suspicion", "packed", "packed-suspicion",
            "packed-arc-align"])
    def test_config_from_args_is_the_reference_config(self, argv, want):
        got = tcli.config_from_args(tcli.make_parser().parse_args(argv))
        assert dataclasses.asdict(got) == dataclasses.asdict(
            want(JConfig, JSus))
        assert got == want(TConfig, TSus)

    def test_config_from_args_refuses_suspicion_with_broadcast(self):
        with pytest.raises(ValueError):
            tcli.config_from_args(tcli.make_parser().parse_args(
                ["--n", "16", "--t-suspect", "2"]))

    def test_cosim_from_args_packed_on_the_cpu(self):
        args = tcli.make_parser().parse_args(
            ["--n", "64", "--packed", "--device", "cpu", "--seed", "3"])
        sim = tcli.cosim_from_args(args, tcli.config_from_args(args))
        assert type(sim.detector).__name__ == "PackedDetector"
        out = io.StringIO()
        for line in ("advance 2", "crash 9", "advance 8", "lsm 0"):
            tcli.dispatch(sim, line, out=out)
        assert "9" not in out.getvalue().splitlines()[-1].split(", ")

    def test_build_kernels_builds_nothing_for_the_cpu(self):
        assert tservice.build_kernels(TConfig(n=8), "cpu") == []
