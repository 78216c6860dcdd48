"""The port's CLI twins against the JAX package's CLIs.

``python -m gossipfs_tpu_torch.campaigns`` and ``python -m
gossipfs_tpu_torch.conformance`` (their ``main(argv)``, with ``--device
cpu``) print the same JSON document, with the same exit code, as
``tools/campaign.py`` and ``tools/conformance.py`` for:

* ``--case <committed case> --engine tensor`` (the replay) and a case
  the run does not reproduce (exit 1);
* ``--family ... --values`` (a sweep) and ``--bisect`` with its ledger
  and the committed case it writes (``--commit``);
* ``conformance --replay <repro> --engines reference tensor`` and
  ``--matrix --engines reference tensor --out``.

The matrix modes re-run each engine cell in a fresh interpreter: the
child command is ``python -m gossipfs_tpu_torch.campaigns`` with the
parent's ``--device``.  Without a card the CLIs exit unless told
``--device cpu``.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from gossipfs_tpu_torch.campaigns import __main__ as cli
from gossipfs_tpu_torch.conformance import __main__ as conf_cli

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}_cli", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_CAMPAIGN = _load("campaign")
JAX_CONFORMANCE = _load("conformance")


def _run(main, argv, capsys):
    rc = main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return rc, json.loads(line)


@pytest.mark.parametrize("case", ["outage_mild_udp_n24",
                                  "outage_absorbed_udp_n64"])
def test_case_replay_matches_jax(case, capsys):
    argv = ["--case", str(REPO / "regressions" / f"{case}.json")]
    want = _run(JAX_CAMPAIGN.main, argv, capsys)
    got = _run(cli.main, argv + ["--engine", "tensor", "--device", "cpu"],
               capsys)
    assert got == want
    assert got[0] == 0 and got[1]["reproduced"]


def test_case_not_reproduced_exits_1(tmp_path, capsys):
    doc = json.loads(
        (REPO / "regressions" / "outage_mild_udp_n24.json").read_text())
    doc["expect"] = {"verdict": "violated", "invariants": ["fpr_storm"]}
    path = tmp_path / "wrong.json"
    path.write_text(json.dumps(doc))
    want = _run(JAX_CAMPAIGN.main, ["--case", str(path)], capsys)
    got = _run(cli.main, ["--case", str(path), "--device", "cpu"], capsys)
    assert got == want and got[0] == 1


def test_sweep_matches_jax(capsys):
    argv = ["--family", "flap", "--n", "32", "--t-fail", "3",
            "--values", "2", "5", "--fault-rounds", "12"]
    want = _run(JAX_CAMPAIGN.main, argv, capsys)
    got = _run(cli.main, argv + ["--device", "cpu"], capsys)
    assert got == want
    assert len(got[1]["rows"]) == 2


def test_bisect_ledger_and_commit_match_jax(tmp_path, capsys):
    base = ["--family", "outage", "--n", "32", "--t-fail", "3",
            "--bisect", "1", "6", "--fault-rounds", "12"]
    docs = {}
    for who, main, extra in (("jax", JAX_CAMPAIGN.main, []),
                             ("port", cli.main, ["--device", "cpu"])):
        ledger, case = tmp_path / f"{who}.jsonl", tmp_path / f"{who}.json"
        rc, doc = _run(main, base + ["--ledger", str(ledger),
                                     "--commit", str(case)] + extra, capsys)
        assert doc.pop("ledger") == str(ledger)
        committed = doc.pop("committed", None)
        docs[who] = (rc, doc, ledger.read_text(),
                     case.read_text() if committed else None)
    assert docs["port"] == docs["jax"]
    assert docs["port"][1]["breaking_point"] is not None
    assert docs["port"][3] is not None


def test_conformance_replay_matches_jax(capsys):
    argv = ["--replay",
            str(REPO / "regressions" / "conformance_malformed_udp.json"),
            "--engines", "reference", "tensor"]
    want = _run(JAX_CONFORMANCE.main, argv, capsys)
    got = _run(conf_cli.main, argv + ["--device", "cpu"], capsys)
    assert got == want and got[0] == 0


def test_conformance_matrix_matches_jax(tmp_path, capsys):
    argv = ["--matrix", "--engines", "reference", "tensor", "--seeds", "0"]
    want = _run(JAX_CONFORMANCE.main,
                argv + ["--out", str(tmp_path / "jax.json")], capsys)
    got = _run(conf_cli.main, argv + ["--out", str(tmp_path / "port.json"),
                                      "--device", "cpu"], capsys)
    assert got == want and got[0] == 0
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())


def test_matrix_children_get_the_device(monkeypatch):
    seen = []

    def fake_run(cmd, **kw):
        seen.append((cmd, kw["env"]["PYTHONPATH"]))
        return subprocess.CompletedProcess(cmd, 0, stdout='{"ok": 1}\n',
                                           stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert cli._case_subprocess("c.json", "native", 24, 0.2, "cpu") == \
        {"ok": 1}
    assert cli._ab_cell_subprocess(256, 1, 4, 24, None) == {"ok": 1}
    (case_cmd, path), (ab_cmd, _) = seen
    assert case_cmd[:3] == [sys.executable, "-m",
                            "gossipfs_tpu_torch.campaigns"]
    assert case_cmd[3:] == ["--case", "c.json", "--engine", "native",
                            "--device", "cpu", "--scale-n", "24",
                            "--period", "0.2"]
    assert str(REPO) in path.split(":")
    # an A/B cell runs the native engine alone: no device, no tensor side
    assert "--device" not in ab_cmd and "--ab-cell" in ab_cmd


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("module", ["gossipfs_tpu_torch.campaigns",
                                    "gossipfs_tpu_torch.conformance"])
def test_cli_without_a_card_exits_unless_told_cpu(module):
    arg = (["--case", "regressions/outage_mild_udp_n24.json"]
           if module.endswith("campaigns") else ["--slice"])
    out = subprocess.run([sys.executable, "-m", module, *arg], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "needs a CUDA device" in out.stderr
    assert out.stdout == ""
