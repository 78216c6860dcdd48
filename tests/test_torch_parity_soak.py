"""The port's parity soak (``python -m gossipfs_tpu_torch.parity_soak``)
against the JAX package's ``tools/parity_soak.py --interpret``: lanes and
SWAR (the suspicion and scenario variants are in
test_torch_parity_soak_fastpath.py).

On the CPU the soak runs the kernels' plain versions: the lean loop and
the separate-pass loop must agree bit for bit, and every per-lane
boolean and total of its JSON line must equal the JAX tool's at the same
N, rounds and seed (run through the JAX tool's ``main(argv)``, its rr
kernel in interpret mode against its XLA path).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import pathlib

import pytest
import torch

from gossipfs_tpu_torch import parity_soak

REPO = pathlib.Path(__file__).resolve().parents[1]
N, ROUNDS, SEED = 512, 16, 42
CASES = {"lanes": [], "swar": ["--elementwise", "swar"]}


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_parity_soak", REPO / "tools" / "parity_soak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_json(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def jax_doc(flags, n=N, rounds=ROUNDS):
    return run_json(jax_tool().main, [
        "--interpret", "--n", str(n), "--block-c", str(n), "--block-r",
        "128", "--rounds", str(rounds), "--seed", str(SEED), *flags])


def port_doc(flags, n=N, rounds=ROUNDS):
    return run_json(parity_soak.main, [
        "--device", "cpu", "--n", str(n), "--rounds", str(rounds),
        "--seed", str(SEED), *flags])


def check_against_jax(flags):
    rc, port = port_doc(flags)
    assert rc == 0 and port["all_equal"], port
    jrc, jax = jax_doc(flags)
    assert jrc == 0 and jax["all_equal"], jax
    assert jax["kernel"] == "pallas_rr_interpret"
    assert port["kernel"] == "pallas_rr"
    for key, value in jax.items():
        if key != "kernel":
            assert port[key] == value, (key, port[key], value)
    # on the CPU both loops run plain versions: no kernel launched
    assert port["lean_launches"] == {} == port["separate_launches"]
    return port


@pytest.mark.parametrize("case", sorted(CASES))
def test_soak_bit_equal_and_equal_to_the_jax_tool(case):
    port = check_against_jax(CASES[case])
    assert port["route"] == ("aligned_group/onepass" if case == "lanes"
                             else "aligned_group/swar/onepass")
    assert port["separate_kernel"] == "arc_merge_update"
    assert port["carry"] and port["metrics"]


def test_the_lanes_soak_detects_what_the_jax_tool_did():
    """The JAX tool's CPU run at this N, rounds and seed printed 8,804
    detections: the port's two loops replay it."""
    _, port = port_doc([])
    assert port["total_detections"] == 8804


def test_soak_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        parity_soak.main(["--n", "512", "--rounds", "2"])


def test_soak_config_is_the_jax_tools():
    cfg = parity_soak.soak_config(2048, suspicion=True)
    assert (cfg.topology, cfg.fanout, cfg.arc_align, cfg.merge_kernel,
            cfg.view_dtype, cfg.hb_dtype, cfg.rr_resident) == (
        "random_arc", 16, 8, "pallas_rr", "int8", "int8", "auto")
    assert (cfg.t_fail, cfg.suspicion.t_suspect, cfg.t_cooldown) == (3, 2, 12)
    assert not cfg.remove_broadcast and cfg.fresh_cooldown


@pytest.mark.cuda
def test_soak_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    doc = parity_soak.soak(n=2048, rounds=24, device="cuda")
    assert doc["all_equal"], doc
    assert doc["lean_launches"]["resident_round"] == 24
    assert doc["separate_launches"] == {"arc_merge_update": 24}
