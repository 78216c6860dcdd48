"""The port's parity soak under ``--suspicion`` and ``--scenario``
against the JAX package's ``tools/parity_soak.py --interpret`` (lanes
and SWAR are in test_torch_parity_soak.py): the SWIM lifecycle at the
fast knob on both loops (the suspicion counters compared too), and a
timed half/half partition with slow senders (K3's edge_filter form on the
lean loop, the masked group form on the separate-pass loop)."""

from __future__ import annotations

import pytest

from test_torch_parity_soak import check_against_jax, port_doc


@pytest.mark.parametrize("flags", [["--suspicion"], ["--scenario"]],
                         ids=["suspicion", "scenario"])
def test_soak_bit_equal_and_equal_to_the_jax_tool(flags):
    port = check_against_jax(flags)
    if "--scenario" in flags:
        assert port["route"] == "filter_group/onepass"
        assert port["separate_kernel"] == "arc_group_merge_update"
    else:
        for key in ("first_suspect", "suspects_entered", "refutations",
                    "fp_suppressed"):
            assert port[key] is True
        assert port["total_suspects"] > 0


def test_every_flag_at_once_on_a_wider_cluster():
    rc, doc = port_doc(["--suspicion", "--scenario", "--elementwise",
                        "swar"], n=2048, rounds=24)
    assert rc == 0 and doc["all_equal"], doc
    assert doc["route"] == "filter_group/swar/onepass"
    assert doc["total_suspects"] > 0 and doc["total_detections"] > 0
