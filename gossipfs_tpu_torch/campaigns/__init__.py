"""Adversarial scenario campaigns: find the protocol's breaking points
automatically.

The port's copy of the JAX package's ``gossipfs_tpu/campaigns/``, its
tensor replay only: a campaign drives the round loops through a FAMILY of
fault scenarios (``driver.FAMILIES``), uses the streaming invariant
monitor (``obs/monitor.py``) as the per-run oracle, sweeps or BISECTS the
severity axis to the knee where an invariant breaks, and replays
committed regression CASE files (``driver.run_case``).  The socket-engine
runners (``engines.py``) are not ported yet (ROADMAP Queue 1, the socket
engines).
"""

from gossipfs_tpu_torch.campaigns.driver import (
    FAMILIES,
    CampaignLedger,
    bisect_axis,
    campaign_config,
    case_verdict_ok,
    knob_surface,
    load_case,
    make_scenario,
    run_case,
    run_scenario,
    run_traffic_case_doc,
    sweep_axis,
    write_case,
)

__all__ = [
    "FAMILIES",
    "CampaignLedger",
    "bisect_axis",
    "campaign_config",
    "case_verdict_ok",
    "knob_surface",
    "load_case",
    "make_scenario",
    "run_case",
    "run_scenario",
    "run_traffic_case_doc",
    "sweep_axis",
    "write_case",
]
