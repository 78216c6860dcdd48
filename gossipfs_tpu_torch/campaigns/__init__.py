"""Adversarial scenario campaigns: find the protocol's breaking points
automatically.

The port's copy of the JAX package's ``gossipfs_tpu/campaigns/``: a
campaign drives the round loops through a FAMILY of fault scenarios
(``driver.FAMILIES``), uses the streaming invariant monitor
(``obs/monitor.py``) as the per-run oracle, sweeps or BISECTS the severity
axis to the knee where an invariant breaks, and replays committed
regression CASE files (``driver.run_case``).  ``engines.py`` replays the
same case files over real sockets (the asyncio udp cluster, the native
C++ epoll engine, the per-process deployment) and requires each verdict
to agree with the tensor replay's (``engines.run_case_engine``).

``python -m gossipfs_tpu_torch.campaigns`` is the CLI; the ledger it
writes is a ``gossipfs-obs/v1`` stream (header + ``campaign_verdict``
rows) that ``obs/timeline.py`` ingests unchanged.
"""

from gossipfs_tpu_torch.campaigns.engines import (
    run_case_engine,
    scale_case,
    verdict_agreement,
)
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
    "run_case_engine",
    "run_scenario",
    "run_traffic_case_doc",
    "scale_case",
    "sweep_axis",
    "verdict_agreement",
    "write_case",
]
