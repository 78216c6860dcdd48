"""Scenario engine: declarative network-partition & link-fault injection.

One :class:`~gossipfs_tpu_torch.scenarios.schedule.FaultScenario` drives
the tensor sim through edge filters on the sampled topology
(``scenarios/tensor.py``); ``scenarios/runtime.py`` holds the per-message
reference semantics.  See ``scenarios/schedule.py`` for the schema.

The tensor backend's exports resolve lazily (module ``__getattr__``), as
in the JAX package: ``schedule`` and ``runtime`` are pure Python and
import without torch.
"""

from gossipfs_tpu_torch.scenarios.runtime import ScenarioRuntime
from gossipfs_tpu_torch.scenarios.schedule import (
    CorrelatedOutage,
    FaultScenario,
    Flapping,
    LinkFault,
    Partition,
    SlowNode,
    expand_selector,
    split_halves,
)

_TENSOR_EXPORTS = (
    "TensorScenario",
    "compile_tensor",
    "filter_edges",
    "require_scenario_config",
)

__all__ = [
    "CorrelatedOutage",
    "FaultScenario",
    "Flapping",
    "LinkFault",
    "Partition",
    "ScenarioRuntime",
    "SlowNode",
    "expand_selector",
    "split_halves",
    *_TENSOR_EXPORTS,
]


def __getattr__(name: str):
    if name in _TENSOR_EXPORTS:
        from gossipfs_tpu_torch.scenarios import tensor

        return getattr(tensor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
