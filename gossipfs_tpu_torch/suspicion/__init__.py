"""SWIM suspicion + Lifeguard local health: the parameter schema and the
dissemination-mode check (the lifecycle itself lives in core/rounds.py and
the merge kernels)."""

from gossipfs_tpu_torch.suspicion.params import SuspicionParams
from gossipfs_tpu_torch.suspicion.tensor import require_suspicion_config

__all__ = ["SuspicionParams", "require_suspicion_config"]
