"""Tensorized erasure-coded SDFS plane: a (k, m) systematic Reed-Solomon
codec over GF(256) (``codec``) and the stripe-aware placement/repair
planner (``planner``) — the ``redundancy="stripe"`` mode behind
``sdfs/cluster.py`` and the traffic plane.  The port of the JAX
package's ``gossipfs_tpu/erasure/``.

Threshold math (k-of-(k+m) reads, (k+m-f)-of-(k+m) writes) is owned by
``sdfs/quorum.py``; this package imports it, never re-derives it.
"""

from gossipfs_tpu_torch.erasure import codec, planner

__all__ = ["codec", "planner"]
