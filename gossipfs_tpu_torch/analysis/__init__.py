"""The protocol contract, as data.

``protocol_spec`` is the port's copy of the JAX package's machine-readable
SWIM + Lifeguard lifecycle contract (states, transitions, wire verbs,
injections, rate limits, dissemination bounds, guard thresholds): the
conformance schedules (``gossipfs_tpu_torch.conformance``) are generated
from it.  The JAX package's lint rules over the contract have no port-side
twin yet.
"""

from gossipfs_tpu_torch.analysis import protocol_spec  # noqa: F401

__all__ = ["protocol_spec"]
