"""Conformance fuzzing: the protocol contract run as adversarial schedules.

The port of the JAX package's ``conformance/``.  ``analysis/protocol_spec``
pins the SWIM + Lifeguard lifecycle as data; this package walks its
transition table, generates adversarial schedules, drives the engines
through them and compares each engine's observable surface against a
step-for-step reference prediction:

  * :mod:`schedules`: the seed-pure schedule generator
    (``gossipfs-conformance/v1`` case docs);
  * :mod:`harness`: the per-round reference oracle built on
    ``suspicion/runtime.py``, the tensor column (the port's
    ``SimDetector``, on the card unless told otherwise) and the udp and
    native socket columns;
  * :mod:`verdict`: the per-(schedule, engine) conformance matrix;
  * :mod:`shrink`: greedy delta-debugging for failing schedules.

``python -m gossipfs_tpu_torch.conformance`` is the CLI.
"""

from gossipfs_tpu_torch.conformance.schedules import (  # noqa: F401
    FAMILIES,
    coverage,
    generate,
    generate_corpus,
)
from gossipfs_tpu_torch.conformance.verdict import (  # noqa: F401
    compare,
    run_matrix,
)
