"""One digest of a run's outputs, shared by the tools that hold two runs
equal (``sweep_rr``, ``frontier --digest``, chip_smoke.py).

The sha256 of each 32 MiB piece of the tensors' bytes (copied to the host
in order), hashed in threads (hashlib lets go of the GIL: an N = 65,536
run's lanes are 8.6 GB), then the sha256 of those digests in order.
"""

from __future__ import annotations

import concurrent.futures
import hashlib

PIECE = 1 << 25


def tensors_digest(tensors) -> str:
    """The digest of ``tensors``' bytes, in order."""
    pieces = []
    for t in tensors:
        raw = memoryview(t.contiguous().cpu().numpy()).cast("B")
        pieces += [raw[i:i + PIECE] for i in range(0, max(len(raw), 1),
                                                  PIECE)]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        digests = pool.map(lambda b: hashlib.sha256(b).digest(), pieces)
        return hashlib.sha256(b"".join(digests)).hexdigest()
