"""Opt-in profiler hook around a bench's run: the device-level view.

The port of the JAX package's ``obs/profile.py``, on ``torch.profiler``
(``utils/profiling.trace``).  The benches use this seam so a profile of
the headline shape can be captured beside its numbers::

    python -m gossipfs_tpu_torch.bench --xprof DIR

With no directory the context is a no-op and the timed loops are
untouched.
"""

from __future__ import annotations

import contextlib
import pathlib
from typing import Iterator


@contextlib.contextmanager
def maybe_xprof(log_dir: str | pathlib.Path | None) -> Iterator[None]:
    """``with maybe_xprof(args.xprof):`` profiles the block into
    ``log_dir`` (``utils/profiling.trace``) when a directory is given, a
    no-op otherwise."""
    if not log_dir:
        yield
        return
    from gossipfs_tpu_torch.utils.profiling import trace

    with trace(log_dir):
        yield


def xprof_summary(log_dir: str | pathlib.Path, top: int = 10) -> list[dict]:
    """Top device events of a captured trace (``utils/profiling.
    op_breakdown``); empty when the trace is missing or unreadable, so a
    bench never dies of its diagnostics."""
    try:
        from gossipfs_tpu_torch.utils.profiling import op_breakdown

        return op_breakdown(log_dir, top=top)
    except Exception:  # noqa: BLE001 — diagnostics only
        return []
