"""Bounded exponential backoff for control-plane RPCs — ONE owner.

The port's copy of the JAX package's ``gossipfs_tpu/shim/retry.py``
(pure stdlib; the grpc predicates import grpc lazily).

Before round 14 every retry loop in the deploy/shim lane was
hand-rolled: ``ShimClient.call`` had a fixed-count RESOURCE_EXHAUSTED
loop with open-coded delay doubling, and the launcher's control-plane
fan-outs (``load_scenario``/``load_suspicion``/``vitals``) were
one-shot ``try/except`` — a node hiccuping for one scheduling quantum
(a kill -9 storm, a correlated outage, an overloaded CI host) dropped
its push silently.  Raw retry loops also have no TOTAL time bound: six
doublings from 50 ms is fine, but a loop around a 30 s data-plane
deadline could park a caller for minutes.

:func:`call_with_backoff` is the one discipline: bounded attempt count,
exponential delay with a cap, and a hard ceiling on the TOTAL time
spent sleeping — the property the deploy campaign runner
(campaigns/engines.py) relies on when it calls "a campaign surviving a
correlated outage" evidence of graceful degradation (a runner that can
hang is not graceful).  Callers pass a *retryable* predicate so the
policy stays per-call-site: the shim client retries only
RESOURCE_EXHAUSTED (the server's explicit backpressure — anything else
is the caller's to see), the launcher's idempotent control-plane verbs
also retry UNAVAILABLE/DEADLINE_EXCEEDED (a node mid-restart or a
starved host, both transient by design there).

Pure stdlib; the grpc predicates import grpc lazily so the jax-free
deploy tooling can import this module without it.
"""

from __future__ import annotations

import time
from typing import Callable, TypeVar

T = TypeVar("T")


def call_with_backoff(
    fn: Callable[[], T],
    *,
    retryable: Callable[[BaseException], bool],
    attempts: int = 6,
    base_delay: float = 0.05,
    max_delay: float = 1.0,
    total_deadline: float = 10.0,
) -> T:
    """Call ``fn`` retrying transient failures with bounded backoff.

    Retries only exceptions ``retryable`` accepts; everything else
    propagates immediately.  The delay doubles from ``base_delay`` up to
    ``max_delay`` per attempt, and the SUM of all sleeps never exceeds
    ``total_deadline`` (each sleep is clipped to the remaining budget;
    an exhausted budget re-raises without sleeping) — so the worst-case
    wall time of a call is bounded by
    ``attempts * <per-call deadline> + min(total_deadline, geometric
    sum)`` no matter how the failures interleave.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    t0 = time.monotonic()
    delay = base_delay
    last: BaseException | None = None
    for i in range(attempts):
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — predicate decides
            if not retryable(e):
                raise
            last = e
            if i == attempts - 1:
                break
            remaining = total_deadline - (time.monotonic() - t0)
            if remaining <= 0:
                break
            time.sleep(min(delay, max_delay, remaining))
            delay = min(delay * 2, max_delay)
    assert last is not None
    raise last


def grpc_backpressure(e: BaseException) -> bool:
    """The shim server's explicit backpressure: RESOURCE_EXHAUSTED only
    (its Advance handlers fail fast instead of parking workers on the
    election lock — shim/service.py)."""
    import grpc

    return isinstance(e, grpc.RpcError) and (
        e.code() is grpc.StatusCode.RESOURCE_EXHAUSTED
    )


def grpc_transient(e: BaseException) -> bool:
    """Transient-by-design failures of an IDEMPOTENT control-plane verb:
    backpressure, a node mid-restart (UNAVAILABLE), or a starved host
    missing a short deadline (DEADLINE_EXCEEDED).  NOT for data-plane
    writes — a retried non-idempotent Put could double-apply."""
    import grpc

    return isinstance(e, grpc.RpcError) and e.code() in (
        grpc.StatusCode.RESOURCE_EXHAUSTED,
        grpc.StatusCode.UNAVAILABLE,
        grpc.StatusCode.DEADLINE_EXCEEDED,
    )
