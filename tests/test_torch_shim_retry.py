"""The port's bounded backoff (``shim/retry.py``) against the JAX
package's, on the CPU: the retry cases of ``tests/test_backoff.py`` run
through both modules on a deterministic clock, with equal outcomes,
attempts and sleep schedules; the two grpc predicates classify every
status code alike; and the port's ``ShimClient`` rides out its server's
``Advance`` backpressure (RESOURCE_EXHAUSTED) with that schedule.
"""

from __future__ import annotations

import threading

import grpc
import pytest
import torch

from gossipfs_tpu.shim import retry as jretry
from gossipfs_tpu_torch import cosim as tcosim
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.shim import retry as tretry
from gossipfs_tpu_torch.shim.client import ShimClient
from gossipfs_tpu_torch.shim.service import ShimServer

torch.set_num_threads(1)


class Clock:
    """sleep() advances monotonic() and records every delay."""

    def __init__(self):
        self.now = 0.0
        self.sleeps: list[float] = []

    def monotonic(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.sleeps.append(s)
        self.now += s


class Transient(Exception):
    pass


class Fatal(Exception):
    pass


# (failures before success (None: never succeeds), exception, kwargs,
#  expected sleeps, expected attempts)
CASES = {
    "transient_then_success": (3, Transient, dict(
        attempts=6, base_delay=0.05, max_delay=1.0, total_deadline=10.0),
        [0.05, 0.1, 0.2], 4),
    "permanent_failure_bounded": (None, Transient, dict(
        attempts=6, base_delay=0.05, max_delay=1.0, total_deadline=10.0),
        [0.05, 0.1, 0.2, 0.4, 0.8], 6),
    "total_deadline_clips": (None, Transient, dict(
        attempts=50, base_delay=4.0, max_delay=8.0, total_deadline=10.0),
        [4.0, 6.0], 3),
    "max_delay_caps": (None, Transient, dict(
        attempts=5, base_delay=0.3, max_delay=0.5, total_deadline=60.0),
        [0.3, 0.5, 0.5, 0.5], 5),
    "non_retryable": (None, Fatal, dict(
        attempts=6, base_delay=0.05, total_deadline=10.0), [], 1),
    "first_try_success": (0, Transient, {}, [], 1),
}


def run_case(mod, monkeypatch, fails, exc, kw):
    clock = Clock()
    monkeypatch.setattr(mod, "time", clock)
    calls = []

    def fn():
        calls.append(clock.now)
        if fails is None or len(calls) <= fails:
            raise exc(f"attempt {len(calls)}")
        return "ok"

    try:
        out = mod.call_with_backoff(
            fn, retryable=lambda e: isinstance(e, Transient), **kw)
    except (Transient, Fatal) as e:
        out = type(e).__name__
    return out, calls, clock.sleeps


@pytest.mark.parametrize("case", sorted(CASES))
def test_backoff_schedule_matches_the_reference(monkeypatch, case):
    fails, exc, kw, sleeps, attempts = CASES[case]
    got = run_case(tretry, monkeypatch, fails, exc, kw)
    want = run_case(jretry, monkeypatch, fails, exc, kw)
    assert got == want
    assert got[2] == pytest.approx(sleeps) and len(got[1]) == attempts
    assert sum(got[2]) <= kw.get("total_deadline", 10.0)


def test_attempts_must_be_positive():
    with pytest.raises(ValueError, match="attempts must be >= 1"):
        tretry.call_with_backoff(lambda: 1, retryable=bool, attempts=0)


def rpc_error(code: grpc.StatusCode) -> grpc.RpcError:
    class Err(grpc.RpcError):
        def code(self):
            return code

    return Err()


def test_grpc_predicates_match_the_reference():
    for code in grpc.StatusCode:
        e = rpc_error(code)
        assert tretry.grpc_backpressure(e) == jretry.grpc_backpressure(e)
        assert tretry.grpc_transient(e) == jretry.grpc_transient(e)
    assert tretry.grpc_backpressure(
        rpc_error(grpc.StatusCode.RESOURCE_EXHAUSTED))
    assert not tretry.grpc_backpressure(rpc_error(
        grpc.StatusCode.UNAVAILABLE))
    assert {c for c in grpc.StatusCode
            if tretry.grpc_transient(rpc_error(c))} == {
        grpc.StatusCode.RESOURCE_EXHAUSTED, grpc.StatusCode.UNAVAILABLE,
        grpc.StatusCode.DEADLINE_EXCEEDED}
    assert not tretry.grpc_transient(RuntimeError("x"))


def test_client_retries_advance_backpressure():
    """Every Advance slot taken: the server answers RESOURCE_EXHAUSTED and
    the client backs off; once a slot frees the call goes through, and
    without one it gives up with the server's status."""
    sim = tcosim.CoSim(SimConfig(n=8), seed=0, device="cpu")
    server = ShimServer(sim, port=0, max_workers=3).start()
    client = ShimClient(server.address, timeout=10.0)
    slots = server.servicer._advance_slots
    try:
        assert slots.acquire(blocking=False)   # max(1, 3 - 2) == 1 slot
        with pytest.raises(grpc.RpcError) as err:
            client.call("Advance", rounds=1)
        assert err.value.code() is grpc.StatusCode.RESOURCE_EXHAUSTED
        assert sim.round == 0
        timer = threading.Timer(0.2, slots.release)
        timer.start()
        assert client.advance(2) == 2
        timer.join(timeout=10)
        assert not timer.is_alive()
    finally:
        client.close()
        server.stop()
