"""gRPC shim client — what the reference's ``rpc.Dial`` call sites become.

Every SDFS client op in the reference dials the master and calls a
string-named method (e.g. ``rpc.Dial("tcp", master:9000)`` then
``TCPServer.Get_put_info``, reference: slave/slave.go:669-678).  This client
is the same shape over gRPC: one channel, methods addressed by name under
``/gossipfs.Shim/``, protobuf messages per ``gossipfs.proto`` (dict in,
dict out — the json_format transcoding lives in wire.py).
"""

from __future__ import annotations

import base64

import grpc

from gossipfs_tpu_torch.shim import retry, wire
from gossipfs_tpu_torch.shim.wire import SERVICE


class ShimClient:
    """Thin dynamic proxy: ``client.call("GetFileInfo", file="x")``."""

    def __init__(
        self,
        address: str,
        timeout: float = 30.0,
        max_message_mb: int = wire.MAX_MESSAGE_MB,
    ):
        # same cap as the server (wire.py — multi-MB file payloads)
        self.channel = grpc.insecure_channel(
            address, options=wire.message_size_options(max_message_mb)
        )
        self.timeout = timeout
        self._methods: dict[str, grpc.UnaryUnaryMultiCallable] = {}

    def call(self, method: str, timeout: float | None = None,
             retries: bool = True, **request):
        """One RPC; ``timeout`` overrides the client default per call
        (bulk-data methods carry multi-MB payloads and need deadlines far
        past the control-plane default).  ``retries=False`` issues
        exactly one attempt — for callers that own their OWN retry
        policy (the launcher's ``_ctrl_call``), so two backoff loops
        never nest (a nested inner loop would multiply the outer
        policy's advertised time bound)."""
        fn = self._methods.get(method)
        if fn is None:
            fn = self._methods[method] = self.channel.unary_unary(
                f"/{SERVICE}/{method}",
                request_serializer=wire.request_serializer(method),
                response_deserializer=wire.response_deserializer(method),
            )
        deadline = self.timeout if timeout is None else timeout
        if not retries:
            return fn(request, timeout=deadline)
        # RESOURCE_EXHAUSTED is the server's explicit backpressure (its
        # Advance handlers fail fast instead of holding workers parked on
        # the election lock — service.py ShimServicer._advance_slots):
        # retry with backoff rather than surfacing it to every caller.
        # Round 14: the raw loop became the shared bounded-backoff
        # discipline (shim/retry.py) — same 7-attempt 50ms-doubling
        # schedule, now with a hard ceiling on total retry time so a
        # saturated server cannot park callers open-endedly
        return retry.call_with_backoff(
            lambda: fn(request, timeout=deadline),
            retryable=retry.grpc_backpressure,
            attempts=7, base_delay=0.05, max_delay=1.0,
            total_deadline=10.0,
        )

    # -- convenience wrappers for the common verbs -------------------------
    def join(self, node: int) -> None:
        self.call("Join", node=node)

    def leave(self, node: int) -> None:
        self.call("Leave", node=node)

    def crash(self, node: int) -> None:
        self.call("Crash", node=node)

    def lsm(self, observer: int) -> list[int]:
        return self.call("Lsm", observer=observer)["members"]

    def alive_nodes(self) -> list[int]:
        return self.call("AliveNodes")["nodes"]

    def advance(self, rounds: int = 1) -> int:
        return self.call("Advance", rounds=rounds)["round"]

    def advance_bulk(self, rounds: int, snapshot_every: int | None = None) -> int:
        """One compiled scan; returns the target round immediately while the
        device runs.  Subsequent ``lsm``/``alive_nodes`` answer from the
        scan's snapshot stream (reply carries ``as_of_round``)."""
        req = {"rounds": rounds}
        if snapshot_every is not None:
            req["snapshot_every"] = snapshot_every
        return self.call("AdvanceBulk", **req)["round_target"]

    def put(self, file: str, data: bytes, confirm: bool = False) -> bool:
        return self.call(
            "Put", file=file, data_b64=base64.b64encode(data).decode(),
            confirm=confirm,
        )["ok"]

    def get(self, file: str) -> bytes | None:
        resp = self.call("Get", file=file)
        if not resp["found"]:
            return None
        return base64.b64decode(resp["data_b64"])

    def delete(self, file: str) -> bool:
        return self.call("Delete", file=file)["ok"]

    def ls(self, file: str) -> list[int]:
        return self.call("Ls", file=file)["replicas"]

    def store(self, node: int) -> dict[str, int]:
        return self.call("Store", node=node)["listing"]

    def grep(self, pattern: str) -> list[dict]:
        return self.call("Grep", pattern=pattern)["lines"]

    def close(self) -> None:
        self.channel.close()
