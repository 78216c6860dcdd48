"""gRPC shim: the process boundary the BASELINE north star names.

The port of the JAX package's ``gossipfs_tpu/shim/service.py`` over the
port's ``CoSim``: the detector's rounds run on the card (K2 for the
service's ``ring`` and ``random`` configurations) unless the caller asks
for the CPU; the control plane, the locks and the wire are the JAX
package's, line for line.

The reference's control plane is a Go ``net/rpc`` server over TCP :9000
exposing 12 string-named methods (reference: server/server.go:19-251).  This
module is its equivalent: a real gRPC server whose method surface
mirrors all 12 RPCs one-for-one, backed by the simulated detector + SDFS
control plane (``CoSim``), plus the membership verbs (join/leave/lsm) the
north star says external consumers keep using across the shim.

The wire is protobuf per ``shim/gossipfs.proto`` (see ``shim/wire.py``):
messages are real proto structs encoded/decoded at this server's boundary
through gRPC's generic-handler API, so any language's gRPC toolchain can
generate a full client from the ``.proto`` — tools/gossipfs_sh_client.sh
drives the server with protoc + curl alone (no Python, no gRPC runtime;
tests/test_sh_client.py runs it in CI).

Method map (reference server/server.go -> here):

  Response (remote grep, :55-72)        -> Grep
  Get_put_info (:74-121)                -> GetPutInfo
  Get_file_data (:123-131)              -> GetFileData
  Get_file_info (:133-142)              -> GetFileInfo
  Ask_for_confirmation (:155-177)       -> AskForConfirmation
  Get_delete_info (:214-219)            -> GetDeleteInfo
  Delete_file_data (:221-223)           -> DeleteFileData
  Remote_reput (:225-229)               -> RemoteReput
  Vote (:231-234)                       -> Vote
  Assign_new_master (:236-239)          -> AssignNewMaster
  Update_file_version (:241-245)        -> UpdateFileVersion
  Get_Update_Meta (:247-251)            -> GetUpdateMeta

plus Join/Leave/Crash/Lsm/AliveNodes/Advance/Events (membership seam,
slave/slave.go:288-336, 546-613) and whole-op verbs Put/Get/Delete/Ls/Store/
ShowMetadata matching the CLI surface (README.md:8-29).
"""

from __future__ import annotations

import base64
import threading
from concurrent import futures

import grpc
import numpy as np
import torch

from gossipfs_tpu_torch.cosim import CoSim
from gossipfs_tpu_torch.sdfs import election
from gossipfs_tpu_torch.sdfs.types import CONFIRM_TIMEOUT
from gossipfs_tpu_torch.shim import wire
from gossipfs_tpu_torch.shim.wire import SERVICE

__all__ = ["SERVICE", "ShimServicer", "ShimServer", "build_kernels"]

# the merge kernels of the separate-pass round (core/rounds.merge_kernel)
# -> their sources under csrc/; the arc form under a scenario launches none
_MERGE_SOURCES = {"fused_merge_update": "fused_merge",
                  "stripe_merge_update": "stripe_merge",
                  "arc_merge_update": "arc_merge"}


def build_kernels(config, device="cuda") -> list[str]:
    """Build and load the CUDA kernels the detector of ``config`` launches
    on ``device`` (none on the CPU): the resident round's form where the
    lean loop runs its rounds (``core/rounds.route``), and the
    separate-pass round's merge, which rounds with joins take.  A
    server calls it before it serves, so that no client's first
    ``Advance`` waits out its deadline behind nvcc; a failed build
    raises.  Returns the sources built."""
    if torch.device(device).type != "cuda":
        return []
    from gossipfs_tpu_torch.core import rounds
    from gossipfs_tpu_torch.ops import _build
    from gossipfs_tpu_torch.ops import merge as ops_merge

    names = set()
    loop, form = rounds.route(config)
    if loop == "lean" and form.endswith("/onepass"):
        # the library of the blocking that holds the square round
        blocking = ops_merge.onepass_blocking(
            config.n, config.n, form.split("/")[0], config.elementwise)
        names.add(ops_merge.ONEPASS_BLOCKINGS[blocking].source)
    elif loop == "lean":
        names.add("resident_round")
    merge = _MERGE_SOURCES.get(rounds.merge_kernel(config))
    if merge is not None:
        names.add(merge)
    for name in sorted(names):
        _build.load(name)
    return sorted(names)


class ShimServicer:
    """The RPC method implementations over one CoSim (single-writer lock).

    ``confirm_timeout``: wall-clock seconds the master waits on a
    write-conflict confirmation callback before defaulting to reject — the
    reference's 30 s ``Ask_for_confirmation`` timeout (server.go:155-177;
    1 round == 1 s, so CONFIRM_TIMEOUT doubles as both).
    ``confirm_handler``: this node's answer when *it* is asked (the
    interactive yes/no prompt site, server.go:144-153); None falls back to
    the ``auto_confirm`` policy.
    """

    def __init__(
        self,
        sim: CoSim,
        auto_confirm: bool = False,
        confirm_timeout: float = float(CONFIRM_TIMEOUT),
        confirm_handler=None,
    ):
        self.sim = sim
        self.auto_confirm = auto_confirm
        self.confirm_timeout = confirm_timeout
        self.confirm_handler = confirm_handler
        self.address: str | None = None  # set by ShimServer after binding
        self._self_client = None  # loopback channel for the election fan-out
        self._lock = threading.Lock()
        # serializes tick+election pairs: a concurrent Advance must not
        # mutate detector state while an election reads per-node views
        self._election_lock = threading.Lock()
        # set by ShimServer: caps concurrent Advance handlers below the
        # worker-pool size so the election's self-dialed Vote /
        # AssignNewMaster RPCs always find a free worker (otherwise
        # Advances parked on _election_lock could hold every worker and
        # starve the self-call until its deadline — a livelock)
        self._advance_slots: threading.BoundedSemaphore | None = None
        # Vote tallies: candidate -> set of voters (Receive_vote state,
        # reference: slave/slave.go:53-57, 968-984)
        self._votes: dict[int, set[int]] = {}
        # while an AdvanceBulk scan is in flight, membership reads answer
        # from its snapshot stream instead of blocking on device futures
        self._snapshots = None

    # -- membership verbs (the north-star seam) ----------------------------
    def Join(self, req, ctx):
        with self._lock:
            self.sim.detector.join(int(req["node"]))
        return {"ok": True}

    def Leave(self, req, ctx):
        with self._lock:
            self.sim.detector.leave(int(req["node"]))
        return {"ok": True}

    def Crash(self, req, ctx):
        with self._lock:
            self.sim.detector.crash(int(req["node"]))
        return {"ok": True}

    def Lsm(self, req, ctx):
        with self._lock:
            snap = self._snapshots.latest() if self._snapshots else None
            if snap is not None:
                obs = int(req["observer"])
                return {"members": snap.membership(obs), "as_of_round": snap.round}
            return {"members": self.sim.detector.membership(int(req["observer"]))}

    def AliveNodes(self, req, ctx):
        with self._lock:
            snap = self._snapshots.latest() if self._snapshots else None
            if snap is not None:
                return {
                    "nodes": np.nonzero(snap.alive)[0].tolist(),
                    "as_of_round": snap.round,
                }
            return {"nodes": self.sim.detector.alive_nodes()}

    def Advance(self, req, ctx):
        # fail fast when the worker pool is saturated with Advances rather
        # than park on _election_lock holding a worker thread — the
        # reserved headroom keeps the election's self-dialed RPCs
        # schedulable (see _advance_slots); ShimClient retries RESOURCE_
        # EXHAUSTED with backoff
        slots = self._advance_slots
        if slots is not None and not slots.acquire(blocking=False):
            ctx.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                "advance workers saturated; retry",
            )
        try:
            # the election lock (taken OUTSIDE the sim lock) serializes
            # whole tick+election sequences: no other Advance can mutate
            # detector state while run_pending_election reads per-node views
            with self._election_lock:
                with self._lock:
                    self._snapshots = None  # synchronous path resolves bulk scans
                    self.sim.tick(int(req.get("rounds", 1)))
                    out = {"round": self.sim.round}
                # sim lock released: the distributed election self-dials
                # Vote / AssignNewMaster on this server, whose handlers
                # take it
                self.run_pending_election()
            return out
        finally:
            if slots is not None:
                slots.release()

    # -- distributed election (reference: slave.go:930-1051) ---------------
    def _self_call(self, method: str, **req):
        from gossipfs_tpu_torch.shim.client import ShimClient

        if self._self_client is None:
            self._self_client = ShimClient(self.address, timeout=30.0)
        return self._self_client.call(method, **req)

    def run_pending_election(self) -> bool:
        """Drive one election attempt through the real RPC surface.

        Mirrors the reference's per-node protocol: every live node whose own
        membership row lacks the master votes for the lowest member of ITS
        OWN row (revote_master, slave.go:930-948) via the Vote RPC; the
        tally elects on majority (Receive_vote, :968-984); the winner then
        fans out AssignNewMaster to collect registries and commits the
        rebuilt metadata (rebuild_file_meta, :986-1051).  Split views that
        produce no majority stall the election — it retries on the next
        Advance, like the reference's per-heartbeat revote.  Call under
        ``_election_lock`` with the sim lock RELEASED (the dialed handlers
        take it); the election lock keeps concurrent Advances from mutating
        detector state mid-election.  Returns True if a master was
        installed.
        """
        sim = self.sim
        if getattr(sim, "election", "local") != "rpc":
            return False
        with self._lock:
            if not sim.cluster.election_pending:
                return False
            old_master = sim.cluster.master_node
            now = sim.round
        det = sim.detector
        winner = None
        for voter in det.alive_nodes():
            row = det.membership(voter)
            if not row or old_master in row:
                continue  # this node still believes in the old master
            candidate = min(row)  # MemberList[0] in id order (slave.go:936)
            reply = self._self_call("Vote", candidate=candidate, voter=voter)
            if reply.get("elected"):
                winner = candidate
                break
        if winner is None:
            return False  # split view / insufficient votes: stall + retry
        # the winner collects registries from every member it can reach
        with self._lock:
            members = [x for x in sim.cluster.live if x in sim.cluster.reachable]
        registries: dict[int, dict[str, int]] = {}
        for node in members:
            reply = self._self_call("AssignNewMaster", node=node, master=winner)
            registries[node] = reply["listing"]
        with self._lock:
            if winner not in set(det.alive_nodes()):
                # master crashed during the rebuild: abort the commit; the
                # next Advance detects the vacancy and re-elects
                sim.cluster.election_pending = True
                return False
            sim.cluster.install_rebuilt_master(winner, registries, now)
            sim.cluster.election_pending = False
            sim.log.write(
                f"Elected new master {winner} via Vote/AssignNewMaster "
                f"(was {old_master})",
                round=now,
                kind="election",
                node=winner,  # the winner announces (slave.go:968-984)
            )
        return True

    def AdvanceBulk(self, req, ctx):
        """Advance many rounds in the background (SURVEY §7.4's async
        boundary): ``SimDetector.advance_bulk`` runs the horizon in chunks
        of ``snapshot_every`` rounds from a thread of its own and returns
        at once, publishing a membership snapshot as each chunk ends, so
        ``Lsm``/``AliveNodes`` answer from the freshest snapshot (tagged
        ``as_of_round``) while the rounds run.  The next synchronous verb
        joins the run and drops back to exact reads.

        Bulk advancement trades the per-round SDFS co-sim reactions for
        throughput (the detector still detects; the control plane reacts at
        the next ``Advance``) — the same trade ``bench.run.run_cosim``
        makes between recovery cadences.
        """
        rounds = int(req.get("rounds", 1))
        every = int(req.get("snapshot_every", max(1, rounds // 10)))
        with self._lock:
            start = int(self.sim.detector.state.round)  # resolved pre-dispatch
            self._snapshots = self.sim.detector.advance_bulk(
                rounds, snapshot_every=every
            )
            return {"round_target": start + rounds, "snapshot_every": every}

    def Vitals(self, req, ctx):
        """The uniform vitals counter set (obs.schema.VITALS_FIELDS) as
        one GrepReply Struct line — the same verb the deploy daemons
        serve per node, so one client renders live counters identically
        across engines (sim-only fields are simply absent elsewhere)."""
        with self._lock:
            return {"lines": [self.sim.vitals()]}

    def Events(self, req, ctx):
        """Detection events from cursor ``since`` (default 0) on; the reply's
        ``next`` is the cursor for the following poll, so long-running
        monitors don't re-download (or double-count) the whole history."""
        since = int(req.get("since", 0))
        with self._lock:
            events = self.sim.events[since:]
            return {
                "events": [
                    {
                        "round": e.round,
                        "observer": e.observer,
                        "subject": e.subject,
                        "false_positive": e.false_positive,
                    }
                    for e in events
                ],
                "next": since + len(events),
            }

    # -- the 12 reference RPCs --------------------------------------------
    def Grep(self, req, ctx):
        """TCPServer.Response — distributed log grep (server.go:55-72).

        An optional ``node`` restricts the search to that machine's own log
        view, matching the reference's grep-one-machine's-Machine.log
        semantics; without it the whole cluster's stream is searched.
        """
        with self._lock:
            node = req.get("node")
            return {
                "lines": self.sim.log.grep(
                    req["pattern"], node=None if node is None else int(node)
                )
            }

    def _ask_confirmation(self, callback: str, name: str) -> bool:
        """Master -> requester confirmation round-trip (server.go:155-177).

        Dials the requester's own shim server at ``callback`` and asks; any
        error or no answer within ``confirm_timeout`` seconds is the
        reference's 30 s-timeout outcome: reject.
        """
        from gossipfs_tpu_torch.shim.client import ShimClient

        client = ShimClient(callback, timeout=self.confirm_timeout)
        try:
            reply = client.call("AskForConfirmation", file=name)
            return bool(reply.get("confirm", False))
        except Exception:
            return False
        finally:
            client.close()

    def _resolve_conflict(self, req, name: str) -> bool:
        """Whether a conflicting put may proceed.  Precedence: explicit
        ``confirm`` flag (programmatic client) > server auto-confirm policy >
        callback round-trip to the requester > reject.  Call with the sim
        lock RELEASED — the callback is a network round-trip.
        """
        if req.get("confirm", False) or self.auto_confirm:
            return True
        callback = req.get("callback")
        if callback:
            return self._ask_confirmation(callback, name)
        return False

    def GetPutInfo(self, req, ctx):
        """Conflict check + placement + version bump (server.go:74-121).

        On a write within the 60-round window the master asks the
        *requester* for confirmation: a ``callback`` address in the request
        names the requester's own shim server, which the master dials with
        a ``confirm_timeout``-second deadline defaulting to reject
        (Ask_for_confirmation, server.go:144-177).  The callback runs with
        the lock released (only this request blocks, like the reference's
        per-connection goroutine); the conflict window is re-checked under
        the lock before committing, so a put that raced in during the
        callback still needs its own confirmation.
        """
        name = req["file"]
        with self._lock:
            now = self.sim.round
            master = self.sim.cluster.master
            conflict = master.updated_recently(name, now)
            # version observed when the confirmation was asked: the answer
            # covers overwriting THIS write, not one that races in later
            _, seen_version = master.file_info(name)
        confirmed = self._resolve_conflict(req, name) if conflict else False
        if conflict and not confirmed:
            return {"ok": False, "conflict": True}
        with self._lock:
            master = self.sim.cluster.master
            _, cur_version = master.file_info(name)
            if master.updated_recently(name, self.sim.round) and (
                not confirmed or cur_version != seen_version
            ):
                # a concurrent put landed while the lock was released (e.g.
                # during the confirmation callback): it needs its own
                # confirmation — any earlier answer was about the version
                # observed then, so re-reject and let the client retry
                return {"ok": False, "conflict": True}
            replicas, version = master.handle_put(name, self.sim.round)
            return {"ok": bool(replicas), "replicas": replicas, "version": version}

    def GetFileData(self, req, ctx):
        """Replica-side version report (server.go:123-131, slave.go:799-813)."""
        with self._lock:
            store = self.sim.cluster.stores[int(req["node"])]
            return {"local_version": store.version(req["file"])}

    def GetFileInfo(self, req, ctx):
        """Replica list + version; ([], -1) when absent (server.go:133-142)."""
        with self._lock:
            replicas, version = self.sim.cluster.master.file_info(req["file"])
            return {"replicas": replicas, "version": version}

    def AskForConfirmation(self, req, ctx):
        """The requester-side conflict prompt (server.go:144-177): the
        master dialed THIS node back about ``file``.  ``confirm_handler``
        is the interactive yes/no site; without one, the ``auto_confirm``
        policy answers (and the master's timeout covers a hung prompt)."""
        if self.confirm_handler is not None:
            return {"confirm": bool(self.confirm_handler(req.get("file", "")))}
        return {"confirm": self.auto_confirm}

    def GetDeleteInfo(self, req, ctx):
        """Master drops metadata, returns old replicas (server.go:214-219)."""
        with self._lock:
            return {"old_replicas": self.sim.cluster.master.delete(req["file"])}

    def DeleteFileData(self, req, ctx):
        """Replica-local delete (server.go:221-223, sdfs_slave.go:63-77)."""
        with self._lock:
            ok = self.sim.cluster.stores[int(req["node"])].delete(req["file"])
            return {"ok": ok}

    def RemoteReput(self, req, ctx):
        """Ask a healthy source to push a file to a new replica
        (server.go:225-229 -> slave.Re_put, slave.go:1093-1120)."""
        with self._lock:
            stores = self.sim.cluster.stores
            blob = stores[int(req["source"])].get(req["file"])
            if blob is None:
                return {"ok": False}
            stores[int(req["target"])].put(req["file"], blob, int(req["version"]))
            return {"ok": True}

    def Vote(self, req, ctx):
        """Election vote (server.go:231-234 -> Receive_vote, slave.go:968-984):
        candidate counts distinct voters; on majority of the current view it
        becomes master."""
        candidate, voter = int(req["candidate"]), int(req["voter"])
        with self._lock:
            voters = self._votes.setdefault(candidate, set())
            voters.add(voter)
            # only count voters still in the current view: a tally that
            # persists across a stalled round must not let since-dead
            # voters push a later, smaller majority over the line
            live = set(self.sim.cluster.live)
            elected = election.tally(voters & live, len(live))
            if elected:
                self.sim.cluster.master_node = candidate
                # election over: clear ALL tallies so losers' votes can't
                # leak into a later election (VoteStatus reset,
                # slave.go:968-975)
                self._votes.clear()
            return {"elected": elected, "votes": len(voters)}

    def AssignNewMaster(self, req, ctx):
        """Tell a node the new master; it answers with its local registry for
        the metadata rebuild (server.go:236-239 -> slave.go:1045-1051)."""
        with self._lock:
            self.sim.cluster.master_node = int(req["master"])
            listing = self.sim.cluster.stores[int(req["node"])].listing()
            return {"listing": listing}

    def UpdateFileVersion(self, req, ctx):
        """Registry-only version write on a replica (server.go:241-245 ->
        sdfs_slave.go:20-25)."""
        with self._lock:
            store = self.sim.cluster.stores[int(req["node"])]
            store.set_version(req["file"], int(req["version"]))
            return {"ok": True}

    def GetUpdateMeta(self, req, ctx):
        """Feed a membership snapshot, get the repair plan back
        (server.go:247-251 -> master.go:74-127).  Planning only — executing
        the copies and committing is the caller's job, like the reference;
        the cluster's own view/reachability/master state is untouched (the
        snapshot may be stale relative to the detector)."""
        with self._lock:
            cluster = self.sim.cluster
            view = sorted(int(x) for x in req["membership"])
            reach = cluster.reachable & set(view)
            plans = cluster.master.plan_repairs(view, reachable=reach)
            return {
                "plans": [
                    {
                        "file": p.file,
                        "source": p.source,
                        "version": p.version,
                        "new_nodes": list(p.new_nodes),
                        "survivors": list(p.survivors),
                    }
                    for p in plans
                ]
            }

    # -- whole-op verbs (CLI surface, README.md:8-29) ----------------------
    def Put(self, req, ctx):
        data = base64.b64decode(req["data_b64"])
        name = req["file"]
        # resolve any needed confirmation BEFORE taking the lock: the
        # callback is a network round-trip (up to confirm_timeout) that must
        # not stall every other RPC.  The pre-resolved answer feeds the
        # in-lock put; a conflict that appears only while we were unlocked
        # gets a None confirm and rejects conservatively.
        with self._lock:
            conflict = self.sim.cluster.master.updated_recently(
                name, self.sim.round
            )
        confirm = None
        if conflict:
            allowed = self._resolve_conflict(req, name)
            confirm = (lambda: allowed)  # noqa: E731
        elif req.get("confirm") or self.auto_confirm:
            confirm = lambda: True  # noqa: E731
        with self._lock:
            ok = self.sim.put(name, data, confirm=confirm)
            return {"ok": ok}

    def Get(self, req, ctx):
        with self._lock:
            blob = self.sim.get(req["file"])
        if blob is None:
            return {"found": False}
        return {"found": True, "data_b64": base64.b64encode(blob).decode()}

    def Delete(self, req, ctx):
        with self._lock:
            return {"ok": self.sim.delete(req["file"])}

    def Ls(self, req, ctx):
        with self._lock:
            return {"replicas": self.sim.cluster.ls(req["file"])}

    def Store(self, req, ctx):
        with self._lock:
            return {"listing": self.sim.cluster.store_listing(int(req["node"]))}

    def ShowMetadata(self, req, ctx):
        with self._lock:
            return {
                "files": {
                    name: {
                        "version": info.version,
                        "node_list": list(info.node_list),
                    }
                    for name, info in self.sim.cluster.master.files.items()
                }
            }

    # -- plumbing -----------------------------------------------------------
    METHODS = [
        "Join", "Leave", "Crash", "Lsm", "AliveNodes", "Advance",
        "AdvanceBulk", "Events", "Vitals",
        "Grep", "GetPutInfo", "GetFileData", "GetFileInfo",
        "AskForConfirmation", "GetDeleteInfo", "DeleteFileData", "RemoteReput",
        "Vote", "AssignNewMaster", "UpdateFileVersion", "GetUpdateMeta",
        "Put", "Get", "Delete", "Ls", "Store", "ShowMetadata",
    ]

    def generic_handler(self) -> grpc.GenericRpcHandler:
        handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                getattr(self, name),
                request_deserializer=wire.request_deserializer(name),
                response_serializer=wire.response_serializer(name),
            )
            for name in self.METHODS
        }
        return grpc.method_handlers_generic_handler(SERVICE, handlers)


class ShimServer:
    """Owns the grpc.Server lifecycle around one ShimServicer."""

    def __init__(
        self,
        sim: CoSim,
        port: int = 0,
        host: str = "127.0.0.1",
        auto_confirm: bool = False,
        confirm_timeout: float = float(CONFIRM_TIMEOUT),
        confirm_handler=None,
        max_workers: int = 8,
        max_message_mb: int = wire.MAX_MESSAGE_MB,
    ):
        self.servicer = ShimServicer(
            sim, auto_confirm=auto_confirm, confirm_timeout=confirm_timeout,
            confirm_handler=confirm_handler,
        )
        # same cap as the client (wire.py — multi-MB file payloads)
        opts = wire.message_size_options(max_message_mb)
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers), options=opts
        )
        # leave >= 2 workers free for the election's self-dialed Vote /
        # AssignNewMaster RPCs (see ShimServicer._advance_slots)
        self.servicer._advance_slots = threading.BoundedSemaphore(
            max(1, max_workers - 2)
        )
        self.server.add_generic_rpc_handlers((self.servicer.generic_handler(),))
        self.port = self.server.add_insecure_port(f"{host}:{port}")
        self.address = f"{host}:{self.port}"
        self.servicer.address = self.address

    def start(self) -> "ShimServer":
        self.server.start()
        return self

    def stop(self, grace: float = 0.5) -> None:
        if self.servicer._self_client is not None:
            self.servicer._self_client.close()
            self.servicer._self_client = None
        self.server.stop(grace).wait()


def main(argv=None) -> None:
    """Standalone shim process — the reference's ``./main`` for the service:

        python -m gossipfs_tpu_torch.shim.service --n 100 --port 9000

    Serves /gossipfs.Shim/* until interrupted; advance the simulated clock
    via the Advance/AdvanceBulk RPCs (shim/client.py) or --auto-tick.  The
    detector's rounds run on the card (``--device cpu`` for the CPU); the
    kernels they launch are built before the server starts.
    """
    import argparse
    import time as _time

    from gossipfs_tpu_torch.config import SimConfig

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--n", type=int, default=10)
    p.add_argument("--port", type=int, default=9000)
    p.add_argument("--topology", choices=["ring", "random"], default="ring")
    p.add_argument("--auto-confirm", action="store_true",
                   help="answer write-conflict confirmations yes (30 s-timeout default is no)")
    p.add_argument("--auto-tick", type=float, default=0.0, metavar="SECONDS",
                   help="advance one round every SECONDS of wall time (the "
                        "reference's 1 s driver: --auto-tick 1.0); default: "
                        "clients drive time via Advance")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.shim.service needs a CUDA "
                         "device (or --device cpu)")

    fanout = 3 if args.topology == "ring" else SimConfig.log_fanout(args.n)
    cfg = SimConfig(n=args.n, topology=args.topology, fanout=fanout)
    build_kernels(cfg, args.device)
    sim = CoSim(cfg, device=args.device)
    server = ShimServer(sim, port=args.port, auto_confirm=args.auto_confirm).start()
    print(f"gossipfs shim serving {SERVICE} on {server.address} "
          f"(n={args.n}, device={args.device})", flush=True)
    try:
        while True:
            if args.auto_tick > 0:
                _time.sleep(args.auto_tick)
                with server.servicer._election_lock:
                    with server.servicer._lock:
                        # like Advance: the synchronous path resolves any
                        # bulk scan, so Lsm/AliveNodes can't stay pinned to
                        # a stale bulk snapshot while the state moves on
                        server.servicer._snapshots = None
                        sim.tick(1)
                    server.servicer.run_pending_election()
            else:
                _time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
