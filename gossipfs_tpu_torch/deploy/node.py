"""One-process-per-node deployment: the reference's REAL topology.

The reference runs every cluster member as its own OS process carrying all
layers — UDP gossip membership, the SDFS replica store, and a per-node RPC
server (reference: main.go:14-35, server/server.go:179-199).  The embedded
shim (shim/service.py) keeps that RPC surface but hosts the whole cluster
in one process; THIS module is the deployment where each node is its own
``python -m gossipfs_tpu_torch.deploy.node`` process and every repair, election,
and confirmation crosses a real process boundary:

  * membership: the real-socket gossip node (detector/udp.py ``UdpNode``
    — reference wire constants, ring push, timeout detection, REMOVE
    broadcast) auto-ticking on its own asyncio loop.  kill -9 the process
    and the others detect it the protocol way.
  * files: a private ``sdfs/store.LocalStore`` rooted in the node's own
    directory; replica bytes move between processes as ``PutFileData``
    gRPC messages (the reference moves them via scp, slave.go:680-698 —
    same sanctioned substitution the embedded shim documents).
  * control plane: each node serves the gossipfs.proto surface on its own
    port.  The master role (initially node 0, reference master/master.go)
    plans placement and drives re-replication ``RECOVERY_DELAY`` periods
    after a holder leaves its own membership view; when the master dies,
    the lowest live node campaigns with per-node ``Vote`` RPCs and
    ``AssignNewMaster`` returns each node's store listing for the metadata
    rebuild (reference: slave.go:930-1051).
  * logs: every node appends to ``<dir>/node<i>.log``; the ``Grep`` RPC
    serves the node's own log — the reference's distributed grep, with the
    querier fanning out to live nodes.

The port's copy of the JAX package's ``deploy/node.py``.  No torch
anywhere on this path: a node process starts in milliseconds and never
opens the card.

    python -m gossipfs_tpu_torch.deploy.node --idx 3 --n 5 \
        --udp-base 19000 --rpc-base 19100 --dir /tmp/cluster

``deploy/launcher.py`` spawns a whole cluster and runs the kill -9
detection/repair/election scenario end to end.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import pathlib
import threading
import time

import grpc

from gossipfs_tpu_torch.detector.udp import CMD_SEP, UdpNode
from gossipfs_tpu_torch.obs import schema as obs_schema
from gossipfs_tpu_torch.sdfs.store import LocalStore
from gossipfs_tpu_torch.sdfs.types import (
    RECOVERY_DELAY,          # periods after detection before re-replication
    REPLICATION_FACTOR,
    WRITE_CONFLICT_WINDOW,   # seconds (1 reference round == 1 s)
)
from gossipfs_tpu_torch.shim import wire
from gossipfs_tpu_torch.shim.client import ShimClient
from gossipfs_tpu_torch.shim.wire import SERVICE


class _Env:
    """The small interface UdpNode needs from its host (duck-typed for the
    in-process UdpCluster in detector/udp.py)."""

    def __init__(self, daemon: "NodeDaemon", period: float, t_fail: int,
                 t_cooldown: int, min_group: int):
        self.period = period
        self.t_fail = t_fail
        self.t_cooldown = t_cooldown
        self.min_group = min_group
        self.fresh_cooldown = True
        # protocol-mode knobs (round 14, detector/udp.py): the deploy
        # daemons keep the Go-parity wire behavior — ring pushes + the
        # REMOVE broadcast (the reference's per-machine topology)
        self.push = "ring"
        self.fanout = 3
        self.remove_broadcast = True
        # delta dissemination (round 20, protocol_spec DELTA_GOSSIP)
        # stays OFF in the deployment: the daemons keep the committed
        # full-list wire format; the knobs exist because UdpNode reads
        # them from its host every tick
        self.delta = False
        self.delta_entries = 16
        self.anti_entropy_every = 4
        # suspicion subsystem (suspicion/): SuspicionParams pushed over
        # the control plane (SuspicionLoad RPC); the UdpNode reads this
        # every tick, exactly like the in-process UdpCluster's attribute
        self.suspicion = None
        self._daemon = daemon

    def record_detection(self, observer: int, subject_addr: str) -> None:
        self._daemon.on_detection(subject_addr)

    def record_obs(self, kind: str, observer: int, subject_addr: str,
                   **detail) -> None:
        """UdpNode's flight-recorder seam (obs/): in the deployment the
        recorder IS the node's structured log — suspect/refute/remove
        events land in node<i>.log as schema rows, so merging the
        per-node logs (obs/timeline.py) reconstructs the lifecycle."""
        self._daemon.log(kind, f"{kind} {subject_addr}",
                         subject=self._daemon.addr_to_idx(subject_addr))

    def message_allowed(self, src: int, peer_addr: str) -> bool:
        """UdpNode._send scenario hook: the daemon evaluates the rule
        table pushed over the control plane (ScenarioLoad)."""
        return not self._daemon.scenario_drops(src, peer_addr)


class NodeDaemon:
    """One cluster member: gossip + store + RPC server, all in-process."""

    def __init__(self, idx: int, n: int, udp_base: int, rpc_base: int,
                 root: str, period: float = 0.1, t_fail: int = 5,
                 t_cooldown: int = 5, min_group: int = 4,
                 auto_confirm: bool = True, introducer: int = 0):
        self.idx = idx
        self.n = n
        self.udp_base = udp_base
        self.rpc_base = rpc_base
        self.period = period
        self.auto_confirm = auto_confirm
        self.introducer = introducer
        self.master_id = 0  # initial master, reference main.go
        root_p = pathlib.Path(root)
        self.store = LocalStore(root_p / f"node{idx}")
        self.log_path = root_p / f"node{idx}.log"
        self._env = _Env(self, period, t_fail, t_cooldown, min_group)
        self.udp = UdpNode(self._env, idx, udp_base + idx)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._lock = threading.RLock()
        # master state (meaningful only while self.idx == self.master_id)
        self.meta: dict[str, tuple[int, list[int]]] = {}  # file -> (version, holders)
        # placements handed out by GetPutInfo but not yet committed by the
        # writer's UpdateFileVersion — a writer that dies mid-push leaves
        # only a stale pending entry, never unreadable metadata.  Keyed by
        # (file, version) with versions allocated past any pending one, so
        # concurrent writers to the same file each commit THEIR OWN plan
        # (a single slot would let writer A publish writer B's replica set)
        # (file, version) -> (planned replicas, plan time).  The timestamp
        # lets GetPutInfo expire plans whose writer died before committing
        # (round-5 advisor: an abandoned plan used to hold the write-
        # conflict window open forever and leak the pending entry)
        self.pending: dict[tuple[str, int], tuple[list[int], float]] = {}
        self.last_put: dict[str, tuple[float, str]] = {}  # file -> (time, callback)
        self._lost_at: dict[int, float] = {}              # node -> detect time
        self._repair_tick = 0
        self._clients: dict[int, ShimClient] = {}
        self._server: grpc.Server | None = None
        self._stop = threading.Event()
        # scenario engine: rule table pushed via ScenarioLoad.  Each node
        # anchors round 0 at its own PROTOCOL-round counter at receipt
        # (UdpNode.rounds — the same clock the logs stamp): under host
        # load the node's ticks stall and the fault windows stall with
        # them, exactly like the sim and in-process UDP engines.  A
        # wall-clock anchor would instead let a partition "heal" while
        # the starved node executed almost no protocol rounds.  Receipt
        # skew across the fan-out is ~one tick against multi-round rule
        # windows.
        self._scn_runtime = None
        self._scn_round0 = 0
        # vitals counter: detections this daemon's own detector fired
        # (drain-free — the Vitals RPC reports cumulative counts)
        self._det_total = 0
        # the per-node log IS a schema event stream (obs/schema.py): a
        # self-describing header row opens it, and every log site's kind
        # rewrites through LOG_KIND_MAP on write
        if not self.log_path.exists() or self.log_path.stat().st_size == 0:
            with open(self.log_path, "a") as f:
                f.write(json.dumps(obs_schema.header(
                    "deploy-node", n=n, node=idx)) + "\n")

    # -- scenario engine ---------------------------------------------------

    def _scn_round(self) -> int:
        return self.udp.rounds - self._scn_round0

    def scenario_drops(self, src: int, peer_addr: str) -> bool:
        """Whether the armed scenario drops this outgoing gossip datagram."""
        rt = self._scn_runtime
        if rt is None:
            return False
        try:
            dst = int(peer_addr.rsplit(":", 1)[1]) - self.udp_base
        except ValueError:
            return False
        if not 0 <= dst < self.n:
            return False
        return rt.drops(src, dst, self._scn_round())

    # -- plumbing ----------------------------------------------------------

    def addr_to_idx(self, addr: str) -> int:
        try:
            return int(addr.rsplit(":", 1)[1]) - self.udp_base
        except (ValueError, IndexError):
            return -1

    def log(self, kind: str, message: str, **fields) -> None:
        # ``round`` is the node's OWN protocol-round clock (heartbeat
        # ticks, detector/udp.py UdpNode.rounds): latency read off the
        # log is then in protocol rounds — it stalls with the process
        # under host load instead of widening like wall-clock windows.
        # ``kind`` rewrites through the schema map (obs/schema.py), so
        # node<i>.log is a flight-recorder stream the timeline analyzer
        # merges directly; unmapped operational kinds pass through and
        # must be listed in UNEXPORTED_LOG_KINDS (the lint test).  The
        # original site name survives as ``site`` — the distributed-grep
        # surface keeps matching the historical kind strings.
        skind = obs_schema.LOG_KIND_MAP.get(kind, kind)
        entry = {"ts": round(time.time(), 3), "node": self.idx,
                 "round": self.udp.rounds,
                 "kind": skind, "message": message, **fields}
        if skind != kind:
            entry["site"] = kind
        with open(self.log_path, "a") as f:
            f.write(json.dumps(entry) + "\n")

    # deadline for data-plane RPCs (multi-MB payloads — the reference's
    # file5/file10 workload takes seconds per transfer on a loaded host);
    # control-plane RPCs keep the snappy 3 s default so an election or
    # repair scan over a stalled-but-connected peer cannot park the
    # control loop for tens of seconds
    DATA_RPC_TIMEOUT = 30.0

    def client(self, idx: int) -> ShimClient:
        # called from gRPC worker threads, the control loop, and announce
        # threads; grpc channels are thread-safe but the cache isn't
        with self._lock:
            c = self._clients.get(idx)
            if c is None:
                c = self._clients[idx] = ShimClient(
                    f"127.0.0.1:{self.rpc_base + idx}", timeout=3.0
                )
            return c

    def view(self) -> list[int]:
        """Node indices in this node's own membership table."""
        out = []
        for addr in list(self.udp.members):
            port = int(addr.rsplit(":", 1)[1])
            out.append(port - self.udp_base)
        return sorted(out)

    def on_detection(self, subject_addr: str) -> None:
        port = int(subject_addr.rsplit(":", 1)[1])
        subject = port - self.udp_base
        self._lost_at.setdefault(subject, time.monotonic())
        self._det_total += 1
        self.log("detect", f"detected failure of node {subject}",
                 subject=subject)

    # -- master duties -----------------------------------------------------

    def _place(self, file: str, live: list[int]) -> list[int]:
        """Hash-ringed placement over the master's live view (reference
        master/master.go:104-131 hashes onto the member ring).  crc32, not
        ``hash()``: Python string hashing is salted per process, and the
        master role migrates between processes on election."""
        import zlib

        if not live:
            return []
        start = zlib.crc32(file.encode()) % len(live)
        return [live[(start + k) % len(live)] for k in
                range(min(REPLICATION_FACTOR, len(live)))]

    def _master_repair(self) -> None:
        now = time.monotonic()
        self._repair_tick += 1
        live = set(self.view())
        # a holder can leave the master's view through a peer's REMOVE
        # broadcast, which never passes through this node's own detector —
        # the view, not record_detection, is the authority on loss
        with self._lock:
            holding = {h for _, hs in self.meta.values() for h in hs}
        for h in holding - live:
            self._lost_at.setdefault(h, now)
        due = {s for s, t0 in self._lost_at.items()
               if now - t0 >= RECOVERY_DELAY * self.period and s not in live}
        if not due:
            return
        retry = False
        with self._lock:
            for file, (version, holders) in list(self.meta.items()):
                dead = [h for h in holders if h in due]
                if not dead:
                    continue
                survivors = [h for h in holders if h in live]
                if not survivors:
                    self.log("lost", f"no live replica of {file}", file=file)
                    continue
                candidates = [x for x in sorted(live)
                              if x not in holders]
                placed, failed = [], False
                for k, tgt in enumerate(candidates[:len(dead)]):
                    # rotate sources ACROSS ticks too, so a copy-less
                    # survivor (refused RemoteReput) doesn't livelock the
                    # retry on the same source forever
                    src = survivors[(k + self._repair_tick) % len(survivors)]
                    try:
                        ok = bool(self.client(src).call(
                            "RemoteReput", source=src, target=tgt,
                            file=file, version=version,
                            timeout=self.DATA_RPC_TIMEOUT,
                        ).get("ok"))
                    except grpc.RpcError as e:
                        ok = False
                        self.log("repair_error", str(e.code()), file=file)
                    if ok:
                        placed.append(tgt)
                        self.log("re_replicate",
                                 f"Re-replicated {file} v{version} from "
                                 f"{src} to [{tgt}]", file=file, source=src,
                                 target=tgt)
                    else:
                        failed = True
                if failed:
                    # keep the dead holders listed so the next control
                    # tick re-detects the deficit and retries; only the
                    # successfully-pushed targets become holders
                    retry = True
                    self.meta[file] = (version, holders + placed)
                else:
                    self.meta[file] = (
                        version, [h for h in holders if h not in due] + placed
                    )
        if not retry:
            for s in due:
                self._lost_at.pop(s, None)

    def _maybe_campaign(self) -> None:
        """Lowest live node runs the distributed revote when the master is
        gone from its own view (reference slave.go:930-1051)."""
        live = self.view()
        if self.master_id in live or not live or live[0] != self.idx:
            return
        votes = 1  # self
        for peer in live:
            if peer == self.idx:
                continue
            try:
                r = self.client(peer).call(
                    "Vote", candidate=self.idx, voter=peer
                )
                votes += 1 if r.get("elected") else 0
            except grpc.RpcError:
                pass
        if votes <= len(live) // 2:
            self.log("election_stall", f"{votes}/{len(live)} votes")
            return
        # won.  Rebuild the metadata from per-node store listings BEFORE
        # announcing: each AssignNewMaster flips that peer's master pointer
        # immediately, so a put raced between announcement and rebuild
        # would land in a meta dict the rebuild then replaces (observed as
        # a lost file).  Gather -> install atomically -> announce.
        per_holder: dict[str, list[tuple[int, int]]] = {}  # file -> [(peer, v)]
        for peer in live:
            listing: dict[str, int] = {}
            if peer == self.idx:
                listing = self.store.listing()
            else:
                try:
                    r = self.client(peer).call("Store", node=peer)
                    listing = dict(r.get("listing") or {})
                except grpc.RpcError:
                    continue
            for file, version in listing.items():
                per_holder.setdefault(file, []).append((peer, int(version)))
        with self._lock:
            self.master_id = self.idx
            # keep only the max-version holders per file (stale replicas
            # are repaired by read-repair / the next put, not trusted here)
            self.meta = {}
            for file, pairs in per_holder.items():
                v = max(ver for _, ver in pairs)
                self.meta[file] = (v, [p for p, ver in pairs if ver == v])
        for peer in live:
            if peer == self.idx:
                continue
            try:
                # the reply's listing (reference slave.go:1010-1051 shape)
                # is redundant here — the rebuild already ran
                self.client(peer).call(
                    "AssignNewMaster", node=peer, master=self.idx
                )
            except grpc.RpcError:
                pass
        self.log("elected", f"node {self.idx} became master with "
                 f"{votes}/{len(live)} votes", votes=votes)

    def _announce(self, peers: list[int]) -> None:
        for peer in peers:
            try:
                self.client(peer).call(
                    "AssignNewMaster", node=peer, master=self.idx
                )
            except grpc.RpcError:
                pass

    def _control_loop(self) -> None:
        tick = 0
        while not self._stop.wait(self.period):
            tick += 1
            try:
                if self.master_id == self.idx:
                    self._master_repair()
                    if tick % 20 == 0:
                        # idempotent re-announce: a peer whose server was
                        # slow during the election's single AssignNewMaster
                        # fan-out would otherwise point at the dead master
                        # forever (it never campaigns unless it is lowest).
                        # Fire-and-forget thread: a hung peer's RPC timeout
                        # must not stall the repair loop it shares a thread
                        # with
                        peers = [p for p in self.view() if p != self.idx]
                        threading.Thread(
                            target=self._announce, args=(peers,), daemon=True
                        ).start()
                else:
                    self._maybe_campaign()
            except Exception as e:  # keep the daemon alive; log the fault
                self.log("control_error", repr(e))

    # -- RPC handlers ------------------------------------------------------

    def Put(self, req, ctx):
        file = req["file"]
        data = base64.b64decode(req.get("data_b64", ""))
        info = self.client(self.master_id).call(
            "GetPutInfo", file=file, confirm=bool(req.get("confirm")),
            callback=f"127.0.0.1:{self.rpc_base + self.idx}",
        )
        if not info.get("ok"):
            return {"ok": False}
        version = int(info.get("version", 1))
        payload = base64.b64encode(data).decode()
        for replica in info.get("replicas") or []:
            self.client(int(replica)).call(
                "PutFileData", node=int(replica), file=file,
                version=version, data_b64=payload,
                timeout=self.DATA_RPC_TIMEOUT,
            )
        # commit: the master publishes the new version only now that every
        # replica holds the bytes (reference Update_file_version).  A
        # refused commit means the plan expired under us (we stalled past
        # the conflict window) — report failure so the caller retries the
        # whole put instead of believing unpublished bytes are durable
        r = self.client(self.master_id).call(
            "UpdateFileVersion", node=self.idx, file=file, version=version
        )
        if not r.get("ok"):
            return {"ok": False, "expired": True}
        self.log("put", f"put {file} v{version}", file=file)
        return {"ok": True}

    def GetPutInfo(self, req, ctx):
        file = req["file"]
        now = time.time()
        with self._lock:
            # expire abandoned plans: a writer that took a plan and died
            # without committing must not keep prompting later writers,
            # and its pending entry must not leak.  A last_put stamp no
            # newer than the expired plan belonged to that aborted write
            stale = [(k, t) for k, (_r, t) in self.pending.items()
                     if now - t >= WRITE_CONFLICT_WINDOW]
            for k, t in stale:
                del self.pending[k]
                lp = self.last_put.get(k[0])
                if lp and lp[0] <= t:
                    del self.last_put[k[0]]
            prev = self.last_put.get(file)
        conflict = prev is not None and now - prev[0] < WRITE_CONFLICT_WINDOW
        if conflict and not req.get("confirm"):
            # ask the REQUESTER to confirm the overwrite
            # (server.go:155-177); its own policy answers.  The RPC runs
            # with no lock held — a dead/hung requester must not stall
            # the master's repair loop or other writers for its timeout
            cb = req.get("callback") or ""
            ok = False
            if cb:
                try:
                    c = ShimClient(cb, timeout=5.0)
                    ok = bool(c.call("AskForConfirmation",
                                     file=file).get("confirm"))
                    c.close()
                except grpc.RpcError:
                    ok = False
            if not ok:
                return {"ok": False, "conflict": True}
        with self._lock:
            version, holders = self.meta.get(file, (0, []))
            live = self.view()
            replicas = holders if holders else self._place(file, live)
            replicas = [r for r in replicas if r in live] or \
                self._place(file, live)
            # two-phase, the reference's own flow (Get_put_info hands out
            # the plan, Update_file_version commits after the transfer):
            # committing here would strand the readable version if the
            # writer dies between this reply and its pushes.  The new
            # version goes past every in-flight one so concurrent writers
            # never share a pending slot
            new_v = max([version] + [v for (f, v) in self.pending
                                     if f == file]) + 1
            self.pending[(file, new_v)] = (list(replicas), now)
            self.last_put[file] = (now, req.get("callback") or "")
        return {"ok": True, "conflict": conflict,
                "replicas": list(replicas), "version": new_v}

    def PutFileData(self, req, ctx):
        data = base64.b64decode(req.get("data_b64", ""))
        self.store.put(req["file"], data, int(req.get("version", 1)))
        return {"ok": True}

    def GetFileData(self, req, ctx):
        data = self.store.get(req["file"])
        if data is None:
            return {"local_version": -1}
        return {"local_version": self.store.version(req["file"]),
                "data_b64": base64.b64encode(data).decode()}

    def GetFileInfo(self, req, ctx):
        with self._lock:
            version, holders = self.meta.get(req["file"], (-1, []))
        return {"replicas": list(holders), "version": version}

    def Get(self, req, ctx):
        info = self.client(self.master_id).call("GetFileInfo",
                                                file=req["file"])
        want = int(info.get("version", -1))
        live = set(self.view())
        for holder in info.get("replicas") or []:
            if int(holder) not in live:
                continue
            try:
                r = self.client(int(holder)).call(
                    "GetFileData", node=int(holder), file=req["file"],
                    timeout=self.DATA_RPC_TIMEOUT,
                )
            except grpc.RpcError:
                continue
            # exact-version gate: a stale replica (failed push, repair
            # from a stale holder) must not serve old bytes as current,
            # and a NEWER-than-committed local version means a writer
            # pushed and died before UpdateFileVersion — serving those
            # bytes would be a dirty read of an aborted two-phase put
            # (round-5 advisor)
            if want >= 0 and int(r.get("local_version", -1)) == want:
                return {"found": True, "data_b64": r.get("data_b64", "")}
        return {"found": False}

    def GetDeleteInfo(self, req, ctx):
        with self._lock:
            _, holders = self.meta.get(req["file"], (0, []))
            self.meta.pop(req["file"], None)
            self.last_put.pop(req["file"], None)
            for k in [k for k in self.pending if k[0] == req["file"]]:
                del self.pending[k]
        return {"old_replicas": list(holders)}

    def DeleteFileData(self, req, ctx):
        self.store.delete(req["file"])
        return {"ok": True}

    def Delete(self, req, ctx):
        info = self.client(self.master_id).call("GetDeleteInfo",
                                                file=req["file"])
        for holder in info.get("old_replicas") or []:
            try:
                self.client(int(holder)).call(
                    "DeleteFileData", node=int(holder), file=req["file"]
                )
            except grpc.RpcError:
                pass
        return {"ok": True}

    def Ls(self, req, ctx):
        info = self.client(self.master_id).call("GetFileInfo",
                                                file=req["file"])
        return {"replicas": info.get("replicas") or []}

    def Store(self, req, ctx):
        return {"listing": self.store.listing()}

    def RemoteReput(self, req, ctx):
        """Master -> surviving holder: push the file to the new target."""
        file, target = req["file"], int(req["target"])
        data = self.store.get(file)
        if data is None:
            # OkReply carries only `ok` — a free-text field here would
            # fail response serialization and surface as an opaque
            # RpcError at the master instead of a clean refusal
            self.log("reput_miss", f"no local copy of {file}", file=file)
            return {"ok": False}
        self.client(target).call(
            "PutFileData", node=target, file=file,
            version=int(req.get("version", 1)),
            data_b64=base64.b64encode(data).decode(),
            timeout=self.DATA_RPC_TIMEOUT,
        )
        self.log("reput", f"pushed {file} to {target}", file=file,
                 target=target)
        return {"ok": True}

    def Vote(self, req, ctx):
        """Grant iff the candidate is the lowest node in MY live view."""
        live = self.view()
        grant = bool(live) and int(req["candidate"]) == live[0]
        return {"elected": grant, "votes": 1 if grant else 0}

    def AssignNewMaster(self, req, ctx):
        with self._lock:
            changed = self.master_id != int(req["master"])
            self.master_id = int(req["master"])
        if changed:  # re-announces are periodic; log transitions only
            self.log("new_master", f"master is now {self.master_id}",
                     master=self.master_id)
        return {"listing": self.store.listing()}

    def AskForConfirmation(self, req, ctx):
        return {"confirm": self.auto_confirm}

    def ScenarioLoad(self, req, ctx):
        """Arm a fault scenario on THIS node (scenarios/schedule.py JSON in
        ``data_b64``).  The launcher fans the same table out to every
        node — the deploy backend of the scenario engine; windows count
        from each node's receipt.  An empty payload disarms."""
        from gossipfs_tpu_torch.scenarios.runtime import ScenarioRuntime
        from gossipfs_tpu_torch.scenarios.schedule import FaultScenario

        payload = base64.b64decode(req.get("data_b64", "") or "")
        if not payload:
            self._scn_runtime = None
            self.log("scenario_clear", "scenario cleared")
            return {"ok": True}
        try:
            sc = FaultScenario.from_json(payload.decode())
        except (ValueError, KeyError) as e:
            self.log("scenario_error", repr(e))
            return {"ok": False}
        if sc.n != self.n:
            self.log("scenario_error",
                     f"scenario n={sc.n} != cluster n={self.n}")
            return {"ok": False}
        self._scn_round0 = self.udp.rounds
        self._scn_runtime = ScenarioRuntime(sc)
        self.log("scenario", f"armed scenario {sc.name}",
                 scenario=sc.name, horizon=sc.horizon)
        return {"ok": True}

    def ScenarioStatus(self, req, ctx):
        """This node's view of the armed scenario (GrepReply lines).

        Also carries the node's protocol-round tick counter, its members'
        heartbeat counters, and — when suspicion is armed — the node's
        suspicion vitals (live suspects, refutation/confirm totals): the
        per-node state an operator (or a test) wants next to the fault
        state, all riding the one status RPC."""
        rt = self._scn_runtime
        doc = {"node": self.idx, "armed": rt is not None,
               "rounds": self.udp.rounds,
               "tick_error": repr(self.udp.last_tick_error)
               if self.udp.last_tick_error else "",
               "hb": {a: m.hb for a, m in self.udp.members.items()}}
        doc["suspicion_armed"] = self._env.suspicion is not None
        if self.udp._sus is not None:
            srt = self.udp._sus[1]
            # the ONE vitals producer (SuspicionRuntime.status) so the
            # fields cannot drift between engines; only `suspects` is
            # remapped from addresses to node indices
            sdoc = srt.status()
            sdoc["suspects"] = sorted(
                int(a.rsplit(":", 1)[1]) - self.udp_base
                for a in srt.suspects
            )
            doc.update(sdoc)
        if rt is not None:
            doc.update(rt.status(self._scn_round()))
        return {"lines": [doc]}

    def SuspicionLoad(self, req, ctx):
        """Arm the suspicion lifecycle on THIS node (suspicion/params.py
        JSON in ``data_b64``; empty payload disarms).  The launcher fans
        the same params out to every node — the deploy backend of the
        suspicion subsystem, riding the control plane like ScenarioLoad."""
        from gossipfs_tpu_torch.suspicion.params import SuspicionParams

        payload = base64.b64decode(req.get("data_b64", "") or "")
        if not payload:
            self._env.suspicion = None
            self.log("suspicion_clear", "suspicion cleared")
            return {"ok": True}
        try:
            params = SuspicionParams.from_json(payload.decode())
        except (ValueError, KeyError) as e:
            self.log("suspicion_error", repr(e))
            return {"ok": False}
        self._env.suspicion = params
        self.log("suspicion", f"armed suspicion t_suspect={params.t_suspect}",
                 t_suspect=params.t_suspect)
        return {"ok": True}

    def Vitals(self, req, ctx):
        """THIS node's uniform vitals row (obs.schema.VITALS_FIELDS),
        riding GrepReply Struct lines like ScenarioStatus.  Ground-truth
        fields the per-process deployment cannot know (n_alive,
        false_positives, fp_suppressed — other processes' liveness) are
        ABSENT, rendered ``n/a`` by consumers, never 0 (the round-8
        status-shape convention)."""
        doc = {
            "engine": "deploy",
            "node": self.idx,
            "round": self.udp.rounds,
            "members": len(self.udp.members),
            "detections": self._det_total,
        }
        if self.udp._sus is not None:
            srt = self.udp._sus[1]
            doc.update(suspects_now=len(srt.suspects),
                       suspects_entered=srt.entered,
                       refutations=srt.refutations,
                       confirms=srt.confirms)
        return {"lines": [doc]}

    def UpdateFileVersion(self, req, ctx):
        """The writer's commit: the pushes landed, publish the placement."""
        file, version = req["file"], int(req["version"])
        with self._lock:
            entry = self.pending.pop((file, version), None)
            cur_v, _holders = self.meta.get(file, (0, []))
            if entry is None or version < cur_v:
                # the plan expired (writer stalled past the conflict
                # window and the GetPutInfo sweep reclaimed it) or this
                # is a stale duplicate: publishing would pin the version
                # to holders that never took these bytes.  The writer
                # must retry the whole put
                return {"ok": False, "expired": True}
            self.meta[file] = (version, entry[0])
            # refresh the conflict stamp at commit: the window measures
            # from the write that actually published
            lp = self.last_put.get(file)
            self.last_put[file] = (time.time(), lp[1] if lp else "")
        return {"ok": True}

    def Lsm(self, req, ctx):
        return {"members": self.view()}

    def AliveNodes(self, req, ctx):
        return {"nodes": self.view()}

    def Grep(self, req, ctx):
        """Serve THIS node's own log (reference: each machine greps its own
        Machine.log, logger/logger.go:28-44); the querier fans out."""
        import re
        pat = re.compile(req.get("pattern", ""))
        lines = []
        if self.log_path.exists():
            for line in self.log_path.read_text().splitlines():
                if pat.search(line):
                    lines.append(json.loads(line))
        return {"lines": lines}

    def ShowMetadata(self, req, ctx):
        with self._lock:
            return {"files": {
                f: {"version": v, "node_list": hs}
                for f, (v, hs) in self.meta.items()
            }}

    METHODS = (
        "Put", "GetPutInfo", "PutFileData", "GetFileData", "GetFileInfo",
        "Get", "GetDeleteInfo", "DeleteFileData", "Delete", "Ls", "Store",
        "RemoteReput", "Vote", "AssignNewMaster", "AskForConfirmation",
        "UpdateFileVersion", "Lsm", "AliveNodes", "Grep", "ShowMetadata",
        "ScenarioLoad", "ScenarioStatus", "SuspicionLoad", "Vitals",
    )

    # -- lifecycle ---------------------------------------------------------

    def _generic_handler(self) -> grpc.GenericRpcHandler:
        def make(method):
            fn = getattr(self, method)

            def unary(request, context):
                return fn(request, context)

            return grpc.unary_unary_rpc_method_handler(
                unary,
                request_deserializer=wire.request_deserializer(method),
                response_serializer=wire.response_serializer(method),
            )

        return grpc.method_handlers_generic_handler(
            SERVICE, {m: make(m) for m in self.METHODS}
        )

    def serve_forever(self) -> None:
        from concurrent import futures

        # membership loop on a background thread
        loop = asyncio.new_event_loop()
        self._loop = loop
        t = threading.Thread(target=loop.run_forever, daemon=True)
        t.start()
        asyncio.run_coroutine_threadsafe(self.udp.start(), loop).result(10)
        if self.idx != self.introducer:
            intro_addr = f"127.0.0.1:{self.udp_base + self.introducer}"
            loop.call_soon_threadsafe(
                self.udp._send, intro_addr,
                f"{self.udp.addr}{CMD_SEP}JOIN",
            )
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=16),
            options=wire.message_size_options(),
        )
        self._server.add_generic_rpc_handlers((self._generic_handler(),))
        self._server.add_insecure_port(f"127.0.0.1:{self.rpc_base + self.idx}")
        self._server.start()
        ctrl = threading.Thread(target=self._control_loop, daemon=True)
        ctrl.start()
        self.log("start", f"node {self.idx} up "
                 f"(udp {self.udp.port}, rpc {self.rpc_base + self.idx})")
        try:
            self._server.wait_for_termination()
        finally:
            self._stop.set()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--idx", type=int, required=True)
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--udp-base", type=int, default=19000)
    p.add_argument("--rpc-base", type=int, default=19100)
    p.add_argument("--dir", type=str, required=True)
    p.add_argument("--period", type=float, default=0.1)
    p.add_argument("--t-fail", type=int, default=5)
    p.add_argument("--no-auto-confirm", action="store_true")
    p.add_argument("--introducer", type=int, default=0)
    args = p.parse_args(argv)
    NodeDaemon(
        args.idx, args.n, args.udp_base, args.rpc_base, args.dir,
        period=args.period, t_fail=args.t_fail,
        auto_confirm=not args.no_auto_confirm, introducer=args.introducer,
    ).serve_forever()


if __name__ == "__main__":
    main()
