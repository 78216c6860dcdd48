"""Real-socket parity implementation: N gossip nodes over localhost UDP.

BASELINE config 1 is "10-node UDP gossip on localhost (Go-parity path)".  This
is a faithful re-implementation of the reference's wire behavior — full
member-list push to ring neighbours every period, ``<#ENTRY#>``/``<#INFO#>``
list framing and ``addr<CMD>VERB`` control datagrams (reference:
slave/slave.go:365-385, 293, 218), max-merge with local timestamping
(slave.go:414-440), timeout detection with hb<=1 grace (slave.go:460-482),
REMOVE broadcast (slave.go:338-363) and fail-list cooldown with the entry's
*original* timestamp (slave.go:276-286) — built on asyncio datagram endpoints
instead of goroutines, with a configurable period so tests run at 20x
real-time.  It satisfies the same FailureDetector interface as the tensor
sim, which is the whole point: consumers can't tell them apart.

The port's copy of the JAX package's ``detector/udp.py``: host code with
no torch, the same codec, the same per-node random streams and the same
``_now`` clock seam, so a run driven through both packages on one fake
clock gives the same tables, events and obs rows.
"""

from __future__ import annotations

import asyncio
import random
import time

from gossipfs_tpu_torch.detector.api import DetectionEvent

ENTRY_SEP = "<#ENTRY#>"
FIELD_SEP = "<#INFO#>"
CMD_SEP = "<CMD>"
# Delta-piggyback frame marker (protocol_spec.DELTA_GOSSIP wire_mark):
# a delta payload is the full-list wire format prefixed by this token;
# the receiver strips it and runs the SAME hardened per-entry max-merge.
DELTA_MARK = "<#DELTA#>"


class _Member:
    __slots__ = ("hb", "ts", "ver")

    def __init__(self, hb: float, ts: float, ver: int = 0):
        self.hb = int(hb)
        self.ts = ts
        # monotone change version (delta gossip): stamped from the
        # owner node's counter whenever this entry materially changes —
        # add, heartbeat/incarnation advance, self bump.  Per-peer
        # cursors compare against it to pick the changed-first slice.
        self.ver = ver


class _NodeProtocol(asyncio.DatagramProtocol):
    def __init__(self, node: "UdpNode"):
        self.node = node

    def datagram_received(self, data: bytes, addr) -> None:
        self.node.handle(data.decode(), addr)


class UdpNode:
    """One gossip process: UDP endpoint + heartbeat task."""

    def __init__(self, cluster: "UdpCluster", idx: int, port: int):
        self.cluster = cluster
        self.idx = idx
        self.port = port
        self.addr = f"127.0.0.1:{port}"
        self.alive = False
        self.members: dict[str, _Member] = {}
        self.fail_list: dict[str, float] = {}  # addr -> entry's last ts
        self.transport: asyncio.DatagramTransport | None = None
        self._hb_task: asyncio.Task | None = None
        # protocol rounds THIS node has ticked — the node's own logical
        # clock.  Deploy logs stamp it so latency assertions count
        # protocol rounds instead of widenable wall-clock windows, and it
        # stalls exactly when the process is starved (unlike wall time).
        self.rounds = 0
        self.last_tick_error: Exception | None = None
        # suspicion subsystem (suspicion/): per-node suspect table, armed
        # when the cluster (or deploy _Env) carries SuspicionParams.
        # (params, runtime) pair so a mid-run re-arm rebuilds the table
        self._sus: tuple[object, object] | None = None
        self._last_refute_t = float("-inf")  # rate-limits REFUTE broadcasts
        # per-node stream for the random-push topology draw (the
        # north-star campaign profile; unused in the reference ring mode)
        self._rng = random.Random(0x5EED ^ (idx * 2654435761))
        # delta gossip state (protocol_spec DELTA_GOSSIP): the node's
        # monotone change counter, the per-peer change cursors (last
        # version pushed to that peer), and the round-robin refresh
        # cursor over the stable tail
        self._ver = 0
        self._sent_ver: dict[str, int] = {}
        self._refresh_pos = 0

    def _suspicion(self):
        """The armed SuspicionRuntime, tracking the host's params."""
        params = getattr(self.cluster, "suspicion", None)
        if params is None:
            self._sus = None
            return None
        if self._sus is None or self._sus[0] is not params:
            from gossipfs_tpu_torch.suspicion.runtime import SuspicionRuntime

            self._sus = (params, SuspicionRuntime(params))
        return self._sus[1]

    def _obs(self, kind: str, subject_addr: str, **detail) -> None:
        """Flight-recorder seam (obs/): the host — the in-process
        UdpCluster or the deploy daemon's _Env — decides whether a
        recorder/structured log is armed and stamps its own round clock.
        A host without the hook costs one getattr per event site."""
        hook = getattr(self.cluster, "record_obs", None)
        if hook is not None:
            hook(kind, self.idx, subject_addr, **detail)

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self.transport, _ = await loop.create_datagram_endpoint(
            lambda: _NodeProtocol(self), local_addr=("127.0.0.1", self.port)
        )
        self.alive = True
        self.members = {self.addr: _Member(0, self._now())}
        self._ver = 0
        self._sent_ver = {}
        self._refresh_pos = 0
        self._hb_task = asyncio.create_task(self._heartbeat_loop())

    def stop(self, graceful: bool = False) -> None:
        """graceful=False models CTRL+C (crash-stop, README.md:30)."""
        if graceful and self.alive:
            msg = f"{self.addr}{CMD_SEP}LEAVE"
            for peer in list(self.members):
                if peer != self.addr:
                    self._send(peer, msg)
        self.alive = False
        if self._hb_task:
            self._hb_task.cancel()
        if self.transport:
            self.transport.close()
            self.transport = None

    def _now(self) -> float:
        return time.monotonic()

    def _send(self, peer_addr: str, msg: str) -> None:
        if self.transport is None:
            return
        # scenario engine send hook (scenarios/): the cluster (or the
        # deploy daemon's _Env) decides per datagram whether an armed
        # fault rule — partition, Bernoulli link loss, slow sender —
        # drops it.  Dropping HERE models the network, so heartbeats,
        # JOIN/LEAVE/REMOVE verbs and list pushes are all affected alike.
        allowed = getattr(self.cluster, "message_allowed", None)
        if allowed is not None and not allowed(self.idx, peer_addr):
            return
        # wire accounting (the delta-gossip A/B surface): payload bytes
        # actually handed to the transport, split full-list vs delta
        account = getattr(self.cluster, "account_send", None)
        if account is not None:
            account(msg)
        host, port = peer_addr.rsplit(":", 1)
        self.transport.sendto(msg.encode(), (host, int(port)))

    # -- wire codec (slave.go:365-385) -------------------------------------
    def _encode(self) -> str:
        return ENTRY_SEP.join(
            f"{a}{FIELD_SEP}{m.hb}{FIELD_SEP}{m.ts}" for a, m in self.members.items()
        )

    def _bump(self) -> int:
        """Advance the node's change counter (delta gossip versioning)."""
        self._ver += 1
        return self._ver

    def _encode_delta(self, peer: str) -> str:
        """One bounded delta frame for ``peer`` — the protocol_spec
        DELTA_GOSSIP entry-selection rule: entries whose version
        advanced past the per-peer cursor, most recently changed first,
        then round-robin refresh of the stable tail in any leftover
        capacity, capped at ``delta_entries``.  A peer with no cursor
        yet (first contact) gets the full list instead."""
        c = self.cluster
        cursor = self._sent_ver.get(peer)
        self._sent_ver[peer] = self._ver
        if cursor is None:
            return self._encode()
        cap = c.delta_entries
        changed = [(a, m) for a, m in self.members.items() if m.ver > cursor]
        changed.sort(key=lambda am: am[1].ver, reverse=True)
        picks = changed[:cap]
        if len(picks) < cap and len(self.members) > len(picks):
            # round-robin refresh of the stable tail
            addrs = sorted(self.members)
            seen = {a for a, _ in picks}
            taken = 0
            for k in range(len(addrs)):
                if len(picks) >= cap:
                    break
                a = addrs[(self._refresh_pos + k) % len(addrs)]
                if a not in seen:
                    picks.append((a, self.members[a]))
                    seen.add(a)
                taken = k + 1
            self._refresh_pos = (self._refresh_pos + taken) % len(addrs)
        return DELTA_MARK + ENTRY_SEP.join(
            f"{a}{FIELD_SEP}{m.hb}{FIELD_SEP}{m.ts}" for a, m in picks
        )

    @staticmethod
    def _decode(payload: str) -> list[tuple[str, int, float | None]]:
        out = []
        for chunk in payload.split(ENTRY_SEP):
            parts = chunk.split(FIELD_SEP)
            if len(parts) >= 2:
                # wire-derived fields are untrusted: skip entries whose hb
                # does not parse instead of aborting the whole datagram —
                # the native codec's DecodeMembers semantics.  The old
                # raise lost every VALID entry sharing a datagram with one
                # bad chunk (conformance malformed_codec: a refuting
                # incarnation advance rides with a truncated entry; losing
                # it confirms a live node dead — the committed
                # regressions/conformance_malformed_udp.json repro)
                try:
                    hb = int(float(parts[1]))
                except ValueError:
                    continue
                # the wire ts (delta mode merges it on EQUAL counters);
                # an unparsable ts degrades the entry to hb-only, it
                # does not drop it
                ts = None
                if len(parts) >= 3:
                    try:
                        ts = float(parts[2])
                    except ValueError:
                        ts = None
                out.append((parts[0], hb, ts))
        return out

    # -- receive dispatch (GetMsg, slave.go:207-248) ------------------------
    def handle(self, payload: str, src) -> None:
        if not self.alive:
            return
        if CMD_SEP in payload:
            arg, verb = payload.split(CMD_SEP, 1)
            if verb == "JOIN":
                self._add_member(arg)
            elif verb in ("LEAVE", "REMOVE"):
                self._remove_member(arg)
            elif verb == "SUSPECT":
                self._on_suspect(arg)
            elif verb == "REFUTE":
                self._on_refute(arg)
        elif payload.startswith(DELTA_MARK):
            # delta frame: strip the marker and run the SAME hardened
            # per-entry max-merge — a truncated or replayed delta
            # degrades to a smaller merge, never a protocol error
            self._merge(self._decode(payload[len(DELTA_MARK):]))
        else:
            self._merge(self._decode(payload))

    # -- suspicion wire verbs (SWIM suspect/refute, suspicion/) -------------
    def _on_suspect(self, addr: str) -> None:
        """A peer broadcast ``addr<CMD>SUSPECT``.

        If the suspect is ME: refute by INCARNATION BUMP — advance my own
        heartbeat counter past whatever the suspicion was based on and
        broadcast a REFUTE carrying it (SWIM's alive message; the next
        list pushes carry the bumped counter too).  Otherwise adopt the
        suspicion: an observer whose OWN entry is already stale inherits
        the earlier suspect-start and confirms sooner than its local
        timer alone would.  An observer whose entry is still fresh
        discards the adoption at its next tick — local freshness IS
        refuting evidence (SWIM's alive-over-suspect rule), and honoring
        a foreign timer across it would let a later staleness confirm
        without serving any suspect window.
        """
        rt = self._suspicion()
        if rt is None:
            return
        if addr == self.addr:
            me = self.members.get(self.addr)
            if me is None:
                return
            now = self._now()
            if now - self._last_refute_t < self.cluster.period:
                # k observers suspecting the same episode each broadcast
                # SUSPECT to everyone, so k*(N-1) copies land here; one
                # bump + one REFUTE broadcast per period answers the
                # whole episode (SWIM refutes once per incarnation)
                # instead of amplifying to O(k*N) datagrams
                return
            self._last_refute_t = now
            me.hb += 1
            me.ts = now
            me.ver = self._bump()
            msg = f"{self.addr}{FIELD_SEP}{me.hb}{CMD_SEP}REFUTE"
            for peer in list(self.members):
                if peer != self.addr:
                    self._send(peer, msg)
        elif addr in self.members:
            rt.adopt(addr, self._now())

    def _on_refute(self, arg: str) -> None:
        """``addr<#INFO#>hb<CMD>REFUTE``: the suspect's alive message.

        Receiving it at all proves the sender was alive a datagram ago:
        adopt the bumped incarnation, stamp fresh, and cancel any pending
        suspicion.  A confirmed (fail-listed) entry is NOT resurrected —
        the cooldown suppression wins, as it does for list gossip
        (slave.go:430-439); the node rejoins through the introducer.
        """
        parts = arg.split(FIELD_SEP)
        addr = parts[0]
        hb = int(float(parts[1])) if len(parts) > 1 else 0
        m = self.members.get(addr)
        if m is None:
            return
        if hb > m.hb:
            m.hb = hb
            m.ver = self._bump()
        m.ts = self._now()
        rt = self._suspicion()
        if rt is not None and rt.refute(addr):
            self._obs("refute", addr)

    def _add_member(self, addr: str) -> None:
        """Introducer path: append + push full list to everyone
        (addNewMember, slave.go:250-274)."""
        if addr not in self.members:
            self.members[addr] = _Member(0, self._now(), self._bump())
        msg = self._encode()
        for peer in list(self.members):
            if peer != self.addr:
                self._send(peer, msg)

    def _remove_member(self, addr: str) -> None:
        """Move the entry onto the fail list (removeMember, slave.go:276-286).

        Faithful mode keeps the entry's existing (stale) timestamp, which
        gives detector-removed entries a near-zero cooldown; when message
        latency + scheduling jitter is non-trivial relative to the period,
        that sustains an endemic re-add/re-detect limit cycle (observed both
        here and in the tensor sim).  fresh_cooldown stamps removal time
        instead, restoring a real suppression window.
        """
        member = self.members.pop(addr, None)
        if member is not None and addr not in self.fail_list:
            self.fail_list[addr] = (
                self._now() if self.cluster.fresh_cooldown else member.ts
            )
            self._obs("remove", addr)
        if self._sus is not None:
            # removed for any reason (LEAVE, a peer's REMOVE): forget the
            # pending suspicion (a confirm already popped it, uncounted)
            self._sus[1].drop(addr)

    def _merge(self, remote: list[tuple[str, int, float | None]]) -> None:
        """Anti-entropy max-merge with local stamping (slave.go:414-440)."""
        now = self._now()
        rt = self._sus[1] if self._sus is not None else None
        delta_mode = getattr(self.cluster, "delta", False)
        for addr, hb, wire_ts in remote:
            local = self.members.get(addr)
            if local is not None:
                if hb > local.hb:
                    local.hb = hb
                    local.ts = now
                    local.ver = self._bump()
                    if rt is not None and rt.refute(addr):
                        # refute-by-advance: a fresher counter observed
                        # while SUSPECT cancels the pending failure
                        self._obs("refute", addr)
                elif (delta_mode and hb == local.hb
                      and wire_ts is not None and wire_ts > local.ts):
                    # delta mode only: freshness rides the wire on EQUAL
                    # counters (the native Merge's twin).  Bounded frames
                    # break the full-list assumption that every round
                    # max-merges fanout fresh draws — after a synchronized
                    # anti-entropy round most nodes hold the SAME hb for
                    # an entry, so the next full push carries no advance
                    # and local-stamp-only ts ages toward t_fail on a
                    # QUIET cluster.  Max-merging the wire ts closes it
                    # without breaking crash detection (a crashed node's
                    # copies converge to a constant max, so staleness
                    # still grows globally); clamped to now so a forged
                    # future ts cannot suppress detection.
                    local.ts = min(wire_ts, now)
            elif addr not in self.fail_list:
                self.members[addr] = _Member(hb, now, self._bump())

    # -- heartbeat tick (HeartBeat, slave.go:499-544) -----------------------
    async def _heartbeat_loop(self) -> None:
        period = self.cluster.period
        while self.alive:
            await asyncio.sleep(period)
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001
                # a tick that throws must not silently kill the heartbeat
                # task: the node would freeze mid-protocol (peers see its
                # counter stop at the last pushed value — and if that is
                # still within the hb<=1 grace, slave.go:468, it becomes
                # PERMANENTLY undetectable).  Record and keep ticking.
                self.last_tick_error = e

    def tick(self) -> None:
        c = self.cluster
        now = self._now()
        if not self.alive:
            return
        self.rounds += 1
        if len(self.members) < c.min_group:
            for m in self.members.values():
                m.ts = now  # refresh-only (slave.go:504-509)
            return
        me = self.members.get(self.addr)
        if me is not None:
            me.hb += 1
            me.ts = now
            me.ver = self._bump()
        # detection (slave.go:460-482); with suspicion armed (suspicion/)
        # a stale member passes through SUSPECT first: the first stale
        # tick broadcasts SUSPECT (so the subject can actively refute by
        # incarnation bump — see _on_suspect), and only t_suspect more
        # periods of silence confirm the removal.  The confirm keeps the
        # reference's REMOVE broadcast; a refresh before it (list gossip
        # advance or a REFUTE) cancels the suspicion in _merge/_on_refute.
        t_fail = c.t_fail * c.period
        rt = self._suspicion()
        for addr in list(self.members):
            if addr == self.addr:
                continue
            m = self.members[addr]
            stale = m.hb > 1 and m.ts < now - t_fail
            if not stale:
                if rt is not None:
                    # a genuinely-refuted suspicion was already popped
                    # (and counted) by _merge/_on_refute when the fresh
                    # evidence arrived; anything left here is a
                    # peer-disseminated adoption for an entry that was
                    # never stale locally — clear it WITHOUT counting a
                    # refutation (no evidence-of-life event happened)
                    rt.drop(addr)
                continue
            if rt is not None:
                if rt.suspect(addr, now):
                    self._obs("suspect", addr)
                    msg = f"{addr}{CMD_SEP}SUSPECT"
                    if c.push == "random":
                        # campaign profile: bounded dissemination
                        # (protocol_spec new_suspect/campaign, shared
                        # with the native engine) — the SUBJECT always
                        # hears (its active incarnation-bump refute is
                        # the point) plus fanout random peers, O(fanout)
                        # per new suspicion like every other push in
                        # this mode.  The all-peers broadcast below is
                        # O(suspects x N) per round: at cohort sizes a
                        # rack outage makes every observer suspect the
                        # whole rack in one tick.
                        self._send(addr, msg)
                        peers = [a for a in self.members
                                 if a != self.addr and a != addr]
                        for peer in self._rng.sample(
                                peers, min(c.fanout, len(peers))):
                            self._send(peer, msg)
                    else:
                        # reference-faithful ring mode: all-peers
                        # broadcast, kept verbatim for the small-n
                        # udp-parity lane
                        for peer in list(self.members):
                            if peer != self.addr:
                                self._send(peer, msg)
                    continue
                window = rt.t_suspect_window(c.period, len(self.members))
                if not rt.expired(addr, now, window):
                    # periodic re-notification (round 16, shared with the
                    # native engine): the original SUSPECT broadcast may
                    # have been sent into a fault window — a rack outage
                    # drops it, so the subject never learns and the
                    # post-heal refute wave rides passive list gossip
                    # alone, leaking a bi-modal heal-race FP burst.  One
                    # subject-only datagram per suspect per tick triggers
                    # the active incarnation-bump refute the moment the
                    # subject is reachable again; the REFUTE broadcast is
                    # rate-limited on the subject's side, so k
                    # re-notifiers cost one bump per period.
                    self._send(addr, f"{addr}{CMD_SEP}SUSPECT")
                    continue
                rt.confirm(addr)
            # detection first, then the removal it causes — the same
            # confirm -> remove causal order the tensor engine's events
            # carry (the flight-recorder parity tests compare sequences)
            c.record_detection(self.idx, addr)
            self._remove_member(addr)
            if c.remove_broadcast:
                msg = f"{addr}{CMD_SEP}REMOVE"
                for peer in list(self.members):
                    if peer != self.addr:
                        self._send(peer, msg)
        # fail-list cooldown (slave.go:484-497)
        t_cool = c.t_cooldown * c.period
        for addr in list(self.fail_list):
            if self.fail_list[addr] < now - t_cool:
                del self.fail_list[addr]
        # membership refresh push.  Delta mode (protocol_spec
        # membership_refresh/delta, round 20): every anti_entropy_every-th
        # round — cluster-round aligned, all nodes tick on the same
        # clock — pushes the FULL list so a lost delta can never wedge
        # convergence; every other round sends a bounded per-peer delta
        # frame (_encode_delta: changed-first, rr tail, capped).
        anti_entropy = (not c.delta
                        or self.rounds % c.anti_entropy_every == 0)
        full_msg = self._encode() if anti_entropy else None

        def refresh(peer: str) -> str:
            if anti_entropy:
                if c.delta:
                    # a full list covers everything: advance the cursor
                    self._sent_ver[peer] = self._ver
                return full_msg
            return self._encode_delta(peer)

        if c.push == "random":
            # north-star / campaign push topology: fanout random listed
            # peers per tick (the tensor engine's topology='random' —
            # event propagation in O(log N) rounds instead of the ring's
            # O(N) position walk; see UdpCluster's push notes)
            peers = [a for a in self.members if a != self.addr]
            for peer in self._rng.sample(peers,
                                         min(c.fanout, len(peers))):
                self._send(peer, refresh(peer))
            return
        # ring push to list positions self-1, self+1, self+2 (slave.go:515-542)
        ordered = sorted(self.members)
        if self.addr not in ordered:
            return  # removed-self edge case: no push targets defined
        i = ordered.index(self.addr)
        n = len(ordered)
        for off in (-1, 1, 2):
            peer = ordered[(i + off) % n]
            if peer != self.addr:
                self._send(peer, refresh(peer))


class UdpCluster:
    """FailureDetector over real localhost sockets (asyncio-driven)."""

    def __init__(
        self,
        n: int,
        base_port: int = 18000,
        period: float = 0.05,
        t_fail: int = 5,
        t_cooldown: int = 5,
        min_group: int = 4,
        fresh_cooldown: bool = False,
        scenario=None,
        suspicion=None,
        push: str = "ring",
        fanout: int | None = None,
        remove_broadcast: bool = True,
        delta: bool = False,
        delta_entries: int = 16,
        anti_entropy_every: int = 4,
    ):
        self.n = n
        self.period = period
        self.t_fail = t_fail
        self.t_cooldown = t_cooldown
        self.min_group = min_group
        self.fresh_cooldown = fresh_cooldown
        # protocol-mode knobs (round 14): the reference defaults are the
        # Go-parity wire behavior — ring-position pushes + the REMOVE
        # broadcast.  ``push="random"`` + ``remove_broadcast=False`` is
        # the NORTH-STAR profile the tensor campaigns run (SimConfig
        # topology='random' + gossip-only dissemination): fanout random
        # peers per tick, removal by local timeout only.  The ring walks
        # an event (a heal's fresh counter, a refutation) ~3 positions
        # per tick, so any fault longer than t_fail - n/3 rounds storms
        # distant observers BY TOPOLOGY at campaign cohort sizes; the
        # random push propagates in O(log N) rounds like the tensor
        # engine, which is what makes cross-engine verdict agreement a
        # protocol comparison instead of a topology artifact
        # (campaigns/engines.py).
        if push not in ("ring", "random"):
            raise ValueError(f"unknown push mode: {push!r}")
        self.push = push
        self.fanout = fanout if fanout is not None else max(
            2, (n - 1).bit_length())
        self.remove_broadcast = remove_broadcast
        # delta-piggyback dissemination (round 20, protocol_spec
        # DELTA_GOSSIP): per-round refresh pushes carry a bounded
        # changed-first + rr-tail slice instead of the full O(N) list,
        # with a cluster-round-aligned full-list anti-entropy push every
        # anti_entropy_every rounds.  The cadence must stay strictly
        # below t_fail (the contract constraint): a receiver's last
        # refresh of a live entry is then at most anti_entropy_every
        # rounds old, so delta mode cannot manufacture staleness.
        if delta and anti_entropy_every >= t_fail:
            raise ValueError(
                f"anti_entropy_every={anti_entropy_every} must stay "
                f"strictly below t_fail={t_fail} (protocol_spec "
                "DELTA_GOSSIP constraint — a refresh gap past the "
                "detection window manufactures false positives)")
        self.delta = delta
        self.delta_entries = delta_entries
        self.anti_entropy_every = anti_entropy_every
        # wire accounting (the delta A/B surface): cumulative payload
        # bytes handed to sendto + the full-list vs delta frame split
        self._bytes_sent = 0
        self._frames_full = 0
        self._frames_delta = 0
        # suspicion subsystem (suspicion/): SuspicionParams or None; the
        # nodes read it every tick, so (dis)arming mid-run takes effect
        # on their next heartbeat
        self.suspicion = suspicion
        self.nodes = [UdpNode(self, i, base_port + i) for i in range(n)]
        self._addr_to_idx = {node.addr: i for i, node in enumerate(self.nodes)}
        self._events: list[DetectionEvent] = []
        self._round = 0
        self.introducer = 0
        # flight recorder (obs/) + cumulative vitals counters (events
        # drain, so the `metrics` surface needs its own accounting)
        self._recorder = None
        self._det_total = 0
        self._fp_total = 0
        # scenario engine (scenarios/): armed rule table + the cluster
        # round it was armed at (rule windows are arming-relative)
        self._scn_runtime = None
        self._scn_round0 = 0
        if scenario is not None:
            self.load_scenario(scenario)

    # -- scenario engine ----------------------------------------------------
    def load_scenario(self, scenario) -> None:
        """Arm a scenarios.FaultScenario; windows count from NOW (the
        current cluster round).  Same rule table and semantics as the
        tensor sim's edge filter and the deploy daemons' pushed table."""
        from gossipfs_tpu_torch.scenarios.runtime import ScenarioRuntime

        if scenario.n != self.n:
            raise ValueError(
                f"scenario is for n={scenario.n}, cluster has n={self.n}"
            )
        self._scn_runtime = ScenarioRuntime(scenario)
        self._scn_round0 = self._round
        self._rec_cluster("scenario_arm", -1, name=scenario.name,
                          horizon=scenario.horizon)

    def clear_scenario(self) -> None:
        if self._scn_runtime is not None:
            self._rec_cluster("scenario_clear", -1)
        self._scn_runtime = None

    def scenario_status(self) -> dict | None:
        if self._scn_runtime is None:
            return None
        return self._scn_runtime.status(self._round - self._scn_round0)

    # -- suspicion subsystem ------------------------------------------------
    def load_suspicion(self, params) -> None:
        """Arm a suspicion.SuspicionParams on every node (None disarms);
        takes effect on each node's next heartbeat tick."""
        self.suspicion = params

    def clear_suspicion(self) -> None:
        self.suspicion = None

    def suspects(self, observer: int) -> list[int]:
        """Node ids the observer currently holds SUSPECT."""
        sus = self.nodes[observer]._sus
        if sus is None:
            return []
        return sorted(
            self._addr_to_idx[a] for a in sus[1].suspects
            if a in self._addr_to_idx
        )

    def suspicion_status(self) -> dict | None:
        """Cluster-wide suspicion vitals: per-node live suspect counts +
        cumulative lifecycle totals — the tensor sim's document shape
        (SimDetector.suspicion_status) minus ``fp_suppressed``, which
        needs the ground-truth aliveness only the sim has per refute (a
        consumer reading the real-socket engine must not mistake an
        unknowable for a zero)."""
        if self.suspicion is None:
            return None
        counts: dict[int, int] = {}
        entered = refutations = confirms = 0
        for i, node in enumerate(self.nodes):
            if node._sus is None:
                continue
            rt = node._sus[1]
            if node.alive and rt.suspects:
                counts[i] = len(rt.suspects)
            entered += rt.entered
            refutations += rt.refutations
            confirms += rt.confirms
        return {
            "enabled": True,
            "t_suspect": self.suspicion.t_suspect,
            "lh_multiplier": self.suspicion.lh_multiplier,
            "suspect_counts": counts,
            "suspects_now": sum(counts.values()),
            "suspects_entered": entered,
            "refutations": refutations,
            "confirms": confirms,
        }

    def account_send(self, msg: str) -> None:
        """The UdpNode._send accounting hook (wire-plane vitals)."""
        self._bytes_sent += len(msg)
        if msg.startswith(DELTA_MARK):
            self._frames_delta += 1
        elif CMD_SEP not in msg:
            self._frames_full += 1

    def message_allowed(self, src: int, peer_addr: str) -> bool:
        """The UdpNode._send hook: False = the armed scenario drops it."""
        rt = self._scn_runtime
        if rt is None:
            return True
        dst = self._addr_to_idx.get(peer_addr)
        if dst is None:
            return True
        return not rt.drops(src, dst, self._round - self._scn_round0)

    # -- flight recorder (obs/) ---------------------------------------------
    def attach_recorder(self, recorder) -> None:
        """Arm an obs.FlightRecorder on the UdpNode tick/receive seams."""
        self._recorder = recorder

    def record_obs(self, kind: str, observer: int, subject_addr: str,
                   **detail) -> None:
        """UdpNode._obs lands here; the cluster stamps its round clock."""
        if self._recorder is None:
            return
        from gossipfs_tpu_torch.obs.schema import Event

        subject = self._addr_to_idx.get(subject_addr, -1)
        self._recorder.emit(Event(round=self._round, observer=observer,
                                  subject=subject, kind=kind,
                                  detail=detail))

    def _rec_cluster(self, kind: str, subject: int, **detail) -> None:
        if self._recorder is None:
            return
        from gossipfs_tpu_torch.obs.schema import Event

        self._recorder.emit(Event(round=self._round, observer=-1,
                                  subject=subject, kind=kind,
                                  detail=detail))

    def vitals(self) -> dict:
        """The uniform counter set (obs.schema.VITALS_FIELDS).  This
        engine knows ground-truth aliveness (in-process), so
        false_positives is live; ``fp_suppressed`` stays absent — the
        per-refute ground truth only the sim has (rendered n/a)."""
        doc = {
            "engine": "udp",
            "round": self._round,
            "n_alive": len(self.alive_nodes()),
            "detections": self._det_total,
            "false_positives": self._fp_total,
            "bytes_sent": self._bytes_sent,
            "frames_full": self._frames_full,
            "frames_delta": self._frames_delta,
        }
        sus = self.suspicion_status()
        if sus is not None:
            doc.update({k: sus[k] for k in (
                "suspects_now", "suspects_entered", "refutations",
                "confirms") if k in sus})
        mon = getattr(self._recorder, "monitor", None)
        if mon is not None:
            # a MonitorRecorder attached: the live invariant verdict
            # (absent otherwise -> rendered n/a, the round-8 rule)
            doc["invariant_violations"] = len(mon.violations)
        return doc

    def record_detection(self, observer: int, subject_addr: str) -> None:
        subject = self._addr_to_idx.get(subject_addr)
        if subject is None:
            # a wire-learned address outside the cluster (a stray
            # datagram from a port-space neighbour merged a ghost
            # member): the removal already happened at the caller —
            # nothing to account.  Raising here aborted the observer's
            # tick at the detection step EVERY period (the ghost stays
            # stale), which froze its pushes and stormed the cluster
            # with real FPs; the native engine's IdxOf guard is the
            # same contract.
            return
        fp = self.nodes[subject].alive
        self._det_total += 1
        self._fp_total += int(fp)
        self._events.append(
            DetectionEvent(
                round=self._round,
                observer=observer,
                subject=subject,
                false_positive=fp,
            )
        )
        self.record_obs("confirm", observer, subject_addr,
                        false_positive=bool(fp))

    # -- async lifecycle ----------------------------------------------------
    async def start_all(self) -> None:
        for node in self.nodes:
            await node.start()
        # everyone joins through the introducer (slave.go:288-308)
        intro = self.nodes[self.introducer]
        for node in self.nodes:
            if node.idx != self.introducer:
                node._send(intro.addr, f"{node.addr}{CMD_SEP}JOIN")
        await asyncio.sleep(self.period)

    def seed_full_membership(self) -> None:
        """Start from the fully-joined steady state the tensor engine's
        ``init_state`` models: every node lists everyone at hb 0 with a
        fresh local stamp (inside the hb<=1 detection grace, exactly
        like the sim's hb_grace).  The protocol boot instead funnels
        N-1 JOINs through the introducer — an O(N^2) full-list push
        burst that takes minutes (and drops datagrams) at campaign
        cohort sizes; the campaign runner (campaigns/engines.py) seeds
        and lets the counters flow for a couple of periods instead."""
        now = time.monotonic()
        addrs = [node.addr for node in self.nodes]
        for node in self.nodes:
            if node.alive:
                node.members = {a: _Member(0, now) for a in addrs}

    async def run(self, rounds: int, emit_round_ticks: bool = False) -> None:
        """Advance the cluster clock ``rounds`` heartbeat periods.

        ``emit_round_ticks`` (round 14, the socket campaign runner):
        emit one ``round_tick`` schema event per period carrying the
        ground truth this in-process engine KNOWS — n_alive and the
        period's detection/false-positive deltas (plus the suspicion
        counters when armed) — so a recorded udp stream feeds the
        streaming monitor's rolling-FPR invariant exactly like a tensor
        trace.  ``fp_suppressed`` stays absent (per-refute ground truth
        is sim-only — the n/a-not-0 rule).
        """
        for _ in range(rounds):
            det0, fp0 = self._det_total, self._fp_total
            sus0 = self.suspicion_status() if emit_round_ticks else None
            await asyncio.sleep(self.period)
            if emit_round_ticks:
                det_d = self._det_total - det0
                fp_d = self._fp_total - fp0
                detail = {
                    "n_alive": len(self.alive_nodes()),
                    "true_detections": det_d - fp_d,
                    "false_positives": fp_d,
                }
                sus1 = self.suspicion_status()
                if sus0 is not None and sus1 is not None:
                    detail["suspects_entered"] = (
                        sus1["suspects_entered"] - sus0["suspects_entered"])
                    detail["refutations"] = (
                        sus1["refutations"] - sus0["refutations"])
                self._rec_cluster("round_tick", -1, **detail)
            self._round += 1

    # -- FailureDetector verbs (used inside the event loop) -----------------
    def crash(self, node: int) -> None:
        self.nodes[node].stop(graceful=False)
        self._rec_cluster("crash", node)
        self._rec_cluster("hb_freeze", node)

    def leave(self, node: int) -> None:
        self.nodes[node].stop(graceful=True)
        self._rec_cluster("leave", node)

    async def join(self, node: int) -> None:
        """(Re)start a node's process and send JOIN to the introducer
        (slave.go:288-308).  Lost if the introducer is down — SPOF kept."""
        n = self.nodes[node]
        if not n.alive:
            await n.start()
        n._send(self.nodes[self.introducer].addr, f"{n.addr}{CMD_SEP}JOIN")
        self._rec_cluster("join", node)

    def membership(self, observer: int) -> list[int]:
        return sorted(
            self._addr_to_idx[a]
            for a in self.nodes[observer].members
            if a in self._addr_to_idx
        )

    def alive_nodes(self) -> list[int]:
        return [i for i, node in enumerate(self.nodes) if node.alive]

    def drain_events(self) -> list[DetectionEvent]:
        out, self._events = self._events, []
        return out

    def stop_all(self) -> None:
        for node in self.nodes:
            if node.alive:
                node.stop()


class UdpDetector:
    """Synchronous FailureDetector facade over UdpCluster.

    Runs the asyncio event loop on a background thread so the UDP parity path
    is drop-in interchangeable with detector/sim.SimDetector — same verbs,
    same views, real datagrams underneath.  ``advance(r)`` blocks for r
    heartbeat periods of wall time (this detector runs in real time; the sim
    runs as fast as the chip allows — that asymmetry is the whole point).
    """

    def __init__(self, n: int, **cluster_kwargs):
        import concurrent.futures
        import threading

        self.cluster = UdpCluster(n, **cluster_kwargs)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever, daemon=True)
        self._thread.start()
        self._call(self.cluster.start_all()).result(timeout=30)
        self._futures = concurrent.futures

    def _call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    def _sync(self, fn, *args):
        async def run():
            return fn(*args)

        return self._call(run()).result(timeout=30)

    # -- FailureDetector protocol ------------------------------------------
    def join(self, node: int) -> None:
        self._call(self.cluster.join(node)).result(timeout=30)

    def leave(self, node: int) -> None:
        self._sync(self.cluster.leave, node)

    def crash(self, node: int) -> None:
        self._sync(self.cluster.crash, node)

    def advance(self, rounds: int = 1) -> None:
        self._call(self.cluster.run(rounds)).result(timeout=30 + rounds)

    def membership(self, observer: int) -> list[int]:
        return self._sync(self.cluster.membership, observer)

    def alive_nodes(self) -> list[int]:
        return self._sync(self.cluster.alive_nodes)

    def drain_events(self):
        return self._sync(self.cluster.drain_events)

    # -- scenario engine (executed on the cluster's own loop thread) --------
    def load_scenario(self, scenario) -> None:
        self._sync(self.cluster.load_scenario, scenario)

    def clear_scenario(self) -> None:
        self._sync(self.cluster.clear_scenario)

    def scenario_status(self):
        return self._sync(self.cluster.scenario_status)

    # -- observability (same thread discipline) -----------------------------
    def attach_recorder(self, recorder) -> None:
        self._sync(self.cluster.attach_recorder, recorder)

    def vitals(self) -> dict:
        return self._sync(self.cluster.vitals)

    # -- suspicion subsystem (same thread discipline) -----------------------
    def load_suspicion(self, params) -> None:
        self._sync(self.cluster.load_suspicion, params)

    def clear_suspicion(self) -> None:
        self._sync(self.cluster.clear_suspicion)

    def suspicion_status(self):
        return self._sync(self.cluster.suspicion_status)

    def suspects(self, observer: int) -> list[int]:
        return self._sync(self.cluster.suspects, observer)

    def close(self) -> None:
        self._sync(self.cluster.stop_all)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)
