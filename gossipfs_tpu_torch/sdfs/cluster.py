"""In-process SDFS cluster: client ops + quorum + read-repair + recovery.

This is the data/control plane of the reference (put/get/delete/ls/store,
re-replication, election) with its *transport* replaced: where the reference
moves bytes with sshpass/scp and control with Go net/rpc over TCP
(reference: slave/slave.go:668-928, T1/T2 in SURVEY §2.3), the TPU build moves
bytes between LocalStores directly and takes the membership view from the
failure detector (the sim).  The protocol logic — conflict windows, quorum
counting, stale-replica self-repair, repair planning, election — is preserved
verbatim, so BASELINE config 5 (SDFS co-sim over simulated membership) runs
the same decisions the Go cluster would make.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from gossipfs_tpu_torch.erasure import codec
from gossipfs_tpu_torch.sdfs import election
from gossipfs_tpu_torch.sdfs.master import SDFSMaster
from gossipfs_tpu_torch.sdfs.quorum import (
    read_quorum,
    stripe_read_quorum,
    stripe_write_quorum,
    write_quorum,
)
from gossipfs_tpu_torch.sdfs.store import LocalStore
from gossipfs_tpu_torch.sdfs.types import (
    STRIPE_K,
    STRIPE_M,
    STRIPE_WRITE_SLACK,
    WRITE_CONFLICT_WINDOW,
    ReplicatePlan,
    StripeInfo,
    StripeRepairPlan,
)


class SDFSCluster:
    """All nodes' stores plus the master role, driven by a membership view.

    ``redundancy="stripe"`` swaps the 4-full-replica byte plane for the
    erasure plane (``gossipfs_tpu_torch/erasure/``): puts encode the payload
    into k data + m parity fragments (one LocalStore key per fragment,
    ``codec.frag_key``), landed rack-disjointly; gets reconstruct from
    ANY k fresh fragments; repair re-encodes missing fragments from k
    surviving ones — moving ~1/k the bytes a whole-replica copy moves.
    Threshold math stays in ``sdfs/quorum.py``.
    """

    def __init__(self, n: int, seed: int = 0, introducer: int = 0,
                 redundancy: str = "replica", stripe_k: int = STRIPE_K,
                 stripe_m: int = STRIPE_M, rack_size: int | None = None):
        if redundancy not in ("replica", "stripe"):
            raise ValueError(f"unknown redundancy mode: {redundancy!r}")
        self.n = n
        self.seed = seed
        self.redundancy = redundancy
        self.stripe_k = stripe_k
        self.stripe_m = stripe_m
        # node -> rack id; contiguous blocks of rack_size nodes (the
        # scenario engine's correlated-outage grouping), or every node
        # its own rack when no topology is configured
        self.racks = {i: (i // rack_size if rack_size else i)
                      for i in range(n)}
        self.stores = {i: LocalStore() for i in range(n)}
        self.master_node = introducer  # initial master = introducer (slave.go:22,99)
        self.master = self._new_master()
        self.live: list[int] = list(range(n))      # gossip membership VIEW
        self.reachable: set[int] = set(self.live)  # transport-level reachability
        self.election_pending = False  # master missing, external driver elects
        # repairs a budgeted fail_recover pass planned but deferred (the
        # repair-storm scheduler's backlog signal — see fail_recover)
        self.last_repair_pending = 0
        # repair byte accounting, both modes: bytes actually written per
        # landed repair copy (replica: the whole blob; stripe: one row of
        # S/k bytes — framing headers excluded) — the ERASURE_r18
        # repair-bandwidth claim's measurement
        self.repair_bytes_written = 0
        self.repair_copies = 0
        self.master.update_member(self.live)

    def _new_master(self) -> SDFSMaster:
        return SDFSMaster(seed=self.seed, redundancy=self.redundancy,
                          stripe_k=self.stripe_k, stripe_m=self.stripe_m,
                          racks=self.racks)

    # -- membership seam ---------------------------------------------------
    def update_membership(
        self,
        view: list[int],
        reachable: list[int] | None = None,
        now: int = 0,
        elect: bool = True,
    ) -> None:
        """Feed the detector's membership *view* in (the slave.go:478 seam).

        ``view`` drives placement and the election trigger — it is gossip
        data and may lag ground truth (a dead-but-undetected replica stays
        placeable, exactly like the reference).  ``reachable`` models which
        processes answer RPC/scp at all (a connection to a dead host fails
        immediately even before gossip detects it); it defaults to the view.
        Triggers election when the master is gone from the view
        (updateMemberList, slave.go:452-457); with ``elect=False`` the
        trigger only sets ``election_pending`` and an external driver (the
        shim's distributed Vote/AssignNewMaster path) runs the protocol.
        """
        self.live = sorted(view)
        self.reachable = set(reachable) if reachable is not None else set(self.live)
        self.master.update_member(self.live)
        if self.master_node not in self.live and self.live:
            if elect:
                self._elect(now)
            else:
                self.election_pending = True
        else:
            self.election_pending = False

    def _elect(self, now: int = 0) -> None:
        """Fixed-candidate majority vote + metadata rebuild (slave.go:930-1051),
        computed centrally (the in-process fast path; the gRPC shim's
        distributed mode drives the same outcome through the Vote /
        AssignNewMaster RPC surface instead — shim/service.py).

        Every live node votes for the lowest-ordered member; with all votes
        cast the majority is automatic.  Candidates must actually answer RPC
        (a dead-but-undetected lowest member can't receive votes).  The new
        master rebuilds metadata from surviving local registries.
        """
        candidates = [x for x in self.live if x in self.reachable]
        candidate = election.successor(candidates)
        # majority is counted against the full member list (Receive_vote,
        # slave.go:968-984): with most of the view unreachable, the election
        # stalls rather than letting a minority rebuild (and shrink) metadata
        if candidate is None or not election.tally(set(candidates), len(self.live)):
            return
        registries = {
            i: self.stores[i].listing() for i in self.live if i in self.reachable
        }
        self.install_rebuilt_master(candidate, registries, now)

    def install_rebuilt_master(
        self, winner: int, registries: dict[int, dict[str, int]], now: int
    ) -> None:
        """Make ``winner`` the master with metadata rebuilt from collected
        registries (rebuild_file_meta, slave.go:986-1043) — the commit step
        shared by the central ``_elect`` and the shim's distributed
        Vote/AssignNewMaster election."""
        self.master_node = winner
        # a rebuilt file's true last-write time died with the old master;
        # treat it as not-recent so the conflict window doesn't spuriously
        # reject the first post-election put
        new_master = self._new_master()
        if self.redundancy == "stripe":
            new_master.stripes = self._rebuild_stripes(
                registries, now=now - WRITE_CONFLICT_WINDOW
            )
        else:
            new_master.files = election.rebuild_metadata(
                registries, now=now - WRITE_CONFLICT_WINDOW
            )
        new_master.update_member(self.live)
        self.master = new_master

    def _rebuild_stripes(
        self, registries: dict[int, dict[str, int]], now: int
    ) -> dict[str, StripeInfo]:
        """Stripe-mode metadata rebuild: surviving registries list
        fragment keys (``name#s<slot>``), so the new master recovers
        per-slot holders at the highest version seen; the payload length
        comes out of any surviving fragment's self-describing frame."""
        width = self.stripe_k + self.stripe_m
        # file -> slot -> (version, node), highest version per slot wins
        best: dict[str, dict[int, tuple[int, int]]] = {}
        for node, listing in registries.items():
            for key, version in listing.items():
                parsed = codec.parse_frag_key(key)
                if parsed is None:
                    continue
                name, slot = parsed
                if not 0 <= slot < width:
                    continue
                slots = best.setdefault(name, {})
                if slot not in slots or version > slots[slot][0]:
                    slots[slot] = (version, node)
        rebuilt: dict[str, StripeInfo] = {}
        for name, slots in best.items():
            nodes = [-1] * width
            version = max(v for v, _ in slots.values())
            for slot, (_v, node) in slots.items():
                nodes[slot] = node
            length = 0
            for slot, (v, node) in sorted(
                slots.items(), key=lambda kv: -kv[1][0]
            ):
                blob = self.stores[node].get(codec.frag_key(name, slot))
                if blob is not None:
                    length, _ = codec.unpack_fragment(blob)
                    break
            rebuilt[name] = StripeInfo(fragment_nodes=nodes, version=version,
                                       timestamp=now, length=length)
        return rebuilt

    # -- client ops --------------------------------------------------------
    def put(
        self,
        name: str,
        data: bytes,
        now: int,
        confirm: Callable[[], bool] | None = None,
    ) -> bool:
        """Write path with conflict window + quorum (slave.go:668-778).

        On a write-write conflict (another put within 60 rounds) the master
        asks the requester for confirmation (server.go:74-121); ``confirm``
        models the interactive yes/no (default: reject, the 30 s-timeout
        outcome).
        """
        if self.master.updated_recently(name, now):
            if confirm is None or not confirm():
                return False  # "Write-Write conflicts!" (slave.go:681-686)
        if self.redundancy == "stripe":
            slots, version = self.master.handle_stripe_put(name, now)
            return self._push_stripe(name, data, slots, version)
        replicas, version = self.master.handle_put(name, now)
        return self._push(name, data, replicas, version)

    def _push(self, name: str, data: bytes, replicas: list[int],
              version: int) -> bool:
        """Replica fan-out + W-ack count — the write path's commit half,
        shared by :meth:`put` and :meth:`put_batch`."""
        if not replicas:
            return False  # no live members to place on
        acks = 0
        for node in replicas:
            if node in self.reachable:  # scp to a dead host fails, no ack
                self.stores[node].put(name, data, version)
                acks += 1
        return acks >= write_quorum(len(replicas))

    def _push_stripe(self, name: str, data: bytes, slots: list[int],
                     version: int) -> bool:
        """Stripe fan-out: encode the payload into k+m fragments, land each
        on its slot's holder, ack at the stripe write quorum
        (``sdfs/quorum.py`` owns the threshold).  Every put re-encodes and
        rewrites ALL slots, so at most ``STRIPE_WRITE_SLACK`` slots can be
        stale at any acked version — which keeps k fresh fragments live
        without a stripe read-repair path (the repair plane owns fragment
        refresh)."""
        if not slots:
            return False
        k, m = self.stripe_k, self.stripe_m
        fragments = codec.encode_blob(data, k, m)
        self.master.set_stripe_length(name, len(data))
        acks = 0
        for slot, node in enumerate(slots):
            if node >= 0 and node in self.reachable:
                self.stores[node].put(
                    codec.frag_key(name, slot),
                    codec.pack_fragment(fragments[slot], len(data)),
                    version,
                )
                acks += 1
        return acks >= stripe_write_quorum(k, m, STRIPE_WRITE_SLACK)

    def put_batch(
        self,
        items: list[tuple[str, bytes]],
        now: int,
        confirm: Callable[[], bool] | None = None,
    ) -> dict[str, bool]:
        """Many puts in one round: placement for every NEW file happens as
        ONE vectorized draw (``SDFSMaster.handle_put_batch``) instead of a
        per-file RNG walk; conflict checking, version bumps, replica
        pushes and W-ack counting stay per file (bytes still move per
        replica).  The traffic plane's open-loop generator drives this at
        thousands of files per round.
        """
        allowed: list[str] = []
        results: dict[str, bool] = {}
        payload: dict[str, bytes] = {}
        for name, data in items:
            if self.master.updated_recently(name, now) and (
                confirm is None or not confirm()
            ):
                results[name] = False  # conflict window, unconfirmed
                continue
            allowed.append(name)
            payload[name] = data
        if self.redundancy == "stripe":
            # stripe placement stays per file (the rack-disjoint draw has
            # no batched twin yet — BASELINE.md's erasure section notes it)
            for name in allowed:
                slots, version = self.master.handle_stripe_put(name, now)
                results[name] = self._push_stripe(
                    name, payload[name], slots, version
                )
            return results
        placed = self.master.handle_put_batch(allowed, now)
        for name in allowed:
            replicas, version = placed[name]
            results[name] = self._push(name, payload[name], replicas, version)
        return results

    def get(self, name: str) -> bytes | None:
        """Read path with quorum of version reports + read-repair
        (slave.go:780-892)."""
        if self.redundancy == "stripe":
            return self._get_stripe(name)
        replicas, version = self.master.file_info(name)
        if not replicas or version < 0:
            return None  # "No File Found" (slave.go:830-834)
        reports = {
            node: self.stores[node].version(name)
            for node in replicas
            if node in self.reachable
        }
        if len(reports) < read_quorum(len(replicas)):
            return None  # can't reach a quorum of replicas
        # stale replicas self-repair by pulling from a fresh one (slave.go:799-813)
        fresh = [node for node, v in reports.items() if v >= version]
        if not fresh:
            return None
        blob = self.stores[fresh[0]].get(name)
        for node, v in reports.items():
            if v < version and blob is not None:
                self.stores[node].put(name, blob, version)
        # the client's copy of the pulled bytes (the reference scp-pulls one
        # replica, slave.go:857-878) — reads move one copy, writes move R
        return None if blob is None else bytes(memoryview(blob))

    def _get_stripe(self, name: str) -> bytes | None:
        """Stripe read: fresh fragments from any ``stripe_read_quorum``
        slots reconstruct the payload.  No read-repair here — every put
        rewrites all slots and the repair plane refreshes the rest, so
        stale slots are bounded by the write slack (see
        :meth:`_push_stripe`)."""
        k, m = self.stripe_k, self.stripe_m
        slots, version, length = self.master.stripe_file_info(name)
        if not slots or version < 0:
            return None
        rows: dict[int, bytes] = {}
        for slot, node in enumerate(slots):
            if node < 0 or node not in self.reachable:
                continue
            key = codec.frag_key(name, slot)
            if self.stores[node].version(key) < version:
                continue  # stale fragment can't serve this read
            blob = self.stores[node].get(key)
            if blob is None:
                continue
            _, rows[slot] = codec.unpack_fragment(blob)
            if len(rows) == stripe_read_quorum(k, m):
                break
        if len(rows) < stripe_read_quorum(k, m):
            return None
        return codec.decode_blob(rows, k, m, length)

    def delete(self, name: str) -> bool:
        """Master drops metadata, replicas drop data (slave.go:1057-1091)."""
        if self.redundancy == "stripe":
            old_slots = self.master.stripe_delete(name)
            if not old_slots:
                return False
            for slot, node in enumerate(old_slots):
                if node >= 0:
                    self.stores[node].delete(codec.frag_key(name, slot))
            return True
        old = self.master.delete(name)
        if not old:
            return False
        for node in old:
            self.stores[node].delete(name)
        return True

    def ls(self, name: str) -> list[int]:
        """Replica locations of a file (slave.go:894-917); in stripe mode
        the slot-aligned fragment holders (-1 = unplaced slot)."""
        if self.redundancy == "stripe":
            slots, _, _ = self.master.stripe_file_info(name)
            return slots
        replicas, _ = self.master.file_info(name)
        return replicas

    def store_listing(self, node: int) -> dict[str, int]:
        """Files stored on one node (slave.go:919-928)."""
        return self.stores[node].listing()

    def lost_files(self) -> list[str]:
        """Files with NO replica left in the membership view — the
        ``replica_lost`` evidence (plan_repairs silently skips them as
        unrecoverable; the traffic plane wants them observable)."""
        live_set = set(self.live)
        if self.redundancy == "stripe":
            # a stripe is LOST once fewer than k fragments remain in the
            # view — the MDS bound, not total wipeout, is the loss line
            rq = stripe_read_quorum(self.stripe_k, self.stripe_m)
            return [
                name
                for name, info in self.master.stripes.items()
                if sum(1 for nd in info.fragment_nodes if nd in live_set) < rq
            ]
        return [
            name
            for name, info in self.master.files.items()
            if not any(nd in live_set for nd in info.node_list)
        ]

    # -- failure recovery (slave.go:1093-1175 + master.go:74-127) ----------
    def fail_recover(
        self, budget: int | None = None
    ) -> list[ReplicatePlan] | list[StripeRepairPlan]:
        """Re-replicate every under-replicated file from its first healthy
        replica (Fail_recover + Re_put).  Called RECOVERY_DELAY rounds after a
        detection in the co-sim driver.

        Metadata commits *after* the copies: a file's node_list only gains
        replicas that actually received the bytes, so a failed copy (target
        dead-but-undetected) leaves the file under-replicated in metadata and
        eligible for retry on the next recovery pass.

        ``budget``: the repair-storm scheduler's per-pass cap — at most this
        many plans EXECUTE (plans arrive most-deficient-first from
        ``plan_repairs``, so the budget drains the files closest to data
        loss first); the remainder stays under-replicated in metadata and
        is re-planned next pass.  ``last_repair_pending`` records how many
        planned repairs the budget deferred, so the co-sim driver knows to
        schedule another pass immediately instead of waiting for the next
        detection.

        Returns only *executed* plans, with ``new_nodes`` narrowed to the
        copies that actually landed — what the event log and the bench's
        repair count should reflect.
        """
        if budget is not None and budget <= 0:
            # a zero budget would defer every plan forever while the
            # driver reschedules a full planning sweep each round
            raise ValueError("repair budget must be positive (None = "
                             "unbounded)")
        if self.redundancy == "stripe":
            return self._fail_recover_stripe(budget)
        plans = self.master.plan_repairs(self.live, reachable=self.reachable)
        executed: list[ReplicatePlan] = []
        self.last_repair_pending = 0
        for i, plan in enumerate(plans):
            if budget is not None and len(executed) >= budget:
                self.last_repair_pending = len(plans) - i
                break
            # a listed survivor can hold no bytes (put acked by quorum while
            # it was unreachable, then it rejoined): fall through the other
            # reachable survivors instead of livelocking on an empty source
            # ... and a survivor can hold *stale* bytes (same rejoin story,
            # one version behind): only a source at the plan's version may
            # seed copies, else old bytes get re-stamped as current
            blob = None
            used_source = plan.source  # == first survivor in reach
            for src in plan.survivors:
                if (
                    src in self.reachable
                    and self.stores[src].version(plan.file) >= plan.version
                ):
                    blob = self.stores[src].get(plan.file)
                    if blob is not None:
                        used_source = src
                        break
            if blob is None:
                continue
            copied = []
            for node in plan.new_nodes:
                if node in self.reachable:
                    self.stores[node].put(plan.file, blob, plan.version)
                    self.repair_bytes_written += len(blob)
                    self.repair_copies += 1
                    copied.append(node)
            self.master.commit_repair(plan.file, list(plan.survivors) + copied)
            if copied:
                # report the survivor that actually served the bytes, which
                # can differ from plan.source (stale/empty-source fallthrough)
                executed.append(
                    dataclasses.replace(
                        plan, source=used_source, new_nodes=tuple(copied)
                    )
                )
        return executed

    def _fail_recover_stripe(
        self, budget: int | None
    ) -> list[StripeRepairPlan]:
        """Stripe recovery: fetch k surviving fragments, re-encode the
        missing slots, land them on the planned rack-disjoint targets.
        Each landed fragment moves ceil(S/k) bytes where a replica repair
        moves S — the 1/k repair-bandwidth claim's mechanism.  Budget
        counts executed PLANS (stripes), symmetric with replica mode."""
        k, m = self.stripe_k, self.stripe_m
        plans = self.master.plan_stripe_repairs(
            self.live, reachable=self.reachable
        )
        executed: list[StripeRepairPlan] = []
        self.last_repair_pending = 0
        for i, plan in enumerate(plans):
            if budget is not None and len(executed) >= budget:
                self.last_repair_pending = len(plans) - i
                break
            info = self.master.stripes.get(plan.file)
            if info is None:
                continue
            # gather k source fragments at the plan's version — a listed
            # survivor can be empty or stale (acked while unreachable, then
            # rejoined), so fall through the other survivors; short of k
            # sources the stripe is skipped and re-planned next pass
            rows: dict[int, bytes] = {}
            length = info.length
            for slot in plan.survivors:
                node = info.fragment_nodes[slot]
                key = codec.frag_key(plan.file, slot)
                if (
                    node in self.reachable
                    and self.stores[node].version(key) >= plan.version
                ):
                    blob = self.stores[node].get(key)
                    if blob is not None:
                        length, rows[slot] = codec.unpack_fragment(blob)
                if len(rows) == stripe_read_quorum(k, m):
                    break
            if len(rows) < stripe_read_quorum(k, m):
                continue
            rebuilt = codec.repair_fragments(
                rows, list(plan.slots), k, m, length
            )
            landed: dict[int, int] = {}
            for slot, target in zip(plan.slots, plan.new_nodes):
                if target in self.reachable:
                    self.stores[target].put(
                        codec.frag_key(plan.file, slot),
                        codec.pack_fragment(rebuilt[slot], length),
                        plan.version,
                    )
                    # row bytes only: the 4-byte frame is storage framing,
                    # not repair traffic (BASELINE.md's convention)
                    self.repair_bytes_written += len(rebuilt[slot])
                    self.repair_copies += 1
                    landed[slot] = target
            if landed:
                self.master.commit_stripe_repair(plan.file, landed)
                executed.append(
                    dataclasses.replace(
                        plan,
                        slots=tuple(landed),
                        new_nodes=tuple(landed[s] for s in landed),
                    )
                )
        return executed
