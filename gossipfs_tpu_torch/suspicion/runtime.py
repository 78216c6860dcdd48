# The port's own copy of the JAX package's
# gossipfs_tpu/suspicion/runtime.py, kept verbatim.
"""Per-node suspicion runtime for the socket engines.

The reference implementation of the suspect/refute lifecycle in
``suspicion/params.py``: one :class:`SuspicionRuntime` per gossip node
tracks which peers that node currently suspects, applies the
local-health stretch to its confirmation window, and counts
refutations/confirmations.  The asyncio UDP engine (``detector/udp.py``
``UdpNode``) and the per-process deploy daemons (``deploy/node.py``,
which arm it via the ``SuspicionLoad`` RPC) both drive it from their
heartbeat tick; the tensor engine implements the same state machine as
fused array transitions (``core/rounds.py``) and is pinned against the
per-node model by the golden suspicion tests.

Clock convention: the caller owns time (the UDP engines pass
``time.monotonic()`` seconds and scale windows by their period), this
class only compares "now - suspect_start" against the window it is
handed.  Keys are whatever the engine uses to name peers (addresses for
the socket engines).
"""

from __future__ import annotations

from gossipfs_tpu_torch.suspicion.params import SuspicionParams


class SuspicionRuntime:
    """One node's suspect table + refute/confirm accounting.

    The verb surface here (suspect/adopt/expired/refute/confirm/drop/
    degraded/t_suspect_window) IS the contract's per-node lifecycle API
    (analysis/protocol_spec.py); the spec-runtime-protocol rule pins it,
    including the lh_frac-driven ``degraded`` signal and the
    lh-multiplied confirmation window.
    """

    def __init__(self, params: SuspicionParams):
        self.params = params
        self.suspects: dict[object, float] = {}  # key -> suspect-start time
        self.entered = 0
        self.refutations = 0
        self.confirms = 0

    # -- lifecycle -----------------------------------------------------------
    def suspect(self, key, now: float) -> bool:
        """Mark ``key`` SUSPECT on local evidence (a stale entry); no-op
        if already suspected.  True when newly marked."""
        if key in self.suspects:
            return False
        self.suspects[key] = now
        self.entered += 1
        return True

    def adopt(self, key, now: float) -> None:
        """Adopt a peer-disseminated suspicion (a SUSPECT broadcast):
        starts the timer but does NOT count toward ``entered`` — the
        vitals count entries newly suspected on local evidence (the
        tensor engine's semantics), and an adoption of a locally-fresh
        entry is discarded uncounted at the next tick anyway."""
        self.suspects.setdefault(key, now)

    def expired(self, key, now: float, t_suspect_window: float) -> bool:
        """Whether ``key``'s suspicion outlived the confirmation window."""
        start = self.suspects.get(key)
        return start is not None and now - start > t_suspect_window

    def refute(self, key) -> bool:
        """Fresh evidence of life (a heartbeat/incarnation advance): clear
        the suspicion.  True when a pending suspicion was refuted."""
        if self.suspects.pop(key, None) is None:
            return False
        self.refutations += 1
        return True

    def confirm(self, key) -> None:
        """SUSPECT -> FAILED: the caller removes the member; we count it."""
        self.suspects.pop(key, None)
        self.confirms += 1

    def drop(self, key) -> None:
        """Member removed for a non-detector reason (LEAVE, a peer's
        REMOVE): forget any pending suspicion without counting."""
        self.suspects.pop(key, None)

    # -- local health (Lifeguard) --------------------------------------------
    def degraded(self, n_listed: int) -> bool:
        """Evidence of self-degradation: an anomalous fraction of the
        node's listed peers simultaneously SUSPECT (params.lh_frac)."""
        p = self.params
        return p.lh_multiplier > 0 and len(self.suspects) > p.lh_frac * n_listed

    def t_suspect_window(self, unit: float, n_listed: int) -> float:
        """The SUSPECT->FAILED window in the caller's clock: ``t_suspect``
        rounds of ``unit`` seconds each, stretched by the local-health
        multiplier while degraded."""
        mult = 1 + (self.params.lh_multiplier if self.degraded(n_listed) else 0)
        return self.params.t_suspect * mult * unit

    # -- status --------------------------------------------------------------
    def status(self) -> dict:
        """THE per-node suspicion vitals document (CLI ``suspicion
        status``, the deploy ``ScenarioStatus`` ride-along) — one
        producer, so the fields cannot drift between engines."""
        return {
            "t_suspect": self.params.t_suspect,
            "lh_multiplier": self.params.lh_multiplier,
            "suspects": sorted(str(k) for k in self.suspects),
            "suspects_entered": self.entered,
            "refutations": self.refutations,
            "confirms": self.confirms,
        }
