"""Simulation configuration for the PyTorch port.

The same protocol object as ``gossipfs_tpu.config``: same field names, same
defaults, same semantic validation, so a configuration compares field for
field with the JAX package's.  The port keeps its own copy (it imports
nothing of the JAX package).  What is dropped is the JAX package's Pallas
admissibility checks (VMEM budgets, stripe widths): they describe TPU
layout, not the protocol.  The tiling knobs (``merge_block_*``,
``merge_slots``, ``rr_rotate``) are kept so configurations line up, and
the port's round loop ignores them.  ``rr_resident`` picks the lean
loop's kernel as in the JAX package: the one-pass resident round (K3 form
(f), each lane read and written once) where it holds the shape, else the
two-launch form (core/rounds.onepass).  ``elementwise="swar"`` picks the
SWAR form (ops/swar.py: 4 packed int8 subjects per int32 word) on both
loops, as in the JAX package: the resident round's SWAR kernel on the
lean loop, the SWAR tick and the scenario-armed arc epilogue on the
separate-pass loop; the outputs are the lanes form's bit for bit.  Of
``merge_kernel`` the port reads the family: a ``pallas_rr*`` value sends crash-only rounds of
random edges and arcs to the lean loop (core/rounds._lean_ok), and a
``pallas_stripe*``/``pallas_rr*`` value sends the separate-pass loop's
explicit-edge rounds to the stripe kernel K5 (core/rounds.merge_kernel).

Reference constants (the Go implementation this system models):
  heartbeat period 1 s  -> 1 round == 1 s of simulated time
  failure timeout 5 s   -> t_fail = 5 rounds
  fail-list cooldown 5 s-> t_cooldown = 5 rounds
  minimum group size 4  -> min_group = 4
  fanout 3 ring         -> topology="ring", fanout=3
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

from gossipfs_tpu_torch.suspicion.params import SuspicionParams
from gossipfs_tpu_torch.suspicion.tensor import require_suspicion_config

Topology = Literal["ring", "random", "random_arc"]

# The age lane saturates here.  Every protocol comparison is against a
# small threshold (t_fail, t_cooldown), so ages past the clamp behave
# identically.  63 is 6 bits, so age and status (2 bits) pack into one
# byte: the resident round's lane format (ops/merge.pack_age_status).
AGE_CLAMP = 63

# Per-subject heartbeat rebase windows for the gossip view.  Gossipable
# entries lag the freshest copy of a subject's counter by about t_fail
# rounds per hop, so the window bounds the rebased values and picks the
# view dtype: int16 (window 16384) covers every topology up to a ring of
# ~32k nodes; int8 (window 126) covers short-diameter random topologies.
# REBASE_WINDOW doubles as the storage window of hb_dtype="int16".
REBASE_WINDOW = 16_384
INT8_REBASE_WINDOW = 126


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static parameters of the gossip simulation (see module docstring)."""

    n: int = 1024                    # number of simulated nodes
    fanout: int = 3                  # gossip in-degree per round
    topology: Topology = "ring"      # "ring" (reference parity) | "random" |
                                     # "random_arc" (F consecutive senders)
    arc_align: int = 1               # "random_arc" base granularity: bases
                                     # are multiples of this, and fanout a
                                     # multiple of it.  An aligned arc may
                                     # include the receiver itself, which
                                     # merges as a no-op
    t_fail: int = 5                  # rounds without hb advance before failure
    t_cooldown: int = 5              # rounds a removed member stays on the
                                     # fail list
    min_group: int = 4               # below this list size a node only
                                     # refreshes timestamps
    hb_grace: int = 1                # only detect members with hb > hb_grace
    remove_broadcast: bool = True    # detector broadcasts REMOVE in one round;
                                     # False = failures spread by gossip
    fresh_cooldown: bool = False     # True = stamp the fail-list entry at
                                     # removal time (full t_cooldown)
    introducer: int = 0              # node playing the hardcoded introducer
    merge_block_r: int = 128         # JAX tiling knob (ignored by the port)
    merge_block_c: int = 8192        # JAX tiling knob (ignored by the port)
    merge_slots: int = 4             # JAX tiling knob (ignored by the port)
    merge_kernel: str = "xla"        # JAX merge implementation; the port
                                     # reads only whether it names the
                                     # stripe family (K5 for explicit edges)
    view_dtype: str = "int16"        # gossip-view storage: "int16" | "int8"
    hb_dtype: str = "int32"          # heartbeat-lane storage: "int32" |
                                     # "int16" | "int8" (int8 requires
                                     # view_dtype="int8")
    elementwise: str = "lanes"       # "lanes" | "swar": the SWAR form runs
                                     # the round's compares and selects on 4
                                     # packed int8 subjects per int32 word
                                     # (needs hb_dtype="int8")
    rr_resident: str = "auto"        # K3's one-pass form (f) on the lean
                                     # loop: "auto" wherever it holds the
                                     # round (ops/merge.onepass_fits), "on"
                                     # required (ValueError where it does
                                     # not), "off" the two-launch form
    rr_rotate: str = "auto"          # JAX VMEM layout knob (ignored)
    suspicion: SuspicionParams | None = None  # SWIM suspect/refute
                                     # parameters; None = direct
                                     # crash-on-timeout
    fused_tick: str = "auto"         # JAX fused-tick knob (ignored)

    def __post_init__(self) -> None:
        if self.n < 2:
            raise ValueError(f"n must be >= 2, got {self.n}")
        if not (0 < self.fanout < self.n):
            raise ValueError(f"fanout must be in (0, n), got {self.fanout}")
        if self.topology == "ring" and self.fanout != 3:
            raise ValueError("ring (parity) topology is defined for fanout=3")
        if self.arc_align < 1 or (self.arc_align & (self.arc_align - 1)):
            raise ValueError(
                f"arc_align must be a power of two >= 1, got {self.arc_align}"
            )
        if self.arc_align > 1:
            if self.topology != "random_arc":
                raise ValueError("arc_align > 1 requires topology='random_arc'")
            if self.fanout % self.arc_align or self.n % self.arc_align:
                raise ValueError(
                    "arc_align must divide both fanout and n "
                    f"(align={self.arc_align}, fanout={self.fanout}, "
                    f"n={self.n})"
                )
        if self.t_fail < 1 or self.t_cooldown < 0:
            raise ValueError("t_fail >= 1 and t_cooldown >= 0 required")
        if self.t_fail >= AGE_CLAMP or self.t_cooldown >= AGE_CLAMP:
            raise ValueError(
                f"t_fail and t_cooldown must be < AGE_CLAMP ({AGE_CLAMP}); "
                "the age lane saturates there"
            )
        if self.merge_kernel not in (
            "xla", "pallas", "pallas_interpret",
            "pallas_stripe", "pallas_stripe_interpret",
            "pallas_rr", "pallas_rr_interpret",
        ):
            raise ValueError(f"unknown merge_kernel: {self.merge_kernel!r}")
        if self.rr_resident not in ("auto", "on", "off"):
            raise ValueError(f"unknown rr_resident: {self.rr_resident!r}")
        if self.rr_rotate not in ("auto", "off"):
            raise ValueError(f"unknown rr_rotate: {self.rr_rotate!r}")
        if self.elementwise not in ("lanes", "swar"):
            raise ValueError(f"unknown elementwise: {self.elementwise!r}")
        if self.elementwise == "swar" and self.hb_dtype != "int8":
            raise ValueError("elementwise='swar' requires hb_dtype='int8'")
        if self.fused_tick not in ("auto", "off"):
            raise ValueError(f"unknown fused_tick: {self.fused_tick!r}")
        if self.suspicion is not None:
            if not isinstance(self.suspicion, SuspicionParams):
                raise ValueError(
                    "suspicion must be a suspicion.SuspicionParams, got "
                    f"{type(self.suspicion).__name__}"
                )
            require_suspicion_config(self)
            # the age lane carries the suspicion clock and saturates at
            # AGE_CLAMP: the stretched confirm window must stay below it
            worst = self.suspicion.max_confirm_after(self.t_fail)
            if worst >= AGE_CLAMP:
                raise ValueError(
                    f"t_fail + t_suspect * (1 + lh_multiplier) = {worst} "
                    f"must be < AGE_CLAMP ({AGE_CLAMP}); the age lane, which "
                    "carries the suspicion clock, saturates there"
                )
        if self.view_dtype not in ("int16", "int8"):
            raise ValueError(f"unknown view_dtype: {self.view_dtype!r}")
        if self.hb_dtype not in ("int32", "int16", "int8"):
            raise ValueError(f"unknown hb_dtype: {self.hb_dtype!r}")
        if self.hb_dtype != "int32" and self.topology == "ring":
            raise ValueError(
                f"hb_dtype={self.hb_dtype!r} requires a random topology"
            )
        if self.hb_dtype == "int8" and self.view_dtype != "int8":
            raise ValueError("hb_dtype='int8' requires view_dtype='int8'")
        if self.view_dtype == "int8":
            if self.topology == "ring":
                raise ValueError("view_dtype='int8' requires topology='random'")
            # lag ~ t_fail per hop over the graph's effective diameter, with
            # a 2x safety factor against the 126-round window
            hops = math.ceil(math.log(self.n) / math.log(self.fanout + 1))
            if self.t_fail * (hops + 1) * 2 > INT8_REBASE_WINDOW:
                raise ValueError(
                    f"view_dtype='int8': t_fail={self.t_fail} x estimated "
                    f"graph diameter ({hops} hops at fanout={self.fanout}, "
                    f"n={self.n}) exceeds the {INT8_REBASE_WINDOW}-round "
                    "rebase window (with 2x margin); use int16 or raise fanout"
                )
        for name, lo in (("merge_block_r", 8), ("merge_block_c", 128)):
            v = getattr(self, name)
            if v < lo or (v & (v - 1)) != 0:
                raise ValueError(f"{name} must be a power of two >= {lo}, got {v}")
        if self.merge_slots < 2:
            raise ValueError(f"merge_slots must be >= 2, got {self.merge_slots}")
        arc = self.topology == "random_arc"
        if self.rr_resident == "on" and (
                self.merge_kernel.startswith("pallas_rr")
                or (arc and self.arc_align > 1)):
            # the one-pass form required on a lean profile: it must hold
            # the square round at this N (a shard's width and a scenario's
            # form are checked where core/rounds routes them)
            from gossipfs_tpu_torch.ops import merge

            form = merge.kernel_form(self.fanout if arc else None,
                                     self.arc_align)
            why = merge.onepass_refusal(self.n, self.n, form,
                                        self.elementwise)
            if why is not None:
                raise ValueError(f"rr_resident='on': {why}")

    @property
    def rebase_window(self) -> int:
        """Rebase window matching ``view_dtype`` (see module constants)."""
        return INT8_REBASE_WINDOW if self.view_dtype == "int8" else REBASE_WINDOW

    @staticmethod
    def log_fanout(n: int) -> int:
        """North-star fanout = ceil(log2 N)."""
        return max(1, math.ceil(math.log2(max(n, 2))))

    @classmethod
    def headline(cls, n: int = 16_384, **overrides) -> "SimConfig":
        """The headline round-loop profile: tile-aligned arcs of 16
        consecutive senders, gossip-only dissemination, all-int8 lanes."""
        kw = dict(
            n=n, topology="random_arc", fanout=16, arc_align=8,
            remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
            merge_kernel="pallas_rr", view_dtype="int8", hb_dtype="int8",
        )
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def suspicion_rr(cls, n: int, block_c: int = 1024, t_fail: int = 3,
                     t_suspect: int = 2, interpret: bool = False,
                     **overrides) -> "SimConfig":
        """The rr capacity profile with the SWIM lifecycle armed at the fast
        knob (t_fail=3 + t_suspect=2): the JAX package's fused fast path's
        production config, field for field."""
        kw = dict(t_fail=t_fail,
                  suspicion=SuspicionParams(t_suspect=t_suspect))
        kw.update(overrides)
        return cls.packed_rr(n, block_c, interpret=interpret, **kw)

    @classmethod
    def packed_rr(cls, n: int, block_c: int = 1024,
                  interpret: bool = False, **overrides) -> "SimConfig":
        """The resident-round capacity profile (random fanout log2 N,
        gossip-only with fresh cooldown, all-int8 lanes), field for field
        the JAX package's.  Its crash-only rounds run the lean loop on the
        resident round's explicit-edge form; rounds with joins run the
        separate-pass round on K5."""
        kw = dict(
            n=n, topology="random", fanout=cls.log_fanout(n),
            remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
            merge_kernel="pallas_rr_interpret" if interpret else "pallas_rr",
            merge_block_c=block_c, view_dtype="int8", hb_dtype="int8",
        )
        kw.update(overrides)
        return cls(**kw)
