"""SWIM suspect/refute lifecycle parameters (the port's own copy).

The same schema as the JAX package's ``suspicion/params.py``, field for
field, so a configuration compares equal across the two packages.

Timer semantics: the suspicion clock runs on entry staleness.  An entry is
suspected once it has been silent more than ``t_fail`` rounds, and
confirmed FAILED once silent more than ``t_fail + t_suspect * (1 + lh)``
rounds, where ``lh`` is the Lifeguard local-health multiplier (0 unless the
observer is degraded: more than ``lh_frac`` of its listed peers SUSPECT at
once).  The per-entry age lane carries the clock (``age - t_fail`` = rounds
in SUSPECT), so no new ``[N, N]`` lane is needed.  A refutation is any
heartbeat advance observed while SUSPECT.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class SuspicionParams:
    """One suspicion policy (frozen and hashable: it rides ``SimConfig``).

    ``t_suspect``: rounds an entry stays SUSPECT before confirmation.
    ``lh_multiplier`` (0 = off): a degraded observer's confirmation window
    stretches to ``t_fail + t_suspect * (1 + lh_multiplier)``.
    ``lh_frac``: the degradation threshold as a fraction of the observer's
    listed (MEMBER + SUSPECT) peers.  Exact binary fractions (0.25, 1/64)
    keep the float32 compare of the round loops exact.
    """

    t_suspect: int = 2
    lh_multiplier: int = 0
    lh_frac: float = 0.25

    def __post_init__(self) -> None:
        if self.t_suspect < 1:
            raise ValueError(f"t_suspect must be >= 1, got {self.t_suspect}")
        if self.lh_multiplier < 0:
            raise ValueError(
                f"lh_multiplier must be >= 0, got {self.lh_multiplier}")
        if not 0.0 < self.lh_frac < 1.0:
            raise ValueError(f"lh_frac must be in (0, 1), got {self.lh_frac}")

    def confirm_after(self, t_fail: int, degraded: bool = False) -> int:
        """Rounds of total silence before SUSPECT confirms to FAILED."""
        mult = 1 + (self.lh_multiplier if degraded else 0)
        return t_fail + self.t_suspect * mult

    def max_confirm_after(self, t_fail: int) -> int:
        """The worst-case confirmation age (full local-health stretch),
        which the age lane's saturation clamp must stay above."""
        return self.confirm_after(t_fail, degraded=True)

    def to_json(self) -> str:
        return json.dumps({
            "t_suspect": self.t_suspect,
            "lh_multiplier": self.lh_multiplier,
            "lh_frac": self.lh_frac,
        }, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "SuspicionParams":
        doc = json.loads(text)
        return cls(
            t_suspect=int(doc["t_suspect"]),
            lh_multiplier=int(doc.get("lh_multiplier", 0)),
            lh_frac=float(doc.get("lh_frac", 0.25)),
        )
