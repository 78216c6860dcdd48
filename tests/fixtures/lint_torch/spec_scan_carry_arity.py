"""Seeded drift for the port's scan-carry-arity rule: PackedDetector's
step unpacks eight values from the lean loop's core, which returns nine
(the Lifeguard SUSPECT-count slot dropped), so the carry, the metrics and
every slot after the dropped one bind to the wrong values.  Mounted over
gossipfs_tpu_torch/detector/sim.py by tests/test_torch_analysis.py only
-- never imported."""

from gossipfs_tpu_torch.core import rounds as R


class PackedDetector:
    def advance(self, rounds: int = 1) -> None:
        for _ in range(rounds):
            # DRIFT: no sus_counts slot between counts and the carry
            (self._hb, self._asl, self._alive, self._hb_base, self._round,
             self._counts, self._mcarry, per_round) = R.run_lean_packed(
                self._hb, self._asl, self._alive, self._hb_base,
                self._round, self.config, self._key, 1,
                mcarry0=self._mcarry, counts0=self._counts)
            self._last = per_round
