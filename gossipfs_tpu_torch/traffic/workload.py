"""Open-loop SDFS load generation: deterministic arrivals, skewed keys.

The port of the JAX package's ``gossipfs_tpu/traffic/workload.py`` (pure
Python; the co-sim driver runs over the port's ``CoSim``).

OPEN-LOOP means arrivals are a function of TIME, not of completions: the
generator emits ``rate`` operations every round regardless of how the
previous round's ops fared, so a saturated or partitioned system shows up
as rejected/failed ops and growing repair backlog instead of silently
slowing the generator down (the classic closed-loop coordination bug in
load testing).  Determinism is per-(seed, round): the op list for round r
never depends on how many times or in what order rounds were generated.

Workload shape mirrors the reference's benchmark workload: the repo's
checked-in Wikipedia-dump shards are ~3-4 MB (file1..10.txt; BASELINE.md
"Published claims"), so the default size distribution spans 64 KB to
4 MB with most mass at the shard magnitudes.  Key popularity is Zipf by
default (a few hot files take most writes — what makes the 60-round
write-write conflict window actually bind) or uniform.

Two drivers ship here: ``drive_cosim`` (the interactive CoSim — in-process
byte movement, flight-recordable) and ``drive_shim`` (the gRPC shim —
base64-framed protobuf over a real HTTP/2 socket, the process-boundary
path), which raises until the shim is ported (ROADMAP Queue 1 item 7).
Both consume the same op stream, so their throughput rows are
comparable.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
import time

from gossipfs_tpu_torch.sdfs.types import STRIPE_K, STRIPE_M

# the reference shards' magnitudes: 64 KB / 1 MB / 3.2 MB / 4 MB
# (file10.txt is 3.2 MB, file5.txt 4.0 MB — BASELINE.md "wire_ops")
REFERENCE_SIZES = (65_536, 1_048_576, 3_276_800, 4_194_304)
REFERENCE_SIZE_WEIGHTS = (1.0, 2.0, 3.0, 3.0)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """The declarative workload knob set (JSON-friendly field types).

    ``rate`` — mean operations per round (open-loop; fractional rates
    accumulate, e.g. 0.5 issues one op every other round).
    ``put_frac``/``delete_frac`` — operation mix; the remainder is gets.
    ``n_keys`` — keyspace size (names ``f<k>.txt``).
    ``popularity`` — "zipf" (exponent ``zipf_s``) or "uniform".
    ``sizes``/``size_weights`` — logical file-size distribution.
    ``payload_cap`` — cap on bytes ACTUALLY materialized per op: big runs
    keep the logical size for the record while moving capped payloads
    (the honest CPU-pinned boundary is documented in BASELINE.md; 0/None
    = move the full logical size).
    ``redundancy`` — "replica" (4 full copies) or "stripe" (the erasure
    plane: ``stripe_k`` data + ``stripe_m`` parity Reed-Solomon
    fragments per file — gossipfs_tpu_torch/erasure/).
    """

    rate: float = 16.0
    put_frac: float = 0.3
    delete_frac: float = 0.02
    n_keys: int = 128
    popularity: str = "zipf"
    zipf_s: float = 1.1
    sizes: tuple[int, ...] = REFERENCE_SIZES
    size_weights: tuple[float, ...] = REFERENCE_SIZE_WEIGHTS
    payload_cap: int | None = 65_536
    seed: int = 0
    redundancy: str = "replica"
    stripe_k: int = STRIPE_K
    stripe_m: int = STRIPE_M

    def __post_init__(self):
        if not 0 <= self.put_frac + self.delete_frac <= 1:
            raise ValueError("put_frac + delete_frac must be within [0, 1]")
        if self.popularity not in ("zipf", "uniform"):
            raise ValueError(f"unknown popularity: {self.popularity!r}")
        if len(self.sizes) != len(self.size_weights):
            raise ValueError("sizes and size_weights lengths differ")
        if self.rate <= 0 or self.n_keys <= 0:
            raise ValueError("rate and n_keys must be positive")
        if self.redundancy not in ("replica", "stripe"):
            raise ValueError(f"unknown redundancy: {self.redundancy!r}")
        if self.stripe_k < 1 or self.stripe_m < 1:
            raise ValueError("stripe_k and stripe_m must be >= 1")


@dataclasses.dataclass(frozen=True)
class Op:
    """One arrival: ``kind`` in {"put", "get", "delete"}; ``size`` is the
    LOGICAL byte size (puts only; ``payload`` may cap materialized bytes)."""

    kind: str
    key: str
    size: int = 0


class Workload:
    """Deterministic open-loop op stream over a :class:`WorkloadSpec`."""

    def __init__(self, spec: WorkloadSpec):
        self.spec = spec
        # Zipf CDF over key RANKS; a seed-keyed permutation maps rank ->
        # key id so "which keys are hot" varies with the seed, not just
        # how hot hotness is
        weights = (
            [1.0 / (r + 1) ** spec.zipf_s for r in range(spec.n_keys)]
            if spec.popularity == "zipf"
            else [1.0] * spec.n_keys
        )
        total = sum(weights)
        acc, cdf = 0.0, []
        for w in weights:
            acc += w
            cdf.append(acc / total)
        self._cdf = cdf
        perm = list(range(spec.n_keys))
        random.Random(f"wl-perm:{spec.seed}").shuffle(perm)
        self._rank_to_key = perm
        sacc, scdf = 0.0, []
        stot = sum(spec.size_weights)
        for w in spec.size_weights:
            sacc += w
            scdf.append(sacc / stot)
        self._size_cdf = scdf

    def _pick(self, cdf: list[float], u: float) -> int:
        lo, hi = 0, len(cdf) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if u <= cdf[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def arrivals(self, rnd: int) -> int:
        """Open-loop arrival count for round ``rnd``: the deterministic
        rate accumulator floor(rate*(r+1)) - floor(rate*r) — constant
        long-run rate, no completion feedback."""
        rate = self.spec.rate
        return int(rate * (rnd + 1)) - int(rate * rnd)

    def ops(self, rnd: int) -> list[Op]:
        """The round's op list — a pure function of (spec.seed, rnd)."""
        rng = random.Random(f"wl:{self.spec.seed}:{rnd}")
        out: list[Op] = []
        for _ in range(self.arrivals(rnd)):
            key = f"f{self._rank_to_key[self._pick(self._cdf, rng.random())]}.txt"
            u = rng.random()
            if u < self.spec.put_frac:
                size = self.spec.sizes[self._pick(self._size_cdf, rng.random())]
                out.append(Op("put", key, size))
            elif u < self.spec.put_frac + self.spec.delete_frac:
                out.append(Op("delete", key))
            else:
                out.append(Op("get", key))
        return out

    def payload(self, key: str, rnd: int, size: int) -> bytes:
        """Deterministic content for (key, round): verifiable after the
        fact (``payload_digest``) and capped at ``payload_cap`` actually
        materialized bytes — the logical ``size`` rides the op record."""
        cap = self.spec.payload_cap
        n = size if not cap else min(size, cap)
        token = f"{self.spec.seed}:{key}:{rnd}:{size}|".encode()
        return (token * (n // len(token) + 1))[:n]


def payload_digest(data: bytes) -> str:
    """Short content digest for durability bookkeeping (not security)."""
    return hashlib.sha256(data).hexdigest()[:16]


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def drive_cosim(sim, wl: Workload, rounds: int, *, recorder=None,
                on_ack=None, on_delete=None) -> dict:
    """Issue each round's arrivals against a CoSim, then tick one round.

    Write-write conflicts are auto-confirmed (the programmatic-client
    convention every bench uses; rejected-anyway puts count as issued,
    not acked).  ``on_ack(key, version, digest)`` / ``on_delete(key)``
    feed the harness's durability ledger; ``recorder`` (a FlightRecorder)
    gets one ``client_op`` latency row per op.  Returns the counter/latency
    summary for the window.
    """
    from gossipfs_tpu_torch.obs.schema import Event

    lat = {"put": [], "get": [], "delete": []}
    counts = {"put": [0, 0], "get": [0, 0], "delete": [0, 0]}  # issued, acked
    confirm = lambda: True  # noqa: E731
    for _ in range(rounds):
        rnd = sim.round
        for op in wl.ops(rnd):
            t0 = time.perf_counter()
            if op.kind == "put":
                data = wl.payload(op.key, rnd, op.size)
                ok = sim.put(op.key, data, confirm=confirm)
                if ok and on_ack is not None:
                    meta = (sim.cluster.master.stripes
                            if sim.cluster.redundancy == "stripe"
                            else sim.cluster.master.files)
                    version = meta[op.key].version
                    on_ack(op.key, version, payload_digest(data))
            elif op.kind == "get":
                ok = sim.get(op.key) is not None
            else:
                ok = sim.delete(op.key)
                if ok and on_delete is not None:
                    on_delete(op.key)
            ms = (time.perf_counter() - t0) * 1e3
            counts[op.kind][0] += 1
            counts[op.kind][1] += bool(ok)
            lat[op.kind].append(ms)
            if recorder is not None:
                recorder.emit(Event(
                    round=rnd, observer=-1, subject=-1, kind="client_op",
                    detail={"op": op.kind, "file": op.key, "bytes": op.size,
                            "ms": round(ms, 4), "ok": bool(ok)},
                ))
        sim.tick(1)
    return summarize_window(counts, lat, rounds)


def drive_shim(client, wl: Workload, rounds: int, *, start_round: int = 0,
               recorder=None) -> dict:
    """The same op stream through the gRPC shim (process boundary).  The
    shim is not ported yet: this raises (ROADMAP Queue 1 item 7)."""
    raise NotImplementedError(
        "drive_shim needs the port's gRPC shim, not ported yet (ROADMAP "
        "Queue 1 item 7)")


def quantiles(vals: list[float]) -> dict:
    """Nearest-rank p50/p95/max rollup for latency lists — the ONE
    convention every client_op consumer uses (the drivers' window
    summaries here, obs/timeline.py's stream rollup)."""
    if not vals:
        return {"p50_ms": None, "p95_ms": None, "max_ms": None}
    s = sorted(vals)
    return {
        "p50_ms": round(s[len(s) // 2], 4),
        "p95_ms": round(s[min(len(s) - 1, int(len(s) * 0.95))], 4),
        "max_ms": round(s[-1], 4),
    }


def summarize_window(counts: dict, lat: dict, rounds: int) -> dict:
    """One driver window's throughput/latency row set."""
    issued = sum(c[0] for c in counts.values())
    acked = sum(c[1] for c in counts.values())
    return {
        "rounds": rounds,
        "ops_issued": issued,
        "ops_acked": acked,
        "ops_per_round": round(issued / rounds, 3) if rounds else 0.0,
        "by_op": {
            kind: {"issued": counts[kind][0], "acked": counts[kind][1],
                   **quantiles(lat[kind])}
            for kind in counts
        },
    }
