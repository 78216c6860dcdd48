"""ctypes bindings for the native (C++) gossip runtime.

The reference's runtime is Go: a blocking UDP receive goroutine plus a 1 s
heartbeat driver per process (reference: slave/slave.go:207-248, main.go:27-33).
The repo's native equivalent lives in ``native/``: an epoll-driven C++
engine running all N protocol nodes over real localhost UDP sockets, speaking
the reference wire format (``<#ENTRY#>``/``<#INFO#>``/``<CMD>`` framing,
slave.go:365-385).  This module wraps it in the same ``FailureDetector``
interface as the tensor sim and the Python asyncio parity path — three
interchangeable engines, one seam.

The port's copy of the JAX package's ``native.py``.  It compiles the same
sources in ``native/`` but never writes there: ``g++ -O2 -std=c++17 -fPIC
-shared -pthread`` straight into ``gossipfs_tpu_torch/_build/native/``
(gitignored), under a file lock, through a temporary file renamed into
place, so a process that has the library mapped never sees it rewritten.
The build is redone when any source (or this file, which holds the flags)
is at or newer than the library.  A failed build raises
``NativeBuildError``; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import shutil
import subprocess
import threading

from gossipfs_tpu_torch.detector.api import DetectionEvent

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build" / "native"
_LIB_PATH = _BUILD_DIR / "libgossipfs_native.so"
_CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared"]
_build_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    """The shared library could not be built (no toolchain, compile error)."""


def _build(src_dir: pathlib.Path = _NATIVE_DIR,
           out_path: pathlib.Path = _LIB_PATH) -> None:
    """Compile ``src_dir``'s engine into ``out_path``.  Only ``out_path``'s
    directory is written: the object goes to a temporary name there and is
    renamed over ``out_path`` once the compiler succeeds."""
    # g++ from PATH, never $CXX: a compiler that links libstdc++
    # statically (as one machine's $CXX does) puts a second libstdc++ in
    # a process that already maps torch's, and the engine's threads then
    # die of segmentation faults
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("native build needs g++ on PATH")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = out_path.with_name(f".{out_path.name}.{os.getpid()}.tmp")
    cmd = [cxx, *_CXXFLAGS, "-o", str(tmp),
           str(src_dir / "codec.cc"), str(src_dir / "engine.cc")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"native build failed ({' '.join(cmd)}):\n{proc.stdout}\n"
            f"{proc.stderr}")
    tmp.replace(out_path)


def _sources(src_dir: pathlib.Path = _NATIVE_DIR) -> list[pathlib.Path]:
    return [src_dir / "codec.cc", src_dir / "engine.cc",
            src_dir / "codec.h", src_dir / "tsa.h",
            pathlib.Path(__file__)]


def _stale() -> bool:
    """Whether the .so must be (re)built.  ``>=`` on purpose: a fresh
    checkout stamps sources and a stray .so with the SAME mtime, and a
    ``>`` compare would let a binary built from DIFFERENT sources run.
    An mtime tie costs one cheap rebuild."""
    if not _LIB_PATH.exists():
        return True
    lib_mtime = _LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime >= lib_mtime for s in _sources())


class _FileLock:
    """An exclusive ``flock`` on ``_build/native/.lock``: processes that
    build at the same time (test workers) take turns, and the second one
    finds the library fresh."""

    def __enter__(self):
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._f = open(_BUILD_DIR / ".lock", "w")
        fcntl.flock(self._f, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        fcntl.flock(self._f, fcntl.LOCK_UN)
        self._f.close()


def ensure_fresh() -> pathlib.Path:
    """Rebuild the .so if any source is at-or-newer than it; raise
    NativeBuildError on failure.

    Once the library is LOADED in this process a rebuild cannot take
    effect (the CDLL handle keeps serving the old mapping) — that
    situation raises instead of claiming freshness."""
    with _build_lock, _FileLock():
        if _stale():
            if _lib is not None:
                raise NativeBuildError(
                    "native sources changed AFTER the library was loaded "
                    "in this process; restart to pick up the rebuild"
                )
            _build()
    return _LIB_PATH


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native runtime, caching the handle."""
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        with _FileLock():
            if _stale():
                _build()
            lib = ctypes.CDLL(str(_LIB_PATH))
        lib.gfs_cluster_create.restype = ctypes.c_void_p
        lib.gfs_cluster_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.gfs_cluster_start.argtypes = [ctypes.c_void_p]
        lib.gfs_cluster_start.restype = ctypes.c_int
        lib.gfs_cluster_destroy.argtypes = [ctypes.c_void_p]
        for fn in (lib.gfs_crash, lib.gfs_leave, lib.gfs_join):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.gfs_advance.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.gfs_round.argtypes = [ctypes.c_void_p]
        lib.gfs_round.restype = ctypes.c_int
        for fn in (lib.gfs_membership, lib.gfs_suspects):
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ]
            fn.restype = ctypes.c_int
        lib.gfs_incarnation.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int
        ]
        lib.gfs_incarnation.restype = ctypes.c_longlong
        for fn in (lib.gfs_alive, lib.gfs_drain_events):
            fn.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int
            ]
            fn.restype = ctypes.c_int
        for fn in (lib.gfs_codec_encode, lib.gfs_codec_decode):
            fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
            fn.restype = ctypes.c_int
        # round-16 observability + campaign surface
        lib.gfs_configure.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.gfs_configure.restype = ctypes.c_int
        lib.gfs_obs_enable.argtypes = [ctypes.c_void_p]
        lib.gfs_obs_enable.restype = ctypes.c_int
        for fn in (lib.gfs_obs_drain, lib.gfs_vitals):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            fn.restype = ctypes.c_int
        lib.gfs_scenario_load.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
        ]
        lib.gfs_scenario_load.restype = ctypes.c_int
        lib.gfs_scenario_clear.argtypes = [ctypes.c_void_p]
        lib.gfs_stop.argtypes = [ctypes.c_void_p]
        lib.gfs_seed_full.argtypes = [ctypes.c_void_p]
        lib.gfs_warm.argtypes = [ctypes.c_void_p]
        lib.gfs_warm.restype = ctypes.c_int
        _lib = lib
        return _lib


# -- codec (parity-testable against detector/udp.py's Python codec) ---------

def _call_sized(fn, data: bytes, initial_cap: int) -> bytes:
    """Call a snprintf-style C function, growing the buffer on truncation
    (the function returns the full required length)."""
    cap = initial_cap
    while True:
        out = ctypes.create_string_buffer(cap)
        need = fn(data, out, cap)
        if need < cap:
            return out.raw[:need]
        cap = need + 1


def codec_encode(entries: list[tuple[str, int, float]]) -> str:
    """Members -> reference wire string, through the C++ codec."""
    lib = load_library()
    lines = "\n".join(f"{a} {hb} {ts}" for a, hb, ts in entries).encode()
    return _call_sized(lib.gfs_codec_encode, lines, 3 * len(lines) + 64).decode()


def codec_decode(wire: str) -> list[tuple[str, int, float]]:
    """Reference wire string -> members, through the C++ codec."""
    lib = load_library()
    raw = _call_sized(
        lib.gfs_codec_decode, wire.encode(), 2 * len(wire) + 64
    ).decode()
    entries = []
    for line in raw.splitlines():
        addr, hb, ts = line.split(" ")
        entries.append((addr, int(hb), float(ts)))
    return entries


# -- observability plane (obs/) ---------------------------------------------

# detail values the C++ engine emits as 0/1 ints but the schema carries
# as booleans (the json the other recorders write)
_BOOL_DETAIL = frozenset({"false_positive", "scheduled"})


def _parse_obs_lines(text: str):
    """``gfs_obs_drain`` text -> schema Events.

    Line form (one writer, ``Cluster::ObsEmit`` in native/engine.cc):
    ``kind round observer subject k=v k=v ...`` — kinds are
    ``obs/schema.py`` EVENT_KINDS members (the native-obs-kinds lint
    rule enforces it), so the rendered stream is a plain
    ``gossipfs-obs/v1`` stream and ``obs.recorder.load_stream`` stays
    the one reader.
    """
    from gossipfs_tpu_torch.obs.schema import Event

    events = []
    for line in text.splitlines():
        parts = line.split(" ")
        if len(parts) < 4:
            continue
        detail = {}
        for kv in parts[4:]:
            k, _, v = kv.partition("=")
            if k in _BOOL_DETAIL:
                detail[k] = v not in ("0", "")
            else:
                try:
                    detail[k] = int(v)
                except ValueError:
                    try:
                        detail[k] = float(v)
                    except ValueError:
                        detail[k] = v
        events.append(Event(round=int(parts[1]), observer=int(parts[2]),
                            subject=int(parts[3]), kind=parts[0],
                            detail=detail))
    return events


# log-spaced tick_ms histogram buckets (upper bounds, ms); the last
# bucket is open-ended
_HIST_EDGES_MS = (0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0, 300.0)


def latency_histogram(events) -> dict:
    """Per-round wall-clock latency histogram from a native stream's
    ``round_tick.tick_ms`` samples (the epoll tick pass's cost — the
    real-time engine's 'did we fall behind the period' evidence).

    Returns ``{"count", "p50_ms", "max_ms", "buckets": {"<=0.1": k, ...,
    ">300.0": k}}``; zero samples -> count 0 and no quantiles (absent,
    not 0 — the n/a rule).
    """
    import bisect
    import statistics

    samples = sorted(
        e.detail["tick_ms"] for e in events
        if e.kind == "round_tick" and "tick_ms" in e.detail)
    doc: dict = {"count": len(samples)}
    if not samples:
        return doc
    doc["p50_ms"] = round(statistics.median(samples), 3)
    doc["max_ms"] = round(samples[-1], 3)
    buckets: dict[str, int] = {}
    lo = 0
    for edge in _HIST_EDGES_MS:
        hi = bisect.bisect_right(samples, edge)
        buckets[f"<={edge}"] = hi - lo
        lo = hi
    buckets[f">{_HIST_EDGES_MS[-1]}"] = len(samples) - lo
    doc["buckets"] = buckets
    return doc


def compile_native_scenario(scenario) -> str:
    """``scenarios.FaultScenario`` -> the native engine's fault-gate
    table (the text ``gfs_scenario_load`` parses).

    Covers the gate primitives the committed campaign cases use —
    flapping duty-cycle blackout, correlated-outage rack darkness,
    timed partition, lagging senders — with ``ScenarioRuntime.drops``
    semantics applied at ``Node::Send``.  Bernoulli link loss is
    rejected (an RNG-stream parity question the gate table deliberately
    does not take on; run those cases on the udp engine).
    """
    if scenario.link_faults:
        raise ValueError(
            "Bernoulli link loss is not expressible on the native gate "
            "table — the drop draw would need an RNG-stream parity "
            "decision; drive loss cases through the udp engine")
    lines = [f"name {scenario.name.replace(' ', '_')}"]
    for f in scenario.flapping:
        ids = " ".join(str(i) for i in f.nodes)
        lines.append(f"flap {f.start} {f.end} {f.up} {f.down} {ids}")
    for o in scenario.outages:
        ids = " ".join(str(i) for i in o.nodes)
        lines.append(f"outage {o.start} {o.end} {ids}")
    for p in scenario.partitions:
        pid = " ".join(str(int(x)) for x in p.pid(scenario.n))
        lines.append(f"partition {p.start} {p.end} {pid}")
    for s in scenario.slow_nodes:
        ids = " ".join(str(i) for i in s.nodes)
        lines.append(f"slow {s.start} {s.end} {s.stride} {ids}")
    return "\n".join(lines) + "\n"


# -- the engine behind the FailureDetector seam -----------------------------

class NativeUdpDetector:
    """FailureDetector over the C++ epoll engine (real localhost datagrams).

    Same verbs and views as ``detector.sim.SimDetector`` and
    ``detector.udp.UdpDetector`` — the config-1 parity path at native speed.
    ``advance(r)`` blocks for r heartbeat periods of wall time (the native
    engine, like the reference, runs in real time).

    Round 16 — the obs-plane + campaign surface (mirroring UdpCluster's
    round-14 knobs): ``push="random"``/``fanout``/``remove_broadcast``
    select the campaign protocol profile, ``suspicion`` arms the SWIM
    lifecycle (+ Lifeguard local health) inside the engine, and
    ``attach_recorder`` turns on structured event buffering that
    ``pump_obs`` drains through the ONE schema (``obs/schema.py``) into
    the attached ``FlightRecorder`` — so a native trace is a plain
    ``gossipfs-obs/v1`` stream every existing reader ingests unchanged.

    Round 20: ``delta=True`` turns membership pushes into delta-piggyback
    frames (changed-first + round-robin tail, capped at ``delta_entries``,
    full anti-entropy push every ``anti_entropy_every`` rounds — must stay
    below ``t_fail``), and ``loops=k`` stripes the receive path across k
    epoll loops with node i owned by stripe ``i % k``.
    """

    def __init__(
        self,
        n: int,
        base_port: int = 19000,
        period: float = 0.05,
        t_fail: int = 5,
        t_cooldown: int = 5,
        min_group: int = 4,
        fresh_cooldown: bool = False,
        introducer: int = 0,
        push: str = "ring",
        fanout: int | None = None,
        remove_broadcast: bool = True,
        suspicion=None,
        delta: bool = False,
        delta_entries: int = 16,
        anti_entropy_every: int = 4,
        loops: int = 1,
    ):
        self._lib = load_library()
        self.n = n
        self.base_port = base_port
        self.period = period
        self.suspicion = suspicion
        self._recorder = None
        self._obs_round0 = 0
        self._h = self._lib.gfs_cluster_create(
            n, base_port, period, t_fail, t_cooldown, min_group,
            int(fresh_cooldown), introducer,
        )
        knobs = []
        if push != "ring":
            knobs.append(f"push={push}")
        if fanout is not None:
            knobs.append(f"fanout={fanout}")
        if not remove_broadcast:
            knobs.append("remove_broadcast=0")
        if suspicion is not None:
            knobs.append(f"t_suspect={suspicion.t_suspect}")
            knobs.append(f"lh_multiplier={suspicion.lh_multiplier}")
            knobs.append(f"lh_frac={suspicion.lh_frac!r}")
        if delta:
            # delta piggybacking (protocol_spec.DELTA_GOSSIP); the engine
            # rejects anti_entropy_every >= t_fail like UdpCluster does
            knobs.append("delta=1")
            knobs.append(f"delta_entries={delta_entries}")
            knobs.append(f"anti_entropy_every={anti_entropy_every}")
        if loops != 1:
            knobs.append(f"loops={loops}")
        if knobs and self._lib.gfs_configure(
                self._h, " ".join(knobs).encode()) != 0:
            self._lib.gfs_cluster_destroy(self._h)
            self._h = None
            raise ValueError(f"native engine rejected knobs: {knobs}")
        if self._lib.gfs_cluster_start(self._h) != 0:
            self._lib.gfs_cluster_destroy(self._h)
            self._h = None
            raise RuntimeError(
                f"native cluster failed to start (ports {base_port}..{base_port + n - 1} busy?)"
            )

    # -- FailureDetector protocol ------------------------------------------
    def join(self, node: int) -> None:
        self._lib.gfs_join(self._h, node)

    def leave(self, node: int) -> None:
        self._lib.gfs_leave(self._h, node)

    def crash(self, node: int) -> None:
        self._lib.gfs_crash(self._h, node)

    def advance(self, rounds: int = 1) -> None:
        self._lib.gfs_advance(self._h, rounds)

    @property
    def round(self) -> int:
        return self._lib.gfs_round(self._h)

    def membership(self, observer: int) -> list[int]:
        buf = (ctypes.c_int * self.n)()
        count = self._lib.gfs_membership(self._h, observer, buf, self.n)
        return list(buf[:count])

    def alive_nodes(self) -> list[int]:
        buf = (ctypes.c_int * self.n)()
        count = self._lib.gfs_alive(self._h, buf, self.n)
        return list(buf[:count])

    # -- conformance-harness read seams (round 19) -------------------------
    def suspects(self, observer: int) -> list[int]:
        """Node indices the observer currently holds under suspicion."""
        buf = (ctypes.c_int * self.n)()
        count = self._lib.gfs_suspects(self._h, observer, buf, self.n)
        return list(buf[:count])

    def incarnation(self, observer: int, subject: int) -> int:
        """The subject's heartbeat counter in the observer's view
        (the per-entry incarnation surface); -1 when absent."""
        return int(self._lib.gfs_incarnation(self._h, observer, subject))

    def wire_addr(self, node: int) -> str:
        """The wire address datagrams name this node by."""
        return f"127.0.0.1:{self.base_port + node}"

    # -- obs plane (round 16) ----------------------------------------------
    def attach_recorder(self, recorder) -> int:
        """Arm an ``obs.FlightRecorder`` (or MonitorRecorder) and enable
        event buffering in the engine.  Returns the ABSOLUTE engine
        round the recorded stream's round 0 maps to (the rebased,
        arming-relative frame the udp campaign streams use)."""
        self._recorder = recorder
        self._obs_round0 = self._lib.gfs_obs_enable(self._h)
        return self._obs_round0

    def pump_obs(self) -> int:
        """Drain buffered engine events into the attached recorder;
        returns the event count.  Call after (or periodically during)
        ``advance`` — the engine buffers until drained."""
        if self._recorder is None:
            return 0
        total = 0
        cap = 1 << 20
        while True:
            buf = ctypes.create_string_buffer(cap)
            got = self._lib.gfs_obs_drain(self._h, buf, cap)
            if got == -1:
                cap *= 2
                continue
            if got == 0:
                return total
            events = _parse_obs_lines(buf.raw[:got].decode())
            self._recorder.extend(events)
            total += len(events)

    def vitals(self) -> dict:
        """The uniform counter set (obs.schema.VITALS_FIELDS).  This
        engine knows ground-truth aliveness (in-process), so
        ``false_positives`` is live; suspicion counters appear only when
        the lifecycle is armed, and ``fp_suppressed`` stays absent — the
        per-refute ground truth only the sim has (rendered n/a)."""
        raw = _call_sized(self._lib.gfs_vitals, self._h, 512).decode()
        doc: dict = {"engine": "native"}
        for kv in raw.split():
            k, _, v = kv.partition("=")
            doc[k] = int(v)
        mon = getattr(self._recorder, "monitor", None)
        if mon is not None:
            doc["invariant_violations"] = len(mon.violations)
        return doc

    # -- campaign surface (round 16) ---------------------------------------
    def seed_full_membership(self) -> None:
        """Start from the fully-joined steady state (the udp engine's
        ``seed_full_membership``): every node lists everyone at hb 0
        with a fresh local stamp — inside the hb<=1 detection grace."""
        self._lib.gfs_seed_full(self._h)

    def warm(self) -> bool:
        """Whether every live view is full with every counter past the
        hb<=1 detection grace (the campaign runners' readiness gate)."""
        return bool(self._lib.gfs_warm(self._h))

    def load_scenario(self, scenario, round0: int | None = None) -> None:
        """Arm a ``scenarios.FaultScenario`` as the engine's send-gate
        table.  Windows are anchored at absolute engine round
        ``round0`` (default: the current round) — pass the round
        ``attach_recorder`` returned so the gate windows and the
        recorded stream share one relative clock."""
        if scenario.n != self.n:
            raise ValueError(
                f"scenario is for n={scenario.n}, cluster has n={self.n}")
        table = compile_native_scenario(scenario)
        if round0 is None:
            round0 = self.round
        if self._lib.gfs_scenario_load(
                self._h, table.encode(), int(round0)) != 0:
            raise ValueError(
                f"native engine rejected the gate table for {scenario.name}")

    def clear_scenario(self) -> None:
        self._lib.gfs_scenario_clear(self._h)

    def stop(self) -> None:
        """Halt the epoll loop + sockets, keeping state drainable: call
        before a big ``pump_obs`` — on a 1-core host a long drain parse
        starves a still-running loop (rounds lag, entries look stale)
        and manufactures an FP cascade in the stream's tail."""
        self._lib.gfs_stop(self._h)

    def drain_events(self) -> list[DetectionEvent]:
        cap = 4096 * 4
        buf = (ctypes.c_int * cap)()
        events = []
        while True:
            count = self._lib.gfs_drain_events(self._h, buf, cap)
            for i in range(count):
                events.append(
                    DetectionEvent(
                        round=buf[i * 4 + 0],
                        observer=buf[i * 4 + 1],
                        subject=buf[i * 4 + 2],
                        false_positive=bool(buf[i * 4 + 3]),
                    )
                )
            if count < cap // 4:
                return events

    def close(self) -> None:
        if self._h is not None:
            self._lib.gfs_cluster_destroy(self._h)
            self._h = None

    def __enter__(self) -> "NativeUdpDetector":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
