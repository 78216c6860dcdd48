"""Cluster launcher for the one-process-per-node deployment.

Spawns ``n`` ``gossipfs_tpu_torch.deploy.node`` OS processes (each with its own
UDP gossip endpoint, replica store, log file, and gRPC server — the
reference's per-machine topology, main.go:14-35), then exposes client
helpers and the kill -9 scenario the deployment exists to demonstrate:

    python -m gossipfs_tpu_torch.deploy.launcher --n 5

prints one JSON document with measured wall-clock times for failure
detection (the gossip way: the victim vanishes from a SURVIVOR's view),
re-replication (the replica set heals to full strength on live nodes),
byte-identical recovery of the file, and a master-kill election.

The port's copy of the JAX package's ``deploy/launcher.py``: the nodes it
spawns run ``gossipfs_tpu_torch.deploy.node``, which imports no torch.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from gossipfs_tpu_torch.shim import retry
from gossipfs_tpu_torch.shim.client import ShimClient

# the directory holding the package, so ``python -m`` finds it from any cwd
_PKG_ROOT = Path(__file__).resolve().parents[2]


def _free_port_base(span: int, *, tcp: bool = True, udp: bool = True) -> int:
    """A base port with ``span`` free ports above it.

    Probes EVERY port in the window — TCP and/or UDP per the flags; the
    deploy cluster needs both (gossip sockets on UDP, RPC servers on
    TCP), the in-process udp campaign runner (campaigns/engines.py)
    UDP only — by bind-and-hold before releasing the lot (round-5
    advisor: the old single-ephemeral probe let two concurrent clusters
    land overlapping windows and cross-talk; round 14 re-observed the
    same failure between a tier-1 udp smoke and a concurrent campaign
    run on a fixed base port).  A race remains between release and the
    cluster's own binds, but it is milliseconds wide instead of
    window-sized.
    """
    for _ in range(64):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1]
        s.close()
        if base + span >= 65000:
            continue
        held: list[socket.socket] = []
        try:
            for p in range(base, base + span):
                if tcp:
                    t = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                    t.bind(("127.0.0.1", p))
                    held.append(t)
                if udp:
                    u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                    u.bind(("127.0.0.1", p))
                    held.append(u)
        except OSError:
            continue
        finally:
            for h in held:
                h.close()
        return base
    raise RuntimeError("no free port window")


class Cluster:
    """n node processes + per-node ShimClients."""

    def __init__(self, n: int, period: float = 0.1, root: str | None = None,
                 rpc_timeout: float = 5.0, t_fail: int = 5,
                 ctrl_timeout: float = 2.0):
        self.n = n
        self.period = period
        self.t_fail = t_fail  # detection timeout in rounds (slave.go:24);
                              # partition scenarios on small rings raise it
                              # — mid-split freshness paths stretch across
                              # the dropped boundary, and the default 5 sits
                              # at the cascade threshold (BASELINE's ring-
                              # fragility finding, now reproducible on demand)
        self.root = root or tempfile.mkdtemp(prefix="gossipfs_deploy_")
        # multi-MB puts fan out 4 replica pushes through the writer's RPC:
        # on a loaded 1-core host the reference-size workload (5-10 MB,
        # bench/ref_workflow.py) needs deadlines past the 5 s default
        self.rpc_timeout = rpc_timeout
        # per-RPC deadline for the small idempotent CONTROL-PLANE verbs
        # (scenario/suspicion pushes, vitals, status): far shorter than
        # the data-plane timeout — a dead node should cost a campaign
        # runner ~2 s, not 5+ s per probe — with transient failures
        # retried under the shared bounded-backoff discipline
        # (shim/retry.py; round 14)
        self.ctrl_timeout = ctrl_timeout
        base = _free_port_base(2 * n + 16)
        self.udp_base = base
        self.rpc_base = base + n + 8
        self.procs: dict[int, subprocess.Popen] = {}
        self._clients: dict[int, ShimClient] = {}

    def client(self, idx: int) -> ShimClient:
        c = self._clients.get(idx)
        if c is None:
            c = self._clients[idx] = ShimClient(
                f"127.0.0.1:{self.rpc_base + idx}", timeout=self.rpc_timeout
            )
        return c

    def spawn(self, idx: int) -> None:
        env = dict(os.environ)
        # the node imports no torch; hide the card anyway so a transitive
        # import can never open a device context in N processes
        env["CUDA_VISIBLE_DEVICES"] = ""
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(_PKG_ROOT), env.get("PYTHONPATH")) if p)
        self.procs[idx] = subprocess.Popen(
            [sys.executable, "-m", "gossipfs_tpu_torch.deploy.node",
             "--idx", str(idx), "--n", str(self.n),
             "--udp-base", str(self.udp_base),
             "--rpc-base", str(self.rpc_base),
             "--dir", self.root, "--period", str(self.period),
             "--t-fail", str(self.t_fail)],
            env=env,
        )

    def _probe_lsm(self, idx: int) -> list[int] | None:
        """One liveness probe on a FRESH throwaway channel.

        Boot-time probing must NOT reuse the cached ``client(idx)``
        channel: a channel whose first connect hit the not-yet-bound
        port enters grpc's transient-failure backoff, and rapid retries
        on it never reconnect — observed on this host as a LIVE server
        staying "unavailable" for 40+ s (the whole deploy lane failed to
        boot).  A fresh channel connects the moment the server is up;
        the cached clients are only created after start() returns, when
        every server answers.
        """
        c = ShimClient(f"127.0.0.1:{self.rpc_base + idx}", timeout=2.0)
        try:
            return c.lsm(idx)
        except Exception:
            return None
        finally:
            c.close()

    def _probe_ready(self, idx: int) -> bool:
        """Full view AND every heartbeat counter past the detection grace.

        View convergence alone is NOT "the cluster is up": members whose
        counters still sit at hb <= 1 are inside the reference's
        detection grace (slave.go:468-469) — kill one then and NO
        survivor can ever declare it failed (its entry is frozen at
        hb=1, permanently grace-protected).  Scenarios that start with a
        kill therefore need counters > 1 everywhere, which also proves
        gossip (not just the introducer's JOIN push) actually flows.
        """
        c = ShimClient(f"127.0.0.1:{self.rpc_base + idx}", timeout=2.0)
        try:
            line = c.call("ScenarioStatus")["lines"][0]
            hb = line.get("hb") or {}
            if len(hb) != self.n:
                return False
            # below min_group (NodeDaemon's default 4) nodes stay in the
            # refresh-only branch and never bump — counters sit at 0
            # forever, AND detection is disabled anyway, so the grace
            # concern the hb check exists for cannot arise
            return self.n < 4 or min(hb.values()) > 1
        except Exception:
            return False
        finally:
            c.close()

    def start(self, timeout: float = 30.0) -> None:
        self.spawn(0)  # introducer first (reference SPOF, slave.go:22)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._probe_lsm(0) is not None:
                break
            time.sleep(0.25)
        else:
            raise RuntimeError("introducer did not come up")
        for i in range(1, self.n):
            self.spawn(i)
        # wait until every node's own view holds the full cohort with
        # every counter past the hb-grace (see _probe_ready)
        while time.monotonic() < deadline:
            if all(self._probe_ready(i) for i in range(self.n)):
                return
            time.sleep(0.25)
        raise RuntimeError("cluster did not converge")

    def kill9(self, idx: int) -> None:
        self.procs[idx].send_signal(signal.SIGKILL)
        self.procs[idx].wait()

    def _ctrl_call(self, idx: int, method: str, **request):
        """One idempotent control-plane RPC to node ``idx`` under the
        shared bounded-backoff discipline (shim/retry.py): a short
        per-RPC deadline (``ctrl_timeout``) so a dead node fails fast,
        transient codes (UNAVAILABLE mid-restart, DEADLINE_EXCEEDED on
        a starved host, backpressure) retried with exponential backoff,
        total retry time hard-bounded — replacing the round-7 one-shot
        try/except fan-outs that silently dropped a push whenever a
        node hiccuped for one scheduling quantum.  ``retries=False``
        disables the ShimClient's own backpressure loop: THIS is the
        one retry layer (nesting the two would multiply the bound —
        ~4 x the inner 10 s ceiling instead of the ~3 s promised here).
        """
        return retry.call_with_backoff(
            lambda: self.client(idx).call(
                method, timeout=self.ctrl_timeout, retries=False,
                **request),
            retryable=retry.grpc_transient,
            attempts=4, base_delay=0.1, max_delay=0.8,
            total_deadline=3.0,
        )

    def load_scenario(self, scenario) -> list[int]:
        """Push one scenarios.FaultScenario rule table to every live node
        (the deploy backend of the scenario engine).  Each node anchors
        the rule windows at its own receipt; the fan-out completes in
        milliseconds against multi-period windows.  Returns the node ids
        that acked."""
        payload = base64.b64encode(scenario.to_json().encode()).decode()
        acked = []
        for idx, proc in self.procs.items():
            if proc.poll() is not None:
                continue
            try:
                ok = self._ctrl_call(
                    idx, "ScenarioLoad", file=scenario.name,
                    data_b64=payload,
                ).get("ok")
            except Exception:
                ok = False
            if ok:
                acked.append(idx)
        return acked

    def load_suspicion(self, params) -> list[int]:
        """Push one suspicion.SuspicionParams to every live node (the
        deploy backend of the suspicion subsystem; None disarms).
        Returns the node ids that acked."""
        payload = ("" if params is None
                   else base64.b64encode(params.to_json().encode()).decode())
        acked = []
        for idx, proc in self.procs.items():
            if proc.poll() is not None:
                continue
            try:
                ok = self._ctrl_call(
                    idx, "SuspicionLoad", file="suspicion",
                    data_b64=payload,
                ).get("ok")
            except Exception:
                ok = False
            if ok:
                acked.append(idx)
        return acked

    def vitals(self) -> list[dict]:
        """Collect every live node's uniform vitals row (the `Vitals`
        RPC; obs.schema.VITALS_FIELDS).  Dead nodes are skipped — their
        absence, not a zeroed row, is the signal."""
        lines: list[dict] = []
        for idx, proc in self.procs.items():
            if proc.poll() is not None:
                continue
            try:
                lines += self._ctrl_call(idx, "Vitals").get("lines") or []
            except Exception:
                pass
        return lines

    def scenario_status(self) -> list[dict]:
        """Collect every node's ScenarioStatus line (skipping dead nodes)."""
        lines: list[dict] = []
        for idx, proc in self.procs.items():
            if proc.poll() is not None:
                continue
            try:
                lines += self._ctrl_call(idx, "ScenarioStatus").get(
                    "lines") or []
            except Exception:
                pass
        return lines

    def wait_detected(self, victim: int, observer: int,
                      timeout: float = 30.0) -> float:
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if victim not in self.client(observer).lsm(observer):
                return time.monotonic() - t0
            time.sleep(self.period / 4)
        raise TimeoutError(f"{observer} never dropped {victim}")

    def wait_repaired(self, file: str, via: int, expect: int,
                      timeout: float = 60.0) -> float:
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            live = set(self.client(via).lsm(via))
            reps = set(self.client(via).ls(file))
            if len(reps) >= expect and reps <= live:
                return time.monotonic() - t0
            time.sleep(self.period / 2)
        raise TimeoutError(f"{file} never healed")

    def wait_new_master(self, via: int, old: int, timeout: float = 60.0) -> float:
        """Wait until a put through ``via`` succeeds under a new master."""
        t0 = time.monotonic()
        probe = b"election-probe"
        while time.monotonic() - t0 < timeout:
            try:
                if self.client(via).put("___probe.txt", probe, confirm=True):
                    return time.monotonic() - t0
            except Exception:
                pass
            time.sleep(self.period)
        raise TimeoutError("no new master answered a put")

    def stop(self) -> None:
        for c in self._clients.values():
            c.close()
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()


def scenario(n: int = 5, period: float = 0.1) -> dict:
    """The deployment's reason to exist, measured end to end."""
    cluster = Cluster(n, period=period)
    out: dict = {"n": n, "period_s": period}
    try:
        t0 = time.monotonic()
        cluster.start()
        out["startup_convergence_s"] = round(time.monotonic() - t0, 3)

        data = os.urandom(256 * 1024)  # 256 KB payload
        assert cluster.client(1).put("wiki.txt", data)
        holders = cluster.client(1).ls("wiki.txt")
        out["put_replicas"] = holders

        # kill -9 a NON-master replica holder; watch from a survivor
        victim = next(h for h in holders if h != 0)
        observer = next(i for i in range(n) if i != victim and i != 0)
        cluster.kill9(victim)
        out["victim"] = victim
        out["detect_s"] = round(
            cluster.wait_detected(victim, observer), 3
        )
        out["repair_s"] = round(
            cluster.wait_repaired("wiki.txt", observer, min(4, n - 1)), 3
        )
        got = cluster.client(observer).get("wiki.txt")
        out["bytes_identical_after_repair"] = got == data

        # kill -9 the master; the lowest live node must take over
        cluster.kill9(0)
        out["election_s"] = round(cluster.wait_new_master(observer, 0), 3)
        # distributed grep: each node serves only its own log; fan out
        hits = []
        for i in range(n):
            if i in (0, victim):
                continue
            hits += cluster.client(i).call(
                "Grep", pattern="became master"
            ).get("lines") or []
        out["election_logged"] = bool(hits)
        return out
    finally:
        cluster.stop()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=5)
    p.add_argument("--period", type=float, default=0.1)
    args = p.parse_args(argv)
    print(json.dumps(scenario(args.n, args.period)))


if __name__ == "__main__":
    main()
