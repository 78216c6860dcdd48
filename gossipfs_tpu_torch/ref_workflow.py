"""The reference's real 10-VM README workflow on the process cluster.

Runs the exact scenario the reference's report measures (README.md:8-30,
main.go:14-35; report.pdf "Performance"): a 10-node cluster, ``put`` /
update / ``get`` of a 5 MB and a 10 MB file (the report's file5/file10
workload), ``ls``/``store`` listings, then a kill -9 of a replica holder
mid-workload and a byte-identity check on the post-repair ``get``.  Every
node is a real OS process with its own UDP gossip socket, RPC server,
store directory, and log (deploy/node.py) — the same topology the
reference ran across VMs, on localhost.

Prints one JSON line with insert/update/read wall-times per size plus
detection/repair seconds — the quantitative version of the report's
qualitative latency claims (insert ~ update, read slightly less, latency
grows with file size, flat in cluster size).

    python -m gossipfs_tpu_torch.ref_workflow            # full sizes
    python -m gossipfs_tpu_torch.ref_workflow --mb5 1 --mb10 2   # smoke

The port's copy of the JAX package's ``bench/ref_workflow.py`` (host code
only: the node processes import no torch).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

from gossipfs_tpu_torch.deploy.launcher import Cluster
from gossipfs_tpu_torch.sdfs.types import REPLICATION_FACTOR


def run(n: int = 10, mb5: int = 5, mb10: int = 10, period: float = 0.5,
        root: str | None = None, timeout: float = 120.0) -> dict:
    # period 0.5 s (vs the tests' 0.1-0.2): ten Python gossip processes
    # plus multi-MB transfers on a often-loaded 1-core host can starve a
    # node past the t_fail*period failure timeout, false-positive the
    # master, and elect mid-put (observed; the commit then lands on a
    # plan-less new master and is refused).  The reference's own period
    # is 1 s with a 5 s timeout — 0.5 s keeps detection honest at half
    # the reference's latency while tolerating scheduler jitter.
    f5 = os.urandom(mb5 * 1024 * 1024)
    f10 = os.urandom(mb10 * 1024 * 1024)
    c = Cluster(n, period=period, root=root, rpc_timeout=60.0)
    own_root = root is None  # Cluster made its (prefixed) tempdir: clean it
    out: dict = {"metric": "reference 10-node README workflow "
                           "(real processes, localhost)",
                 "n": n, "file5_mb": mb5, "file10_mb": mb10,
                 "period_s": period}
    try:
        t0 = time.monotonic()
        c.start(timeout=timeout)
        out["boot_s"] = round(time.monotonic() - t0, 2)

        def timed(fn):
            t = time.monotonic()
            r = fn()
            return r, round(time.monotonic() - t, 3)

        ok, out["insert5_s"] = timed(lambda: c.client(1).put("file5.txt", f5))
        assert ok
        ok, out["insert10_s"] = timed(
            lambda: c.client(2).put("file10.txt", f10))
        assert ok
        # update = re-put within the 60 s window: the writer pre-confirms
        # the overwrite (the reference's stdin prompt, server.go:155-177)
        f5b = os.urandom(len(f5))
        ok, out["update5_s"] = timed(
            lambda: c.client(3).put("file5.txt", f5b, confirm=True))
        assert ok
        got, out["read5_s"] = timed(lambda: c.client(4).get("file5.txt"))
        assert got == f5b
        got, out["read10_s"] = timed(lambda: c.client(5).get("file10.txt"))
        assert got == f10

        holders5 = c.client(1).ls("file5.txt")
        holders10 = c.client(1).ls("file10.txt")
        assert len(holders5) == REPLICATION_FACTOR
        assert len(holders10) == REPLICATION_FACTOR
        stored = c.client(holders5[0]).store(holders5[0])
        assert "file5.txt" in stored

        # kill -9 a non-master replica holder mid-workload and read
        # through the failure window (the reference's CTRL+C crash)
        victim = next(h for h in holders5 if h != 0)
        observer = next(i for i in range(n) if i not in (victim, 0))
        c.kill9(victim)
        got, out["read5_during_failure_s"] = timed(
            lambda: c.client(observer).get("file5.txt"))
        assert got == f5b  # quorum survives 1 of 4 holders dying
        out["detect_s"] = round(
            c.wait_detected(victim, observer, timeout=timeout), 2)
        out["repair_s"] = round(
            c.wait_repaired("file5.txt", observer, REPLICATION_FACTOR,
                            timeout=timeout), 2)
        healed = set(c.client(observer).ls("file5.txt"))
        assert victim not in healed and len(healed) == REPLICATION_FACTOR
        got, out["read5_post_repair_s"] = timed(
            lambda: c.client(observer).get("file5.txt"))
        assert got == f5b
        out["post_repair_byte_identical"] = True
        out["ok"] = True
    finally:
        c.stop()
        if own_root:
            # ~60-80 MB of random replica payloads per run otherwise
            # accumulate in anonymous tempdirs
            shutil.rmtree(c.root, ignore_errors=True)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=10)
    p.add_argument("--mb5", type=int, default=5)
    p.add_argument("--mb10", type=int, default=10)
    p.add_argument("--period", type=float, default=0.5)
    args = p.parse_args(argv)
    print(json.dumps(run(n=args.n, mb5=args.mb5, mb10=args.mb10,
                         period=args.period)))


if __name__ == "__main__":
    main()
