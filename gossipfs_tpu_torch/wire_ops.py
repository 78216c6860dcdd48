"""Multi-MB file payloads through the gRPC shim: put, overwrite, read, and
the crash -> detection -> re-replication repair, across a real wire.

The port of the JAX package's ``gossipfs_tpu/bench/wire_ops.py``.  BASELINE
config 1 names the reference's ``file1-10.txt`` payloads (multi-MB
Wikipedia dump shards; ``file5.txt`` 4.0 MB and ``file10.txt`` 3.2 MB) as
the put/get workload the report's latency charts were measured on.  This
runner pushes given files through the shim's Put/Get against a live
server on the port's ``CoSim`` (base64-framed protobuf over HTTP/2, the
64 MB message cap of ``shim/wire.py`` doing the work it exists for), then
crashes a replica of the first file, advances past detection and the
recovery delay, and checks that the replica set healed and the bytes
still read back identical over the wire.  The detector's rounds run on
the card unless ``--device cpu`` is given.

The reference's shards are not part of this repository, so the files
are the caller's (``--files``); ``chip_smoke.py`` writes two seeded
payloads of the shards' sizes.

    python -m gossipfs_tpu_torch.wire_ops --files a.bin b.bin [--device cpu]

Prints one JSON document.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import time

import torch


def _ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def run(files, n: int = 16, reps: int = 5, device="cuda") -> dict:
    """Each file ``reps`` times under a fresh name: insert, confirmed
    overwrite, read back (byte-identical); then the repair of the first
    file.  Returns ``{"nodes", "device", "rows", "repair"}``."""
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.cosim import CoSim
    from gossipfs_tpu_torch.shim.client import ShimClient
    from gossipfs_tpu_torch.shim.service import ShimServer, build_kernels

    cfg = SimConfig(n=n)
    build_kernels(cfg, device)
    sim = CoSim(cfg, device=device)
    server = ShimServer(sim).start()
    client = ShimClient(server.address, timeout=120.0)
    rows = []
    repair = None
    try:
        client.advance(2)
        for path in files:
            path = pathlib.Path(path)
            data = path.read_bytes()
            name = path.name
            inserts, updates, reads = [], [], []
            for r in range(reps):
                # each rep inserts a fresh name (first put = insert), then
                # updates it (confirmed overwrite), then reads it back
                rname = f"{r}_{name}"
                inserts.append(_ms(lambda: client.put(rname, data)))
                updates.append(_ms(lambda: client.put(rname, data,
                                                      confirm=True)))
                blob = None

                def read():
                    nonlocal blob
                    blob = client.get(rname)

                reads.append(_ms(read))
                if blob != data:
                    raise AssertionError(
                        f"{rname}: the wire round trip changed the bytes")
            rows.append({
                "file": name,
                "size_bytes": len(data),
                "insert_ms_min": round(min(inserts), 2),
                "insert_ms_median": round(statistics.median(inserts), 2),
                "update_ms_min": round(min(updates), 2),
                "update_ms_median": round(statistics.median(updates), 2),
                "read_ms_min": round(min(reads), 2),
                "read_ms_median": round(statistics.median(reads), 2),
            })

        # repair path: crash a replica of the first file, advance past
        # detection (t_fail=5) + recovery delay (8), confirm the replica
        # set healed and the bytes still read back identical over the wire
        path = pathlib.Path(files[0])
        data = path.read_bytes()
        name = f"repair_{path.name}"
        client.put(name, data)
        before = client.ls(name)
        victim = before[0]
        client.crash(victim)
        client.advance(16)
        after = client.ls(name)
        blob = client.get(name)
        repair = {
            "file": name,
            "size_bytes": len(data),
            "crashed_replica": victim,
            "replicas_before": before,
            "replicas_after": after,
            "healed": victim not in after and len(after) == len(before),
            "bytes_identical_after_repair": blob == data,
            "re_replications_logged": len(client.grep("Re-replicated")),
        }
    finally:
        client.close()
        server.stop()
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"nodes": n, "device": name, "rows": rows, "repair": repair}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--files", nargs="+", required=True)
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.wire_ops needs a CUDA device "
                         "(or --device cpu)")
    doc = json.dumps(run(args.files, n=args.n, reps=args.reps,
                         device=args.device), indent=2)
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")


if __name__ == "__main__":
    main()
