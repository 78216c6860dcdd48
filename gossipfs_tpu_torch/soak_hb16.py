"""Long-horizon soak: narrow heartbeat storage against exact int32.

The port of the JAX package's ``bench/soak_hb16.py``.  The narrow lanes
(int16 and int8 counters relative to a per-subject base, and the int8
gossip view) carry window invariants that unit tests reach only with
synthetic counter shifts.  This soak runs them end to end: by default
N = 4,096 on the K2 merge (``merge_kernel="pallas"``), 10 chunks of 5,000
rounds of continuous crash and rejoin churn, where half the cluster (the
introducer included) is immune to churn, so its counters cross the
storage rebase windows (the int16 window of 16,384 rounds ~3 times, the
int8 window of 126 rounds ~400 times) while the churned half keeps
exercising joins, detections and merges against the rebased columns.

PASS: the int16 and int8 runs each agree exactly with the int32 run on
status, age and alive, on every chunk's ``first_detect`` and
``converged``, on the detection counts, and on the true counters of every
live MEMBER entry.

    python -m gossipfs_tpu_torch.soak_hb16                     # the card
    python -m gossipfs_tpu_torch.soak_hb16 --dtypes int8
    python -m gossipfs_tpu_torch.soak_hb16 --n 64 --chunks 2 \\
        --chunk-rounds 150 --device cpu

A cut run (fewer than 16,384 rounds in all) does not cross the int16
window; the line for each dtype prints how many of its storage windows
the largest live counter spans.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import (
    INT8_REBASE_WINDOW, REBASE_WINDOW, SimConfig)
from gossipfs_tpu_torch.core.rounds import run_rounds
from gossipfs_tpu_torch.core.state import MEMBER, SimState, init_state

N = 4096
CHUNKS = 10
CHUNK_ROUNDS = 5000
CRASH_RATE = 0.004
REJOIN_RATE = 0.004
WINDOWS = {"int16": REBASE_WINDOW, "int8": INT8_REBASE_WINDOW}


def base_config(n: int = N) -> SimConfig:
    return SimConfig(n=n, topology="random", fanout=SimConfig.log_fanout(n),
                     merge_kernel="pallas", view_dtype="int8",
                     merge_block_c=16_384)


def churn_ok(n: int, device) -> torch.Tensor:
    """Half the cluster (the introducer included) is immune to churn."""
    return torch.arange(n, device=device) >= n // 2


def run_mode(hb_dtype: str, n: int = N, chunks: int = CHUNKS,
             chunk_rounds: int = CHUNK_ROUNDS, device="cuda"):
    """One storage mode's soak: (final state, per-chunk outputs
    ``(first_detect, converged, true detections, false positives)``),
    the arrays on the host."""
    cfg = dataclasses.replace(base_config(n), hb_dtype=hb_dtype)
    state = init_state(cfg, device=device)
    key = trandom.PRNGKey(0, device=device)
    mask = churn_ok(n, device)
    outs = []
    for _ in range(chunks):
        state, mc, pr = run_rounds(state, cfg, chunk_rounds, key,
                                   crash_rate=CRASH_RATE,
                                   rejoin_rate=REJOIN_RATE, churn_ok=mask)
        outs.append((mc.first_detect.cpu().numpy(),
                     mc.converged.cpu().numpy(),
                     int(pr.true_detections.sum()),
                     int(pr.false_positives.sum())))
    return state, outs


def host_lanes(state: SimState) -> dict:
    """status, age, alive and the true counters (``hb + hb_base``) on the
    host."""
    return {"status": (state.asl & 3).cpu().numpy(),
            "age": state.age.cpu().numpy(),
            "alive": state.alive.cpu().numpy(),
            "hb_true": (state.hb.to(torch.int32)
                        + state.hb_base[None, :]).cpu().numpy(),
            "hb_base": state.hb_base.cpu().numpy()}


def compare(tag: str, st32: SimState, o32, st: SimState, o) -> bool:
    """Whether a narrow run agrees with the int32 run (module docstring);
    prints each divergence and a summary line."""
    ok = True
    for c, (a, b) in enumerate(zip(o32, o)):
        for name, x, y in (("first_detect", a[0], b[0]),
                           ("converged", a[1], b[1])):
            if not np.array_equal(x, y):
                ok = False
                print(f"[{tag}] chunk {c}: {name} DIVERGED "
                      f"({np.sum(x != y)} entries)")
        if a[2:] != b[2:]:
            ok = False
            print(f"[{tag}] chunk {c}: detection counts diverged {a[2:]} "
                  f"vs {b[2:]}")
    w, n = host_lanes(st32), host_lanes(st)
    same = {k: np.array_equal(w[k], n[k]) for k in ("status", "age",
                                                    "alive")}
    live = w["alive"][:, None] & (w["status"] == MEMBER)
    h32 = np.where(live, w["hb_true"], -1)
    same["hb_true"] = np.array_equal(h32, np.where(live, n["hb_true"], -1))
    top, window = int(h32.max()), WINDOWS[tag]
    print(f"[{tag}] status equal: {same['status']} | age equal: "
          f"{same['age']} | alive equal: {same['alive']} | live MEMBER "
          f"hb_true equal: {same['hb_true']} | max true hb: {top} "
          f"({top / window:.1f} storage windows of {window}) | store_base "
          f"active: {int(n['hb_base'].max())}")
    return ok and all(same.values())


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtypes", nargs="*", default=["int16", "int8"],
                   choices=["int16", "int8"])
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--chunks", type=int, default=CHUNKS)
    p.add_argument("--chunk-rounds", type=int, default=CHUNK_ROUNDS)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit("gossipfs_tpu_torch.soak_hb16 needs a CUDA device "
                         "(or --device cpu)")
    kw = dict(n=args.n, chunks=args.chunks, chunk_rounds=args.chunk_rounds,
              device=args.device)
    t0 = time.perf_counter()
    st32, o32 = run_mode("int32", **kw)
    seconds = {"int32": time.perf_counter() - t0}
    print(f"int32 reference done in {seconds['int32']:.1f}s, "
          f"round={st32.round}")
    doc = {"n": args.n, "chunks": args.chunks,
           "chunk_rounds": args.chunk_rounds, "rounds": st32.round,
           "max_true_hb": int(host_lanes(st32)["hb_true"].max()),
           "seconds": seconds, "store_base": {}, "pass": {}}
    for dtype in args.dtypes:
        t1 = time.perf_counter()
        st, o = run_mode(dtype, **kw)
        seconds[dtype] = time.perf_counter() - t1
        print(f"{dtype} done in {seconds[dtype]:.1f}s")
        doc["pass"][dtype] = compare(dtype, st32, o32, st, o)
        doc["store_base"][dtype] = int(st.hb_base.max())
    ok = all(doc["pass"].values())
    doc["ok"] = ok
    print("SOAK", "PASS" if ok else "FAIL")
    if not ok:
        raise SystemExit(1)
    return doc


if __name__ == "__main__":
    main()
