"""Measure one card's share of the sharded resident round, and the ladder.

The port of the JAX package's ``tools/shard_anchor.py``.  The sharded
round (``parallel/mesh.py``) runs on each rank the same K3 over all N
receiver rows and its shard's N / shards subject columns, from the
shard's global column offset; the only traffic between ranks is an
``[N]``-vector all-reduce a round.  This tool runs that one shard's
program on one card: K3's column-shard form in the form the sharded
round's route takes (``core/rounds.route`` under ``rr_resident="auto"``:
the one-pass form (f) where ``ops/merge.onepass_fits`` holds ``[N, N /
shards]``, so at (65,536, 8) and (98,304, 8), else the two-launch form;
``ops/merge.resident_round(..., col_offset=shard * N / shards)``, the
``aligned_group`` form at the defaults: ``arc_align`` 8, fanout 24) over
``[N, N / shards]`` int8 lanes carried across ``--rounds`` rounds, best of
``--reps`` runs (CUDA events around the rounds), and prints one JSON row.

``--ladder`` runs the JAX tool's capacity ladder (:data:`LADDER`) in one
invocation and prints one JSON object.  Its admission is the port's own:
a shard needs :func:`shard_bytes` of device memory (both lanes, the view
the two-launch form writes between its launches where the shard runs
that form, the per-subject and per-receiver counts, the inputs),
admitted where that is at most
:data:`BUDGET_BYTES`, the H100's stated 80 GB, and on the card at most
the free bytes ``torch.cuda.mem_get_info`` reports.  Each admitted row is
measured on the card (the growth of ``torch.cuda.max_memory_allocated``
beside its formula bytes); ``--budget-only``, or ``--device cpu``, gives
the admission alone.  The JAX tool's ``rr_shard_admissible`` (a TPU VMEM
row budget) is not ported; its ``block_c`` and ``block_r`` (``--block-c``,
``--block-r``, the ladder's Pallas tiles) are recorded in each row and
ignored, the port's K3 sizing its own grid.

    python -m gossipfs_tpu_torch.shard_anchor --n 131072 --shards 8
    python -m gossipfs_tpu_torch.shard_anchor --ladder
    python -m gossipfs_tpu_torch.shard_anchor --ladder --budget-only
    python -m gossipfs_tpu_torch.shard_anchor --device cpu --n 512 \\
        --shards 4 --rounds 2 --reps 1

The inputs are built in row chunks of at most :data:`CHUNK_ENTRIES`
entries from a ``torch.Generator`` on the device, in int8 and int16: a
temporary of a whole shard in int32 or int64 would be 4-8x the lane size.
``implied_rounds_per_sec`` is 1,000 over one card's ms a round: the
cross-card all-reduce is not in it.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from gossipfs_tpu_torch.config import AGE_CLAMP
from gossipfs_tpu_torch.ops import merge

# The capacity ladder --ladder sweeps in one invocation: (n, shards,
# block_c, block_r, fanout), the JAX tool's rows (block_c and block_r its
# TPU tiles, recorded only).
LADDER = [
    (65_536, 8, 1024, 512, 16),
    (98_304, 8, 2048, 512, 24),
    (131_072, 8, 1024, 512, 24),
    (196_608, 16, 1024, 512, 24),
    (262_144, 16, 2048, 512, 24),
    (327_680, 16, 1024, 512, 24),
    (393_216, 16, 512, 512, 24),
    (524_288, 16, 512, 512, 24),
    (786_432, 16, 512, 512, 24),
]
# the H100 SXM's device memory as its data sheet states it (decimal)
BUDGET_BYTES = 80 * 10**9
# entries a chunk of the input build: its int16 temporaries stay a few MB
CHUNK_ENTRIES = 1 << 20
# the caching allocator's rounding a tensor: a block rounded up to 512 B,
# cut from segments of 2 MB multiples
ALLOC_SLACK = 2 << 20
T_FAIL, T_COOLDOWN, WINDOW = 5, 12, 126
NOTE = ("one card's share of the sharded resident round, measured on one "
        "card; the sharded program's only traffic between cards is an "
        "[N]-vector all-reduce a round, which implied_rounds_per_sec does "
        "not include")


def shard_onepass(n: int, shards: int, arc_align: int = 8) -> bool:
    """Whether the shard's round runs K3's one-pass form (f): where it
    holds the ``[N, N / shards]`` block, as the route takes it."""
    return merge.onepass_fits(n, n // shards,
                              merge.kernel_form(1, arc_align))


def shard_tensors(n: int, shards: int, arc_align: int = 8) -> dict:
    """The tensors one shard's round holds at its peak, by name: (shape,
    dtype).  The two-launch form adds its view between its launches
    (ops/merge.two_launch_view_rows: N / 8 rows in the aligned forms);
    the one-pass form keeps its view in shared memory."""
    nloc = n // shards
    view = {} if shard_onepass(n, shards, arc_align) else {
        "view": ((merge.two_launch_view_rows(
            n, merge.kernel_form(1, arc_align)), nloc), torch.int8)}
    return {
        "hb": ((n, nloc), torch.int8),
        "asl": ((n, nloc), torch.int8),
        **view,
        "subj": ((3, nloc), torch.int32),       # member_cnt, n_det, first_obs
        "recv": ((1, n), torch.int32),          # recv_cnt
        "flags": ((n,), torch.int8),
        "vecs": ((merge.N_VEC, nloc), torch.int8),
        "bases": ((n,), torch.int32),
    }


def shard_bytes(n: int, shards: int, arc_align: int = 8) -> int:
    """Device bytes one shard's round needs: every tensor of
    :func:`shard_tensors`."""
    return sum(math.prod(shape) * torch.empty((), dtype=dtype).element_size()
               for shape, dtype in shard_tensors(n, shards, arc_align).values())


def budget_limit(device, budget_only: bool) -> int:
    """The bytes a shard may take: the stated :data:`BUDGET_BYTES`, and on
    the card no more than its free memory."""
    dev = torch.device(device)
    if budget_only or dev.type != "cuda":
        return BUDGET_BYTES
    torch.cuda.empty_cache()
    return min(BUDGET_BYTES, torch.cuda.mem_get_info(dev)[0])


def admission(n: int, shards: int, block_c: int, block_r: int, fanout: int,
              arc_align: int, limit: int) -> dict:
    """A ladder row's admission: the shape the kernel takes (N a multiple
    of the shards and of ``arc_align``, 4-byte column words) and its
    :func:`shard_bytes` within ``limit``."""
    nloc = n // shards
    why = None
    if n % shards or nloc % merge.KERNEL_VEC or n % arc_align \
            or fanout % arc_align:
        why = (f"shape: n % shards, n % arc_align and fanout % arc_align "
               f"must be 0 and N / shards a multiple of {merge.KERNEL_VEC}")
    need = shard_bytes(n, shards, arc_align)
    if why is None and need > limit:
        why = f"needs {need} B of device memory, over the {limit} B limit"
    return {"n_global": n, "shards": shards, "local_cols": nloc,
            "merge_block_c": block_c, "merge_block_r": block_r,
            "fanout": fanout, "arc_align": arc_align, "shard_bytes": need,
            "budget_limit_bytes": limit, "admissible": why is None,
            **({"refused": why} if why else {})}


def shard_inputs(n: int, shards: int, arc_align: int = 8, seed: int = 0,
                 device="cuda") -> dict:
    """One shard's pre-tick inputs, built in row chunks from a seeded
    generator on ``device``: random int8 hb, ages 1..39 and statuses
    MEMBER / FAILED / UNKNOWN packed, every row active and alive, zero
    view and store shifts with a grace threshold of -120, arc bases that
    are multiples of ``arc_align``."""
    dev = torch.device(device)
    nloc = n // shards
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    hb = torch.empty((n, nloc), dtype=torch.int8, device=dev)
    asl = torch.empty((n, nloc), dtype=torch.int8, device=dev)
    step = max(1, CHUNK_ENTRIES // nloc)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        hb[r0:r1] = torch.randint(-128, 127, (r1 - r0, nloc), generator=gen,
                                  dtype=torch.int8, device=dev)
        v = torch.randint(0, 39 * 3, (r1 - r0, nloc), generator=gen,
                          dtype=torch.int16, device=dev)
        # age 1 + v // 3 in the high six bits, status v % 3 in the low two
        asl[r0:r1] = ((((v // 3) + 1) << 2 | (v % 3)) - 128).to(torch.int8)
    flags = torch.full((n,), 1 + 4, dtype=torch.int8, device=dev)
    zero = torch.zeros(nloc, dtype=torch.int32, device=dev)
    vecs = merge.threshold_stack(zero, zero, torch.full_like(zero, -120),
                                 WINDOW)
    bases = (torch.randint(0, n // arc_align, (n,), generator=gen,
                           dtype=torch.int32, device=dev) * arc_align)
    return {"hb": hb, "asl": asl, "flags": flags, "vecs": vecs,
            "bases": bases}


def shard_round(x: dict, fanout: int, arc_align: int, col_offset: int):
    """One round of the shard, in place on ``x``'s lanes: K3 in the form
    the route takes (:func:`shard_onepass`) on the card, its plain version
    on the CPU."""
    n, nloc = x["hb"].shape
    return merge.resident_round(
        x["hb"], x["asl"], x["flags"], x["vecs"], x["bases"], fanout=fanout,
        arc_align=arc_align, t_fail=T_FAIL, t_cooldown=T_COOLDOWN,
        age_clamp=AGE_CLAMP, col_offset=col_offset,
        onepass=shard_onepass(n, n // nloc, arc_align))


def _run(x: dict, rounds: int, fanout: int, arc_align: int,
         col_offset: int, cuda: bool) -> float:
    """``rounds`` rounds carried on ``x``'s lanes: their seconds (CUDA
    events on the card)."""
    import time

    if not cuda:
        t0 = time.perf_counter()
        for _ in range(rounds):
            shard_round(x, fanout, arc_align, col_offset)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        shard_round(x, fanout, arc_align, col_offset)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def measure(n: int, shards: int, block_c: int, block_r: int, fanout: int,
            arc_align: int, rounds: int, reps: int, shard: int = 0,
            device="cuda", seed: int = 0) -> dict:
    """Time one shard's round on ``device`` (one warm-up round, then the
    best of ``reps`` runs of ``rounds`` rounds carried on the lanes);
    returns the row.  ``alloc_bytes`` is the growth of the card's peak
    allocated memory over the rounds, the inputs included (the CPU: the
    bytes of the tensors held, the plain version's view by its shape)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    nloc = n // shards
    row = admission(n, shards, block_c, block_r, fanout, arc_align,
                    budget_limit(dev, False))
    if not row["admissible"]:
        raise SystemExit(f"shape not admitted: n={n}, shards={shards}: "
                         f"{row['refused']}")
    if cuda:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
    x = shard_inputs(n, shards, arc_align, seed, dev)
    if cuda:
        # the rounds' peak over the inputs they hold (the input build's
        # chunk temporaries are not the round's)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    col_offset = shard * nloc
    merge.reset_launch_counts()
    _run(x, 1, fanout, arc_align, col_offset, cuda)
    best = min(_run(x, rounds, fanout, arc_align, col_offset, cuda)
               for _ in range(reps))
    launches = {k: v for k, v in merge.FORM_LAUNCHES.items() if v}
    if cuda:
        alloc = torch.cuda.max_memory_allocated(dev) - base
    else:
        held = [*x.values(), *shard_round(x, fanout, arc_align,
                                          col_offset)[2:]]
        shape, _ = shard_tensors(n, shards, arc_align).get("view",
                                                           ((0, 0), None))
        alloc = (sum(t.nbytes for t in {id(t): t for t in held}.values())
                 + shape[0] * shape[1])
    del x
    if cuda:
        torch.cuda.empty_cache()
    ms = best / rounds * 1e3
    return {
        **row, "entries_per_chip": n * nloc, "shard": shard,
        "rounds": rounds, "ms_per_round_per_chip": ms,
        "implied_rounds_per_sec": 1e3 / ms, "alloc_bytes": alloc,
        "alloc_matches": abs(alloc - row["shard_bytes"])
        <= ALLOC_SLACK * len(shard_tensors(n, shards, arc_align)),
        "launches": launches,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "note": NOTE,
    }


def run_ladder(args, device) -> dict:
    """The whole capacity ladder (the first ``args.ladder_rows`` rows, all
    by default): each row's admission, measured on the card unless
    ``--budget-only``."""
    dev = torch.device(device)
    on_card = dev.type == "cuda" and not args.budget_only
    rows = []
    for n, shards, block_c, block_r, fanout in LADDER[:args.ladder_rows]:
        row = admission(n, shards, block_c, block_r, fanout, args.arc_align,
                        budget_limit(dev, not on_card))
        row["measured"] = False
        if row["admissible"] and on_card:
            row = measure(n, shards, block_c, block_r, fanout,
                          args.arc_align, args.rounds, args.reps,
                          device=dev)
            row["measured"] = True
        rows.append(row)
    return {
        "metric": "sharded resident-round capacity ladder (one card's "
                  "share a row; admission by shard_bytes against the "
                  "stated 80 GB and the card's free memory; measured on "
                  "the card, budget-verified otherwise)",
        "budget_bytes": BUDGET_BYTES,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "measured": on_card,
        "ladder": rows,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gossipfs_tpu_torch.shard_anchor",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=131_072)
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--block-c", type=int, default=512,
                   help="the JAX kernel's stripe width: recorded, ignored")
    p.add_argument("--block-r", type=int, default=512,
                   help="the JAX kernel's receiver block: recorded, ignored")
    p.add_argument("--arc-align", type=int, default=8)
    p.add_argument("--fanout", type=int, default=24)
    p.add_argument("--rounds", type=int, default=30)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--shard", type=int, default=0,
                   help="which shard's column offset to run")
    p.add_argument("--ladder", action="store_true",
                   help="emit the capacity-ladder JSON in one invocation")
    p.add_argument("--ladder-rows", type=int, default=None,
                   help="with --ladder: only its first rows")
    p.add_argument("--budget-only", action="store_true",
                   help="with --ladder: the admission against the stated "
                        "80 GB only (no device work)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.shard_anchor needs a CUDA "
                         "device (or --device cpu)")
    if args.ladder:
        print(json.dumps(run_ladder(args, dev)))
        return 0
    print(json.dumps(measure(args.n, args.shards, args.block_c,
                             args.block_r, args.fanout, args.arc_align,
                             args.rounds, args.reps, shard=args.shard,
                             device=dev)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
