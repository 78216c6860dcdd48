"""Stage-cost bisection of K3's one-pass form (f) at the headline shapes.

The port of the JAX package's ``tools/stub_bisect.py``, which timed the
resident-round kernel (``resident=True``) with stages stubbed out.  Here
the kernel is K3 (f) in the blocking ``ops/merge.onepass_blocking`` picks
for ``--n`` (the header's ``blocking``): ``csrc/rr_onepass.cu`` (8 CTAs x
32 columns, to N = 19,264) or ``csrc/rr_onepass_wide.cu`` (16 CTAs x 16
columns, past it).  A stub is a variant build of that library with the
stage compiled out (``RR_STUB``, csrc/rr_onepass.cuh, which states each
stage's meaning; ops/merge.onepass_defines), built for the one
instantiation the row launches, so the variants of a run build in
seconds, in parallel.  Each row times ``--rounds`` rounds carried on the
lanes (CUDA events), best of ``--reps`` runs from the same inputs, and on
the card adds the step timeline of one more round (``timeline_us``: median
microseconds a stripe in step 1, the cluster barrier, step 2 and the tail;
ops/merge.onepass_timeline_split):

    vtick  - the tick and view encode a raw copy into the park and view
             (the aligned forms' group-max table, which rides them, unbuilt)
    wmax   - the aligned forms' group-max table not built
    gather - best left at the gathers' start row
    epi    - the parked (ticked) lanes written back, every count zero
    rcnt   - the per-receiver counts zero, with no global atomics
    sus    - (--suspicion) the entered, refuted and held sums zero, the
             lifecycle transitions still running

    python -m gossipfs_tpu_torch.stub_bisect
    python -m gossipfs_tpu_torch.stub_bisect --arc-align 8
    python -m gossipfs_tpu_torch.stub_bisect --elementwise swar
    python -m gossipfs_tpu_torch.stub_bisect --arc-align 8 \\
        --elementwise swar --suspicion
    python -m gossipfs_tpu_torch.stub_bisect --arc-align 8 \\
        --elementwise swar --suspicion --scenario
    python -m gossipfs_tpu_torch.stub_bisect --n 65536 --arc-align 8
    python -m gossipfs_tpu_torch.stub_bisect --n 65536 --edges
    python -m gossipfs_tpu_torch.stub_bisect --device cpu --n 1024 \\
        --rounds 2 --reps 1

The JAX tool's default stub list, its ``sus`` insertion, its fanout rule
and its ``--suspicion`` / ``--scenario`` knobs are kept.  A stub whose
stage the launched form does not have is not run, and the header row says
why (ops/merge.stub_refusal): ``wring`` (the JAX kernel's ring-rotated
group-max flush: the port builds no ring, so its ``--rr-rotate`` is gone
too) and ``wmax`` under the full-view forms (the plain ``arc`` form at the
default ``--arc-align 1`` gathers its senders' view rows directly, with no
window pass).  ``--edges`` (not in the JAX tool, whose kernel it did not
time) prices the explicit-edge form of ``packed_rr``: ``fanout`` random
in-edges a receiver.  ``--block-c`` and ``--block-r`` (the JAX kernel's
tiles) are recorded in the header and ignored.  ``--device cpu`` replaces
the JAX tool's ``--interpret``: it times the ``(full)`` row through the
plain version and marks each stub row as needing the CUDA kernel (the
plain version is the oracle and takes no stub).

The first line is the self-describing header row
(``obs.schema.ROUNDPROF_SCHEMA``), so the JSONL reads back through
``obs.timeline.summarize_roundprof``; each row adds to the JAX tool's keys
its form, the kernel library it loaded and its launches a round.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gossipfs_tpu_torch.config import AGE_CLAMP
from gossipfs_tpu_torch.obs import schema as obs_schema
from gossipfs_tpu_torch.ops import _build, merge

DEFAULT_STUBS = ["", "rcnt", "gather", "wmax,gather", "epi", "epi,rcnt",
                 "vtick", "vtick,wmax,gather,epi,rcnt"]
CPU_SKIP = ("needs the CUDA kernel: a stage stub is a variant build of "
            "K3 (f)'s library (csrc/rr_onepass.cu or rr_onepass_wide.cu), "
            "and the plain version takes none")


def default_stubs(arc_align: int, scenario: bool,
                  suspicion: bool) -> list[str]:
    """The JAX tool's default stub list (at its default ``--rr-rotate
    auto``): ``wring`` where its ring build ran (aligned arcs, not under a
    scenario), ``sus`` under suspicion."""
    stubs = list(DEFAULT_STUBS)
    if arc_align > 1 and not scenario:
        stubs.insert(3, "wring")
    if suspicion:
        stubs.insert(1, "sus")
    return stubs


def bisect_fanout(n: int, arc_align: int) -> int:
    """The JAX tool's fanout: log2-ish of N, rounded up to a multiple of
    ``arc_align``."""
    fanout = max(1, n.bit_length() - 1)
    if arc_align > 1:
        fanout = -(-fanout // arc_align) * arc_align
    return fanout


def build_inputs(n: int, fanout: int, arc_align: int = 1,
                 scenario: bool = False, seed: int = 0,
                 device="cuda", edges: bool = False) -> dict:
    """The JAX tool's inputs from a seeded generator on ``device``:
    random int8 hb, ages 0..39 and statuses MEMBER / FAILED / UNKNOWN
    packed, every row active and alive (under ``scenario`` the mute bit
    on about 1/16 of them), zero shifts with a grace threshold of -120,
    arc bases (multiples of ``arc_align`` where it is above 1), and under
    ``scenario`` the edge_filter pairs (base, a random group-match
    mask); under ``edges`` ``fanout`` random in-edges a receiver
    instead."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, dtype=dtype,
                             device=dev)

    hb = ints(-128, 127, (n, n), torch.int8)
    age = ints(0, 40, (n, n), torch.int16)
    st = ints(0, 3, (n, n), torch.int16)
    asl = (((age << 2) | st) - 128).to(torch.int8)
    del age, st
    flags = torch.full((n,), 1 + 4, dtype=torch.int8, device=dev)
    if scenario:
        muted = torch.rand(n, generator=gen, device=dev) < 1.0 / 16.0
        flags = flags + muted.to(torch.int8) * 8
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    vecs = merge.threshold_stack(zero, zero, torch.full_like(zero, -120),
                                 126)
    if arc_align > 1:
        bases = ints(0, n // arc_align, (n,)) * arc_align
    else:
        bases = ints(0, n, (n,))
    senders = bases
    if edges:
        senders = ints(0, n, (n, fanout))
    elif scenario:
        nw = fanout // arc_align
        senders = torch.stack([bases, ints(0, 1 << nw, (n,))], 1)
    return {"hb": hb, "asl": asl, "flags": flags, "vecs": vecs,
            "senders": senders.contiguous()}


def round_kwargs(fanout: int, arc_align: int, elementwise: str,
                 suspicion: bool, scenario: bool,
                 edges: bool = False) -> dict:
    """The round's knobs, the JAX tool's: t_fail 3 and t_suspect 2 under
    suspicion (else t_fail 5), t_cooldown 12, no Lifeguard lane; under
    ``edges`` no fanout (the senders' width is the fanout)."""
    return dict(fanout=None if edges else fanout, arc_align=arc_align,
                t_fail=3 if suspicion else 5, t_cooldown=12,
                age_clamp=AGE_CLAMP, suspect=suspicion,
                t_suspect=2 if suspicion else 0, edge_filter=scenario,
                elementwise=elementwise)


def stub_round(x: dict, kw: dict, stub: str = ""):
    """One round in place on ``x``'s lanes: K3 (f) (its ``stub`` variant)
    on the card, the plain version on the CPU (no stub)."""
    return merge.resident_round(x["hb"], x["asl"], x["flags"], x["vecs"],
                                x["senders"], onepass=True, stub=stub, **kw)


def stub_blocking(n: int, kw: dict) -> str:
    """The blocking of K3 (f) a square round of ``n`` rows with knobs
    ``kw`` launches (ops/merge.onepass_blocking), or a ``ValueError``
    where neither holds it."""
    form = merge.kernel_form(kw["fanout"], kw["arc_align"],
                             kw["edge_filter"])
    blocking = merge.onepass_blocking(n, n, form, kw["elementwise"])
    if blocking is None:
        raise ValueError(merge.onepass_refusal(n, n, form,
                                               kw["elementwise"]))
    return blocking


def stub_variant(kw: dict, stub: str, blocking: str = "8x32") -> tuple:
    """The build item of the kernel library a row loads in ``blocking``:
    its source name and the variant's defines (none for ``(full)``)."""
    form = merge.kernel_form(kw["fanout"], kw["arc_align"],
                             kw["edge_filter"])
    return (merge.ONEPASS_BLOCKINGS[blocking].source,
            merge.onepass_defines(form, kw["suspect"], False,
                                  kw["elementwise"], False, stub))


def stub_library(kw: dict, stub: str, blocking: str = "8x32") -> str:
    """The file name of the kernel library a row loads in ``blocking``:
    the default one for ``(full)``."""
    return _build.lib_path(*stub_variant(kw, stub, blocking)).name


def stub_timeline(x: dict, kw: dict, stub: str, blocking: str) -> dict:
    """One more round on ``x``'s lanes with the step timeline recorded:
    median microseconds a stripe in each step
    (ops/merge.onepass_timeline_split)."""
    ctas, cols, _ = merge.ONEPASS_BLOCKINGS[blocking]
    n = x["hb"].shape[1]
    tl = torch.zeros((n // cols, ctas, merge.ONEPASS_STAMPS),
                     dtype=torch.int64, device=x["hb"].device)
    merge.resident_round(x["hb"], x["asl"], x["flags"], x["vecs"],
                         x["senders"], onepass=True, stub=stub, timeline=tl,
                         **kw)
    return merge.onepass_timeline_split(tl)


def time_stub(x0: dict, kw: dict, stub: str, rounds: int, reps: int,
              blocking: str | None = None) -> tuple[float, float, dict]:
    """Best of ``reps`` runs of ``rounds`` rounds carried on a copy of
    ``x0``'s lanes (one warm-up round first): (seconds, K3 (f) launches a
    round, and on the card with ``blocking`` given the step timeline of
    one more round, else {})."""
    cuda = x0["hb"].device.type == "cuda"
    x = dict(x0, hb=x0["hb"].clone(), asl=x0["asl"].clone())
    stub_round(x, kw, stub)
    form = merge.kernel_form(kw["fanout"], kw["arc_align"], kw["edge_filter"],
                             kw["elementwise"]) + "/onepass"
    before = merge.FORM_LAUNCHES[form]
    best = float("inf")
    for _ in range(reps):
        x["hb"].copy_(x0["hb"])
        x["asl"].copy_(x0["asl"])
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(rounds):
            stub_round(x, kw, stub)
        if cuda:
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3
        else:
            sec = time.perf_counter() - t0
        best = min(best, sec)
    per_round = (merge.FORM_LAUNCHES[form] - before) / (rounds * reps)
    split = ({} if not cuda or blocking is None
             else stub_timeline(x, kw, stub, blocking))
    return best, per_round, split


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gossipfs_tpu_torch.stub_bisect",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=16_384)
    p.add_argument("--block-c", type=int, default=2_048,
                   help="the JAX kernel's stripe width: recorded, ignored")
    p.add_argument("--block-r", type=int, default=512,
                   help="the JAX kernel's receiver block: recorded, ignored")
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--arc-align", type=int, default=1)
    p.add_argument("--elementwise", choices=merge.ELEMENTWISE,
                   default="lanes")
    p.add_argument("--suspicion", action="store_true",
                   help="arm the SWIM lifecycle (t_fail=3, t_suspect=2); "
                        "adds the 'sus' stub")
    p.add_argument("--scenario", action="store_true",
                   help="the edge_filter form: masked gather over (base, "
                        "match-mask) pairs and sender-mute flags (requires "
                        "--arc-align > 1)")
    p.add_argument("--edges", action="store_true",
                   help="the explicit-edge form (packed_rr): fanout random "
                        "in-edges a receiver (requires --arc-align 1, no "
                        "--scenario)")
    p.add_argument("--stubs", nargs="*", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if args.scenario and args.arc_align <= 1:
        p.error("--scenario (the edge_filter build) requires --arc-align "
                "> 1; explicit-edge scenarios rewrite edges outside the "
                "kernel and cost nothing in it")
    if args.edges and (args.arc_align > 1 or args.scenario):
        p.error("--edges takes explicit in-edges: no --arc-align, no "
                "--scenario")
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.stub_bisect needs a CUDA "
                         "device (or --device cpu)")
    stubs = (default_stubs(args.arc_align, args.scenario, args.suspicion)
             if args.stubs is None else args.stubs)
    fanout = bisect_fanout(args.n, args.arc_align)
    kw = round_kwargs(fanout, args.arc_align, args.elementwise,
                      args.suspicion, args.scenario, args.edges)
    form = merge.kernel_form(kw["fanout"], args.arc_align, args.scenario)
    try:
        blocking = stub_blocking(args.n, kw)
    except ValueError as e:
        p.error(str(e))
    not_run = {s: why for s in stubs
               if (why := merge.stub_refusal(s, form, args.suspicion))}
    run = [s for s in stubs if s not in not_run]
    backend = "cuda" if cuda else "cpu (plain version)"
    t0 = time.perf_counter()
    if cuda:
        # every variant of the run at once, one nvcc each (seconds: each
        # compiles one instantiation)
        _build.build([stub_variant(kw, s, blocking) for s in run])
    print(json.dumps({
        "schema": obs_schema.ROUNDPROF_SCHEMA, "tool": "stub_bisect",
        "n": args.n, "block_c": args.block_c, "block_r": args.block_r,
        "arc_align": args.arc_align, "elementwise": args.elementwise,
        "rr_rotate": None, "suspicion": args.suspicion,
        "scenario": args.scenario, "edges": args.edges,
        "backend": backend, "form": form, "blocking": blocking,
        "source": merge.ONEPASS_BLOCKINGS[blocking].source + ".cu",
        "fanout": fanout, "stubs": [s or "(full)" for s in run],
        "not_run": not_run,
        "note": "block_c, block_r: the JAX kernel's tiles, ignored; the "
                "port has no ring-rotated build, so wring and --rr-rotate "
                "have no counterpart",
        "build_s": time.perf_counter() - t0,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
    }), flush=True)
    x0 = build_inputs(args.n, fanout, args.arc_align, args.scenario,
                      args.seed, dev, args.edges)
    for stub in run:
        row = {"stub": stub or "(full)", "elementwise": args.elementwise,
               "rr_rotate": None, "suspicion": args.suspicion,
               "scenario": args.scenario, "backend": backend}
        if stub and not cuda:
            print(json.dumps({**row, "skipped": CPU_SKIP}), flush=True)
            continue
        sec, per_round, split = time_stub(x0, kw, stub, args.rounds,
                                          args.reps, blocking)
        print(json.dumps({
            **row, "ms_per_round": sec / args.rounds * 1e3,
            "form": form + ("/swar" if args.elementwise == "swar" else ""),
            "library": stub_library(kw, stub, blocking) if cuda else None,
            "launches_a_round": per_round,
            **({"timeline_us": split} if split else {}),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
