"""Interactive REPL — the reference CLI, backed by the simulated cluster.

The port of the JAX package's ``gossipfs_tpu/shim/cli.py`` over the
port's ``CoSim``: the detector's rounds run on the card (``--device
cpu`` for the CPU), ``--packed`` on the resident round K3 through the
port's ``PackedDetector``, every other mode on K2.  The verbs and what
they print are the JAX package's.

Command surface matches README.md:8-29 plus fault/time controls the sim adds:

  join <n> / leave <n> / crash <n>   membership verbs (+ CTRL+C equivalent)
  lsm <n>                            print node n's membership list
  IP                                 print node ids (the sim's "addresses")
  put <local> <sdfs>                 write a file into SDFS (quorum write)
  get <sdfs> <local>                 read it back (quorum read + repair)
  delete <sdfs> / ls <sdfs> / store <n>
  show_metadata | check              master's file->replica map
  advance <r>                        advance simulated time by r rounds
  events                             detection events so far
  metrics                            the uniform vitals counter line
                                     (obs/schema.py VITALS_FIELDS — the
                                     same set the deploy Vitals RPC
                                     serves; unknowable fields as n/a)
  scenario load <file.json>          arm a declarative fault scenario
                                     (gossipfs_tpu_torch/scenarios/ schema:
                                     partitions, link loss, slow nodes;
                                     needs --gossip-only — the broadcast
                                     modes aren't transport-filterable)
  scenario status | clear            armed-scenario state / disarm
  suspicion status                   SWIM suspect/refute vitals (per-node
                                     suspect counts, refutations, confirms
                                     — needs --t-suspect); lsm marks a
                                     SUSPECT entry with a trailing ?
  traffic status                     SDFS traffic-plane vitals (ops
                                     issued/acked, repairs pending/done —
                                     the obs/schema.py VITALS_FIELDS
                                     tail; engines without a data plane
                                     render every field n/a, never 0.
                                     invariant_violations appears when a
                                     streaming monitor rides the attached
                                     recorder — obs/monitor.py — and
                                     renders n/a otherwise, same rule)
  grep [--node <k>] <regex>          search the event log (MP1 legacy verb);
                                     --node scopes to one machine's log view

Run: ``python -m gossipfs_tpu_torch.shim.cli [--n 16] [--topology ring]
[--device cuda]``
"""

from __future__ import annotations

import argparse
import pathlib
import re
import select
import sys

import torch

from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.cosim import CoSim
from gossipfs_tpu_torch.obs import schema
from gossipfs_tpu_torch.sdfs.types import CONFIRM_TIMEOUT, STRIPE_K, STRIPE_M


def stdin_confirm(
    name: str,
    timeout: float = float(CONFIRM_TIMEOUT),
    stream=None,
    out=sys.stdout,
) -> bool:
    """Interactive write-conflict prompt (reference: server.go:144-153).

    The reference's master, on a put within the 60 s conflict window, asks
    the requester's human a yes/no question on stdin with a 30 s timeout
    defaulting to reject (server.go:172).  Reads one line from ``stream``
    (the REPL's own input) under ``select`` so a silent terminal rejects
    after the timeout instead of hanging the session.
    """
    stream = stream if stream is not None else sys.stdin
    print(
        f"{name} was updated in the last 60 rounds. Overwrite? "
        f"[y/N, {int(timeout)} s timeout rejects]",
        file=out,
        flush=True,
    )
    try:
        ready, _, _ = select.select([stream], [], [], timeout)
    except (ValueError, OSError, TypeError):
        # stream without a selectable fd (in-memory test streams): read
        # directly — the caller controls pacing there
        ready = [stream]
    if not ready:
        print("confirmation timed out: rejecting write", file=out)
        return False
    line = stream.readline()
    if isinstance(line, bytes):
        line = line.decode(errors="replace")
    return line.strip().lower() in ("y", "yes")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gossipfs", description=__doc__)
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--topology", choices=["ring", "random"], default="ring")
    p.add_argument("--fanout", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--confirm-timeout", type=float, default=float(CONFIRM_TIMEOUT),
        help="seconds to wait for the write-conflict yes/no before "
             "rejecting (reference: server.go:172)",
    )
    p.add_argument(
        "--gossip-only", action="store_true",
        help="gossip-only dissemination (remove_broadcast off, fresh "
             "cooldown) — the north-star mode, and required before "
             "'scenario load' (the instantaneous REMOVE broadcast cannot "
             "be partition-filtered; scenarios/tensor.py)",
    )
    p.add_argument(
        "--t-suspect", type=int, default=0,
        help="arm the SWIM suspicion lifecycle (suspicion/): silent "
             "members pass through a refutable SUSPECT state for this "
             "many rounds before FAILED.  0 = off; needs --gossip-only "
             "(the REMOVE broadcast would bypass the suspect window; "
             "--packed is gossip-only already and runs the lifecycle "
             "in-kernel)",
    )
    p.add_argument(
        "--redundancy", choices=["replica", "stripe"], default="replica",
        help="SDFS redundancy mode: 'replica' = the reference's 4-copy "
             "scheme; 'stripe' = (k,m) GF(256) erasure coding "
             "(gossipfs_tpu_torch/erasure/) — rack-disjoint fragments, "
             "k-of-(k+m) reads, budgeted most-endangered-first repair",
    )
    p.add_argument(
        "--stripe-k", type=int, default=STRIPE_K,
        help="data fragments per stripe (with --redundancy stripe)")
    p.add_argument(
        "--stripe-m", type=int, default=STRIPE_M,
        help="parity fragments per stripe (with --redundancy stripe)")
    p.add_argument(
        "--rack-size", type=int, default=None,
        help="nodes per failure domain for stripe placement "
             "(default: every node its own rack)")
    p.add_argument(
        "--arc-align", type=int, default=1,
        help="with --packed: tile-aligned windowed-arc gossip (bases are "
             "multiples of this; fanout rounds up to a multiple) — the "
             "headline kernel's fastest topology at the capacity frontier")
    p.add_argument(
        "--packed", action="store_true",
        help="capacity-frontier interactive mode: the membership state "
             "lives as the resident-round kernel's packed lanes "
             "(detector.sim.PackedDetector) — what fits N=49,152+ "
             "interactively on one chip.  Implies a random log2(N)-fanout "
             "crash-only protocol profile; 'join' is unsupported",
    )
    p.add_argument(
        "--device", type=str, default="cuda",
        help="where the detector's rounds run: the card (default) or cpu")
    return p


def dispatch(
    sim: CoSim,
    line: str,
    out=sys.stdout,
    in_stream=None,
    confirm_timeout: float = float(CONFIRM_TIMEOUT),
) -> bool:
    """Execute one REPL command; returns False on quit.

    ``in_stream`` is where the write-conflict confirmation prompt reads its
    yes/no answer (the REPL's own stdin) — see :func:`stdin_confirm`.
    """
    parts = line.strip().split()
    if not parts:
        return True
    cmd, args = parts[0], parts[1:]
    try:
        if cmd in ("quit", "exit"):
            return False
        elif cmd == "join":
            sim.detector.join(int(args[0]))
        elif cmd == "leave":
            sim.detector.leave(int(args[0]))
        elif cmd == "crash":
            sim.detector.crash(int(args[0]))
        elif cmd == "lsm":
            obs = int(args[0])
            members = sim.detector.membership(obs)
            suspects: set[int] = set()
            if getattr(sim.config, "suspicion", None) is not None and \
                    hasattr(sim.detector, "suspects"):
                suspects = set(sim.detector.suspects(obs))
            if suspects:
                # SUSPECT entries render distinctly: still members, but
                # pending refute/confirm (suspicion/)
                print("[" + ", ".join(
                    f"{j}?" if j in suspects else str(j) for j in members
                ) + "]", file=out)
            else:
                print(members, file=out)
        elif cmd == "IP":
            print(sim.detector.alive_nodes(), file=out)
        elif cmd == "advance":
            sim.tick(int(args[0]) if args else 1)
            print(f"round={sim.round}", file=out)
        elif cmd == "put":
            data = pathlib.Path(args[0]).read_bytes()
            name = args[1]
            ok = sim.put(
                name,
                data,
                confirm=lambda: stdin_confirm(
                    name, timeout=confirm_timeout, stream=in_stream, out=out
                ),
            )
            print("ok" if ok else "Write-Write conflicts!", file=out)
        elif cmd == "get":
            blob = sim.get(args[0])
            if blob is None:
                print("No File Found", file=out)
            else:
                pathlib.Path(args[1]).write_bytes(blob)
                print(f"wrote {len(blob)} bytes", file=out)
        elif cmd == "delete":
            print("ok" if sim.delete(args[0]) else "No File Found", file=out)
        elif cmd == "ls":
            print(sim.cluster.ls(args[0]), file=out)
        elif cmd == "store":
            print(sim.cluster.store_listing(int(args[0])), file=out)
        elif cmd in ("show_metadata", "check"):  # "check" = reference alias
                                                 # (CheckInput, slave.go:608-610)
            for name, info in sim.cluster.master.files.items():
                print(f"{name}: v{info.version} @ {info.node_list}", file=out)
        elif cmd == "events":
            for ev in sim.events:
                print(ev, file=out)
        elif cmd == "metrics":
            # the uniform vitals line (obs.schema.VITALS_FIELDS): the
            # SAME counter set the deploy `Vitals` RPC renders per node;
            # fields this engine cannot know print as n/a, never 0
            from gossipfs_tpu_torch.obs.schema import render_vitals

            print(render_vitals(sim.vitals()), file=out)
        elif cmd == "scenario":
            sub = args[0] if args else "status"
            if sub == "load":
                from gossipfs_tpu_torch.scenarios import FaultScenario

                sim.load_scenario(FaultScenario.from_file(args[1]))
                st = sim.scenario_status()
                print(f"armed '{st['name']}' (horizon {st['horizon']} "
                      "rounds from now)", file=out)
            elif sub == "status":
                st = sim.scenario_status()
                if st is None:
                    print("no scenario armed", file=out)
                else:
                    print(f"{st['name']}: round {st['round']}, "
                          f"{'ACTIVE' if st['active'] else 'inactive'}; "
                          f"rules: {st['rules'] or 'none'}", file=out)
            elif sub == "clear":
                sim.clear_scenario()
                print("scenario cleared", file=out)
            else:
                print(f"unknown scenario verb: {sub} "
                      "(load <file.json> | status | clear)", file=out)
        elif cmd == "suspicion":
            sub = args[0] if args else "status"
            if sub == "status":
                st = sim.suspicion_status()
                if st is None:
                    print("no suspicion armed (start with --t-suspect N)",
                          file=out)
                else:
                    counts = st.get("suspect_counts") or {}
                    per = ", ".join(f"{i}:{c}" for i, c in sorted(counts.items()))
                    # fp_suppressed needs ground-truth aliveness: the
                    # socket engines omit it — render the unknowable as
                    # n/a, never as a measured zero
                    fps = st.get("fp_suppressed")
                    print(f"suspicion t_suspect={st['t_suspect']}: "
                          f"{st.get('suspects_now', 0)} suspect entries now"
                          f"{' (' + per + ')' if per else ''}; "
                          f"refutations={st.get('refutations', 0)} "
                          f"confirms={st.get('confirms', 0)} "
                          f"fp_suppressed={schema.na(fps)}",
                          file=out)
            else:
                print(f"unknown suspicion verb: {sub} (status)", file=out)
        elif cmd == "traffic":
            sub = args[0] if args else "status"
            if sub == "status":
                # the traffic-plane tail of obs.schema.VITALS_FIELDS; an
                # engine without an SDFS data plane omits the fields and
                # each renders n/a, never a measured 0
                st = (sim.traffic_status()
                      if hasattr(sim, "traffic_status") else {})
                fmt = lambda k: schema.na(st.get(k))  # noqa: E731
                # invariant_violations: present only when a streaming
                # monitor (obs/monitor.py) rides the attached recorder —
                # engines that can't know it render n/a, never 0
                # stripes_degraded/fragments_lost: stripe-mode-only
                # erasure vitals — replica-mode documents omit them, so
                # they render n/a here (a stripe run's clean 0 is a real
                # measurement)
                print(f"ops issued={fmt('ops_issued')} "
                      f"acked={fmt('ops_acked')}; "
                      f"repairs pending={fmt('repairs_pending')} "
                      f"done={fmt('repairs_done')}; "
                      f"stripes degraded={fmt('stripes_degraded')} "
                      f"fragments lost={fmt('fragments_lost')}; "
                      f"invariant_violations={fmt('invariant_violations')}",
                      file=out)
            else:
                print(f"unknown traffic verb: {sub} (status)", file=out)
        elif cmd == "grep":
            # ``grep [--node <k>] [--] <pattern>``: the explicit flag
            # scopes the search to node k's own log view (distributed-grep
            # analog); without it the pattern is searched verbatim, digits
            # included.  ``--`` ends flag parsing, and a ``--node`` whose
            # operand is not an int falls back to pattern text, so a
            # pattern literally starting with "--node" stays greppable
            node = None
            if len(args) >= 2 and args[0] == "--node":
                try:
                    node, args = int(args[1]), args[2:]
                except ValueError:
                    pass
            if args and args[0] == "--":
                args = args[1:]
            for entry in sim.log.grep(" ".join(args), node=node):
                print(entry, file=out)
        else:
            print(f"unknown command: {cmd}", file=out)
    except (IndexError, ValueError, FileNotFoundError, re.error,
            NotImplementedError) as e:
        # NotImplementedError: a mode-gated verb must print an error, not
        # kill a session holding GBs of state
        print(f"error: {e}", file=out)
    return True


def config_from_args(args) -> SimConfig:
    """The protocol configuration a command line asks for (``ValueError``
    where the flags do not compose)."""
    if args.packed:
        if args.arc_align > 1:
            lf = SimConfig.log_fanout(args.n)
            cfg = SimConfig.packed_rr(
                args.n, topology="random_arc",
                arc_align=args.arc_align,
                fanout=-(-lf // args.arc_align) * args.arc_align,
            )
        else:
            cfg = SimConfig.packed_rr(args.n)
    else:
        extra = {}
        if args.gossip_only:
            extra = dict(remove_broadcast=False, fresh_cooldown=True)
        cfg = SimConfig(n=args.n, topology=args.topology,
                        fanout=args.fanout, **extra)
    if args.t_suspect > 0:
        # The SWIM lifecycle runs natively on every merge
        # path (--packed's rr kernel included), so arming it is a
        # plain field set — __post_init__ owns the protocol-mode
        # check (gossip-only; suspicion/tensor.py).
        import dataclasses

        from gossipfs_tpu_torch.suspicion import SuspicionParams

        cfg = dataclasses.replace(
            cfg, suspicion=SuspicionParams(t_suspect=args.t_suspect))
    return cfg


def cosim_from_args(args, cfg: SimConfig) -> CoSim:
    """The REPL's co-simulation on ``args.device``: the kernels the
    detector launches are built first, and ``--packed`` takes a
    ``PackedDetector``."""
    from gossipfs_tpu_torch.shim.service import build_kernels

    build_kernels(cfg, args.device)
    detector = None
    if args.packed:
        from gossipfs_tpu_torch.detector.sim import PackedDetector

        detector = PackedDetector(cfg, seed=args.seed, device=args.device)
    return CoSim(cfg, seed=args.seed, detector=detector,
                 redundancy=args.redundancy, stripe_k=args.stripe_k,
                 stripe_m=args.stripe_m, rack_size=args.rack_size,
                 device=args.device)


def main(argv=None) -> None:
    parser = make_parser()
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.shim.cli needs a CUDA device "
                         "(or --device cpu)")
    try:
        cfg = config_from_args(args)
    except ValueError as e:
        parser.error(str(e))
    sim = cosim_from_args(args, cfg)
    mode = (f", stripe({args.stripe_k},{args.stripe_m})"
            if args.redundancy == "stripe" else "")
    print(f"gossipfs sim: {args.n} nodes, {cfg.topology} topology{mode}"
          f"{' (packed frontier mode)' if args.packed else ''}. "
          "'quit' to exit.")
    # Read stdin UNBUFFERED (byte-at-a-time lines): any buffered layer
    # (the ``for line in sys.stdin`` iterator's read-ahead, or even
    # TextIOWrapper.readline's internal chunking) would slurp pending
    # lines into user space, where the confirmation prompt's select() on
    # the raw fd cannot see them — a piped-in 'y' answer would look like
    # silence and falsely time out.
    stdin = open(sys.stdin.fileno(), "rb", buffering=0, closefd=False)
    for raw in iter(stdin.readline, b""):
        if not dispatch(sim, raw.decode(errors="replace"), in_stream=stdin,
                        confirm_timeout=args.confirm_timeout):
            break


if __name__ == "__main__":
    main()
