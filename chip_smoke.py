#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py            # every phase, needs one CUDA card

Phases (any failure exits non-zero before the last line is printed):

1. device: name, count, and ``nvidia-smi``'s name and power limit;
2. build: the CUDA kernels from ``gossipfs_tpu_torch/csrc`` with nvcc for
   sm_90a, one nvcc per source, started together, and beside them the
   native C++ engine of phase 48 (``native/`` with g++ into
   ``gossipfs_tpu_torch/_build/native``);
3. K3 (resident round) against plain, one round at N = 16,384 on random
   pre-tick lanes (all statuses, ages up to the clamp, never-sent entries,
   mixed flags, deep negative shifts): every output bit-equal; times of
   the kernel, the plain version and the byte bound;
4. K3 scan against plain scan: 12 headline rounds, same key: lanes, carry
   and every per-round metric bit-equal;
5. the lean main path: the headline (N = 16,384, 100 rounds, 1 % crash
   churn, 8 tracked crashes) through ``run_rounds`` on K3, with the launch
   counts zeroed just before and read just after: exactly one K3 launch a
   round, all in its one-pass form (f) (``rr_resident="auto"``); rounds/s,
   the kernel's device ms per round beside the whole round's ms, peak
   memory, and ``summarize``'s TTD and FPR; then the same run with
   ``rr_resident="off"`` (K3's two-launch form): equal lanes, carry and
   metrics, its ms a round beside (phases 16, 21, 27, 28, 32 and 37 run
   their main paths both ways too);
6. K3 capacity: N = 65,536 for 10 rounds on K3's two-launch form, one
   launch a round;
7. K2 (explicit-edge merge) against plain, one call per dtype pair shape
   and detection-stats setting, on corner-case lanes (all statuses, ages
   up to 63, floor sentinels, deep and negative shifts, dead receivers):
   config 3's (int8 view, int16 hb, N = 10,240, F = 14), the ring's
   (int16, int32, N = 1,024, F = 3), (int8, int8, N = 16,384, F = 16) and
   a ragged N = 1,030 (element loads); every output bit-equal; kernel,
   plain and byte-bound times at config 3's shape;
8. K4 (arc merge) against plain at N = 16,384, F = 16, aligned and plain
   arc bases, and at a ragged N = 1,030, F = 13 (int16 view, int32
   lanes), stats on and off; every output bit-equal; times and bound at
   the headline's shape;
9. the separate-pass scan on the kernels against the same scan on the
   plain versions, 20 rounds each: configs 1 and 2 (ring, int32 lanes,
   REMOVE broadcast) and the headline under 2 to 5 % crash and rejoin
   churn, config 3 under 5 % of each; lanes, carry and every metric
   bit-equal; and the flagship one-round step (``gossip_round``) round by
   round;
10. this slice's main path: config 3 ``sim-10k-crash`` as published
    (N = 10,240, 120 rounds, 1 % crash churn, 8 tracked crashes at round
    20) through ``run_rounds`` with the counts zeroed just before and read
    just after: exactly 120 K2 launches and no K3 one; rounds/s, K2 ms
    per round beside the whole round's, peak memory, TTD and FPR; then
    5 rounds under ``torch.profiler``: device ms per round of each stage
    of the round and the device's busy share;
11. the eventful arc path: the headline under 1 % crash and 1 % rejoin
    churn (joins are matrix events), 50 rounds: 50 K4 launches;
    rounds/s and peak memory; the same stage split;
12. capacity under config 4's fault model (5 % crash, 5 % rejoin, random
    fanout 16, int16 lanes, int8 view) at N = 65,536, 10 rounds: exactly
    10 K2 launches and no other kernel's, rounds/s, K2's device ms a round
    (CUDA events around each launch: the largest K2 a main path launches)
    beside the whole round's, and peak memory, which must stay under 40
    GiB;
13. K3's suspicion form against plain, one round at N = 16,384 on random
    pre-tick lanes with SUSPECT entries on both sides of both confirm ages
    and flags bit 4 on half the rows, with and without the Lifeguard lane:
    every output bit-equal (``suspect_cnt`` included); times and bound;
14. the suspect forms of K2 (config 3's shape) and K4 (the headline's)
    against plain, on lanes holding SUSPECT entries, and their times at
    the shapes and stats setting of phases 7-8; then K5 against plain
    and against K2 at N = 16,384, F = 14, an int8 view over int8 and int16
    lanes, and at a ragged N = 1,030, stats and suspicion on and off:
    every output bit-equal; K5's times and bound at the main path's
    shape beside K2's time on the same inputs;
15. 12-round scans, kernels against plain: the ``bench --suspicion``
    headline (K3), the headline at LOCALHEALTH_r14's chosen Lifeguard
    point (K3's lh lane), ``SimConfig.suspicion_rr(16_384)`` under 2 %
    crash and rejoin churn (K5), config 3 with t_fail 3 and t_suspect 2
    (K2), and the suspicion headline under rejoin churn (K4); lanes,
    carry and all six metrics bit-equal;
16. main path A: the ``bench --suspicion`` headline (N = 16,384, 100
    rounds, 1 % crash churn, 8 tracked crashes) through ``run_rounds``:
    exactly 100 K3 launches, all one-pass; rounds/s, K3 ms per round
    beside the whole round, peak memory, TTD, ``ttd_suspect``,
    suspect-to-confirm, FPR and the three suspicion counters;
17. main path B: ``SimConfig.suspicion_rr(16_384)`` (random edges F = 14,
    all-int8) for 50 rounds under 1 % crash and 1 % rejoin churn: exactly
    50 K5 launches and no other kernel's; rounds/s, peak memory and the
    profiled stage split;
18. K1 (``fanout_max_merge``) against plain: int8, int16 and int32 views at
    N = 16,384, F = 14, and a ragged N = 1,030, F = 5; every entry equal;
    kernel, plain and byte-bound times (int8);
19. K3's explicit-edge (F = 14) and plain-arc (F = 16, align 1) forms
    against plain, one round at N = 16,384, crash-only, suspicion and
    suspicion + Lifeguard: every output equal; times, bounds and the
    profiled split between the two launches; K5's suspicion-off time at
    phase 14's all-int8 shape;
20. 12-round lean scans, kernel (one-pass, then two-launch) against
    plain: ``packed_rr``, ``suspicion_rr`` with and without the Lifeguard
    lane, plain arcs and ``headline(arc_align=4)`` (aligned bases the
    kernel takes as plain arcs); lanes, carry and all six metrics
    bit-equal;
21. main path C: ``SimConfig.packed_rr(16_384)`` (random edges F = 14) for
    100 rounds, 1 % crash churn, 8 tracked crashes at round 3, through
    ``run_rounds`` on the lean loop: exactly 100 K3 launches, all
    one-pass, and no other kernel's; rounds/s, K3 ms per round, host ms,
    TTD, FPR and the
    profiled device split; then the same run through the separate-pass
    loop (K5): equal final lanes, carry, metrics and report, and its
    rounds/s beside;
22. capacity frontier: ``python -m gossipfs_tpu_torch.frontier --trace``
    at its defaults (N = 65,536, F = 16, 20 rounds): rounds/s and peak
    memory, which must stay under 40 GiB; the trace's ``remove`` rows
    number at most N and ``obs.timeline.analyze`` gives the JSON's TTD
    and FPR from it;
23. ``PackedDetector`` at the CLI's capacity point N = 49,152: advance 3,
    crash, advance 8, join, advance 10: the detection lands at crash +
    t_fail, the joiner is alive; ms per advance and for the advance that
    joins; at N = 16,384 the same script's lanes equal ``run_rounds`` with
    the same scheduled events;
24. ``SimDetector`` on config 3 (N = 10,240): two rounds, two crashes,
    then ``advance_bulk(60, snapshot_every=10)`` against
    ``advance_bulk(60)`` (equal state and events), then an interactive
    stretch whose crash lands at crash + t_fail;
25. K3's ``edge_filter`` form (the scenario engine on aligned arcs: masked
    group gather, sender mute on flags bit 3) against plain, one round at
    N = 16,384, F = 16: arc alignments 8 (group maxes) and 4 (view rows),
    random match masks (a tenth of them zero), ~6 % of the rows muted,
    crash-only, suspicion and suspicion + Lifeguard: every output equal;
    times, the profiled split between the two launches, and the byte
    bound;
26. 20-round lean scans under a scenario, kernel (one-pass, then
    two-launch) against plain: the
    suspicion headline under split + slow + flap + outage, ``suspicion_rr``
    under split + slow + Bernoulli loss, ``headline(arc_align=4)`` under a
    split; lanes, carry and all six metrics bit-equal;
27. main path D (this slice's path): the suspicion headline for 100 rounds,
    1 % crash churn, 8 tracked crashes, under one scenario (a half/half
    partition for rounds 20-45, 1/16 of the nodes flapping up 3 down 2 for
    rounds 10-80, an 8-node rack outage for rounds 50-62, fault nodes
    disjoint from the tracked victims): exactly 100 K3 launches, all in
    the one-pass ``edge_filter`` form, and no other kernel's; rounds/s,
    K3 ms, host
    ms, the profiled device split and busy share, TTD, FPR, suspects
    entered, refutations;
28. main path D': ``SimConfig.suspicion_rr(16_384)`` for 100 rounds, 1 %
    crash churn, 8 tracked crashes, under a partition + 2 % Bernoulli loss
    on 1/16 of the senders + slow senders: the lean loop on K3's
    one-pass explicit-edge form with rewritten edges (100 launches); then
    20 rounds
    of the same run through the separate-pass loop (K5) beside 20 on the
    lean loop: equal lanes, carry and metrics;
29. ``curves --partition`` at N = 16,384 through
    ``SimDetector.load_scenario`` (interactive rounds on the separate-pass
    loop, K2): the ``PartitionReport`` row, ``cross_hb_advances == 0`` and
    ``reconverge_rounds <= reconverge_bound``;
30. K3's SWAR form (``elementwise="swar"``) in all 15 instantiations the
    lean gate reaches (5 merge forms x crash-only / suspicion / + lh, the
    mute on the ``edge_filter`` forms), one round at N = 16,384 on the
    random lanes of phases 3, 13 and 25: bit-equal to the SWAR plain
    version and to the lanes kernel; SWAR and lanes ms in turns, the byte
    bound, SWAR's pass A / pass B split;
31. 12-round lean scans with ``elementwise="swar"``: the headline, the
    suspicion headline, ``suspicion_rr``, ``headline(arc_align=4)``, main
    path D's scenario and ``headline(arc_align=4)`` under a split (every
    SWAR form): the SWAR kernel (one-pass) == its two-launch form == the
    SWAR plain version == the lanes kernel in lanes, carry and metrics;
32. main paths E and E': the headline and the ``bench --suspicion``
    headline with ``elementwise="swar"`` as phases 5 and 16 run them:
    exactly 100 K3 launches, all ``aligned_group/swar/onepass``; ms a round,
    rounds/s, K3 ms, the profiled split, and a report equal to the lanes
    run's of this invocation;
33. the separate-pass round with ``elementwise="swar"`` (the SWAR tick in
    torch ops): the eventful headline, 20 rounds, equal to the lanes run;
    the profiled ``round.tick`` beside phase 11's;
34. the frontier with ``--elementwise swar``: rounds/s and peak memory
    beside phase 22's, and the same detection fields;
35. K3's column-shard form (``col_offset``, subject-axis sharding): all 30
    instantiations (5 merge forms x crash-only / suspicion / + Lifeguard x
    lanes / SWAR) over the 4 shards ``[16,384 x 4,096]`` of one round on
    phase 30's inputs: each shard launch == the square launch's column
    slice, the shards' per-receiver partials sum to its counts, the
    shards at col_offset 0 and 12,288 == the plain version; then config
    4's layout, shards 0 and 7 of ``[131,072 x 16,384]`` (aligned arcs
    F = 16, lanes and SWAR, crash-only and suspicion) == plain; ``0
    entries differ`` and ms per launch beside the byte bound;
36. K2, K4 and K5 over the column blocks their main paths launch (K2
    G's ``[32,768 x 16,384]``, K4 ``full_scale``'s ``[65,536 x 8,192]``,
    K5 B sharded's ``[16,384 x 8,192]``), K2 over config 4's shard
    ``[131,072 x 16,384]`` (int16 hb, int8 view, F = 17) and over phase
    12's square ``[65,536 x 65,536]`` (int16 hb, int8 view, F = 16),
    against their plain versions on random lanes with dead receivers,
    detection stats and suspicion on and off (tolerance 0); ms, plain ms
    and byte bound;
37. main paths F and F': the headline (lanes, SWAR) sharded over 2 rank
    processes (rank r on cuda:r % cards: gloo through the host on a
    one-card machine, NCCL with a card each), 100 rounds, 1 % crash
    churn, 8 tracked crashes: the gathered lanes, carry and metrics equal
    the single-process run, the report phase 5's, exactly 100
    ``aligned_group`` (``/swar``) one-pass column-block launches a rank;
    ms a round, rounds/s, the all-reduce's ms a round; then both with
    ``rr_resident="off"`` in the same rank processes (the two-launch
    column-shard form), equal to the same single-process run;
38. main path G: config 4's fault model cut to N = 32,768 over 2 rank
    processes (16,384 columns a rank), 10 rounds: equal to the
    single-process run, 10 K2 launches a rank; beside it main path B
    sharded (``suspicion_rr(16_384)`` under rejoins, K5 over column
    blocks);
39. ``python -m gossipfs_tpu_torch.full_scale --n 65536 --rounds 16
    --devices 8``: 8 rank processes, 16 K4 launches each; its JSON beside
    ``FULLSCALE.json``'s ``current`` row, each rank's peak memory;
40. K3's one-pass form (f) (``csrc/rr_onepass.cu``, a thread-block
    cluster a column stripe) in all 30 instantiations (5 merge forms x
    crash-only / suspicion / + Lifeguard x lanes / SWAR), one round at N
    = 16,384 on phase 30's inputs: bit-equal to the plain version and to
    the two-launch form, square and over the 2 shards [16,384 x 8,192] of
    main paths F and F' (partial counts summing to the square launch's);
    ms of (f) and of the two-launch form in turns (three times each way,
    both over the same 10 rounds from the lanes after 20), the ms of (f)
    before its redesign beside them, the byte bound, the step timeline of
    the kernels line's rows, the clusters the card holds at once, each
    instantiation's static SASS count (``cuobjdump``, where the toolkit
    has it) and the SM clock before and after;
41. K3's two-launch form at the N only it runs (the one-pass form holds N
    <= 19,264): the aligned form of capacity (phase 6) and the
    explicit-edge form of the frontier (phases 22, 34) at N = 65,536,
    lanes and SWAR, crash-only and suspicion, the explicit-edge form of
    the PackedDetector (phase 23) at N = 49,152, and the aligned form over
    the last column block [65,536 x 8,192], lanes and SWAR, each against
    the plain version on random pre-tick lanes made on the card: ``0
    entries differ``; ms a round, each launch's ms under the profiler,
    plain ms and byte bound;
42. the geometry of K2 and K1 (``fm_info``, ``fx_info``: stripe columns,
    rows an item, ring stages and slots, shared memory, threads, blocks an
    SM, items), K4 and K5 at every shape they are timed at, with each
    kernel's registers and local memory a thread;
43. the obs plane (``obs/``, the flight recorder, the streaming monitor,
    the analyzer): ``bench --trace --monitor`` on the headline (3
    attempts) beside the bench without the flags, equal K3 launches, an ok
    verdict, the trace's FPR and detection counts equal to ``summarize``
    of the same run, rounds/s beside phase 5's; ``curves.sweep`` at N =
    1,024, 4,096 and 16,384 with a trace and the monitor, one K2 launch a
    round, each row's TTD, FPR and counts reproduced by ``analyze`` of its
    trace and the monitor equal to ``analyze``; ``SimDetector`` on config
    3 with a recorder, 30 rounds interactive against ``advance_bulk(30,
    snapshot_every=10)``: equal crash, hb_freeze and leave rows and first
    confirms, the recorder's ms a round beside the round's; the three
    gossip regression cases reproduced, and an ``outage`` campaign run at
    N = 16,384 (one K2 launch a round) equal to its run on the plain
    versions;
44. the conformance, curve and scenario runners: K2 against its plain
    version at the shapes they give it (the conformance column's N = 8,
    config 1's N = 10, the (t_fail, t_suspect) surface's N = 16,384 in
    its suspect form, timed); the conformance matrix over the oracle and
    the tensor column on the card (4 tensor families x 2 seeds, the
    oracle's self-check over all 24 cases), all agreeing, each card
    bundle equal to the CPU port's; ``curves.sweep_t_fail(n=16_384)``
    at 40 rounds a row (one K2 launch a round, the suspect form at
    t_suspect = 2) with its (3, 2) row equal to its plain re-run;
    ``curves.suspicion_sweep`` at N = 16,384, 40 rounds a row, on K2 and
    on ``pallas_rr`` + SWAR (K3), each loss
    suspect-t3 row equal to its plain re-run, the JAX package's two
    claims for these rows printed; ``python -m gossipfs_tpu_torch.run``
    for parity-10, sim-1k, sim-10k-crash and sim-100k cut to N = 32,768
    and 20 rounds (rounds/s and detection; parity-10's and sim-1k's
    outputs equal their plain re-runs); ``entry()``'s flagship step, 20
    steps equal to 20 plain steps;
45. the SDFS plane (``sdfs/``, ``erasure/``, ``traffic/``, ``cosim.py``):
    K2 against its plain version at the shapes its paths give it (the
    co-sim lane's N = 64 and the traffic case's N = 256, F = log2 N,
    int16 view, int32 hb; a [65,536 x 16,384] column block at config 5's
    int8 view and int16 hb, F = 16), timed; BASELINE config 5
    ``sim-100k-sdfs`` through ``run.run_scenario`` at N = 65,536 (131,072
    needs the lanes sharded), 16 rounds, 1,000 files: the detection
    report, the ``cosim`` dict (files readable, repair plans, elections,
    final alive, rounds/s) and one K2 launch a round, and at N = 4,096 on
    the kernels against the plain versions (equal reports, timings
    aside); the tensor planner's scale lane at N = 100,000 (2,048
    placements a round, budget 4,096, 24 rounds) equal row for row to
    the same lane on the CPU; the co-sim lane's four scenarios and the
    erasure matrix at n = 64 equal to their CPU runs (every count,
    repair curve and durability triple; every ``match`` true, nothing
    lost; each operation's p50 and p95 ms); ``campaigns.run_case`` on
    ``regressions/stripe_rackkill_n256.json`` (pass, lost 0, equal to
    the CPU run); ``erasure.codec`` encode and decode of a 4 MiB blob at
    k = 4, m = 2 equal to the numpy twins, with their ms;
46. the shim and the CLI (``shim/``, ``wire_ops.py``): the gRPC service's
    ``--topology random`` configuration at N = 16,384 (fanout 14) served
    on a localhost port and driven through ``ShimClient`` (8 puts of 1
    MiB, 3 crashes with a replica among them, Lsm, AliveNodes, Ls, Get
    byte for byte, Events, Vitals; ``AdvanceBulk(20, snapshot_every=5)``
    with Lsm answered from its snapshots, ``as_of_round`` rising), one
    K2 launch a round counted from the server's start to its stop, and
    the wire's ``Advance(1)`` and ``Lsm`` ms (median of 10) beside the
    in-process ``SimDetector.advance(1)`` and ``CoSim.tick(1)``; the CLI's
    ``--packed --n 49152`` configuration and co-sim fed a REPL script
    through ``dispatch`` (crashes dropped from node 0's list, put and get,
    ``metrics``, ``events``), its ``advance 1`` ms and K3's launches by
    form (that K3 shape is held against plain by phase 41); the same shim
    script on the card and on the CPU port at N = 1,024 (local and
    ``rpc`` election with the master crashed) and the ``--packed`` REPL
    script at ``packed_rr(1024, fanout=8)``: replies, printed text, event
    logs, detections, vitals and bytes read equal; K2 against its plain
    version at [16,384 x 16,384] (F = 14, int16 view, int32 hb), N =
    1,024 and wire_ops' N = 16, timed; ``wire_ops.run`` with seeded 4.0
    MB and 3.2 MB payloads, n = 16, 5 reps: its rows, healed and
    byte-identical after the repair;
47. the bench and utils tail: K2 against its plain version over config
    5's [16,384 x 8,192] rank block (F = 14, int16 hb), at the soak's N =
    4,096 (F = 12; int32, int16, int8 hb) and roundprof's N = 16,384 (F =
    14; int16, int8 hb), K4 at roundprof's arc rows (F = 14), tolerance
    0, timed; config 5 (``run.run_scenario("sim-100k-sdfs",
    devices=2)``) at N = 16,384 over 2 rank processes sharing the card
    (gloo), its report equal to the one-process run's, each rank's K2
    launches, peak memory and rounds/s; ``roundprof`` at N = 16,384, every
    row of ``variants`` and ``suspicion_variants(interpret=False)`` at 10
    rounds (a lean row with its two-launch twin): route, launches, ms a
    round and the bandwidth block against 3,350 GB/s, each row's 2 rounds
    equal on the kernels and the plain versions; the soak cut (int8 and
    int16 against int32, N = 4,096, 1 chunk of 300 rounds: PASS);
    checkpoint/resume of the headline and config 3 (saved at round 10,
    restored, also into another hb dtype and onto 2 ranks, against the
    uninterrupted run); the profiler seam (``utils.profiling.trace``
    around 10 headline rounds, its rows mapped to K-names, K3's count
    against the launch counters; ``time_rounds`` beside
    ``bench.timed_run``; ``bench --xprof``; ``sweep_merge``);
48. the socket engines: K2 against its plain version at the campaign
    replays' n = 256 (F = 8) and n = 24 (F = 5, int16 view, int32 hb,
    crash-only form) and at N = 8 (F = 3, both forms), tolerance 0, timed;
    ``python -m gossipfs_tpu_torch.campaigns --case
    regressions/outage_storm_n256.json --engine native`` (the C++ epoll
    engine at the committed n = 256) and ``--case
    regressions/outage_mild_udp_n24.json --engine udp`` (the asyncio
    engine), each through the CLI's ``main`` with the launch counts zeroed
    just before and read just after: ``reproduced``, the verdict agreeing
    with the tensor replay on the card, one K2 launch a replay round; the
    native per-round tick histogram, each engine's period and wire bytes;
    each replay's scan on the kernels against the plain versions (lanes,
    carry, per-round metrics: 0 entries differ; the monitor row equal)
    with its ms a round (CUDA events); ``python -m
    gossipfs_tpu_torch.conformance --replay`` over reference, tensor,
    udp and native for leave_broadcast, direct_confirm and refute_race at
    seed 0 (every row ok; one K2 launch a tensor round; each tensor bundle
    equal to the CPU's); ``native_rt`` (n = 32, period 5 ms, 200 rounds:
    the crash detected within 15 rounds); the deploy lane
    (``--engine deploy --scale-n 8``: eight node processes, verdict
    agreement);
49. the static analyzer and the parity soak: ``python -m
    gossipfs_tpu_torch.analysis --probe`` through its main (every AST
    rule clean over the port's sources, and the shared-memory budget
    probe on the card: exit 0); that run's reconciliation kernel by kernel
    (K3's one-pass form at N = 16,384 and 19,264, K5 at ``STRIPE_MAX_N``,
    K4's window tile at the largest F it holds and van Herk past it, K2
    and K1 at ``MAX_KERNEL_FANOUT``: the Python formula's bytes equal to
    the kernel's own info and to ``cudaFuncGetAttributes``' opt-in
    maximum, one counted launch at each edge shape); ``spec_verify``
    (``ok``: the tree clean, each spec rule red on its fixture); ``python
    -m gossipfs_tpu_torch.parity_soak`` at N = 16,384, 0.5 % crash churn,
    ``PARITY_ROUNDS`` rounds a variant (lanes, SWAR, ``--suspicion``,
    ``--scenario``): the lean loop (one K3 launch a round, one-pass)
    against the separate-pass loop (one K4 launch a round; the masked
    group form in torch ops under the scenario), each with the launch
    counts zeroed just before and read just after: every lane, the carry
    and every metric 0 entries differ.

Phase 40's times are one JSON line (``{"onepass": ...}``) after phase
41.  The last four lines printed are the kernels JSON (the five kernels;
K3's one-pass form per merge form and SWAR form in its paths' modes and
over F/F''s blocks, its two-launch form once per merge form and once per
SWAR form and at phase 41's shapes, the column-shard forms of K3, K2, K4
and K5, K2 at phase 45's, phase 46's and phase 47's shapes, K3 at the
CLI --packed's, K4 at roundprof's, K2 at phase 48's), every main path's
ms a round,
rounds/s and launch counts (one JSON line: capacity, the frontier and the
detector's advance as phases 6, 22, 34 and 23; config 4's fault model as
phase 12, with K2's ms a round; phase 43's bench, recorder and campaign
run as ``"43 ..."``; phase 44's and 45's totals, phase 46's as ``"shim"``,
phase 47's as ``"47 ..."``, phase 48's seconds as ``"48"``), the
``nvidia-smi`` name and power limit, and
the device JSON.  Just before them, one ``{"phase_details": ...}`` line
holds each path's ``rr_resident="off"`` run as ``"<phase> off"`` and the
per-part documents of phases 43-49.  The last four lines are compact
(floats to 5 significant digits), so that they fit in the last 24,000
bytes of output.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12   # HBM3 rate of the H100 SXM (data sheet)
N_MAIN = 16_384
N_CAPACITY = 65_536
N_ADVANCE = 49_152             # PackedDetector's capacity point
# rounds of the eventful separate-pass paths (phases 11 and 17) and of
# the profiled stage splits, cut from 100 and 10 to keep the whole run
# inside its time limit
EVENTFUL_ROUNDS = 50
SPLIT_ROUNDS = 5
# rounds a row of phase 44's curve sweeps, cut from their default 60 (the
# tracked crashes at round 10 are confirmed by round 26 at t_fail 12 +
# t_suspect 2)
SWEEP_ROUNDS = 30
_T0 = time.perf_counter()
SEED = 20_261_016


def log(msg: str) -> None:
    """Print a line; a phase's header (``[N] ...``) gets the seconds since
    the script started."""
    if msg.startswith("["):
        msg = f"{msg} (at {time.perf_counter() - _T0:.1f} s)"
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, reset=None) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls; ``reset``
    (untimed, first) puts back the inputs the calls update in place, so
    that every timed run walks the same rounds."""
    import torch

    if reset is not None:
        reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_round_inputs(n: int, seed: int):
    """Pre-tick lanes and per-round vectors exercising every corner."""
    import numpy as np
    import torch

    from gossipfs_tpu_torch.config import AGE_CLAMP, INT8_REBASE_WINDOW
    from gossipfs_tpu_torch.ops import merge

    rng = np.random.default_rng(seed)
    hb = rng.integers(-128, 128, (n, n), dtype=np.int8)
    hb[rng.random((n, n), dtype=np.float32) < 0.05] = -128   # never sent
    age = rng.integers(0, AGE_CLAMP + 1, (n, n), dtype=np.int8)
    st = rng.integers(0, 3, (n, n), dtype=np.int8)
    asl = ((age.astype(np.int16) << 2 | st) - 128).astype(np.int8)
    flags = rng.choice(np.array([0, 4, 5, 6, 1, 7], np.int8), n)
    sa = rng.integers(-260, 60, n).astype(np.int32)   # < -128: deep shifts
    sb = np.where(rng.random(n) < 0.5, sa, rng.integers(-260, 60, n))
    g = rng.integers(-200, 60, n).astype(np.int32)
    bases = (rng.integers(0, n // 8, n) * 8).astype(np.int32)
    dev = "cuda"
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    vecs = merge.threshold_stack(t(sa), t(sb.astype(np.int32)), t(g),
                                 INT8_REBASE_WINDOW)
    return t(hb), t(asl), t(flags), vecs, t(bases)


def phase_kernel_vs_plain(n: int, results: dict) -> None:
    import torch

    from gossipfs_tpu_torch.ops import merge

    hb, asl, flags, vecs, bases = random_round_inputs(n, SEED)
    kw = dict(fanout=16, arc_align=8, t_fail=5, t_cooldown=12)
    names = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt")
    got = merge.resident_round(hb.clone(), asl.clone(), flags, vecs, bases,
                               **kw)
    want = merge.resident_round_plain(hb.clone(), asl.clone(), flags, vecs,
                                      bases, **kw)
    torch.cuda.synchronize()
    err = 0
    for name, a, b in zip(names, got, want):
        diff = (a.to(torch.int64) - b.to(torch.int64)).abs()
        e = int(diff.max())
        err = max(err, e)
        log(f"  {name}: {int((diff != 0).sum())} entries differ, "
            f"max |diff| {e}")
    # tolerance 0: every output is an integer, so any difference is a fault
    if err:
        raise AssertionError("kernel != plain on one round")
    log(f"  n_det total {int(got[3].sum())}, columns fired "
        f"{int((got[4] < n).sum())}: kernel == plain bit for bit "
        "(tolerance 0)")
    # times at the main path's shape; the lanes evolve in place across
    # reps, which changes no byte count.  537 MB of lanes >> 50 MB of L2
    h2, a2 = hb.clone(), asl.clone()
    run_k = lambda: merge.resident_round(h2, a2, flags, vecs, bases, **kw)  # noqa: E731
    run_p = lambda: merge.resident_round_plain(h2, a2, flags, vecs, bases, **kw)  # noqa: E731
    run_k()
    run_p()
    kernel_ms = [cuda_ms(run_k, 20), cuda_ms(run_k, 20)]
    plain_ms = cuda_ms(run_p, 3)
    kernel_ms.append(cuda_ms(run_k, 20))
    # bytes the function must move: each input once (lanes 2 N^2, flags,
    # 11-row stack, int32 bases), each output once (lanes 2 N^2, four
    # int32 [N] reductions)
    floor_bytes = 4 * n * n + n * (1 + 11 + 4) + 4 * 4 * n
    results["kernel"] = dict(
        max_abs_err=err, ms=min(kernel_ms), ms_runs=kernel_ms,
        plain_ms=plain_ms, bound_ms=floor_bytes / H100_BYTES_PER_S * 1e3,
        floor_bytes=floor_bytes)
    log(f"  kernel {min(kernel_ms):.4f} ms (runs {kernel_ms}), plain "
        f"{plain_ms:.3f} ms, byte bound {results['kernel']['bound_ms']:.4f}"
        f" ms ({floor_bytes} B)")


def phase_scan_vs_plain(rounds: int) -> None:
    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state

    cfg = SimConfig.headline(N_MAIN)
    out = {}
    for plain in (False, True):
        key = trandom.PRNGKey(7, device="cuda")
        out[plain] = run_rounds(init_state(cfg), cfg, rounds, key,
                                crash_rate=0.05, plain=plain)
    torch.cuda.synchronize()
    (sk, ck, mk), (sp, cp, mp) = out[False], out[True]
    pairs = [("hb", sk.hb, sp.hb), ("asl", sk.asl, sp.asl),
             ("alive", sk.alive, sp.alive), ("hb_base", sk.hb_base, sp.hb_base)]
    pairs += [(f, getattr(ck, f), getattr(cp, f)) for f in ck._fields]
    pairs += [(f, getattr(mk, f), getattr(mp, f)) for f in mk._fields]
    bad = [name for name, a, b in pairs if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"kernel scan != plain scan in {bad}")
    log(f"  {rounds} rounds: lanes, carry and metrics bit-equal "
        f"(detections {int(mk.true_detections.sum())}, false positives "
        f"{int(mk.false_positives.sum())}, alive {int(mk.n_alive[-1])})")


def phase_main_path(results: dict) -> None:
    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.bench import CRASH_RATE, ROUNDS, tracked_crash_events
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.metrics.detection import summarize
    from gossipfs_tpu_torch.ops import merge

    cfg = SimConfig.headline(N_MAIN)
    events, crash_rounds, churn_ok = tracked_crash_events(cfg, ROUNDS, 8, 20)
    warm_both_forms(cfg, dict(crash_rate=CRASH_RATE, churn_ok=churn_ok))
    state = init_state(cfg)
    key = trandom.PRNGKey(0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    with merge.record_launch_events() as evs:
        final, carry, per_round = run_rounds(
            state, cfg, ROUNDS, key, events=events, crash_rate=CRASH_RATE,
            churn_ok=churn_ok, crash_only_events=True)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(merge.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    check_onepass("main path 5", "aligned_group", ROUNDS)
    kernel_ms = sum(s.elapsed_time(e) for s, e in evs) / ROUNDS
    rep = summarize(carry, per_round, crash_rounds)
    ttd = sorted(rep.ttd_first.values())
    conv = sorted(rep.ttd_converged.values())
    log(f"  {ROUNDS} rounds in {wall:.4f} s: {ROUNDS / wall:.2f} rounds/s; "
        f"whole round {wall / ROUNDS * 1e3:.4f} ms, kernel "
        f"{kernel_ms:.4f} ms/round (CUDA events around each launch)")
    log(f"  launches {launch_counts()} (1 per round: K3's one-pass form, "
        f"one CUDA kernel); peak memory {peak / 2**30:.3f} GiB")
    log(f"  tracked ttd_first {ttd}, ttd_converged {conv}; FPR "
        f"{rep.false_positive_rate:.3e} ({rep.false_positives} false "
        f"positives), true detections {rep.true_detections}, final alive "
        f"{rep.final_alive}")
    if min(ttd) < 1 or max(ttd) > 3 * cfg.t_fail:
        raise AssertionError(f"tracked crashes detected at {ttd}")
    if rep.false_positive_rate > 1e-3 or rep.final_alive >= cfg.n:
        raise AssertionError("main path output out of range")
    results["main"] = dict(launches=launches["resident_round"],
                           rounds_per_s=ROUNDS / wall, kernel_ms=kernel_ms,
                           round_ms=wall / ROUNDS * 1e3,
                           launch_counts=launch_counts(),
                           report=rep.as_dict())
    resident_off_twin("main path 5", cfg, ROUNDS, dict(
        events=events, crash_rate=CRASH_RATE, churn_ok=churn_ok,
        crash_only_events=True), 0, (final, carry, per_round),
        results["main"])


def phase_capacity(rounds: int, results: dict) -> None:
    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.ops import merge

    cfg = SimConfig.headline(N_CAPACITY)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg)
    key = trandom.PRNGKey(1, device="cuda")
    state, _, _ = run_rounds(state, cfg, 1, key)  # allocator warm-up
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    final, _, per_round = run_rounds(state, cfg, rounds, key, crash_rate=0.01)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    alive = per_round.n_alive.cpu()
    if not (0 < int(alive[-1]) < cfg.n and final.round == rounds + 1):
        raise AssertionError("capacity run out of range")
    # K3's two-launch form (N = 65,536 is past the one-pass form's reach)
    if merge.FORM_LAUNCHES["aligned_group"] != rounds:
        raise AssertionError(f"capacity launches {launch_counts()}")
    results["capacity"] = dict(round_ms=wall / rounds * 1e3,
                               rounds_per_s=rounds / wall,
                               launches=rounds, launch_counts=launch_counts())
    log(f"  N={cfg.n}: {rounds} rounds in {wall:.4f} s, "
        f"{rounds / wall:.3f} rounds/s ({wall / rounds * 1e3:.4f} ms a "
        f"round); launches {launch_counts()}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; alive "
        f"{int(alive[-1])}")
    del state, final
    torch.cuda.empty_cache()


def launch_counts() -> dict:
    """The nonzero launch counts of the run just made: each kernel
    wrapper's, and the resident round's again by merge form."""
    from gossipfs_tpu_torch.ops import merge

    out = {k: v for k, v in merge.LAUNCH_COUNTS.items() if v}
    out.update({f"resident_round[{k}]": v
                for k, v in merge.FORM_LAUNCHES.items() if v})
    return out


# the launch-count suffix of K3's one-pass form (f)
ONEPASS = "/onepass"


def check_onepass(label: str, form: str, rounds: int) -> None:
    """The run just made launched K3 ``rounds`` times, one launch a round,
    all in ``form``'s one-pass form (f), and no other kernel."""
    from gossipfs_tpu_torch.ops import merge

    forms = {k: v for k, v in merge.FORM_LAUNCHES.items() if v}
    others = {k: v for k, v in merge.LAUNCH_COUNTS.items()
              if v and k != "resident_round"}
    if forms != {form + ONEPASS: rounds} or others:
        raise AssertionError(f"{label}: launched {merge.LAUNCH_COUNTS} "
                             f"{forms}, want {rounds} {form}{ONEPASS}")


def warm_both_forms(cfg, run_kw: dict) -> None:
    """One untimed round of ``cfg`` in each of K3's lean forms, the one-pass
    form (f) and ``rr_resident="off"``'s two-launch form, before a main path
    and its off twin are timed: each form's first launch (its library's
    load, the module's lazy load, the cluster occupancy query) then lands
    outside both host-clock windows."""
    import dataclasses

    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state

    kw = {k: v for k, v in run_kw.items()
          if k not in ("events", "crash_only_events")}
    for c in (cfg, dataclasses.replace(cfg, rr_resident="off")):
        run_rounds(init_state(c), c, 1, trandom.PRNGKey(1, device="cuda"),
                   **kw)
    torch.cuda.synchronize()


def resident_off_twin(label: str, cfg, rounds: int, run_kw: dict, seed: int,
                      auto_out, row: dict) -> None:
    """The main path ``label`` once more with ``rr_resident="off"`` (K3's
    two-launch form) from the same state, key and arguments: its lanes,
    carry and metrics must equal the one-pass run's ``auto_out`` (state,
    carry, metrics), and every K3 launch be a two-launch form.  Its ms a
    round, rounds/s and launches go into ``row["off"]``."""
    import dataclasses

    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.ops import merge

    off = dataclasses.replace(cfg, rr_resident="off")
    state = init_state(off)
    key = trandom.PRNGKey(seed, device="cuda")
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    out = run_rounds(state, off, rounds, key, **run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    forms = {k: v for k, v in merge.FORM_LAUNCHES.items() if v}
    if (merge.LAUNCH_COUNTS["resident_round"] != rounds
            or sum(forms.values()) != rounds
            or any(k.endswith(ONEPASS) for k in forms)):
        raise AssertionError(f"{label}, rr_resident='off': launched "
                             f"{merge.LAUNCH_COUNTS} {forms}")
    same = run_digest(*out) == run_digest(*auto_out)
    row["off"] = dict(round_ms=wall / rounds * 1e3, rounds_per_s=rounds / wall,
                      launches=rounds, launch_counts=launch_counts())
    log(f"  {label}, rr_resident='off' (the two-launch form, {forms}): "
        f"{wall / rounds * 1e3:.4f} ms a round, {rounds / wall:.2f} rounds/s"
        f", against the one-pass run's {row['round_ms']:.4f} ms; lanes, "
        f"carry and metrics {'==' if same else '!='} the one-pass run's")
    if not same:
        raise AssertionError(f"{label}: rr_resident='off' != the one-pass "
                             "run")


def diff_report(names, got, want) -> int:
    """Log each output's differing entries; return the largest |diff|."""
    import torch

    err = 0
    for name, a, b in zip(names, got, want):
        diff = (a.to(torch.int64) - b.to(torch.int64)).abs()
        e = int(diff.max()) if diff.numel() else 0
        err = max(err, e)
        log(f"    {name}: {int((diff != 0).sum())} entries differ, "
            f"max |diff| {e}")
    return err


def merge_inputs(n: int, fanout: int, vdt, hdt, seed: int, aligned=False,
                 statuses: int = 3):
    """Corner-case inputs of one merge call, made with numpy: post-tick
    lanes over the first ``statuses`` statuses (4: SUSPECT too), ages up
    to 63 (a fifth at 0: fresh detections), floor sentinels, deep and
    negative shifts, dead receivers (whose view rows are absent: a dead
    node never sends).  Returns (view, edges, bases, hb, asl, shift_a,
    shift_b, alive) on the card."""
    import numpy as np
    import torch

    from gossipfs_tpu_torch.ops.merge import pack_age_status

    rng = np.random.default_rng(seed)
    lo, hi = {np.int8: (-128, 127), np.int16: (-32768, 32767),
              np.int32: (-2**20, 2**20)}[hdt]
    top = 126 if vdt == np.int8 else 16_384
    alive = rng.random(n) < 0.8
    view = rng.integers(-1, top + 1, (n, n), dtype=np.int32).astype(vdt)
    view[~alive] = -1
    hb = rng.integers(lo, hi + 1, (n, n), dtype=np.int32).astype(hdt)
    hb[rng.random((n, n), dtype=np.float32) < 0.05] = np.iinfo(hdt).min
    age = rng.integers(0, 64, (n, n), dtype=np.int8)
    age[rng.random((n, n), dtype=np.float32) < 0.2] = 0
    st = rng.integers(0, statuses, (n, n), dtype=np.int8)
    sa = rng.integers(-70_000, 70_000, n).astype(np.int32)
    sb = np.where(rng.random(n) < 0.5, sa,
                  rng.integers(-70_000, 70_000, n)).astype(np.int32)
    edges = rng.integers(0, n, (n, fanout)).astype(np.int32)
    bases = rng.integers(0, n, n).astype(np.int32)
    if aligned:
        bases = bases // 8 * 8
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to("cuda")  # noqa: E731
    asl = pack_age_status(t(age), t(st))
    return (t(view), t(edges), t(bases), t(hb), asl, t(sa), t(sb), t(alive))


MERGE_OUTS = ("hb", "asl", "cnt_incl", "n_det", "first_obs", "refuted",
              "held")


def merge_bound_bytes(view, senders, hb, outputs: int = 3) -> int:
    """Bytes one merge must move: view, senders, shifts and alive read
    once; hb and asl read and written once; ``outputs`` int32 [N]
    reductions (5 in the suspect form)."""
    n = hb.shape[0]
    return (view.numel() * view.element_size()
            + senders.numel() * senders.element_size()
            + 2 * hb.numel() * hb.element_size() + 2 * n * n
            + n * (4 + 4 + 1) + outputs * 4 * n)


def time_merge(fn, plain, args, kw, results: dict, key: str) -> None:
    """Kernel ms (best of 3 x 20 calls), plain ms (3 calls) and the byte
    bound, on one shape; the lanes evolve in place across calls, which
    changes no byte count."""
    view, senders, hb, asl = args[0], args[1], args[2].clone(), args[3].clone()
    rest = args[4:]
    run_k = lambda: fn(view, senders, hb, asl, *rest, **kw)  # noqa: E731
    run_p = lambda: plain(view, senders, hb, asl, *rest, **kw)  # noqa: E731
    run_k()
    run_p()
    kernel_ms = [cuda_ms(run_k, 20), cuda_ms(run_k, 20)]
    plain_ms = cuda_ms(run_p, 3)
    kernel_ms.append(cuda_ms(run_k, 20))
    floor_bytes = merge_bound_bytes(view, senders, hb,
                                    5 if kw.get("suspect") else 3)
    results[key].update(
        ms=min(kernel_ms), ms_runs=kernel_ms, plain_ms=plain_ms,
        bound_ms=floor_bytes / H100_BYTES_PER_S * 1e3,
        floor_bytes=floor_bytes)
    log(f"  {key}: kernel {min(kernel_ms):.4f} ms (runs {kernel_ms}), plain "
        f"{plain_ms:.3f} ms, byte bound "
        f"{results[key]['bound_ms']:.4f} ms ({floor_bytes} B)")


def compare_merge(fn, plain, args, kw) -> int:
    import torch

    view, senders, hb, asl, *rest = args
    got = fn(view, senders, hb.clone(), asl.clone(), *rest, **kw)
    want = plain(view, senders, hb.clone(), asl.clone(), *rest, **kw)
    torch.cuda.synchronize()
    return diff_report(MERGE_OUTS, got, want)


def phase_k2(results: dict) -> None:
    import numpy as np

    from gossipfs_tpu_torch.ops import merge_update as mu

    shapes = [("config 3", 10_240, 14, np.int8, np.int16),
              ("ring", 1_024, 3, np.int16, np.int32),
              ("all-int8", N_MAIN, 16, np.int8, np.int8),
              # N % 4 != 0: the element-load path (config 1's N = 10)
              ("ragged", 1_030, 5, np.int8, np.int16)]
    err = 0
    timing_args = None
    for label, n, f, vdt, hdt in shapes:
        view, edges, _, hb, asl, sa, sb, alive = merge_inputs(
            n, f, vdt, hdt, SEED + n)
        args = (view, edges, hb, asl, sa, sb, alive)
        for det in (False, True):
            log(f"  {label}: N={n}, F={f}, view {vdt.__name__}, hb "
                f"{hdt.__name__}, detect_stats={det}")
            err = max(err, compare_merge(mu.fused_merge_update,
                                         mu.fused_merge_update_plain, args,
                                         dict(detect_stats=det)))
        if label == "config 3":
            timing_args = args
    # tolerance 0: every output is an integer, so any difference is a fault
    if err:
        raise AssertionError("K2 != plain")
    log("  K2 == plain bit for bit on every shape (tolerance 0)")
    results["k2"] = dict(max_abs_err=err)
    time_merge(mu.fused_merge_update, mu.fused_merge_update_plain,
               timing_args, dict(detect_stats=True), results, "k2")


def phase_k4(results: dict) -> None:
    import numpy as np

    from gossipfs_tpu_torch.ops import merge_update as mu

    err = 0
    # the ragged shape (int16 view, int32 lanes, F not dividing N) runs
    # the element-load path
    for n, f, vdt, hdt, aligned in ((1_030, 13, np.int16, np.int32, False),
                                    (N_MAIN, 16, np.int8, np.int8, True),
                                    (N_MAIN, 16, np.int8, np.int8, False)):
        view, _, bases, hb, asl, sa, sb, alive = merge_inputs(
            n, f, vdt, hdt, SEED + int(aligned), aligned)
        args = (view, bases, hb, asl, sa, sb, alive)
        for det in (False, True):
            log(f"  N={n}, F={f}, view {vdt.__name__}, hb {hdt.__name__}, "
                f"{'aligned' if aligned else 'plain'} bases, "
                f"detect_stats={det}")
            err = max(err, compare_merge(
                mu.arc_merge_update, mu.arc_merge_update_plain, args,
                dict(fanout=f, detect_stats=det)))
    timing_args = args
    # F = K4_LONG_F: the halo outgrows a window tile, so K4 computes the
    # window max by van Herk segments
    import torch

    view, _, bases, hb, asl, sa, sb, alive = big_merge_inputs(
        N_MAIN, N_MAIN, 1, torch.int8, SEED + 8)
    args = (view, bases, hb, asl, sa, sb, alive)
    for det in (False, True):
        log(f"  N={N_MAIN}, F={K4_LONG_F} (van Herk window), view int8, hb "
            f"int8, detect_stats={det}")
        err = max(err, compare_merge(
            mu.arc_merge_update, mu.arc_merge_update_plain, args,
            dict(fanout=K4_LONG_F, detect_stats=det)))
    del view, hb, asl, args
    if err:
        raise AssertionError("K4 != plain")
    log("  K4 == plain bit for bit (tolerance 0)")
    results["k4"] = dict(max_abs_err=err)
    time_merge(mu.arc_merge_update, mu.arc_merge_update_plain, timing_args,
               dict(fanout=16, detect_stats=True), results, "k4")


def phase_general_scan_vs_plain(rounds: int) -> None:
    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.models.presets import ALL

    runs = [("config 1", ALL["parity-10"].config, 0.05, 0.05),
            ("config 2", ALL["sim-1k"].config, 0.02, 0.02),
            ("config 3", ALL["sim-10k-crash"].config, 0.05, 0.05),
            ("headline", SimConfig.headline(N_MAIN), 0.02, 0.02)]
    for label, cfg, crash, rejoin in runs:
        out = {}
        for plain in (False, True):
            key = trandom.PRNGKey(7, device="cuda")
            out[plain] = run_rounds(init_state(cfg), cfg, rounds, key,
                                    crash_rate=crash, rejoin_rate=rejoin,
                                    plain=plain)
        torch.cuda.synchronize()
        (sk, ck, mk), (sp, cp, mp) = out[False], out[True]
        pairs = [("hb", sk.hb, sp.hb), ("asl", sk.asl, sp.asl),
                 ("alive", sk.alive, sp.alive),
                 ("hb_base", sk.hb_base, sp.hb_base)]
        pairs += [(f, getattr(ck, f), getattr(cp, f)) for f in ck._fields]
        pairs += [(f, getattr(mk, f), getattr(mp, f)) for f in mk._fields]
        bad = [name for name, a, b in pairs if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"{label}: kernel scan != plain scan in {bad}")
        log(f"  {label} (N={cfg.n}, {cfg.topology}, hb {cfg.hb_dtype}), "
            f"{rounds} rounds at {crash:.0%} crash / {rejoin:.0%} rejoin: "
            f"lanes, carry and metrics bit-equal (detections "
            f"{int(mk.true_detections.sum())}, false positives "
            f"{int(mk.false_positives.sum())}, alive {int(mk.n_alive[-1])})")


def phase_flagship_step_vs_plain(rounds: int) -> None:
    """The flagship one-round step (``gossip_round`` on the JAX package's
    ``__graft_entry__`` config, N = 256) round by round, kernel against
    plain, with a crash, a LEAVE broadcast and a rejoin on the way."""
    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.core.rounds import gossip_round
    from gossipfs_tpu_torch.core.state import RoundEvents, init_state
    from gossipfs_tpu_torch.core.topology import random_in_edges

    n = 256
    cfg = SimConfig(n=n, topology="random", fanout=SimConfig.log_fanout(n),
                    remove_broadcast=False, fresh_cooldown=True,
                    merge_kernel="pallas", view_dtype="int8",
                    hb_dtype="int16")
    states = {p: init_state(cfg) for p in (False, True)}
    for r in range(rounds):
        ev = RoundEvents.none(1, n, device="cuda")
        ev = RoundEvents(*(m[0].clone() for m in ev))
        ev.crash[[3, 50]] = r == 1
        ev.leave[7] = r == 2
        ev.join[[3, 7]] = r == 12
        edges = random_in_edges(trandom.PRNGKey(r, device="cuda"), n,
                                cfg.fanout)
        outs = {p: gossip_round(states[p], ev, edges, cfg, plain=p)
                for p in (False, True)}
        states = {p: outs[p][0] for p in outs}
        (sk, mk, fk, ok), (sp, mp, fp, op) = outs[False], outs[True]
        pairs = [sk.hb, sp.hb, sk.asl, sp.asl, sk.alive, sp.alive, fk, fp,
                 ok, op, *[t for pair in zip(mk, mp) for t in pair]]
        if not all(torch.equal(a, b) for a, b in zip(pairs[::2],
                                                     pairs[1::2])):
            raise AssertionError(f"gossip_round kernel != plain, round {r}")
    log(f"  flagship gossip_round (N={n}, random, hb int16), {rounds} "
        f"rounds: state, metrics, any_fail and first_obs bit-equal "
        f"(alive {int(sk.alive.sum())})")


def timed_main_path(cfg, rounds: int, run_kw: dict, kernel: str):
    """One ``run_rounds`` call from a fresh state with the launch counts
    zeroed just before and read just after.  Returns (carry, per_round,
    launches, wall seconds, kernel ms per round, peak bytes, final
    state)."""
    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.ops import merge

    state = init_state(cfg)
    key = trandom.PRNGKey(0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    with merge.record_launch_events() as evs:
        final, carry, per_round = run_rounds(state, cfg, rounds, key,
                                             **run_kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(merge.LAUNCH_COUNTS)
    want = {k: (rounds if k == kernel else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"main path launched {launches}, want {want}")
    kernel_ms = sum(s.elapsed_time(e) for s, e in evs) / rounds
    peak = torch.cuda.max_memory_allocated()
    log(f"  {rounds} rounds in {wall:.4f} s: {rounds / wall:.2f} rounds/s; "
        f"whole round {wall / rounds * 1e3:.4f} ms, {kernel} "
        f"{kernel_ms:.4f} ms/round (CUDA events around each launch)")
    log(f"  launches {launch_counts()}; peak memory {peak / 2**30:.3f} GiB")
    return carry, per_round, launches, wall, kernel_ms, peak, final


def stage_split(cfg, rounds: int, run_kw: dict, round_ms: float) -> dict:
    """Device ms per round of each stage of the separate-pass round (the
    ``record_function`` ranges of core/rounds.STAGES) under
    ``torch.profiler``, over ``rounds`` rounds from a fresh state, beside
    the device's busy ms per round and its share of ``round_ms`` (the
    unprofiled whole round of the same configuration)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.core.rounds import STAGES, run_rounds
    from gossipfs_tpu_torch.core.state import init_state

    state = init_state(cfg)
    key = trandom.PRNGKey(3, device="cuda")
    state, _, _ = run_rounds(state, cfg, 2, key, **run_kw)   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_rounds(state, cfg, rounds, key, **run_kw)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / rounds
    split = {e.key: e.device_time_total / 1e3 / rounds for e in events
             if e.key in STAGES and e.device_type == DeviceType.CPU}
    # the merge kernels launch from their ctypes library, outside any torch
    # op, so the trace does not tie them to the "round.merge" range: add
    # their device time by kernel name
    split["round.merge"] = split.get("round.merge", 0.0) + sum(
        e.self_device_time_total for e in kernels
        if any(k in e.key for k in ("fused_kernel", "window_max_kernel",
                                    "window_tile_kernel", "arc_rows_kernel",
                                    "stripe_kernel"))
    ) / 1e3 / rounds
    shares = ", ".join(f"{k.split('.')[1]} {v:.4f}" for k, v in
                       sorted(split.items(), key=lambda kv: -kv[1]))
    log(f"  device ms per round by stage ({rounds} profiled rounds): "
        f"{shares}; device busy {busy:.4f} ms per round, "
        f"{busy / round_ms:.1%} of the unprofiled {round_ms:.4f} ms round")
    return dict(split, busy_ms=busy)


def phase_config3_main(results: dict) -> None:
    from gossipfs_tpu_torch.bench import tracked_crash_events
    from gossipfs_tpu_torch.metrics.detection import summarize
    from gossipfs_tpu_torch.models.presets import ALL

    sc = ALL["sim-10k-crash"]
    cfg = sc.config
    events, crash_rounds, churn_ok = tracked_crash_events(cfg, sc.rounds, 8,
                                                          20)
    carry, per_round, launches, wall, kernel_ms, _, _ = timed_main_path(
        cfg, sc.rounds, dict(events=events, crash_rate=sc.crash_rate,
                             churn_ok=churn_ok, crash_only_events=True),
        "fused_merge_update")
    rep = summarize(carry, per_round, crash_rounds)
    ttd = sorted(rep.ttd_first.values())
    conv = sorted(rep.ttd_converged.values())
    log(f"  tracked ttd_first {ttd}, ttd_converged {conv}; FPR "
        f"{rep.false_positive_rate:.3e} ({rep.false_positives} false "
        f"positives), true detections {rep.true_detections}, final alive "
        f"{rep.final_alive}")
    if min(ttd) < 1 or max(ttd) > 3 * cfg.t_fail:
        raise AssertionError(f"tracked crashes detected at {ttd}")
    if rep.false_positive_rate > 1e-3 or not 0 < rep.final_alive < cfg.n:
        raise AssertionError("config 3 output out of range")
    results["config3"] = dict(launches=launches["fused_merge_update"],
                              rounds_per_s=sc.rounds / wall,
                              kernel_ms=kernel_ms,
                              round_ms=wall / sc.rounds * 1e3,
                              launch_counts=launch_counts())
    stage_split(cfg, SPLIT_ROUNDS, dict(crash_rate=sc.crash_rate),
                wall / sc.rounds * 1e3)


def phase_eventful_arc(results: dict, rounds: int) -> None:
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.metrics.detection import summarize

    cfg = SimConfig.headline(N_MAIN)
    kw = dict(crash_rate=0.01, rejoin_rate=0.01)
    carry, per_round, launches, wall, _, _, _ = timed_main_path(
        cfg, rounds, kw, "arc_merge_update")
    rep = summarize(carry, per_round)
    log(f"  FPR {rep.false_positive_rate:.3e}, true detections "
        f"{rep.true_detections}, final alive {rep.final_alive}")
    if rep.true_detections <= 0 or not 0 < rep.final_alive < cfg.n:
        raise AssertionError("eventful arc output out of range")
    results["arc"] = dict(launches=launches["arc_merge_update"],
                          rounds_per_s=rounds / wall,
                          round_ms=wall / rounds * 1e3,
                          launch_counts=launch_counts())
    results["arc"]["split"] = stage_split(cfg, SPLIT_ROUNDS, kw,
                                          wall / rounds * 1e3)


def phase_config4_capacity(rounds: int, results: dict) -> None:
    import dataclasses

    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.models.presets import ALL
    from gossipfs_tpu_torch.ops import merge

    sc = ALL["sim-100k"]
    cfg = dataclasses.replace(sc.config, n=N_CAPACITY,
                              fanout=SimConfig.log_fanout(N_CAPACITY))
    kw = dict(crash_rate=sc.crash_rate, rejoin_rate=sc.rejoin_rate)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg)
    key = trandom.PRNGKey(1, device="cuda")
    state, _, _ = run_rounds(state, cfg, 1, key, **kw)  # allocator warm-up
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    with merge.record_launch_events() as evs:
        final, _, per_round = run_rounds(state, cfg, rounds, key, **kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(merge.LAUNCH_COUNTS)
    want = {k: (rounds if k == "fused_merge_update" else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"config 4 capacity launched {launches}, want "
                             f"{want}")
    # K2's device time: CUDA events around each of its launches
    k2_ms = sum(s.elapsed_time(e) for s, e in evs) / rounds
    alive = per_round.n_alive.cpu()
    log(f"  N={cfg.n}, fanout {cfg.fanout}, hb {cfg.hb_dtype}, view "
        f"{cfg.view_dtype}: {rounds} rounds in {wall:.4f} s, "
        f"{rounds / wall:.3f} rounds/s; whole round "
        f"{wall / rounds * 1e3:.4f} ms, K2 fused_merge_update "
        f"{k2_ms:.4f} ms a round (CUDA events around each launch); peak "
        f"memory {peak / 2**30:.3f} GiB; alive {int(alive[-1])}")
    if peak >= 40 * 2**30:
        raise AssertionError(f"capacity peak {peak / 2**30:.3f} GiB >= 40")
    if not (0 < int(alive[-1]) < cfg.n and final.round == rounds + 1):
        raise AssertionError("config 4 capacity run out of range")
    results["config4"] = dict(round_ms=wall / rounds * 1e3,
                              rounds_per_s=rounds / wall, kernel_ms=k2_ms,
                              launch_counts=launch_counts())


SUS_KW = dict(t_fail=3, t_cooldown=12, fanout=16, arc_align=8)


def suspicion_round_inputs(n: int, seed: int):
    """Pre-tick lanes for one suspicion round: every status, SUSPECT
    entries at ages 3..13 (both sides of the confirm ages 5 and 11 of
    t_fail 3, t_suspect 2, lh_multiplier 3), never-sent entries, flags
    with bit 4 on half the rows, deep shifts."""
    import numpy as np
    import torch

    from gossipfs_tpu_torch.config import AGE_CLAMP, INT8_REBASE_WINDOW
    from gossipfs_tpu_torch.ops import merge

    rng = np.random.default_rng(seed)
    hb = rng.integers(-128, 128, (n, n), dtype=np.int8)
    hb[rng.random((n, n), dtype=np.float32) < 0.05] = -128
    st = rng.integers(0, 4, (n, n), dtype=np.int8)
    age = rng.integers(0, AGE_CLAMP + 1, (n, n), dtype=np.int8)
    age = np.where(st == 3, rng.integers(3, 14, (n, n), dtype=np.int8), age)
    asl = ((age.astype(np.int16) << 2 | st) - 128).astype(np.int8)
    flags = rng.choice(np.array([0, 4, 5, 6, 1, 7], np.int8), n)
    flags = flags + (16 * (rng.random(n) < 0.5)).astype(np.int8)
    sa = rng.integers(-260, 60, n).astype(np.int32)
    g = rng.integers(-200, 60, n).astype(np.int32)
    bases = (rng.integers(0, n // 8, n) * 8).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to("cuda")  # noqa: E731
    vecs = merge.threshold_stack(t(sa), t(sa), t(g), INT8_REBASE_WINDOW)
    return t(hb), t(asl), t(flags), vecs, t(bases)


def phase_k3_suspicion(n: int, results: dict) -> None:
    import torch

    from gossipfs_tpu_torch.ops import merge

    hb, asl, flags, vecs, bases = suspicion_round_inputs(n, SEED + 13)
    names = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt",
             "entered", "refuted", "held", "suspect_cnt")
    err = 0
    for lh in (0, 3):
        kw = dict(SUS_KW, suspect=True, t_suspect=2, lh_multiplier=lh)
        got = merge.resident_round(hb.clone(), asl.clone(), flags, vecs,
                                   bases, **kw)
        want = merge.resident_round_plain(hb.clone(), asl.clone(), flags,
                                          vecs, bases, **kw)
        torch.cuda.synchronize()
        log(f"  lh_multiplier={lh}: {len(got)} outputs")
        err = max(err, diff_report(names, got, want))
        log(f"    confirmations {int(got[3].sum())}, entered "
            f"{int(got[6].sum())}, refuted {int(got[7].sum())}, held "
            f"{int(got[8].sum())}")
    # tolerance 0: every output is an integer, so any difference is a fault
    if err:
        raise AssertionError("K3 suspicion form != plain")
    log("  K3 suspicion form == plain bit for bit (tolerance 0)")
    # times in the form the main path runs (suspicion, no Lifeguard lane)
    kw = dict(SUS_KW, suspect=True, t_suspect=2)
    h2, a2 = hb.clone(), asl.clone()
    run_k = lambda: merge.resident_round(h2, a2, flags, vecs, bases, **kw)  # noqa: E731
    run_p = lambda: merge.resident_round_plain(h2, a2, flags, vecs, bases, **kw)  # noqa: E731
    run_k()
    run_p()
    kernel_ms = [cuda_ms(run_k, 20), cuda_ms(run_k, 20)]
    plain_ms = cuda_ms(run_p, 3)
    kernel_ms.append(cuda_ms(run_k, 20))
    # lanes read and written once, flags, stack and bases read, seven
    # int32 [N] outputs
    floor_bytes = 4 * n * n + n * (1 + 11 + 4) + 7 * 4 * n
    results["k3_sus"] = dict(
        max_abs_err=err, ms=min(kernel_ms), ms_runs=kernel_ms,
        plain_ms=plain_ms, bound_ms=floor_bytes / H100_BYTES_PER_S * 1e3)
    log(f"  suspicion form: kernel {min(kernel_ms):.4f} ms (runs "
        f"{kernel_ms}), plain {plain_ms:.3f} ms, byte bound "
        f"{results['k3_sus']['bound_ms']:.4f} ms ({floor_bytes} B)")


def phase_suspect_merges(results: dict) -> None:
    import numpy as np
    import torch

    from gossipfs_tpu_torch.ops import merge_update as mu

    err = 0
    timed = []
    for key, label, fn, plain, n, f, vdt, hdt in (
            ("k2_sus", "K2 config 3", mu.fused_merge_update,
             mu.fused_merge_update_plain, 10_240, 14, np.int8, np.int16),
            ("k4_sus", "K4 headline", mu.arc_merge_update,
             mu.arc_merge_update_plain, N_MAIN, 16, np.int8, np.int8)):
        view, edges, bases, hb, asl, sa, sb, alive = merge_inputs(
            n, f, vdt, hdt, SEED + 14 + n, aligned=True, statuses=4)
        senders = bases if fn is mu.arc_merge_update else edges
        kw = dict(fanout=f) if fn is mu.arc_merge_update else {}
        args = (view, senders, hb, asl, sa, sb, alive)
        for det in (False, True):
            log(f"  {label} suspect form: N={n}, F={f}, detect_stats={det}")
            err = max(err, compare_merge(
                fn, plain, args, dict(kw, detect_stats=det, suspect=True)))
        timed.append((key, fn, plain, args, kw))
    if err:
        raise AssertionError("suspect forms of K2/K4 != plain")
    log("  K2 and K4 suspect forms == plain bit for bit (tolerance 0)")
    # times at the shapes and stats setting of phases 7-8, suspicion on
    for key, fn, plain, args, kw in timed:
        results[key] = dict(max_abs_err=err)
        time_merge(fn, plain, args, dict(kw, detect_stats=True, suspect=True),
                   results, key)

    timing_args = None
    for label, n, f, hdt in (("all-int8", N_MAIN, 14, np.int8),
                             ("int16 lanes", N_MAIN, 14, np.int16),
                             ("ragged", 1_030, 5, np.int16)):
        view, edges, _, hb, asl, sa, sb, alive = merge_inputs(
            n, f, np.int8, hdt, SEED + 17 + n, statuses=4)
        args = (view, edges, hb, asl, sa, sb, alive)
        for det in (False, True):
            for sus in (False, True):
                kw = dict(detect_stats=det, suspect=sus)
                log(f"  K5 {label}: N={n}, F={f}, hb {hdt.__name__}, "
                    f"detect_stats={det}, suspect={sus}")
                err = max(err, compare_merge(mu.stripe_merge_update,
                                             mu.stripe_merge_update_plain,
                                             args, kw))
                got = mu.stripe_merge_update(view, edges, hb.clone(),
                                             asl.clone(), sa, sb, alive, **kw)
                k2 = mu.fused_merge_update(view, edges, hb.clone(),
                                           asl.clone(), sa, sb, alive, **kw)
                torch.cuda.synchronize()
                bad = [name for name, a, b in zip(MERGE_OUTS, got, k2)
                       if not torch.equal(a, b)]
                if bad:
                    raise AssertionError(f"K5 != K2 in {bad}")
        if label == "all-int8":
            timing_args = args
    if err:
        raise AssertionError("K5 != plain")
    log("  K5 == plain and == K2 bit for bit on every shape (tolerance 0)")
    # the main path's form: suspicion on, detection stats off (joins)
    kw = dict(detect_stats=False, suspect=True)
    results["k5"] = dict(max_abs_err=err)
    time_merge(mu.stripe_merge_update, mu.stripe_merge_update_plain,
               timing_args, kw, results, "k5")
    results["k2_on_k5_shape"] = dict(max_abs_err=0)
    time_merge(mu.fused_merge_update, mu.fused_merge_update_plain,
               timing_args, kw, results, "k2_on_k5_shape")
    # the largest N the route sends to K5 (packed_rr(28_416), F = 15),
    # inputs made on the card
    from gossipfs_tpu_torch.config import SimConfig

    n, f = mu.STRIPE_MAX_N, SimConfig.log_fanout(mu.STRIPE_MAX_N)
    view, edges, _, hb, asl, sa, sb, alive = big_merge_inputs(
        n, n, f, torch.int8, SEED + n)
    args = (view, edges, hb, asl, sa, sb, alive)
    bad = 0
    for det, sus in ((False, False), (True, False), (False, True),
                     (True, True)):
        kw = dict(detect_stats=det, suspect=sus)
        got = mu.stripe_merge_update(view, edges, hb.clone(), asl.clone(),
                                     sa, sb, alive, **kw)
        want = mu.stripe_merge_update_plain(view, edges, hb.clone(),
                                            asl.clone(), sa, sb, alive, **kw)
        diff = sum(count_diff(a, b)[0] for a, b in zip(got, want))
        del want
        k2 = mu.fused_merge_update(view, edges, hb.clone(), asl.clone(), sa,
                                   sb, alive, **kw)
        k2_diff = sum(count_diff(a, b)[0] for a, b in zip(got, k2))
        del got, k2
        bad += diff + k2_diff
        log(f"  K5 N={n}, F={f}, hb int8, detect_stats={det}, suspect={sus}: "
            f"vs plain: {diff} entries differ; vs K2: {k2_diff} entries "
            "differ")
    if bad:
        raise AssertionError(f"K5 at N={n}: {bad} entries differ")
    kw = dict(detect_stats=False, suspect=True)
    results["k5_max_n"] = dict(max_abs_err=0, shape=[n, n])
    time_merge(mu.stripe_merge_update, mu.stripe_merge_update_plain, args,
               kw, results, "k5_max_n")
    del view, edges, hb, asl, args
    torch.cuda.empty_cache()


def suspicion_headline(**sus):
    """The ``bench --suspicion`` headline (t_fail 3), with ``sus`` as its
    SuspicionParams (t_suspect 2 by default)."""
    import dataclasses

    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.suspicion import SuspicionParams

    return dataclasses.replace(SimConfig.headline(N_MAIN), t_fail=3,
                               suspicion=SuspicionParams(
                                   **(sus or dict(t_suspect=2))))


def phase_suspicion_scans(rounds: int) -> None:
    import dataclasses

    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.models.presets import ALL
    from gossipfs_tpu_torch.ops import merge
    from gossipfs_tpu_torch.suspicion import SuspicionParams

    config3 = dataclasses.replace(ALL["sim-10k-crash"].config, t_fail=3,
                                  suspicion=SuspicionParams(t_suspect=2))
    runs = [
        ("bench --suspicion headline", suspicion_headline(), 0.02, 0.0,
         "resident_round"),
        ("headline, Lifeguard t3 m4 1/64",
         suspicion_headline(t_suspect=3, lh_multiplier=4,
                            lh_frac=0.015625), 0.02, 0.0, "resident_round"),
        ("suspicion_rr", SimConfig.suspicion_rr(N_MAIN), 0.02, 0.02,
         "stripe_merge_update"),
        ("config 3, t_fail 3 + t_suspect 2", config3, 0.05, 0.05,
         "fused_merge_update"),
        ("suspicion headline, rejoins", suspicion_headline(), 0.02, 0.02,
         "arc_merge_update"),
    ]
    for label, cfg, crash, rejoin, kernel in runs:
        out = {}
        for plain in (False, True):
            key = trandom.PRNGKey(7, device="cuda")
            merge.reset_launch_counts()
            out[plain] = run_rounds(init_state(cfg), cfg, rounds, key,
                                    crash_rate=crash, rejoin_rate=rejoin,
                                    plain=plain)
            if not plain and merge.LAUNCH_COUNTS[kernel] != rounds:
                raise AssertionError(f"{label}: launched "
                                     f"{merge.LAUNCH_COUNTS}")
        torch.cuda.synchronize()
        (sk, ck, mk), (sp, cp, mp) = out[False], out[True]
        pairs = [("hb", sk.hb, sp.hb), ("asl", sk.asl, sp.asl),
                 ("alive", sk.alive, sp.alive),
                 ("hb_base", sk.hb_base, sp.hb_base)]
        pairs += [(f, getattr(ck, f), getattr(cp, f)) for f in ck._fields]
        pairs += [(f, getattr(mk, f), getattr(mp, f)) for f in mk._fields]
        bad = [name for name, a, b in pairs if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"{label}: kernel scan != plain scan in "
                                 f"{bad}")
        if int(mk.suspects_entered.sum()) <= 0:
            raise AssertionError(f"{label}: the lifecycle never ran")
        log(f"  {label} (N={cfg.n}, {kernel}), {rounds} rounds at "
            f"{crash:.0%} crash / {rejoin:.0%} rejoin: lanes, carry and "
            f"metrics bit-equal (confirmations "
            f"{int(mk.true_detections.sum())}, false positives "
            f"{int(mk.false_positives.sum())}, suspects entered "
            f"{int(mk.suspects_entered.sum())}, refuted "
            f"{int(mk.refutations.sum())}, first_suspect set "
            f"{int((ck.first_suspect >= 0).sum())})")


def phase_suspicion_main(results: dict) -> None:
    from gossipfs_tpu_torch.bench import (
        CRASH_RATE, ROUNDS, tracked_crash_events)
    from gossipfs_tpu_torch.metrics.detection import summarize

    cfg = suspicion_headline()
    events, crash_rounds, churn_ok = tracked_crash_events(cfg, ROUNDS, 8, 20)
    run_kw = dict(events=events, crash_rate=CRASH_RATE, churn_ok=churn_ok,
                  crash_only_events=True)
    warm_both_forms(cfg, run_kw)
    carry, per_round, launches, wall, kernel_ms, _, final = timed_main_path(
        cfg, ROUNDS, run_kw, "resident_round")
    check_onepass("main path A", "aligned_group", ROUNDS)
    rep = summarize(carry, per_round, crash_rounds)
    ttd = sorted(rep.ttd_first.values())
    log(f"  tracked ttd_first {ttd}, ttd_suspect "
        f"{sorted(rep.ttd_suspect.values())}, suspect_to_confirm "
        f"{sorted(rep.suspect_to_confirm.values())}, ttd_converged "
        f"{sorted(rep.ttd_converged.values())}")
    log(f"  FPR {rep.false_positive_rate:.3e} ({rep.false_positives} false "
        f"confirmations), true confirmations {rep.true_detections}, "
        f"suspects entered {rep.suspects_entered}, refutations "
        f"{rep.refutations}, fp_suppressed {rep.fp_suppressed}, final "
        f"alive {rep.final_alive}")
    window = cfg.suspicion.max_confirm_after(cfg.t_fail)
    if min(ttd) < 1 or max(ttd) > 3 * window:
        raise AssertionError(f"tracked crashes confirmed at {ttd}")
    if len(rep.suspect_to_confirm) != len(crash_rounds):
        raise AssertionError("a tracked crash was never suspected")
    if rep.false_positive_rate > 1e-3 or not 0 < rep.final_alive < cfg.n:
        raise AssertionError("suspicion main path output out of range")
    results["sus_main"] = dict(launches=launches["resident_round"],
                               rounds_per_s=ROUNDS / wall,
                               kernel_ms=kernel_ms,
                               round_ms=wall / ROUNDS * 1e3,
                               launch_counts=launch_counts(),
                               report=rep.as_dict())
    resident_off_twin("main path A", cfg, ROUNDS, run_kw, 0,
                      (final, carry, per_round), results["sus_main"])


def phase_suspicion_rr_main(results: dict, rounds: int) -> None:
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.metrics.detection import summarize

    cfg = SimConfig.suspicion_rr(N_MAIN)
    kw = dict(crash_rate=0.01, rejoin_rate=0.01)
    carry, per_round, launches, wall, kernel_ms, _, _ = timed_main_path(
        cfg, rounds, kw, "stripe_merge_update")
    rep = summarize(carry, per_round)
    log(f"  FPR {rep.false_positive_rate:.3e}, true confirmations "
        f"{rep.true_detections}, suspects entered {rep.suspects_entered}, "
        f"refutations {rep.refutations}, fp_suppressed "
        f"{rep.fp_suppressed}, final alive {rep.final_alive}")
    if rep.true_detections <= 0 or not 0 < rep.final_alive < cfg.n:
        raise AssertionError("suspicion_rr output out of range")
    results["k5_main"] = dict(launches=launches["stripe_merge_update"],
                              kernel_ms=kernel_ms,
                              rounds_per_s=rounds / wall,
                              round_ms=wall / rounds * 1e3,
                              launch_counts=launch_counts())
    stage_split(cfg, SPLIT_ROUNDS, kw, wall / rounds * 1e3)

def phase_k1(results: dict) -> None:
    import numpy as np
    import torch

    from gossipfs_tpu_torch.ops import fanout_max as fx

    rng = np.random.default_rng(SEED + 18)
    err = 0
    timing = None
    for n, f in ((N_MAIN, 14), (1_030, 5)):
        edges = torch.from_numpy(
            rng.integers(0, n, (n, f)).astype(np.int32)).cuda()
        for dt in (np.int8, np.int16, np.int32):
            # gossip views lie in [-1, window]; draw below -1 too, where
            # the kernel (no floor) and the JAX XLA oracle part
            view = torch.from_numpy(
                rng.integers(-3, 127, (n, n)).astype(dt)).cuda()
            got = fx.fanout_max_merge(view, edges)
            want = fx.fanout_max_merge_plain(view, edges)
            torch.cuda.synchronize()
            err = max(err, diff_report((f"out {dt.__name__}, N={n}, F={f}",),
                                       (got,), (want,)))
            if n == N_MAIN and dt is np.int8:
                timing = (view, edges)
            del view, got, want
    # tolerance 0: integer outputs
    if err:
        raise AssertionError("K1 != plain")
    log("  K1 == plain bit for bit on every dtype and shape (tolerance 0)")
    view, edges = timing
    run_k = lambda: fx.fanout_max_merge(view, edges)  # noqa: E731
    run_p = lambda: fx.fanout_max_merge_plain(view, edges)  # noqa: E731
    run_k()
    run_p()
    kernel_ms = [cuda_ms(run_k, 20), cuda_ms(run_k, 20)]
    plain_ms = cuda_ms(run_p, 3)
    kernel_ms.append(cuda_ms(run_k, 20))
    # view read once, edges read once, the output written once
    floor_bytes = 2 * view.numel() * view.element_size() + edges.numel() * 4
    results["k1"] = dict(max_abs_err=err, ms=min(kernel_ms),
                         ms_runs=kernel_ms, plain_ms=plain_ms,
                         bound_ms=floor_bytes / H100_BYTES_PER_S * 1e3)
    log(f"  int8 N={N_MAIN}, F=14: kernel {min(kernel_ms):.4f} ms (runs "
        f"{kernel_ms}), plain {plain_ms:.3f} ms, byte bound "
        f"{results['k1']['bound_ms']:.4f} ms ({floor_bytes} B)")


def launch_split(fn, reps: int) -> dict:
    """Device time of each CUDA kernel ``fn`` launches, by kernel name,
    under ``torch.profiler`` over ``reps`` calls: ``{name: (ms in all,
    launches the profiler saw)}``.  The profiler may miss the records of
    the last launches before it stops, so a caller divides by the
    launches seen where it wants ms per launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            # "void (anonymous namespace)::rr_merge_kernel<...>(...)" ->
            # "rr_merge_kernel"
            name = (e.key.split("<")[0].split("::")[-1].split("(")[0].strip()
                    or e.key)
            ms, seen = out.get(name, (0.0, 0))
            out[name] = (ms + e.self_device_time_total / 1e3,
                         seen + e.count)
    return out


def phase_k3_forms(n: int, results: dict) -> None:
    import numpy as np
    import torch

    from gossipfs_tpu_torch.ops import merge

    rng = np.random.default_rng(SEED + 19)
    edges = torch.from_numpy(rng.integers(0, n, (n, 14)).astype(np.int32)).cuda()
    bases = torch.from_numpy(rng.integers(0, n, n).astype(np.int32)).cuda()
    forms = {"edges": (edges, dict()),
             "arc": (bases, dict(fanout=16, arc_align=1))}
    names = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt",
             "entered", "refuted", "held", "suspect_cnt")
    sus_inputs = suspicion_round_inputs(n, SEED + 13)
    modes = {"crash-only": (random_round_inputs(n, SEED), dict(t_fail=5)),
             "suspicion": (sus_inputs,
                           dict(t_fail=3, suspect=True, t_suspect=2)),
             "suspicion + lh": (sus_inputs,
                                dict(t_fail=3, suspect=True, t_suspect=2,
                                     lh_multiplier=3))}
    err = 0
    for form, (senders, fkw) in forms.items():
        for mode, ((hb, asl, flags, vecs, _), mkw) in modes.items():
            kw = dict(fkw, t_cooldown=12, **mkw)
            got = merge.resident_round(hb.clone(), asl.clone(), flags, vecs,
                                       senders, **kw)
            want = merge.resident_round_plain(hb.clone(), asl.clone(), flags,
                                              vecs, senders, **kw)
            torch.cuda.synchronize()
            log(f"  {form} form, {mode}: {len(got)} outputs, detections "
                f"{int(got[3].sum())}")
            err = max(err, diff_report(names, got, want))
    # tolerance 0: integer outputs
    if err:
        raise AssertionError("K3 explicit-edge / plain-arc form != plain")
    log("  K3 explicit-edge and plain-arc forms == plain bit for bit "
        "(tolerance 0)")
    # times: the main path C form (edges, crash-only), its suspicion form,
    # and the plain-arc form, with the split between the two launches
    for key, form, mode in (("k3_edges", "edges", "crash-only"),
                            ("k3_edges_sus", "edges", "suspicion"),
                            ("k3_arc", "arc", "crash-only")):
        senders, fkw = forms[form]
        (hb, asl, flags, vecs, _), mkw = modes[mode]
        kw = dict(fkw, t_cooldown=12, **mkw)
        h2, a2 = hb.clone(), asl.clone()
        run_k = lambda: merge.resident_round(h2, a2, flags, vecs, senders, **kw)  # noqa: E731
        run_p = lambda: merge.resident_round_plain(h2, a2, flags, vecs, senders, **kw)  # noqa: E731
        run_k()
        run_p()
        kernel_ms = [cuda_ms(run_k, 20), cuda_ms(run_k, 20)]
        plain_ms = cuda_ms(run_p, 3)
        kernel_ms.append(cuda_ms(run_k, 20))
        # K3's two kernels, ms per launch as the profiler saw them
        split = {k: (ms / seen, seen) for k, (ms, seen)
                 in launch_split(run_k, 10).items() if k.startswith("rr_")}
        outs = 4 + (3 if mode != "crash-only" else 0)
        floor_bytes = (4 * n * n + n * (1 + 11) + senders.numel() * 4
                       + outs * 4 * n)
        results[key] = dict(max_abs_err=err, ms=min(kernel_ms),
                            ms_runs=kernel_ms, plain_ms=plain_ms,
                            bound_ms=floor_bytes / H100_BYTES_PER_S * 1e3,
                            split=split)
        both = sum(ms for ms, _ in split.values())
        parts = ", ".join(f"{k} {ms:.4f} ms ({ms / both:.1%}; {seen} of 10 "
                          "launches seen)"
                          for k, (ms, seen) in sorted(split.items()))
        log(f"  {form} form, {mode}: kernel {min(kernel_ms):.4f} ms (runs "
            f"{kernel_ms}), plain {plain_ms:.3f} ms, byte bound "
            f"{results[key]['bound_ms']:.4f} ms ({floor_bytes} B); per "
            f"launch under the profiler: {parts}")
    # the K5 row's suspicion-off time, at phase 14's all-int8 shape
    from gossipfs_tpu_torch.ops import merge_update as mu

    view, edges5, _, hb, asl, sa, sb, alive = merge_inputs(
        N_MAIN, 14, np.int8, np.int8, SEED + 17 + N_MAIN, statuses=4)
    results["k5_off"] = dict(max_abs_err=0)
    log("  K5 at phase 14's all-int8 shape, suspicion off, stats off:")
    time_merge(mu.stripe_merge_update, mu.stripe_merge_update_plain,
               (view, edges5, hb, asl, sa, sb, alive),
               dict(detect_stats=False, suspect=False), results, "k5_off")


def lean_scan_configs():
    import dataclasses

    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.suspicion import SuspicionParams

    lh = SuspicionParams(t_suspect=3, lh_multiplier=4, lh_frac=0.015625)
    # (label, config, merge form): N = 16,384, so the one-pass form runs
    return [
        ("packed_rr", SimConfig.packed_rr(N_MAIN), "edges"),
        ("suspicion_rr", SimConfig.suspicion_rr(N_MAIN), "edges"),
        ("suspicion_rr, Lifeguard t3 m4 1/64",
         SimConfig.suspicion_rr(N_MAIN, suspicion=lh), "edges"),
        ("plain arcs", dataclasses.replace(
            SimConfig.packed_rr(N_MAIN), topology="random_arc", fanout=16),
         "arc"),
        ("headline(arc_align=4)", SimConfig.headline(N_MAIN, arc_align=4),
         "arc"),
    ]


def phase_lean_scans(rounds: int, results: dict) -> None:
    for label, cfg, form in lean_scan_configs():
        lean_scan_vs_plain(label, cfg, form, rounds, None, results)


def lean_scan_vs_plain(label: str, cfg, form: str, rounds: int, scenario,
                       results: dict) -> None:
    """One lean scan on the kernel (its one-pass form (f), then with
    ``rr_resident="off"`` the two-launch form) and on its plain version
    from the same key (2 % crash churn, ``scenario`` a FaultScenario or
    None): the route and the launches (all K3, all in ``form``'s one-pass
    or two-launch name) as expected, then lanes, carry and metrics
    bit-equal.  Keeps each form's launch count in
    ``results["scan_launches"]``."""
    import dataclasses

    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.core.rounds import route, run_rounds
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.ops import merge
    from gossipfs_tpu_torch.scenarios.tensor import compile_tensor

    tsc = None if scenario is None else compile_tensor(scenario)
    if route(cfg, scenario=tsc) != ("lean", form + ONEPASS):
        raise AssertionError(f"{label}: routed {route(cfg, scenario=tsc)}")
    off = dataclasses.replace(cfg, rr_resident="off")
    out = {}
    for run, c, plain, launched in (("one-pass", cfg, False, form + ONEPASS),
                                    ("two-launch", off, False, form),
                                    ("plain", cfg, True, None)):
        key = trandom.PRNGKey(7, device="cuda")
        merge.reset_launch_counts()
        out[run] = run_rounds(init_state(c), c, rounds, key,
                              crash_rate=0.02, plain=plain, scenario=tsc)
        want = {k: (rounds if k == "resident_round" and not plain else 0)
                for k in merge.LAUNCH_COUNTS}
        forms = {k: (rounds if k == launched else 0)
                 for k in merge.FORM_LAUNCHES}
        if merge.LAUNCH_COUNTS != want or merge.FORM_LAUNCHES != forms:
            raise AssertionError(
                f"{label}, {run}: launched {merge.LAUNCH_COUNTS} "
                f"{merge.FORM_LAUNCHES}")
        if launched is not None:
            results.setdefault("scan_launches", {})[launched] = rounds
    torch.cuda.synchronize()
    sp, cp, mp = out["plain"]
    for run in ("one-pass", "two-launch"):
        sk, ck, mk = out[run]
        pairs = [("hb", sk.hb, sp.hb), ("asl", sk.asl, sp.asl),
                 ("alive", sk.alive, sp.alive),
                 ("hb_base", sk.hb_base, sp.hb_base)]
        pairs += [(f, getattr(ck, f), getattr(cp, f)) for f in ck._fields]
        pairs += [(f, getattr(mk, f), getattr(mp, f)) for f in mk._fields]
        bad = [name for name, a, b in pairs if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"{label}: {run} kernel scan != plain scan "
                                 f"in {bad}")
    armed = "" if scenario is None else f" under {scenario.name}"
    log(f"  {label} (N={cfg.n}, {form} form, one-pass and two-launch), "
        f"{rounds} rounds at 2% "
        f"crash{armed}: lanes, carry and metrics bit-equal (detections "
        f"{int(mk.true_detections.sum())}, false positives "
        f"{int(mk.false_positives.sum())}, suspects entered "
        f"{int(mk.suspects_entered.sum())}, refuted "
        f"{int(mk.refutations.sum())}, alive {int(mk.n_alive[-1])})")


def lean_split(cfg, rounds: int, run_kw: dict, round_ms: float) -> dict:
    """Device ms per round of the lean loop by CUDA kernel name under
    ``torch.profiler`` over ``rounds`` rounds from a fresh state: K3's
    launches (one a round in its one-pass form, two in the two-launch
    form) and everything else (edge and churn draws, flags, the threshold
    stack, the carry), beside the device's busy ms per round and its share
    of ``round_ms`` (the unprofiled round)."""
    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.core.rounds import route, run_rounds
    from gossipfs_tpu_torch.core.state import init_state

    state = init_state(cfg)
    key = trandom.PRNGKey(3, device="cuda")
    state, _, _ = run_rounds(state, cfg, 2, key, **run_kw)   # warm-up
    raw = launch_split(lambda: run_rounds(state, cfg, rounds, key, **run_kw),
                       1)
    split = {k: ms / rounds for k, (ms, _) in raw.items()}
    per_round = 1 if route(cfg, scenario=run_kw.get("scenario"))[1].endswith(
        ONEPASS) else 2
    seen = sum(n for k, (_, n) in raw.items() if k.startswith("rr_"))
    k3 = {k: v for k, v in split.items() if k.startswith("rr_")}
    other = sum(v for k, v in split.items() if not k.startswith("rr_"))
    busy = sum(split.values())
    top = sorted(((v, k) for k, v in split.items()
                  if not k.startswith("rr_")), reverse=True)[:4]
    log(f"  device ms per round ({rounds} profiled rounds): "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(k3.items()))
        + f", everything else {other:.4f} (largest: "
        + ", ".join(f"{k[:40]} {v:.4f}" for v, k in top)
        + f"); busy {busy:.4f} ms per round, {busy / round_ms:.1%} of the "
        f"unprofiled {round_ms:.4f} ms round; the profiler saw {seen} of "
        f"{per_round * rounds} K3 kernel launches")
    return dict(k3, other_ms=other, busy_ms=busy)


def phase_packed_main(results: dict) -> None:
    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.bench import tracked_crash_events
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.core import rounds as R
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.metrics.detection import summarize
    from gossipfs_tpu_torch.ops import merge

    cfg = SimConfig.packed_rr(N_MAIN)
    rounds = 100
    events, crash_rounds, churn_ok = tracked_crash_events(cfg, rounds, 8, 3)
    kw = dict(events=events, crash_rate=0.01, churn_ok=churn_ok,
              crash_only_events=True)
    if R.route(cfg) != ("lean", "edges" + ONEPASS):
        raise AssertionError(f"main path C routed {R.route(cfg)}")
    warm_both_forms(cfg, kw)
    # the lean loop, through run_rounds, counts zeroed just before
    state = init_state(cfg)
    key = trandom.PRNGKey(0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    with merge.record_launch_events() as evs:
        final, carry, per_round = R.run_rounds(state, cfg, rounds, key, **kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(merge.LAUNCH_COUNTS)
    check_onepass("main path C", "edges", rounds)
    kernel_ms = sum(s.elapsed_time(e) for s, e in evs) / rounds
    peak = torch.cuda.max_memory_allocated()
    round_ms = wall / rounds * 1e3
    rep = summarize(carry, per_round, crash_rounds)
    ttd = sorted(rep.ttd_first.values())
    log(f"  lean loop: {rounds} rounds in {wall:.4f} s, {rounds / wall:.2f} "
        f"rounds/s; whole round {round_ms:.4f} ms, K3 {kernel_ms:.4f} "
        f"ms/round (CUDA events around each launch), host and the rest "
        f"{round_ms - kernel_ms:.4f} ms; peak memory {peak / 2**30:.3f} GiB")
    log(f"  launches {launch_counts()}")
    log(f"  tracked ttd_first {ttd}, ttd_converged "
        f"{sorted(rep.ttd_converged.values())}; FPR "
        f"{rep.false_positive_rate:.3e} ({rep.false_positives} false "
        f"positives), true detections {rep.true_detections}, final alive "
        f"{rep.final_alive}")
    if min(ttd) < 1 or max(ttd) > 3 * cfg.t_fail:
        raise AssertionError(f"tracked crashes detected at {ttd}")
    if rep.false_positive_rate > 1e-3 or not 0 < rep.final_alive < cfg.n:
        raise AssertionError("main path C output out of range")
    results["main_c"] = dict(launches=launches["resident_round"],
                             fanout_max_launches=launches["fanout_max_merge"],
                             rounds_per_s=rounds / wall, kernel_ms=kernel_ms,
                             round_ms=round_ms,
                             launch_counts=launch_counts())
    resident_off_twin("main path C", cfg, rounds, kw, 0,
                      (final, carry, per_round), results["main_c"])
    lean_split(cfg, SPLIT_ROUNDS, dict(crash_rate=0.01), round_ms)
    # the same run through the separate-pass loop (K5): the same function,
    # so equal outputs, at the separate-pass round's cost
    gstate = init_state(cfg)
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    gfinal, gcarry, gper = R._run_general(
        gstate, cfg, rounds, key, events, 0.01, 0.0, churn_ok, None, False,
        False)
    torch.cuda.synchronize()
    gwall = time.perf_counter() - t0
    glaunch = dict(merge.LAUNCH_COUNTS)
    pairs = [("hb", final.hb, gfinal.hb), ("asl", final.asl, gfinal.asl),
             ("alive", final.alive, gfinal.alive),
             ("hb_base", final.hb_base, gfinal.hb_base)]
    pairs += [(f, getattr(carry, f), getattr(gcarry, f))
              for f in carry._fields]
    pairs += [(f, getattr(per_round, f), getattr(gper, f))
              for f in per_round._fields]
    bad = [name for name, a, b in pairs if not torch.equal(a, b)]
    grep = summarize(gcarry, gper, crash_rounds)
    if bad or grep.as_dict() != rep.as_dict():
        raise AssertionError(f"lean != separate-pass in {bad}")
    log(f"  separate-pass loop on the same run: {rounds / gwall:.2f} "
        f"rounds/s ({gwall / rounds * 1e3:.4f} ms a round, launches "
        f"{glaunch}); final lanes, carry, metrics and report equal to the "
        f"lean loop's (TTD {sorted(grep.ttd_first.values())}, FPR "
        f"{grep.false_positive_rate:.3e})")
    results["main_c"]["separate_rounds_per_s"] = rounds / gwall


def phase_frontier(results: dict, elementwise: str = "lanes") -> None:
    """``python -m gossipfs_tpu_torch.frontier --elementwise ... --trace``;
    the trace's ``remove`` rows number at most N and the analyzer gives
    the JSON's TTD and FPR from it; the SWAR run's detection fields must
    equal the lanes run's."""
    import tempfile

    import torch

    from gossipfs_tpu_torch.obs import timeline

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        trace = f"{tmp}/frontier.jsonl"
        out = subprocess.run(
            [sys.executable, "-m", "gossipfs_tpu_torch.frontier",
             "--elementwise", elementwise, "--trace", trace],
            capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise AssertionError(f"frontier failed:\n{out.stderr[-4000:]}")
        doc = json.loads(out.stdout.strip().splitlines()[-1])
        headers, events = timeline.merge([trace])
    post = timeline.analyze(headers, events)
    removes = sum(e.kind == "remove" for e in events)
    bad = [k for k in ("ttd_first_median", "false_positive_rate",
                       "detected", "tracked_crashes") if post[k] != doc[k]]
    log(f"  trace: {doc['trace_events']} events ({removes} remove rows), "
        f"decode {doc['trace_ms']:.3f} ms after the timed run; analyze "
        f"gives TTD {post['ttd_first_median']}, FPR "
        f"{post['false_positive_rate']:.3e}")
    if bad or removes > doc["n"] or len(events) != doc["trace_events"]:
        raise AssertionError(f"frontier trace: analyze differs in {bad}, "
                             f"{removes} remove rows for N={doc['n']}")
    results["frontier_" + elementwise] = doc
    peak = doc["peak_memory_bytes"]
    log(f"  N={doc['n_padded']}, fanout {doc['fanout']}, {doc['rounds']} "
        f"rounds: {doc['rounds_per_sec']:.3f} rounds/s "
        f"({doc['seconds_per_round'] * 1e3:.4f} ms a round); peak memory "
        f"{peak / 2**30:.3f} GiB; detected {doc['detected']} of "
        f"{doc['tracked_crashes']}, TTD median {doc['ttd_first_median']}, "
        f"FPR {doc['false_positive_rate']:.3e} ({doc['device']})")
    if peak >= 40 * 2**30:
        raise AssertionError(f"frontier peak {peak / 2**30:.3f} GiB >= 40")
    if doc["detected"] != doc["tracked_crashes"] or doc["n"] != N_CAPACITY:
        raise AssertionError(f"frontier output out of range: {doc}")
    # K3's two-launch explicit-edge form, one launch a round
    form = "edges" + ("/swar" if elementwise == "swar" else "")
    if doc["launches"] != {form: doc["rounds"]}:
        raise AssertionError(f"frontier launches {doc['launches']}")
    log(f"  launches {doc['launches']}")
    lanes = results["frontier_lanes"]
    same = ("detected", "ttd_first_median", "ttd_first_max",
            "ttd_converged_median", "false_positive_rate")
    if any(doc[k] != lanes[k] for k in same):
        raise AssertionError(f"frontier {elementwise} != lanes in {same}")
    if elementwise != "lanes":
        log(f"  detection fields equal to the lanes run's; lanes "
            f"{lanes['rounds_per_sec']:.3f} rounds/s at "
            f"{lanes['peak_memory_bytes'] / 2**30:.3f} GiB")


def packed_session(n: int, node: int, timed: bool = False):
    """The PackedDetector script: advance 3, crash ``node``, advance 8,
    join it, advance 10.  Returns (detector, events, ms per quiet advance,
    ms of the advance that joins)."""
    import torch

    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.detector.sim import PackedDetector

    def step(d):
        t0 = time.perf_counter()
        d.advance(1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    d = PackedDetector(SimConfig.packed_rr(n), seed=3)
    d.advance(3)
    d.crash(node)
    d.advance(8)
    events = d.drain_events()
    d.join(node)
    join_ms = step(d)
    quiet = [step(d) for _ in range(9)]
    return d, events, min(quiet) if timed else None, join_ms


def phase_packed_detector(n_cap: int, results: dict,
                          node: int = 4_097) -> None:
    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import RoundEvents, init_state
    from gossipfs_tpu_torch.ops import merge

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    merge.reset_launch_counts()
    d, events, adv_ms, join_ms = packed_session(n_cap, node, timed=True)
    results["advance"] = dict(round_ms=adv_ms, rounds_per_s=1e3 / adv_ms,
                              launches=merge.FORM_LAUNCHES["edges"],
                              launch_counts=launch_counts())
    mine = [e for e in events if e.subject == node]
    cfg = d.config
    if (len(mine) != 1 or mine[0].round != 3 + cfg.t_fail
            or mine[0].false_positive or node not in d.alive_nodes()
            or d.round != 21):
        raise AssertionError(f"PackedDetector session out of range: {mine}")
    log(f"  N={n_cap}, fanout {cfg.fanout}: crash of {node} at round 3 "
        f"detected at round {mine[0].round} by observer {mine[0].observer} "
        f"({len(events)} events in all); the joiner is alive; quiet "
        f"advance {adv_ms:.4f} ms, advance with a join {join_ms:.4f} ms; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
        f"launches {results['advance']['launch_counts']}")
    del d
    torch.cuda.empty_cache()
    # N = 16,384: the same script against run_rounds with the scheduled
    # matrix events (crash at round 3, join at round 11)
    d, _, _, _ = packed_session(N_MAIN, node)
    cfg = SimConfig.packed_rr(N_MAIN)
    ev = RoundEvents.none(21, N_MAIN)
    ev = RoundEvents(ev.crash.clone(), ev.leave, ev.join.clone())
    ev.crash[3, node] = True
    ev.join[11, node] = True
    final, _, _ = run_rounds(init_state(cfg), cfg, 21,
                             trandom.PRNGKey(3, device="cuda"), events=ev)
    lanes = d.lanes()
    bad = [k for k in ("hb", "asl", "alive", "hb_base")
           if not torch.equal(getattr(final, k), getattr(lanes, k))]
    if bad:
        raise AssertionError(f"PackedDetector != run_rounds in {bad}")
    log(f"  N={N_MAIN}: the same script's lanes, liveness and bases equal "
        "run_rounds with the scheduled crash and join")


def phase_sim_detector() -> None:
    import torch

    from gossipfs_tpu_torch.detector.sim import SimDetector
    from gossipfs_tpu_torch.models.presets import ALL

    cfg = ALL["sim-10k-crash"].config
    dets, secs = [], []
    for every in (None, 10):
        d = SimDetector(cfg, seed=1)
        # a node that never sent a heartbeat is never detected: crash
        # after two rounds, as the JAX package's detector tests do
        d.advance(2)
        d.crash(5)
        d.crash(300)
        t0 = time.perf_counter()
        buf = d.advance_bulk(60, snapshot_every=every)
        events = d.drain_events()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        dets.append((d, events, buf))
    (one, ev1, _), (chunked, ev2, buf) = dets
    bad = [k for k in ("hb", "asl", "alive", "hb_base")
           if not torch.equal(getattr(one.state, k), getattr(chunked.state, k))]
    snap = buf.latest()
    subjects = sorted({e.subject for e in ev1})
    if (bad or ev1 != ev2 or subjects[:1] != [5] or 300 not in subjects
            or snap.round != 62 or one.state.round != 62):
        raise AssertionError(
            f"advance_bulk with snapshots != one bulk call: lanes differ in "
            f"{bad}, {len(ev1)} vs {len(ev2)} events, subjects {subjects}, "
            f"snapshot round {snap.round}")
    log(f"  config 3 (N={cfg.n}): advance_bulk(60) {secs[0]:.3f} s, with "
        f"snapshot_every=10 {secs[1]:.3f} s: equal state and "
        f"{len(ev1)} equal events (subjects {subjects}); latest snapshot "
        f"round {snap.round}")
    chunked.crash(7)
    t0 = time.perf_counter()
    chunked.advance(8)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 8 * 1e3
    mine = [e for e in chunked.drain_events() if e.subject == 7]
    if not mine or mine[0].round != 62 + cfg.t_fail:
        raise AssertionError(f"interactive stretch: {mine}")
    log(f"  interactive: crash of 7 at round 62 detected at round "
        f"{mine[0].round} by observer {mine[0].observer}; {ms:.4f} ms per "
        "advance")


def match_edges(n: int, fanout: int, align: int, seed: int):
    """int32 ``[n, 2]`` (aligned arc base, group-match bitmask) on the
    card: three masks in ten full, one in ten zero, the rest random."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    nw = fanout // align
    bases = rng.integers(0, n // align, n) * align
    u = rng.random(n)
    mask = np.where(u < 0.3, (1 << nw) - 1,
                    np.where(u < 0.4, 0, rng.integers(0, 1 << nw, n)))
    return torch.from_numpy(
        np.stack([bases, mask], axis=1).astype(np.int32)).cuda()


def phase_k3_edge_filter(n: int, results: dict) -> None:
    import numpy as np
    import torch

    from gossipfs_tpu_torch.ops import merge

    fanout = 16
    names = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt",
             "entered", "refuted", "held", "suspect_cnt")
    rng = np.random.default_rng(SEED + 25)
    muted = torch.from_numpy((8 * (rng.random(n) < 0.06)).astype(np.int8)).cuda()

    def with_mutes(inputs):
        hb, asl, flags, vecs, _ = inputs
        return hb, asl, flags + muted, vecs

    sus_inputs = with_mutes(suspicion_round_inputs(n, SEED + 13))
    modes = {"crash-only": (with_mutes(random_round_inputs(n, SEED)),
                            dict(t_fail=5)),
             "suspicion": (sus_inputs,
                           dict(t_fail=3, suspect=True, t_suspect=2)),
             "suspicion + lh": (sus_inputs,
                                dict(t_fail=3, suspect=True, t_suspect=2,
                                     lh_multiplier=3))}
    senders = {8: match_edges(n, fanout, 8, SEED + 8),
               4: match_edges(n, fanout, 4, SEED + 4)}
    err = 0
    for align, e2 in senders.items():
        form = merge.kernel_form(fanout, align, True)
        for mode, ((hb, asl, flags, vecs), mkw) in modes.items():
            kw = dict(fanout=fanout, arc_align=align, t_cooldown=12,
                      edge_filter=True, **mkw)
            got = merge.resident_round(hb.clone(), asl.clone(), flags, vecs,
                                       e2, **kw)
            want = merge.resident_round_plain(hb.clone(), asl.clone(), flags,
                                              vecs, e2, **kw)
            torch.cuda.synchronize()
            log(f"  align {align} ({form}), {mode}: {len(got)} outputs, "
                f"detections {int(got[3].sum())}, muted rows "
                f"{int((muted != 0).sum())}, zero masks "
                f"{int((e2[:, 1] == 0).sum())}")
            err = max(err, diff_report(names, got, want))
    # tolerance 0: integer outputs
    if err:
        raise AssertionError("K3 edge_filter form != plain")
    log("  K3 edge_filter forms == plain bit for bit (tolerance 0)")
    for key, align, mode in (("k3_filter", 8, "crash-only"),
                             ("k3_filter_sus", 8, "suspicion"),
                             ("k3_filter_lh", 8, "suspicion + lh"),
                             ("k3_filter_rows", 4, "crash-only"),
                             ("k3_filter_rows_sus", 4, "suspicion")):
        (hb, asl, flags, vecs), mkw = modes[mode]
        e2 = senders[align]
        kw = dict(fanout=fanout, arc_align=align, t_cooldown=12,
                  edge_filter=True, **mkw)
        h2, a2 = hb.clone(), asl.clone()
        run_k = lambda: merge.resident_round(h2, a2, flags, vecs, e2, **kw)  # noqa: E731
        run_p = lambda: merge.resident_round_plain(h2, a2, flags, vecs, e2, **kw)  # noqa: E731
        run_k()
        run_p()
        kernel_ms = [cuda_ms(run_k, 20), cuda_ms(run_k, 20)]
        plain_ms = cuda_ms(run_p, 3)
        kernel_ms.append(cuda_ms(run_k, 20))
        split = {k: (ms / seen, seen) for k, (ms, seen)
                 in launch_split(run_k, 10).items() if k.startswith("rr_")}
        outs = 4 + (3 if mode != "crash-only" else 0) + int("lh" in mode)
        # both lanes both ways, flags, the stack, [N, 2] senders, outputs
        floor_bytes = 4 * n * n + n * (1 + 11) + e2.numel() * 4 + outs * 4 * n
        results[key] = dict(max_abs_err=err, ms=min(kernel_ms),
                            ms_runs=kernel_ms, plain_ms=plain_ms,
                            bound_ms=floor_bytes / H100_BYTES_PER_S * 1e3,
                            split=split)
        both = sum(ms for ms, _ in split.values())
        parts = ", ".join(f"{k} {ms:.4f} ms ({ms / both:.1%}; {seen} of 10 "
                          "launches seen)"
                          for k, (ms, seen) in sorted(split.items()))
        log(f"  align {align}, {mode}: kernel {min(kernel_ms):.4f} ms (runs "
            f"{kernel_ms}), plain {plain_ms:.3f} ms, byte bound "
            f"{results[key]['bound_ms']:.4f} ms ({floor_bytes} B); per "
            f"launch under the profiler: {parts}")


def pick_nodes(n: int, count: int, avoid, start: int = 0) -> tuple:
    """The first ``count`` ids from ``start`` on that are outside
    ``avoid``: deterministic, disjoint from the tracked crash victims."""
    out = []
    for x in range(start, n):
        if x not in avoid:
            out.append(x)
            if len(out) == count:
                break
    return tuple(out)


def arc_fault_scenario(n: int, avoid, shift: int = 0):
    """Main path D's scenario: a half/half partition for rounds 20-45,
    1/16 of the nodes flapping (up 3, down 2) for rounds 10-80, an 8-node
    rack outage for rounds 50-62, every fault node outside ``avoid``;
    ``shift`` moves every window earlier."""
    from gossipfs_tpu_torch.scenarios import (
        CorrelatedOutage, FaultScenario, Flapping, Partition)

    w = lambda a, b: dict(start=max(a - shift, 0), end=b - shift)  # noqa: E731
    return FaultScenario(
        name="split+flap+outage", n=n,
        partitions=(Partition(**w(20, 45), groups=(tuple(range(n // 2)),)),),
        flapping=(Flapping(**w(10, 80), up=3, down=2,
                           nodes=pick_nodes(n, n // 16, avoid)),),
        outages=(CorrelatedOutage(**w(50, 62), nodes=pick_nodes(
            n, 8, avoid, n // 2 + 8)),))


def edge_fault_scenario(n: int, avoid, shift: int = 0):
    """Main path D's explicit-edge twin: the partition for rounds 20-45,
    2 % Bernoulli loss on the out-links of 1/16 of the nodes for rounds
    0-100, 1/64 of the nodes sending every third round for rounds 10-80."""
    from gossipfs_tpu_torch.scenarios import (
        FaultScenario, LinkFault, Partition, SlowNode)

    w = lambda a, b: dict(start=max(a - shift, 0), end=b - shift)  # noqa: E731
    return FaultScenario(
        name="split+loss+slow", n=n,
        partitions=(Partition(**w(20, 45), groups=(tuple(range(n // 2)),)),),
        link_faults=(LinkFault(start=0, end=100, rate=0.02,
                               src=pick_nodes(n, n // 16, avoid),
                               dst=tuple(range(n))),),
        slow_nodes=(SlowNode(**w(10, 80), stride=3, nodes=pick_nodes(
            n, n // 64, avoid, n // 2)),))


def phase_scenario_scans(rounds: int, results: dict) -> None:
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.scenarios import (
        CorrelatedOutage, FaultScenario, Flapping, LinkFault, Partition,
        SlowNode, split_halves)

    n = N_MAIN
    # windows inside the 20 rounds
    split = (Partition(start=4, end=14, groups=(tuple(range(n // 2)),)),)
    slow = (SlowNode(start=0, end=16, stride=3,
                     nodes=tuple(range(n // 2, n // 2 + n // 64))),)
    arcs = FaultScenario(
        name="split+slow+flap+outage", n=n, partitions=split,
        slow_nodes=slow,
        flapping=(Flapping(start=2, end=18, up=3, down=2,
                           nodes=tuple(range(n // 16))),),
        outages=(CorrelatedOutage(start=8, end=16, nodes=tuple(
            range(n // 2 + n // 4, n // 2 + n // 4 + 8))),))
    edges = FaultScenario(
        name="split+slow+loss", n=n, partitions=split, slow_nodes=slow,
        link_faults=(LinkFault(start=0, end=20, rate=0.02,
                               src=tuple(range(n // 16)),
                               dst=tuple(range(n))),))
    for label, cfg, form, sc in (
            ("suspicion headline", suspicion_headline(), "filter_group",
             arcs),
            ("suspicion_rr", SimConfig.suspicion_rr(n), "edges", edges),
            ("headline(arc_align=4)", SimConfig.headline(n, arc_align=4),
             "filter_rows", split_halves(n, 4, 14))):
        lean_scan_vs_plain(label, cfg, form, rounds, sc, results)


def scenario_main_path(label: str, cfg, form: str, scenario, rounds: int,
                       results: dict, key: str):
    """One lean main path under ``scenario`` through ``run_rounds``, with
    the launch counts zeroed just before and read just after: exactly
    ``rounds`` K3 launches, all in ``form``'s one-pass form, and no other
    kernel's; then the same run with ``rr_resident="off"``."""
    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.bench import tracked_crash_events
    from gossipfs_tpu_torch.core import rounds as R
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.metrics.detection import summarize
    from gossipfs_tpu_torch.ops import merge
    from gossipfs_tpu_torch.scenarios.tensor import compile_tensor

    events, crash_rounds, churn_ok = tracked_crash_events(cfg, rounds, 8, 3)
    sc = scenario(cfg.n, set(crash_rounds))
    tsc = compile_tensor(sc)
    kw = dict(events=events, crash_rate=0.01, churn_ok=churn_ok,
              crash_only_events=True, scenario=tsc)
    if R.route(cfg, scenario=tsc) != ("lean", form + ONEPASS):
        raise AssertionError(f"{label} routed {R.route(cfg, scenario=tsc)}")
    rkey = trandom.PRNGKey(0, device="cuda")
    # the same run once untimed: earlier phases emptied the allocator's
    # cache, and a first run pays the device allocations of its horizon
    # tables (0.4 ms a round over 100 rounds when it was timed cold)
    R.run_rounds(init_state(cfg), cfg, rounds, rkey, **kw)
    warm_both_forms(cfg, kw)
    state = init_state(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    with merge.record_launch_events() as evs:
        final, carry, per_round = R.run_rounds(state, cfg, rounds, rkey, **kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(merge.LAUNCH_COUNTS)
    forms = {k: v for k, v in merge.FORM_LAUNCHES.items() if v}
    check_onepass(label, form, rounds)
    kernel_ms = sum(s.elapsed_time(e) for s, e in evs) / rounds
    peak = torch.cuda.max_memory_allocated()
    round_ms = wall / rounds * 1e3
    rep = summarize(carry, per_round, crash_rounds)
    ttd = sorted(rep.ttd_first.values())
    log(f"  {sc.name}: {rounds} rounds in {wall:.4f} s, "
        f"{rounds / wall:.2f} rounds/s; whole round {round_ms:.4f} ms, K3 "
        f"{kernel_ms:.4f} ms/round (CUDA events around each launch), host "
        f"and the rest {round_ms - kernel_ms:.4f} ms; peak memory "
        f"{peak / 2**30:.3f} GiB")
    log(f"  launches {launches}, by form {forms}")
    log(f"  tracked ttd_first {ttd}, ttd_suspect "
        f"{sorted(rep.ttd_suspect.values())}; FPR "
        f"{rep.false_positive_rate:.3e} ({rep.false_positives} false "
        f"confirmations: the split's and the outage's cross-side removals "
        f"count here), true confirmations {rep.true_detections}, suspects "
        f"entered {rep.suspects_entered}, refutations {rep.refutations}, "
        f"fp_suppressed {rep.fp_suppressed}, final alive {rep.final_alive}")
    window = cfg.suspicion.max_confirm_after(cfg.t_fail)
    if min(ttd) < 1 or max(ttd) > 3 * window:
        raise AssertionError(f"{label}: tracked crashes confirmed at {ttd}")
    if (rep.suspects_entered <= 0 or rep.refutations <= 0
            or rep.false_positives <= 0
            or not 0 < rep.final_alive < cfg.n):
        raise AssertionError(f"{label}: output out of range")
    results[key] = dict(launches=forms[form + ONEPASS],
                        rounds_per_s=rounds / wall, kernel_ms=kernel_ms,
                        round_ms=round_ms, launch_counts=launch_counts())
    resident_off_twin(label, cfg, rounds, kw, 0, (final, carry, per_round),
                      results[key])
    # the device split over 10 rounds inside the fault windows (every
    # window 30 rounds earlier: the split and the flapping are active)
    mid = compile_tensor(scenario(cfg.n, set(crash_rounds), shift=18))
    lean_split(cfg, SPLIT_ROUNDS, dict(crash_rate=0.01, scenario=mid),
               round_ms)
    return sc, kw, rkey


def phase_scenario_main(results: dict) -> None:
    scenario_main_path("main path D", suspicion_headline(), "filter_group",
                       arc_fault_scenario, 100, results, "main_d")


def phase_scenario_rr_main(results: dict) -> None:
    import torch

    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.core import rounds as R
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.ops import merge

    cfg = SimConfig.suspicion_rr(N_MAIN)
    _, kw, key = scenario_main_path("main path D'", cfg, "edges",
                                    edge_fault_scenario, 100, results,
                                    "main_d2")
    # 20 rounds of the same run on both loops: the same function
    rounds = 20
    kw = dict(kw, events=type(kw["events"])(*(m[:rounds]
                                              for m in kw["events"])))
    lean = R.run_rounds(init_state(cfg), cfg, rounds, key, **kw)
    merge.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = R._run_general(init_state(cfg), cfg, rounds, key, kw["events"],
                         0.01, 0.0, kw["churn_ok"], None, False, False,
                         kw["scenario"])
    torch.cuda.synchronize()
    gwall = time.perf_counter() - t0
    glaunch = dict(merge.LAUNCH_COUNTS)
    want = {k: (rounds if k == "stripe_merge_update" else 0) for k in glaunch}
    if glaunch != want:
        raise AssertionError(f"separate-pass twin launched {glaunch}")
    (sl, cl, ml), (sg, cg, mg) = lean, gen
    pairs = [("hb", sl.hb, sg.hb), ("asl", sl.asl, sg.asl),
             ("alive", sl.alive, sg.alive), ("hb_base", sl.hb_base, sg.hb_base)]
    pairs += [(f, getattr(cl, f), getattr(cg, f)) for f in cl._fields]
    pairs += [(f, getattr(ml, f), getattr(mg, f)) for f in ml._fields]
    bad = [name for name, a, b in pairs if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"main path D': lean != separate-pass in {bad}")
    log(f"  {rounds} rounds of the same run on the separate-pass loop "
        f"({gwall / rounds * 1e3:.4f} ms a round, launches {glaunch}): "
        "lanes, carry and metrics equal to the lean loop's (suspects entered "
        f"{int(mg.suspects_entered.sum())}, refuted "
        f"{int(mg.refutations.sum())})")


def phase_partition_sweep(results: dict) -> None:
    import torch

    from gossipfs_tpu_torch import curves
    from gossipfs_tpu_torch.ops import merge

    torch.cuda.empty_cache()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    doc = curves.partition_sweep(ns=(N_MAIN,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = doc["rows"][0]
    launches = dict(merge.LAUNCH_COUNTS)
    horizon = row["heal_at"] + row["reconverge_bound"] + 8
    log(f"  N={row['n']}, fanout {row['fanout']}: {horizon} interactive "
        f"rounds in {wall:.3f} s ({wall / horizon * 1e3:.4f} ms a round, "
        f"stats and event reads included), launches {launches}")
    log(f"  row {json.dumps(row)}")
    want = {k: (horizon if k == "fused_merge_update" else 0)
            for k in launches}
    if launches != want:
        raise AssertionError(f"partition sweep launched {launches}")
    if (row["cross_hb_advances"] != 0
            or not 0 < row["reconverge_rounds"] <= row["reconverge_bound"]
            or min(row["local_ttd"].values()) < 1):
        raise AssertionError(f"partition sweep row out of range: {row}")
    results["partition"] = dict(seconds=wall, rounds=horizon)


def swar_round_cases(n: int):
    """Phase 30's inputs: each merge form's senders (and kwargs), and the
    three modes' lanes (crash-only lanes hold FAILED entries, the
    suspicion lanes SUSPECT ones on both sides of both confirm ages)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 30)
    cuda = lambda a: torch.from_numpy(a.astype(np.int32)).cuda()  # noqa: E731
    forms = {
        "aligned_group": (cuda(rng.integers(0, n // 8, n) * 8),
                          dict(fanout=16, arc_align=8)),
        "edges": (cuda(rng.integers(0, n, (n, 14))), {}),
        "arc": (cuda(rng.integers(0, n, n)), dict(fanout=16, arc_align=1)),
        "filter_group": (match_edges(n, 16, 8, SEED + 8),
                         dict(fanout=16, arc_align=8, edge_filter=True)),
        "filter_rows": (match_edges(n, 16, 4, SEED + 4),
                        dict(fanout=16, arc_align=4, edge_filter=True)),
    }
    sus = suspicion_round_inputs(n, SEED + 13)[:4]
    modes = {"crash-only": (random_round_inputs(n, SEED)[:4], dict(t_fail=5)),
             "suspicion": (sus, dict(t_fail=3, suspect=True, t_suspect=2)),
             "suspicion + lh": (sus, dict(t_fail=3, suspect=True,
                                          t_suspect=2, lh_multiplier=3))}
    muted = torch.from_numpy(
        (8 * (rng.random(n) < 0.06)).astype(np.int8)).cuda()
    return forms, modes, muted


# the mode of each SWAR form's kernels-line row: that of the path that
# launches it (phases 31 and 32)
SWAR_ROW_MODE = {"aligned_group": "crash-only", "edges": "suspicion",
                 "arc": "crash-only", "filter_group": "suspicion",
                 "filter_rows": "crash-only"}


def phase_k3_swar(n: int, results: dict) -> None:
    """K3's SWAR form (elementwise="swar") in every instantiation the lean
    gate reaches: 5 merge forms x crash-only / suspicion / + Lifeguard,
    the mute on the edge_filter forms.  Each bit-equal to the SWAR plain
    version and to the lanes kernel on the same inputs; then times of
    both kernels in turns (lanes, SWAR, SWAR, lanes), the byte bound (the
    same bytes as the lanes form's) and SWAR's pass A / pass B split."""
    import torch

    from gossipfs_tpu_torch.ops import merge

    names = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt",
             "entered", "refuted", "held", "suspect_cnt")
    forms, modes, muted = swar_round_cases(n)
    err = 0
    out = results.setdefault("k3_swar", {})
    for form, (senders, fkw) in forms.items():
        for mode, ((hb, asl, flags, vecs), mkw) in modes.items():
            if fkw.get("edge_filter"):
                flags = flags + muted
            kw = dict(fkw, t_cooldown=12, **mkw)
            name = merge.kernel_form(kw.get("fanout"), kw.get("arc_align", 1),
                                     kw.get("edge_filter", False), "swar")
            got = merge.resident_round(hb.clone(), asl.clone(), flags, vecs,
                                       senders, elementwise="swar", **kw)
            want = merge.resident_round_plain(hb.clone(), asl.clone(), flags,
                                              vecs, senders,
                                              elementwise="swar", **kw)
            lanes = merge.resident_round(hb.clone(), asl.clone(), flags,
                                         vecs, senders, **kw)
            torch.cuda.synchronize()
            log(f"  {name}, {mode}: {len(got)} outputs, detections "
                f"{int(got[3].sum())}; SWAR kernel vs SWAR plain:")
            e = diff_report(names, got, want)
            log("   SWAR kernel vs lanes kernel:")
            e = max(e, diff_report(names, got, lanes))
            err = max(err, e)
            h2, a2 = hb.clone(), asl.clone()
            run_s = lambda: merge.resident_round(  # noqa: E731
                h2, a2, flags, vecs, senders, elementwise="swar", **kw)
            run_l = lambda: merge.resident_round(  # noqa: E731
                h2, a2, flags, vecs, senders, **kw)
            run_l()
            run_s()
            lanes_ms = [cuda_ms(run_l, 10)]
            swar_ms = [cuda_ms(run_s, 10), cuda_ms(run_s, 10)]
            lanes_ms.append(cuda_ms(run_l, 10))
            split = {k: (ms / seen, seen) for k, (ms, seen)
                     in launch_split(run_s, 10).items()
                     if k.startswith("rr_")}
            plain_ms = None
            if SWAR_ROW_MODE[form] == mode:
                run_p = lambda: merge.resident_round_plain(  # noqa: E731
                    h2, a2, flags, vecs, senders, elementwise="swar", **kw)
                run_p()
                plain_ms = cuda_ms(run_p, 2)
            outs = len(got) - 2
            floor_bytes = (4 * n * n + n * (1 + 11) + senders.numel() * 4
                           + outs * 4 * n)
            out[(form, mode)] = dict(
                max_abs_err=e, ms=min(swar_ms), ms_runs=swar_ms,
                lanes_ms=min(lanes_ms), lanes_runs=lanes_ms,
                plain_ms=plain_ms,
                bound_ms=floor_bytes / H100_BYTES_PER_S * 1e3, split=split)
            parts = ", ".join(f"{k} {ms:.4f} ms ({seen} of 10 launches seen)"
                              for k, (ms, seen) in sorted(split.items()))
            plain = "" if plain_ms is None else f", SWAR plain {plain_ms:.3f} ms"
            log(f"   SWAR {min(swar_ms):.4f} ms (runs {swar_ms}) against "
                f"lanes {min(lanes_ms):.4f} ms (runs {lanes_ms}): "
                f"{min(lanes_ms) / min(swar_ms):.3f}x; byte bound "
                f"{out[(form, mode)]['bound_ms']:.4f} ms ({floor_bytes} B)"
                f"{plain}; SWAR per launch under the profiler: {parts}")
    # tolerance 0: integer outputs
    if err:
        raise AssertionError("K3 SWAR form != SWAR plain or != lanes kernel")
    log("  K3 SWAR form == SWAR plain == lanes kernel bit for bit on all 15 "
        "instantiations (tolerance 0)")


def swar_scan_configs():
    """Phase 31's lean scans: (label, config, form, scenario or None)."""
    import dataclasses

    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.scenarios import split_halves

    sw = dict(elementwise="swar")
    return [
        ("headline", SimConfig.headline(N_MAIN, **sw), "aligned_group", None),
        ("suspicion headline", dataclasses.replace(suspicion_headline(), **sw),
         "aligned_group", None),
        ("suspicion_rr", SimConfig.suspicion_rr(N_MAIN, **sw), "edges", None),
        ("headline(arc_align=4)", SimConfig.headline(N_MAIN, arc_align=4,
                                                     **sw), "arc", None),
        ("main path D's scenario", dataclasses.replace(suspicion_headline(),
                                                       **sw),
         "filter_group", arc_fault_scenario(N_MAIN, set(), shift=18)),
        ("headline(arc_align=4) under a split",
         SimConfig.headline(N_MAIN, arc_align=4, **sw), "filter_rows",
         split_halves(N_MAIN, 4, 14)),
    ]


def phase_swar_scans(rounds: int, results: dict) -> None:
    """20-round lean scans under 2 % crash churn: the SWAR kernel (one-pass
    form, and the two-launch form with ``rr_resident="off"``) against the
    SWAR plain version and against the lanes kernel on the same
    configuration less ``elementwise``; lanes, carry and metrics in
    full."""
    import dataclasses

    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.core.rounds import route, run_rounds
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.ops import merge
    from gossipfs_tpu_torch.scenarios.tensor import compile_tensor

    for label, cfg, form, scenario in swar_scan_configs():
        tsc = None if scenario is None else compile_tensor(scenario)
        if route(cfg, scenario=tsc) != ("lean", form + "/swar" + ONEPASS):
            raise AssertionError(f"{label}: routed {route(cfg, scenario=tsc)}")
        runs = {"swar kernel": (cfg, False, form + "/swar" + ONEPASS),
                "swar two-launch kernel": (
                    dataclasses.replace(cfg, rr_resident="off"), False,
                    form + "/swar"),
                "swar plain": (cfg, True, None),
                "lanes kernel": (dataclasses.replace(cfg, elementwise="lanes"),
                                 False, form + ONEPASS)}
        out = {}
        for run, (c, plain, launched) in runs.items():
            merge.reset_launch_counts()
            out[run] = run_rounds(init_state(c), c, rounds,
                                  trandom.PRNGKey(7, device="cuda"),
                                  crash_rate=0.02, plain=plain, scenario=tsc)
            forms = {k: (rounds if k == launched else 0)
                     for k in merge.FORM_LAUNCHES}
            if merge.FORM_LAUNCHES != forms:
                raise AssertionError(f"{label}, {run}: launched "
                                     f"{merge.FORM_LAUNCHES}")
            if launched is not None and "/swar" in launched:
                results.setdefault("swar_scan_launches", {})[
                    launched] = rounds
        torch.cuda.synchronize()
        sk, ck, mk = out["swar kernel"]
        for other in ("swar two-launch kernel", "swar plain", "lanes kernel"):
            so, co, mo = out[other]
            pairs = [("hb", sk.hb, so.hb), ("asl", sk.asl, so.asl),
                     ("alive", sk.alive, so.alive),
                     ("hb_base", sk.hb_base, so.hb_base)]
            pairs += [(f, getattr(ck, f), getattr(co, f)) for f in ck._fields]
            pairs += [(f, getattr(mk, f), getattr(mo, f)) for f in mk._fields]
            bad = [name for name, a, b in pairs if not torch.equal(a, b)]
            if bad:
                raise AssertionError(f"{label}: SWAR kernel scan != {other} "
                                     f"in {bad}")
        log(f"  {label} ({form}/swar), {rounds} rounds at 2% crash: lanes, "
            f"carry and metrics of the SWAR kernel (one-pass) == its "
            f"two-launch form == SWAR plain == lanes kernel (detections "
            f"{int(mk.true_detections.sum())}, suspects "
            f"entered {int(mk.suspects_entered.sum())}, refuted "
            f"{int(mk.refutations.sum())}, alive {int(mk.n_alive[-1])})")


def phase_swar_main(results: dict) -> None:
    """Main paths E and E': the headline and the ``bench --suspicion``
    headline with ``elementwise="swar"``, 100 rounds each as phases 5 and
    16 run them: exactly 100 K3 launches, all ``aligned_group/swar`` in
    the one-pass form, and a report equal to the lanes run's of this same
    invocation; then each with ``rr_resident="off"``."""
    import dataclasses

    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.bench import (
        CRASH_RATE, ROUNDS, tracked_crash_events)
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.metrics.detection import summarize
    from gossipfs_tpu_torch.ops import merge

    for label, key, lanes_key, cfg in (
            ("E", "main_e", "main",
             SimConfig.headline(N_MAIN, elementwise="swar")),
            ("E'", "main_e2", "sus_main",
             dataclasses.replace(suspicion_headline(), elementwise="swar"))):
        events, crash_rounds, churn_ok = tracked_crash_events(cfg, ROUNDS, 8,
                                                              20)
        kw = dict(events=events, crash_rate=CRASH_RATE, churn_ok=churn_ok,
                  crash_only_events=True)
        rkey = trandom.PRNGKey(0, device="cuda")
        # the same run once untimed: the profiled split of the previous
        # path leaves the allocator cold, and a first run pays its device
        # allocations (E' read 0.7 ms a round slower timed cold)
        run_rounds(init_state(cfg), cfg, ROUNDS, rkey, **kw)
        warm_both_forms(cfg, kw)
        state = init_state(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        merge.reset_launch_counts()
        t0 = time.perf_counter()
        with merge.record_launch_events() as evs:
            final, carry, per_round = run_rounds(state, cfg, ROUNDS, rkey,
                                                 **kw)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(merge.LAUNCH_COUNTS)
        forms = {k: v for k, v in merge.FORM_LAUNCHES.items() if v}
        check_onepass(f"main path {label}", "aligned_group/swar", ROUNDS)
        kernel_ms = sum(s.elapsed_time(e) for s, e in evs) / ROUNDS
        peak = torch.cuda.max_memory_allocated()
        round_ms = wall / ROUNDS * 1e3
        rep = summarize(carry, per_round, crash_rounds)
        lanes = results[lanes_key]
        log(f"  {label}: {ROUNDS} rounds in {wall:.4f} s, {ROUNDS / wall:.2f} "
            f"rounds/s; whole round {round_ms:.4f} ms, K3 {kernel_ms:.4f} "
            f"ms/round (CUDA events around each launch); the lanes run of "
            f"this invocation {lanes['round_ms']:.4f} ms, K3 "
            f"{lanes['kernel_ms']:.4f} ms; peak memory "
            f"{peak / 2**30:.3f} GiB")
        log(f"  launches {launches}, by form {forms}")
        log(f"  tracked ttd_first {sorted(rep.ttd_first.values())}, FPR "
            f"{rep.false_positive_rate:.3e}, true detections "
            f"{rep.true_detections}, final alive {rep.final_alive}")
        if rep.as_dict() != lanes["report"]:
            raise AssertionError(f"{key}: report != the lanes run's")
        log("  report equal to the lanes run's (TTD, FPR and every field)")
        results[key] = dict(launches=ROUNDS, rounds_per_s=ROUNDS / wall,
                            kernel_ms=kernel_ms, round_ms=round_ms,
                            launch_counts=launch_counts())
        resident_off_twin(f"main path {label}", cfg, ROUNDS, kw, 0,
                          (final, carry, per_round), results[key])
        results[key]["split"] = lean_split(cfg, SPLIT_ROUNDS,
                                           dict(crash_rate=CRASH_RATE),
                                           round_ms)


def phase_swar_separate(results: dict, rounds: int) -> None:
    """The separate-pass round with ``elementwise="swar"`` (the SWAR tick
    in torch ops, K4 unchanged): the eventful headline under 1 % crash
    and 1 % rejoin churn against the same run in the lanes form, then the
    profiled stage split beside phase 11's."""
    import dataclasses

    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.ops import merge

    cfg = SimConfig.headline(N_MAIN, elementwise="swar")
    kw = dict(crash_rate=0.01, rejoin_rate=0.01)
    out, walls = {}, {}
    for ew in ("lanes", "swar"):
        c = dataclasses.replace(cfg, elementwise=ew)
        state = init_state(c)
        torch.cuda.synchronize()
        merge.reset_launch_counts()
        t0 = time.perf_counter()
        out[ew] = run_rounds(state, c, rounds,
                             trandom.PRNGKey(5, device="cuda"), **kw)
        torch.cuda.synchronize()
        walls[ew] = time.perf_counter() - t0
        want = {k: (rounds if k == "arc_merge_update" else 0)
                for k in merge.LAUNCH_COUNTS}
        if merge.LAUNCH_COUNTS != want:
            raise AssertionError(f"separate-pass {ew}: launched "
                                 f"{merge.LAUNCH_COUNTS}")
    (sl, cl, ml), (ss, cs, ms) = out["lanes"], out["swar"]
    pairs = [("hb", sl.hb, ss.hb), ("asl", sl.asl, ss.asl),
             ("alive", sl.alive, ss.alive), ("hb_base", sl.hb_base, ss.hb_base)]
    pairs += [(f, getattr(cl, f), getattr(cs, f)) for f in cl._fields]
    pairs += [(f, getattr(ml, f), getattr(ms, f)) for f in ml._fields]
    bad = [name for name, a, b in pairs if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"separate-pass SWAR != lanes in {bad}")
    round_ms = walls["swar"] / rounds * 1e3
    log(f"  {rounds} rounds: SWAR {round_ms:.4f} ms a round, lanes "
        f"{walls['lanes'] / rounds * 1e3:.4f} ms (first runs, host clock); "
        f"lanes, carry and metrics equal (detections "
        f"{int(ms.true_detections.sum())}, alive {int(ms.n_alive[-1])}); "
        f"{rounds} K4 launches each")
    split = stage_split(cfg, SPLIT_ROUNDS, kw, round_ms)
    lanes_tick = results["arc"]["split"]["round.tick"]
    log(f"  round.tick: SWAR {split['round.tick']:.4f} ms against phase "
        f"11's lanes {lanes_tick:.4f} ms per round "
        f"({lanes_tick / split['round.tick']:.3f}x)")
    results["separate_swar"] = dict(round_ms=round_ms,
                                    rounds_per_s=rounds / walls["swar"],
                                    tick_ms=split["round.tick"],
                                    lanes_tick_ms=lanes_tick,
                                    launches={"arc_merge_update": rounds})


# ---------------------------------------------------------------------------
# Subject-axis sharding (phases 35-39): the column-shard forms of the
# kernels, and the sharded main paths in rank processes on this card.
# ---------------------------------------------------------------------------

N_SHARD_TALL = 4_096          # phase 35/36's tall-skinny width, 4 shards
N_CONFIG4 = 131_072           # config 4's N, 8 shards of 16,384
K4_LONG_F = 15_000            # a fanout whose halo outgrows a K4 window tile
K3_OUTS = ("hb", "asl", "member_cnt", "n_det", "first_obs", "recv_cnt",
           "entered", "refuted", "held", "suspect_cnt")
# the per-receiver outputs of the resident round (partial on a shard)
K3_RECV = (5, 9)


def count_diff(a, b) -> tuple[int, int]:
    """(entries that differ, max |diff|) of two integer tensors, in row
    chunks of about 2^26 entries (an [N, N] lane at N = 65,536 is 4.3 G
    entries)."""
    import torch

    step = max(1, (1 << 26) // max(1, a[0].numel() if a.dim() > 1 else 1))
    count, worst = 0, 0
    for r0 in range(0, max(1, a.shape[0] if a.dim() else 1), step):
        x, y = (a, b) if a.dim() == 0 else (a[r0:r0 + step], b[r0:r0 + step])
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        count += int((d != 0).sum())
        worst = max(worst, int(d.max()) if d.numel() else 0)
    return count, worst


def k3_shard_bound_ms(n: int, c: int, senders, outs: int,
                      recv_outs: int) -> float:
    """Byte bound of one shard round: both lanes read and written, flags,
    the [11, C] stack and the senders read, the per-subject [C] and
    per-receiver [N] int32 outputs written."""
    b = (4 * n * c + n + 11 * c + senders.numel() * 4
         + 4 * (outs - recv_outs) * c + 4 * recv_outs * n)
    return b / H100_BYTES_PER_S * 1e3


def k3_shard_case(n: int, c: int, senders, kw: dict, lanes, plain_at):
    """One K3 instantiation over the ``n // c`` shards of [N x C]: each
    shard launch == the square launch's column slice, the shards'
    per-receiver partials sum to the square launch's counts, the shards in
    ``plain_at`` == the plain version.  Returns (entries that differ, max
    |diff|, ms a launch and plain ms of the last shard, byte bound)."""
    import torch

    from gossipfs_tpu_torch.ops import merge

    hb, asl, flags, vecs = lanes
    shards = n // c
    square = merge.resident_round(hb.clone(), asl.clone(), flags, vecs,
                                  senders, **kw)
    nout = len(square)
    recv = [i for i in K3_RECV if i < nout]
    sums = {i: torch.zeros_like(square[i]) for i in recv}
    diffs = []
    for s in range(shards):
        sl = slice(s * c, (s + 1) * c)
        args = (hb[:, sl].contiguous(), asl[:, sl].contiguous(), flags,
                vecs[:, sl].contiguous(), senders)
        got = merge.resident_round(
            *(a.clone() if i < 2 else a for i, a in enumerate(args)),
            col_offset=s * c, **kw)
        for i in range(nout):
            if i in recv:
                sums[i] += got[i]
                continue
            want = square[i][:, sl] if i < 2 else square[i][sl]
            diffs.append(count_diff(got[i], want))
        if s in plain_at:
            plain = merge.resident_round_plain(
                *(a.clone() if i < 2 else a for i, a in enumerate(args)),
                col_offset=s * c, **kw)
            diffs += [count_diff(a, b) for a, b in zip(got, plain)]
        if s == shards - 1:
            h2, a2 = args[0].clone(), args[1].clone()
            run = lambda: merge.resident_round(  # noqa: E731
                h2, a2, *args[2:], col_offset=s * c, **kw)
            run()
            ms = min(cuda_ms(run, 10), cuda_ms(run, 10))
            run_p = lambda: merge.resident_round_plain(  # noqa: E731
                h2, a2, *args[2:], col_offset=s * c, **kw)
            run_p()
            plain_ms = cuda_ms(run_p, 2)
    diffs += [count_diff(sums[i], square[i]) for i in recv]
    torch.cuda.synchronize()
    bound = k3_shard_bound_ms(n, c, senders, nout, len(recv))
    return (sum(d[0] for d in diffs), max(d[1] for d in diffs), ms,
            plain_ms, bound)


def phase_k3_column_shard(results: dict) -> None:
    """K3's column-shard form (g) on the card: every one of the 30
    instantiations (5 merge forms x crash-only / suspicion / + Lifeguard x
    lanes / SWAR) over 4 shards [16,384 x 4,096] of one round: each shard
    launch == the square launch's column slice, the shards' per-receiver
    partials sum to the square launch's counts, and the shards at
    col_offset 0 and 12,288 == the plain version; then the shape of main
    paths F and F' (the headline's crash-only aligned form, lanes and
    SWAR, over 2 shards [16,384 x 8,192], both against plain); then
    config 4's layout (shards 0 and 7 of [131,072 x 16,384], aligned arcs
    F = 16, lanes and SWAR, crash-only and suspicion) against the plain
    version.  ms per launch beside the byte bound of each shard shape."""
    import torch

    from gossipfs_tpu_torch.ops import merge

    n, c = N_MAIN, N_SHARD_TALL
    forms, modes, muted = swar_round_cases(n)
    bad = 0
    out = results.setdefault("k3_shard", {})
    for ew in merge.ELEMENTWISE:
        for form, (senders, fkw) in forms.items():
            for mode, ((hb, asl, flags, vecs), mkw) in modes.items():
                if fkw.get("edge_filter"):
                    flags = flags + muted
                kw = dict(fkw, t_cooldown=12, elementwise=ew, **mkw)
                diff, err, ms, plain_ms, bound = k3_shard_case(
                    n, c, senders, kw, (hb, asl, flags, vecs),
                    (0, n // c - 1))
                bad += diff
                name = merge.kernel_form(kw.get("fanout"),
                                         kw.get("arc_align", 1),
                                         kw.get("edge_filter", False), ew)
                out[(name, mode, "tall")] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, shape=[n, c])
                log(f"  [{n} x {c}] {name}, {mode}: 4 shards vs the square "
                    f"launch's slices and partial sums, offsets 0 and "
                    f"{n - c} vs plain: {diff} entries differ; {ms:.4f} ms "
                    f"a shard launch, plain {plain_ms:.3f} ms, byte bound "
                    f"{bound:.4f} ms")
    # main paths F and F': the headline (crash-only, aligned arcs F = 16)
    # over 2 ranks, [16,384 x 8,192] a rank
    c = N_MAIN // 2
    senders, fkw = forms["aligned_group"]
    lanes, mkw = modes["crash-only"]
    for ew in merge.ELEMENTWISE:
        kw = dict(fkw, t_cooldown=12, elementwise=ew, **mkw)
        diff, err, ms, plain_ms, bound = k3_shard_case(
            n, c, senders, kw, lanes, (0, 1))
        bad += diff
        name = merge.kernel_form(16, 8, False, ew)
        out[(name, "crash-only", "main")] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            shape=[n, c])
        log(f"  [{n} x {c}] (main paths F/F') {name}, crash-only: 2 shards "
            f"vs the square launch's slices and partial sums and vs plain: "
            f"{diff} entries differ; {ms:.4f} ms a shard launch, plain "
            f"{plain_ms:.3f} ms, byte bound {bound:.4f} ms")
    # config 4's layout: 8 shards of [131,072 x 16,384], shards 0 and 7
    n, c = N_CONFIG4, N_CONFIG4 // 8
    for mode, mkw in (("crash-only", dict(t_fail=5)),
                      ("suspicion", dict(t_fail=3, suspect=True,
                                         t_suspect=2))):
        hb, asl, flags, vecs, bases = big_round_inputs(n, c, SEED + 35,
                                                       mode != "crash-only")
        for ew in merge.ELEMENTWISE:
            kw = dict(fanout=16, arc_align=8, t_cooldown=12, elementwise=ew,
                      **mkw)
            for s in (0, 7):
                got = merge.resident_round(hb.clone(), asl.clone(), flags,
                                           vecs, bases, col_offset=s * c,
                                           **kw)
                want = merge.resident_round_plain(hb.clone(), asl.clone(),
                                                  flags, vecs, bases,
                                                  col_offset=s * c, **kw)
                diffs = [count_diff(a, b) for a, b in zip(got, want)]
                diff = sum(d[0] for d in diffs)
                bad += diff
                msg = ""
                if s == 7:
                    h2, a2 = hb.clone(), asl.clone()
                    run = lambda: merge.resident_round(  # noqa: E731
                        h2, a2, flags, vecs, bases, col_offset=s * c, **kw)
                    run()
                    ms = min(cuda_ms(run, 5), cuda_ms(run, 5))
                    del h2, a2
                    bound = k3_shard_bound_ms(n, c, bases, len(got), 1)
                    out[(f"aligned_group{'/swar' if ew == 'swar' else ''}",
                         mode, "config4")] = dict(
                        max_abs_err=max(d[1] for d in diffs), ms=ms,
                        bound_ms=bound)
                    msg = (f"; {ms:.4f} ms a launch, byte bound "
                           f"{bound:.4f} ms")
                log(f"  [{n} x {c}] shard {s}, aligned_group ({ew}), {mode}:"
                    f" kernel vs plain: {diff} entries differ (detections "
                    f"{int(got[3].sum())}){msg}")
                del got, want
        del hb, asl
        torch.cuda.empty_cache()
    # tolerance 0: integer outputs
    if bad:
        raise AssertionError(f"K3 column-shard form: {bad} entries differ")
    log("  K3 column-shard form == the square launch's slices == plain, "
        "all 30 instantiations and config 4's layout (tolerance 0)")


def big_round_inputs(n: int, c: int, seed: int, suspect: bool):
    """A shard's pre-tick lanes made on the card (a [131,072 x 16,384]
    block is 2.1 G entries a lane): every status (SUSPECT under
    ``suspect``), ages to the clamp, never-sent entries, mixed flags (bit
    4 on some rows), deep shifts; aligned arc bases."""
    import torch

    from gossipfs_tpu_torch.config import INT8_REBASE_WINDOW
    from gossipfs_tpu_torch.ops import merge

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = dict(device="cuda")
    hb = torch.empty((n, c), dtype=torch.int8, **dev)
    asl = torch.empty((n, c), dtype=torch.int8, **dev)
    # row chunks of 2^27 entries (8,192 rows of a 16,384-column block)
    step = max(1, (1 << 27) // c)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        h = torch.randint(-128, 128, (r1 - r0, c), generator=g, **dev)
        h[torch.rand((r1 - r0, c), generator=g, **dev) < 0.05] = -128
        hb[r0:r1] = h.to(torch.int8)
        st = torch.randint(0, 4 if suspect else 3, (r1 - r0, c),
                           generator=g, **dev)
        age = torch.randint(0, 64, (r1 - r0, c), generator=g, **dev)
        if suspect:
            age = torch.where(st == 3, torch.randint(
                3, 14, (r1 - r0, c), generator=g, **dev), age)
        asl[r0:r1] = (((age << 2) | st) - 128).to(torch.int8)
    choice = torch.tensor([0, 4, 5, 6, 1, 7], dtype=torch.int8, **dev)
    flags = choice[torch.randint(0, 6, (n,), generator=g, **dev)]
    flags = flags + 16 * (torch.rand(n, generator=g, **dev) < 0.5).to(
        torch.int8)
    sa = torch.randint(-260, 60, (c,), generator=g, **dev).to(torch.int32)
    sb = torch.where(torch.rand(c, generator=g, **dev) < 0.5, sa,
                     torch.randint(-260, 60, (c,), generator=g, **dev)
                     .to(torch.int32))
    gr = torch.randint(-200, 60, (c,), generator=g, **dev).to(torch.int32)
    vecs = merge.threshold_stack(sa, sb, gr, INT8_REBASE_WINDOW)
    bases = (torch.randint(0, n // 8, (n,), generator=g, **dev) * 8).to(
        torch.int32)
    return hb, asl, flags, vecs, bases


def big_merge_inputs(n: int, c: int, fanout: int, hdt, seed: int,
                     vdt=None):
    """One merge call's inputs over an [N, C] block, made on the card:
    post-tick lanes over every status, ages to 63 (a fifth at 0), floor
    sentinels, dead receivers (their view rows absent), deep and negative
    shifts; an int8 view (``vdt``: another view type, values as
    :func:`merge_inputs` draws them); explicit edges and arc bases."""
    import torch

    from gossipfs_tpu_torch.ops.merge import pack_age_status

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = dict(device="cuda")
    info = torch.iinfo(hdt)
    # int32 lanes as merge_inputs draws them, clear of the shifts' overflow
    lo, hi = ((-2**20, 2**20) if hdt == torch.int32
              else (info.min, info.max))
    vdt = vdt or torch.int8
    top = 126 if vdt == torch.int8 else 16_384
    alive = torch.rand(n, generator=g, **dev) < 0.8
    view = torch.empty((n, c), dtype=vdt, **dev)
    hb = torch.empty((n, c), dtype=hdt, **dev)
    asl = torch.empty((n, c), dtype=torch.int8, **dev)
    # row chunks of at most 2^27 entries (8,192 rows of 16,384 columns)
    step = min(8_192, max(1, (1 << 27) // c))
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        shape = (r1 - r0, c)
        v = torch.randint(-1, top + 1, shape, generator=g, **dev)
        view[r0:r1] = torch.where(alive[r0:r1, None], v, -1).to(vdt)
        h = torch.randint(lo, hi + 1, shape, generator=g, **dev)
        h[torch.rand(shape, generator=g, **dev) < 0.05] = info.min
        hb[r0:r1] = h.to(hdt)
        age = torch.randint(0, 64, shape, generator=g, **dev)
        age[torch.rand(shape, generator=g, **dev) < 0.2] = 0
        st = torch.randint(0, 4, shape, generator=g, **dev)
        asl[r0:r1] = pack_age_status(age, st)
    sa = torch.randint(-70_000, 70_000, (c,), generator=g, **dev).to(
        torch.int32)
    sb = torch.where(torch.rand(c, generator=g, **dev) < 0.5, sa,
                     torch.randint(-70_000, 70_000, (c,), generator=g, **dev)
                     .to(torch.int32))
    edges = torch.randint(0, n, (n, fanout), generator=g, **dev).to(
        torch.int32)
    bases = torch.randint(0, n, (n,), generator=g, **dev).to(torch.int32)
    return view, edges, bases, hb, asl, sa, sb, alive


def merge_block_bound_ms(view, senders, hb, outputs: int) -> float:
    """Byte bound of one merge over an [N, C] block: view and senders
    read, hb and asl read and written, shifts [C] and alive [N] read,
    ``outputs`` int32 [C] reductions written."""
    n, c = hb.shape
    b = (view.numel() * view.element_size()
         + senders.numel() * senders.element_size()
         + 2 * hb.numel() * hb.element_size() + 2 * n * c
         + 8 * c + n + 4 * outputs * c)
    return b / H100_BYTES_PER_S * 1e3


def phase_merge_column_blocks(results: dict) -> None:
    """K2, K4 and K5 over column blocks against their plain versions, at
    the shapes of the main paths that launch them: K2 on main path G's
    shard [32,768 x 16,384] (int16 hb, int8 view, F = 15), K4 on
    full_scale's [65,536 x 8,192] (int8, F = 16), K5 on main path B
    sharded's [16,384 x 8,192] (int8, F = 14); K2 on config 4's shard
    [131,072 x 16,384] (F = 17) and on phase 12's square [65,536 x 65,536]
    (int16 hb, int8 view, F = 16: the largest K2 a main path launches).
    Detection stats and suspicion on and off; ms (in the path's own mode),
    plain ms and the byte bound at each shape."""
    import torch

    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.ops import merge_update as mu

    n_g = 32_768
    cases = (
        ("k2_block", mu.fused_merge_update, n_g, n_g // 2,
         SimConfig.log_fanout(n_g), torch.int16, "edges", {}, False),
        ("k4_block", mu.arc_merge_update, N_CAPACITY, N_CAPACITY // 8, 16,
         torch.int8, "bases", dict(fanout=16), False),
        ("k5_block", mu.stripe_merge_update, N_MAIN, N_MAIN // 2,
         SimConfig.log_fanout(N_MAIN), torch.int8, "edges", {}, True),
        ("k2_block_config4", mu.fused_merge_update, N_CONFIG4,
         N_CONFIG4 // 8, SimConfig.log_fanout(N_CONFIG4), torch.int16,
         "edges", {}, False),
        ("k2_config4_fault", mu.fused_merge_update, N_CAPACITY, N_CAPACITY,
         SimConfig.log_fanout(N_CAPACITY), torch.int16, "edges", {}, False),
    )
    bad = 0
    for key, fn, n, c, f, hdt, which, extra, path_sus in cases:
        plain = getattr(mu, fn.__name__ + "_plain")
        view, edges, bases, hb, asl, sa, sb, alive = big_merge_inputs(
            n, c, f, hdt, SEED + n + c)
        snd = edges if which == "edges" else bases
        err = 0
        for det, sus in ((False, False), (True, False), (True, True)):
            kw = dict(detect_stats=det, suspect=sus, **extra)
            got = fn(view, snd, hb.clone(), asl.clone(), sa, sb, alive, **kw)
            want = plain(view, snd, hb.clone(), asl.clone(), sa, sb, alive,
                         **kw)
            diffs = [count_diff(a, b) for a, b in zip(got, want)]
            diff = sum(d[0] for d in diffs)
            err = max([err] + [d[1] for d in diffs])
            bad += diff
            log(f"  {fn.__name__} [{n} x {c}], F={f}, hb {hdt}, "
                f"detect_stats={det}, suspect={sus}: kernel vs plain: "
                f"{diff} entries differ (cnt_incl total "
                f"{int(got[2].sum())})")
            del got, want
        kw = dict(detect_stats=True, suspect=path_sus, **extra)
        h2, a2 = hb.clone(), asl.clone()
        run = lambda: fn(view, snd, h2, a2, sa, sb, alive, **kw)  # noqa: E731
        run_p = lambda: plain(view, snd, h2, a2, sa, sb, alive, **kw)  # noqa: E731
        run()
        ms = min(cuda_ms(run, 10), cuda_ms(run, 10))
        run_p()
        plain_ms = cuda_ms(run_p, 1)
        bound = merge_block_bound_ms(view, snd, hb, 5 if path_sus else 3)
        results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, shape=[n, c])
        log(f"  {fn.__name__} [{n} x {c}], suspect={path_sus}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, byte bound "
            f"{bound:.4f} ms")
        del view, hb, asl, h2, a2
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"K2/K4/K5 column blocks: {bad} entries differ")
    log("  K2, K4 and K5 over column blocks == plain (tolerance 0)")


def scan_rounds() -> int:
    """Rounds of the kernel-against-plain scans of phases 4, 9, 15, 20, 31
    and 33, from the headline's knobs: a crash in round 1 is marked failed
    t_fail rounds later and its fail-list entry expires t_cooldown after
    that, both inside the scan, with 2 rounds to spare (20 at t_fail 5,
    t_cooldown 12)."""
    from gossipfs_tpu_torch.config import SimConfig

    cfg = SimConfig.headline(N_MAIN)
    return 1 + cfg.t_fail + cfg.t_cooldown + 2


def run_tensors(state, carry, metrics) -> list:
    """A run's whole outputs: lanes, alive, hb_base, carry and every
    per-round metric."""
    return [state.hb, state.asl, state.alive, state.hb_base, *carry,
            *metrics]


def runs_equal(a, b) -> bool:
    """Whether two runs' whole outputs are bit-equal (on their device)."""
    import torch

    return all(torch.equal(x, y)
               for x, y in zip(run_tensors(*a), run_tensors(*b)))


def run_digest(state, carry, metrics) -> str:
    """sha256 of a run's whole outputs (lanes, alive, hb_base, carry and
    every per-round metric), on the host."""
    import hashlib

    h = hashlib.sha256()
    for t in run_tensors(state, carry, metrics):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def shard_ranks(rank: int, world: int, device, jobs: list) -> list:
    """One rank of phases 37-38 (a ``distributed.launch`` target): each
    job through ``parallel.mesh.run_job``; rank 0 turns the gathered
    state into a digest and a report, so only small results travel
    back."""
    from gossipfs_tpu_torch.metrics.detection import summarize
    from gossipfs_tpu_torch.parallel import mesh

    out = []
    for job in jobs:
        res = mesh.run_job(rank, world, device, job)
        if "state" in res:
            state, carry = res.pop("state"), res.pop("carry")
            res["digest"] = run_digest(state, carry, res["metrics"])
            res["report"] = summarize(carry, res.pop("metrics"),
                                      job.get("crash_rounds")).as_dict()
        out.append(res)
    return out


def single_digest(cfg, rounds: int, seed: int, kw: dict,
                  crash_rounds=None) -> tuple[str, dict, float, dict]:
    """The same run in this process on the card: (digest, report, ms a
    round, launch counts)."""
    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.metrics.detection import summarize
    from gossipfs_tpu_torch.ops import merge

    dev = {k: (v.cuda() if hasattr(v, "cuda") else v) for k, v in kw.items()}
    if dev.get("events") is not None:
        dev["events"] = type(kw["events"])(*(t.cuda() for t in kw["events"]))
    state = init_state(cfg)
    torch.cuda.synchronize()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    st, carry, per_round = run_rounds(state, cfg, rounds,
                                      trandom.PRNGKey(seed, device="cuda"),
                                      **dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / rounds * 1e3
    rep = summarize(carry, per_round, crash_rounds).as_dict()
    return run_digest(st, carry, per_round), rep, ms, dict(
        merge.LAUNCH_COUNTS)


def check_sharded(label: str, ranks: list, want_digest: str,
                  kernel: str, rounds: int, forms: dict | None = None):
    """Each rank launched ``rounds`` of ``kernel`` (and the ``forms``) and
    no other kernel; the gathered outputs' digest is the single-process
    run's."""
    for r in ranks:
        want = {k: (rounds if k == kernel else 0) for k in r["launches"]}
        if r["launches"] != want or (forms is not None
                                     and r["forms"] != forms):
            raise AssertionError(f"{label}: rank {r['rank']} launched "
                                 f"{r['launches']} {r['forms']}")
    if ranks[0]["digest"] != want_digest:
        raise AssertionError(f"{label}: the gathered shards != the "
                             "single-process run")


def phase_sharded_headline(results: dict) -> None:
    """Main paths F and F': the lean headline sharded over 2 rank
    processes (on one card: gloo; a card each: NCCL), lanes and SWAR, 100
    rounds, 1 % crash churn, 8 tracked crashes: the gathered lanes, carry
    and metrics equal the same run in this process, the report equals
    phase 5's (and phase 32's); each rank launched exactly 100 resident
    rounds, all ``aligned_group`` (``aligned_group/swar``) in the one-pass
    column-block form; then both again with ``rr_resident="off"`` (the
    two-launch column-shard form) in the same rank processes, equal to the
    same single-process run."""
    import dataclasses

    import torch

    from gossipfs_tpu_torch.bench import (
        CRASH_RATE, ROUNDS, tracked_crash_events)
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.parallel import distributed

    torch.cuda.empty_cache()
    world = 2
    cfgs = {"F": SimConfig.headline(N_MAIN),
            "F'": SimConfig.headline(N_MAIN, elementwise="swar")}
    jobs, singles = [], {}
    for label, cfg in cfgs.items():
        events, crash_rounds, churn_ok = tracked_crash_events(
            cfg, ROUNDS, 8, 20, device="cpu")
        kw = dict(events=events, crash_rate=CRASH_RATE, churn_ok=churn_ok,
                  crash_only_events=True)
        singles[label] = single_digest(cfg, ROUNDS, 0, kw, crash_rounds)
        jobs.append(dict(config=cfg, rounds=ROUNDS, seed=0, warm=True,
                         crash_rounds=crash_rounds, **kw))
    # the two-launch twins, after both one-pass jobs
    jobs += [dict(job, config=dataclasses.replace(job["config"],
                                                   rr_resident="off"))
             for job in list(jobs)]
    t0 = time.perf_counter()
    ranks = distributed.launch(shard_ranks, world, (jobs,), timeout=600)
    cards = len({str(distributed.device_for_rank(r)) for r in range(world)})
    log(f"  {world} rank processes on {cards} card(s), "
        f"{torch.cuda.get_device_name(0)}, {ranks[0][0]['backend']}"
        f"{' through the host' if ranks[0][0]['backend'] == 'gloo' else ''}"
        f": {time.perf_counter() - t0:.1f} s with start-up")
    for i, (label, cfg) in enumerate(cfgs.items()):
        per = [r[i] for r in ranks]
        form = "aligned_group" + ("/swar" if label == "F'" else "")
        check_sharded(label, per, singles[label][0], "resident_round",
                      ROUNDS, {form + ONEPASS: ROUNDS})
        off = [r[i + len(cfgs)] for r in ranks]
        check_sharded(label + ", rr_resident='off'", off, singles[label][0],
                      "resident_round", ROUNDS, {form: ROUNDS})
        rep = per[0]["report"]
        if rep != singles[label][1] or rep != results["main"]["report"]:
            raise AssertionError(f"{label}: report != phase 5's")
        secs = max(r["seconds"] for r in per)
        coll = per[0]["collectives"]
        round_ms = secs / ROUNDS * 1e3
        allreduce_ms = coll["seconds"] / ROUNDS * 1e3
        log(f"  {label} ({form}): shard [{cfg.n} x {per[0]['nloc']}] a rank;"
            f" {ROUNDS} rounds in {secs:.4f} s, {ROUNDS / secs:.2f} rounds/s"
            f", {round_ms:.4f} ms a round (the single-process run "
            f"{singles[label][2]:.4f} ms); all-reduce {allreduce_ms:.4f} ms "
            f"a round ({coll['calls']} collectives, host clock, waiting for "
            f"the other rank included); peak memory a rank "
            f"{max(r['peak_bytes'] for r in per) / 2**30:.3f} GiB")
        log(f"  {label}: launches a rank {[r['forms'] for r in per]}; "
            f"gathered lanes, carry and metrics == the single-process run; "
            f"report == phase 5's: ttd_first "
            f"{sorted(rep['ttd_first'].values())}, FPR "
            f"{rep['false_positive_rate']:.3e}")
        off_secs = max(r["seconds"] for r in off)
        log(f"  {label}, rr_resident='off' (the two-launch column-shard "
            f"form): {off_secs / ROUNDS * 1e3:.4f} ms a round, "
            f"{ROUNDS / off_secs:.2f} rounds/s; gathered lanes, carry and "
            "metrics == the same single-process run")
        results["main_f" + ("2" if label == "F'" else "")] = dict(
            round_ms=round_ms, rounds_per_s=ROUNDS / secs,
            allreduce_ms=allreduce_ms, launches=per[0]["launches"][
                "resident_round"],
            launch_counts={"resident_round": ROUNDS,
                           f"resident_round[{form}{ONEPASS}]": ROUNDS,
                           "ranks": world},
            off=dict(round_ms=off_secs / ROUNDS * 1e3,
                     rounds_per_s=ROUNDS / off_secs, launches=ROUNDS,
                     launch_counts={"resident_round": ROUNDS,
                                    f"resident_round[{form}]": ROUNDS,
                                    "ranks": world}))


def phase_sharded_config4(results: dict) -> None:
    """Main path G: config 4's fault model (``sim_100k``: explicit edges
    F = log N, int16 hb, int8 view, 5 % crash + 5 % rejoin) cut to N =
    32,768 over 2 rank processes (16,384 columns a rank, config 4's
    width a chip), 10 rounds, against the single-process run at the same
    N: bit-equal, 10 K2 launches a rank.  Beside it main path B sharded
    (``suspicion_rr(16_384)`` under 1 % crash and rejoin churn, K5 over
    [16,384 x 8,192] blocks), 10 rounds, the same checks."""
    import dataclasses

    import torch

    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.models.presets import ALL
    from gossipfs_tpu_torch.parallel import distributed

    torch.cuda.empty_cache()
    world, rounds = 2, 10
    sc = ALL["sim-100k"]
    n = 32_768
    runs = {
        "G": (dataclasses.replace(sc.config, n=n,
                                  fanout=SimConfig.log_fanout(n)),
              dict(crash_rate=sc.crash_rate, rejoin_rate=sc.rejoin_rate),
              "fused_merge_update"),
        "B (sharded)": (SimConfig.suspicion_rr(N_MAIN),
                        dict(crash_rate=0.01, rejoin_rate=0.01),
                        "stripe_merge_update"),
    }
    jobs, singles = [], {}
    for label, (cfg, kw, _) in runs.items():
        singles[label] = single_digest(cfg, rounds, 3, kw)
        jobs.append(dict(config=cfg, rounds=rounds, seed=3, **kw))
        torch.cuda.empty_cache()
    ranks = distributed.launch(shard_ranks, world, (jobs,), timeout=600)
    for i, (label, (cfg, _, kernel)) in enumerate(runs.items()):
        per = [r[i] for r in ranks]
        if singles[label][3][kernel] != rounds:
            raise AssertionError(f"{label}: single-process launches "
                                 f"{singles[label][3]}")
        check_sharded(label, per, singles[label][0], kernel, rounds)
        secs = max(r["seconds"] for r in per)
        coll = per[0]["collectives"]
        log(f"  {label}: N={cfg.n}, F={cfg.fanout}, hb {cfg.hb_dtype}, "
            f"shard [{cfg.n} x {per[0]['nloc']}] a rank; {rounds} rounds in "
            f"{secs:.4f} s ({secs / rounds * 1e3:.4f} ms a round, the "
            f"single-process run {singles[label][2]:.4f} ms); all-reduce "
            f"{coll['seconds'] / rounds * 1e3:.4f} ms a round; {kernel} "
            f"launches a rank {[r['launches'][kernel] for r in per]}; "
            f"gathered lanes, carry and metrics == the single-process run;"
            f" peak memory a rank "
            f"{max(r['peak_bytes'] for r in per) / 2**30:.3f} GiB")
        results["main_g" if label == "G" else "main_b_sharded"] = dict(
            round_ms=secs / rounds * 1e3, rounds_per_s=rounds / secs,
            allreduce_ms=coll["seconds"] / rounds * 1e3,
            launches=per[0]["launches"][kernel],
            launch_counts={kernel: rounds, "ranks": world})


def phase_full_scale(results: dict) -> None:
    """``python -m gossipfs_tpu_torch.full_scale --n 65536 --rounds 16
    --devices 8`` on this card: 8 rank processes, K4 over [65,536 x
    8,192] blocks.  Its JSON beside FULLSCALE.json's ``current`` row (the
    JAX package's run with the same arguments), each rank's peak memory
    and launches."""
    import ast
    import os
    import re

    import torch

    torch.cuda.empty_cache()
    args = ["--n", "65536", "--rounds", "16", "--devices", "8"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gossipfs_tpu_torch.full_scale",
                           *args], capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise AssertionError(f"full_scale exited {proc.returncode}")
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"  full_scale {' '.join(args)}: {wall:.1f} s with start-up")
    log(f"  port: {json.dumps(doc)}")
    ranks = [ln for ln in proc.stderr.splitlines()
             if ln.startswith("full_scale: rank")]
    for ln in ranks:
        log(f"  {ln}")
    launches = [ast.literal_eval(re.search(r"launches (\{.*\})", ln)[1])
                for ln in ranks]
    if len(launches) != 8 or any(
            d.get("arc_merge_update") != 16 or sum(d.values()) != 16
            for d in launches):
        raise AssertionError(f"full_scale launches {launches}")
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "FULLSCALE.json")
    with open(ref_path) as f:
        ref = json.load(f)["current"]
    log(f"  JAX (FULLSCALE.json current): {json.dumps(ref)}")
    keys = ("detected", "ttd_first_median", "ttd_first_max",
            "ttd_converged_median", "ttd_converged_max",
            "false_positive_rate")
    same = {k: doc[k] == ref[k] for k in ("tracked_crashes",) + keys}
    log(f"  equal to FULLSCALE.json's row: {same}")
    # the same arguments and key as the JAX package's run: every detection
    # field must be its, exactly
    if not all(same.values()):
        raise AssertionError(f"full_scale's detection fields != "
                             f"FULLSCALE.json's: {same}")
    results["full_scale"] = dict(
        round_ms=doc["wall_seconds"] / doc["rounds"] * 1e3,
        rounds_per_s=doc["rounds_per_sec"], doc=doc, same_as_jax=same,
        launches=launches[0]["arc_merge_update"],
        launch_counts={"arc_merge_update": 16, "ranks": 8})


# the mode of each one-pass row of the kernels line: that of the path that
# launches it (the SWAR rows as SWAR_ROW_MODE); aligned_group and edges
# also in the mode of their second path (A, D')
ONEPASS_ROWS = (("aligned_group", "crash-only"),
                ("aligned_group", "suspicion"),
                ("edges", "crash-only"), ("edges", "suspicion"),
                ("arc", "crash-only"), ("filter_group", "suspicion"),
                ("filter_rows", "crash-only"),
                ("aligned_group/swar", "suspicion")) + tuple(
    (f + "/swar", m) for f, m in SWAR_ROW_MODE.items())


# K3 (f)'s ms before its redesign for Hopper (the first one-pass kernel's
# final run, PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W), by
# kernels-line row.  Those runs timed rounds from phase 30's random lanes,
# not from the lanes after 20 rounds as this phase does: other inputs, so
# only the two-launch form timed in turns is a like-for-like yardstick
ONEPASS_MS_BEFORE = {
    ("aligned_group", "crash-only"): 2.0466,
    ("aligned_group", "suspicion"): 2.5508,
    ("edges", "crash-only"): 3.0544, ("edges", "suspicion"): 3.5492,
    ("arc", "crash-only"): 2.9214, ("filter_group", "suspicion"): 2.5327,
    ("filter_rows", "crash-only"): 2.8932,
    ("aligned_group/swar", "crash-only"): 1.2589,
    ("aligned_group/swar", "suspicion"): 1.3825,
    ("edges/swar", "suspicion"): 2.1478, ("arc/swar", "crash-only"): 2.0406,
    ("filter_group/swar", "suspicion"): 1.4124,
    ("filter_rows/swar", "crash-only"): 1.9424,
    ("aligned_group", "crash-only", "block"): 1.1230,
    ("aligned_group/swar", "crash-only", "block"): 0.6577,
}


def cuobjdump() -> str | None:
    import os
    import shutil

    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "cuobjdump")
        if cand and os.path.exists(path):
            return path
    return shutil.which("cuobjdump")


def warm_start(run, hb, asl, rounds: int = 20):
    """Run ``rounds`` rounds of ``run`` (which updates ``hb``, ``asl`` in
    place) and return a function that puts those lanes back, so that
    timed runs walk the same rounds past phase 30's corner-case start."""
    for _ in range(rounds):
        run()
    start = (hb.clone(), asl.clone())

    def reset():
        hb.copy_(start[0])
        asl.copy_(start[1])

    return reset


def in_turns(run_a, run_b, reset, turns: int = 3):
    """ms of 10 calls of ``run_a`` and of ``run_b`` (each from ``reset``),
    timed in turns a, b, b, a, ``turns`` times: the two lists."""
    a_ms, b_ms = [], []
    for _ in range(turns):
        a_ms.append(cuda_ms(run_a, 10, reset))
        b_ms += [cuda_ms(run_b, 10, reset), cuda_ms(run_b, 10, reset)]
        a_ms.append(cuda_ms(run_a, 10, reset))
    return a_ms, b_ms


def sm_clock() -> str:
    """The card's SM clock and power draw now (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def onepass_sass(lib_path: str) -> dict:
    """Static SASS instruction counts of each rr_onepass_kernel
    instantiation in the built library (``cuobjdump -sass``; NOPs left
    out), keyed by its template flags (kSus, kLh, kForm, kSwar, kBlock):
    the whole kernel, and the code between the timeline's stamps of step 1
    (tick and park) and of step 2 (gather and merge).  Empty where
    cuobjdump is missing."""
    import re

    tool = cuobjdump()
    if tool is None:
        return {}
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        m = re.match(r"\S*rr_onepass_kernelILb(\d)ELb(\d)ELi(\d)ELb(\d)"
                     r"ELb(\d)E", part)
        if m is None:
            continue
        lines = [ln for ln in part.splitlines()
                 if re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", ln)
                 and " NOP" not in ln]
        # the five stamps: a stamp reads GLOBALTIMER in a run of a few
        # instructions, and steps lie between the runs
        marks = []
        for i, ln in enumerate(lines):
            if "GLOBALTIMER" in ln and (not marks or i - marks[-1] > 8):
                marks.append(i)
        row = {"total": len(lines)}
        if len(marks) == 5:
            row["step1"] = marks[1] - marks[0]
            row["step2"] = marks[3] - marks[2]
        out[tuple(int(g) for g in m.groups())] = row
    return out


def onepass_flags(name: str, mode: str, block: bool = False) -> tuple:
    """The rr_onepass_kernel template flags of a kernels-line row."""
    from gossipfs_tpu_torch.ops import merge

    return (int(mode != "crash-only"), int(mode == "suspicion + lh"),
            merge.FORMS.index(name.split("/")[0]), int("/swar" in name),
            int(block))


def phase_k3_onepass(results: dict) -> None:
    """K3's one-pass form (f) in every instantiation the lean gate reaches
    (5 merge forms x crash-only / suspicion / + Lifeguard x lanes / SWAR),
    one round at N = 16,384 on phase 30's inputs: bit-equal to the plain
    version and to the two-launch form; then over the 2 column blocks
    [16,384 x 8,192] of main paths F and F' (shards 0 and 1): each shard
    launch == plain and == the two-launch shard launch, and the shards'
    per-receiver partials sum to the square (f) launch's counts.  ms of (f)
    and of the two-launch form in turns (two-launch, (f), (f),
    two-launch) beside the byte bound, the plain version's ms and the
    kernel's step timeline (microseconds a stripe in step 1, the cluster
    sync, step 2, the tail) for the
    kernels line's rows; the clusters the card runs at once."""
    import torch

    from gossipfs_tpu_torch.ops import merge

    n, c = N_MAIN, N_MAIN // 2
    forms, modes, muted = swar_round_cases(n)
    clusters = {}
    for form, (senders, fkw) in forms.items():
        clusters[form] = merge.onepass_clusters(
            n, n, form, fanout=fkw.get("fanout", senders.shape[-1]),
            arc_align=fkw.get("arc_align", 1))
    smem = {f: merge.onepass_smem(n, f) for f in ("edges", "aligned_group")}
    log(f"  stripe clusters of {merge.ONEPASS_CTAS} CTAs the card runs at "
        f"once (cudaOccupancyMaxActiveClusters; {smem['edges']} B of shared "
        f"memory a CTA in the full-view forms, {smem['aligned_group']} B in "
        f"the aligned ones): {clusters}")
    out = results.setdefault("k3_onepass", {"clusters": clusters})
    log(f"  SM clock, power: {sm_clock()}")
    from gossipfs_tpu_torch.ops import _build

    sass = onepass_sass(str(_build.build(["rr_onepass"])["rr_onepass"]))
    out["sass"] = sass
    log(f"  SASS of {len(sass)} rr_onepass_kernel instantiations counted"
        + ("" if sass else " (no cuobjdump here)"))
    rows = set(ONEPASS_ROWS)
    bad = 0
    for ew in merge.ELEMENTWISE:
        for form, (senders, fkw) in forms.items():
            for mode, ((hb, asl, flags, vecs), mkw) in modes.items():
                if fkw.get("edge_filter"):
                    flags = flags + muted
                kw = dict(fkw, t_cooldown=12, elementwise=ew, **mkw)
                name = merge.kernel_form(kw.get("fanout"),
                                         kw.get("arc_align", 1),
                                         kw.get("edge_filter", False), ew)
                got = merge.resident_round(hb.clone(), asl.clone(), flags,
                                           vecs, senders, onepass=True, **kw)
                want = merge.resident_round_plain(hb.clone(), asl.clone(),
                                                  flags, vecs, senders, **kw)
                two = merge.resident_round(hb.clone(), asl.clone(), flags,
                                           vecs, senders, **kw)
                diffs = [count_diff(a, b) for a, b in zip(got, want)]
                diffs += [count_diff(a, b) for a, b in zip(got, two)]
                nout = len(got)
                recv = [i for i in K3_RECV if i < nout]
                sums = {i: torch.zeros_like(got[i]) for i in recv}
                for shard in range(2):
                    sl = slice(shard * c, (shard + 1) * c)
                    args = (hb[:, sl].contiguous(), asl[:, sl].contiguous(),
                            flags, vecs[:, sl].contiguous(), senders)
                    skw = dict(kw, col_offset=shard * c)
                    g = merge.resident_round(args[0].clone(), args[1].clone(),
                                             *args[2:], onepass=True, **skw)
                    p = merge.resident_round_plain(
                        args[0].clone(), args[1].clone(), *args[2:], **skw)
                    t = merge.resident_round(args[0].clone(), args[1].clone(),
                                             *args[2:], **skw)
                    diffs += [count_diff(a, b) for a, b in zip(g, p)]
                    diffs += [count_diff(a, b) for a, b in zip(g, t)]
                    for i in recv:
                        sums[i] += g[i]
                diffs += [count_diff(sums[i], got[i]) for i in recv]
                torch.cuda.synchronize()
                diff = sum(d[0] for d in diffs)
                bad += diff
                h2, a2 = hb.clone(), asl.clone()
                run_f = lambda: merge.resident_round(  # noqa: E731
                    h2, a2, flags, vecs, senders, onepass=True, **kw)
                run_2 = lambda: merge.resident_round(  # noqa: E731
                    h2, a2, flags, vecs, senders, **kw)

                # both forms time the same 10 rounds, in turns, from the
                # lanes after 20 rounds
                reset = warm_start(run_2, h2, a2)
                run_f()
                two_ms, f_ms = in_turns(run_2, run_f, reset)
                plain_ms = split = None
                if (name, mode) in rows:
                    run_p = lambda: merge.resident_round_plain(  # noqa: E731
                        h2, a2, flags, vecs, senders, **kw)
                    run_p()
                    plain_ms = cuda_ms(run_p, 2)
                    # one more launch, the first timed round, with its step
                    # timeline
                    reset()
                    tl = torch.zeros((n // merge.ONEPASS_C,
                                      merge.ONEPASS_CTAS,
                                      merge.ONEPASS_STAMPS),
                                     dtype=torch.int64, device="cuda")
                    merge.resident_round(h2, a2, flags, vecs, senders,
                                         onepass=True, timeline=tl, **kw)
                    torch.cuda.synchronize()
                    split = merge.onepass_timeline_split(tl)
                bound = k3_shard_bound_ms(n, n, senders, nout, len(recv))
                code = sass.get(onepass_flags(name, mode))
                before = ONEPASS_MS_BEFORE.get((name, mode))
                out[(name, mode)] = dict(
                    max_abs_err=max(d[1] for d in diffs), ms=min(f_ms),
                    ms_runs=f_ms, two_launch_ms=min(two_ms),
                    two_launch_runs=two_ms, plain_ms=plain_ms,
                    bound_ms=bound, split=split, before_ms=before,
                    clusters=clusters[form], sass=code)
                log(f"  {name}{ONEPASS}, {mode}: vs plain and two-launch, "
                    f"square and 2 shards: {diff} entries differ; (f) "
                    f"{min(f_ms):.4f} ms"
                    + ("" if before is None else
                       f" (before, other inputs: {before:.4f})")
                    + f", two-launch {min(two_ms):.4f} ms "
                    f"({min(two_ms) / min(f_ms):.3f}x), bound {bound:.4f} ms"
                    f", {clusters[form]} clusters"
                    + ("" if code is None else f", SASS {code}")
                    + ("" if plain_ms is None else
                       f", plain {plain_ms:.3f} ms; us a stripe: " + ", ".join(
                           f"{k} {v:.2f}" for k, v in split.items())))
    # tolerance 0: integer outputs
    if bad:
        raise AssertionError(f"K3 one-pass form: {bad} entries differ")
    log("  K3 one-pass form == plain == the two-launch form on all 30 "
        "instantiations, square and over the 2 shards of F/F' (tolerance 0)")
    log(f"  SM clock, power: {sm_clock()}")
    # main paths F and F': the aligned crash-only form over [16,384 x
    # 8,192], (f) and two-launch in turns, and the plain version
    senders, fkw = forms["aligned_group"]
    (hb, asl, flags, vecs), mkw = modes["crash-only"]
    for ew in merge.ELEMENTWISE:
        kw = dict(fkw, t_cooldown=12, elementwise=ew, col_offset=c, **mkw)
        args = (hb[:, c:].contiguous(), asl[:, c:].contiguous(), flags,
                vecs[:, c:].contiguous(), senders)
        run_f = lambda: merge.resident_round(  # noqa: E731
            *args, onepass=True, **kw)
        run_2 = lambda: merge.resident_round(*args, **kw)  # noqa: E731
        run_p = lambda: merge.resident_round_plain(*args, **kw)  # noqa: E731
        reset = warm_start(run_2, args[0], args[1])
        run_f()
        run_p()
        two_ms, f_ms = in_turns(run_2, run_f, reset)
        plain_ms = cuda_ms(run_p, 2)
        name = merge.kernel_form(16, 8, False, ew)
        bound = k3_shard_bound_ms(n, c, senders, 6, 1)
        held = merge.onepass_clusters(n, c, "aligned_group", fanout=16,
                                      arc_align=8, elementwise=ew,
                                      col_offset=c)
        key = (name, "crash-only", "block")
        code = sass.get(onepass_flags(name, "crash-only", True))
        # one more launch, the first timed round, with its step timeline
        reset()
        tl = torch.zeros((c // merge.ONEPASS_C, merge.ONEPASS_CTAS,
                          merge.ONEPASS_STAMPS), dtype=torch.int64,
                         device="cuda")
        merge.resident_round(*args, onepass=True, timeline=tl, **kw)
        torch.cuda.synchronize()
        split = merge.onepass_timeline_split(tl)
        out[key] = dict(
            max_abs_err=0, ms=min(f_ms), two_launch_ms=min(two_ms),
            plain_ms=plain_ms, bound_ms=bound, shape=[n, c],
            before_ms=ONEPASS_MS_BEFORE[key], clusters=held, sass=code,
            split=split)
        log(f"  [{n} x {c}] (main paths F/F') {name}{ONEPASS}, crash-only: "
            f"(f) {min(f_ms):.4f} ms (before, other inputs: "
            f"{ONEPASS_MS_BEFORE[key]:.4f}), "
            f"two-launch {min(two_ms):.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound:.4f} ms, {held} clusters"
            + ("" if code is None else f", SASS {code}")
            + "; us a stripe: " + ", ".join(
                f"{k} {v:.2f}" for k, v in split.items()))


LARGE_MODES = {"crash-only": dict(t_fail=5),
               "suspicion": dict(t_fail=3, suspect=True, t_suspect=2)}


def k3_large_case(n: int, c: int, col_offset: int, lanes, senders,
                  kw: dict) -> dict:
    """One two-launch K3 instantiation over [n x c] lanes from global
    subject ``col_offset``: the kernel against the plain version on the
    same pre-tick lanes (entries that differ, max |diff|), the plain
    call's device ms, the kernel's ms a round (the least of two 5-round
    means, the lanes evolving in place), each launch's ms under the
    profiler, and the byte bound."""
    import torch

    from gossipfs_tpu_torch.ops import merge

    hb, asl, flags, vecs = lanes
    kw = dict(kw, col_offset=col_offset)
    got = merge.resident_round(hb.clone(), asl.clone(), flags, vecs, senders,
                               **kw)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = merge.resident_round_plain(hb.clone(), asl.clone(), flags, vecs,
                                      senders, **kw)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    diffs = [count_diff(a, b) for a, b in zip(got, want)]
    nout = len(got)
    del got, want
    torch.cuda.empty_cache()
    h2, a2 = hb.clone(), asl.clone()
    run = lambda: merge.resident_round(h2, a2, flags, vecs, senders, **kw)  # noqa: E731
    run()
    ms = min(cuda_ms(run, 5), cuda_ms(run, 5))
    split = {k: ms_ / seen for k, (ms_, seen) in launch_split(run, 5).items()
             if k.startswith("rr_")}
    del h2, a2
    torch.cuda.empty_cache()
    recv_outs = len([i for i in K3_RECV if i < nout])
    return dict(diff=sum(d[0] for d in diffs),
                max_abs_err=max(d[1] for d in diffs), ms=ms,
                plain_ms=plain_ms, split=split, shape=[n, c],
                bound_ms=k3_shard_bound_ms(n, c, senders, nout, recv_outs))


def phase_k3_two_launch_large(results: dict) -> None:
    """K3's two-launch form at the N only it runs (the one-pass form holds
    N <= 19,264): the aligned (capacity, phase 6) and explicit-edge
    (frontier, phases 22 and 34) forms at N = 65,536, lanes and SWAR,
    crash-only and suspicion; the explicit-edge form at the
    PackedDetector's N = 49,152 (phase 23); and the aligned form over the
    last column block [65,536 x 8,192] (the one holding the diagonal's
    last rows), lanes and SWAR.  Every output against the plain version
    on the same random pre-tick lanes (tolerance 0: integer outputs);
    ms a round, each launch's ms, plain ms and byte bound."""
    import torch

    from gossipfs_tpu_torch.ops import merge

    out = results.setdefault("k3_large", {})
    bad = 0
    cases = []
    for mode, mkw in LARGE_MODES.items():
        cases.append((N_CAPACITY, mode, mkw, ("aligned_group", "edges"), 0))
    cases.append((N_ADVANCE, "crash-only", LARGE_MODES["crash-only"],
                  ("edges",), 0))
    cases.append((N_CAPACITY, "crash-only", LARGE_MODES["crash-only"],
                  ("aligned_group",), N_CAPACITY // 8))
    for n, mode, mkw, forms, block in cases:
        hb, asl, flags, vecs, bases = big_round_inputs(
            n, n, SEED + 41 + n, mode != "crash-only")
        g = torch.Generator(device="cuda").manual_seed(SEED + 42 + n)
        edges = torch.randint(0, n, (n, 16), generator=g,
                              device="cuda").to(torch.int32)
        c, off = (block, n - block) if block else (n, 0)
        if block:
            sl = slice(off, n)
            hb, asl = hb[:, sl].contiguous(), asl[:, sl].contiguous()
            vecs = vecs[:, sl].contiguous()
        for form in forms:
            senders, fkw = ((bases, dict(fanout=16, arc_align=8))
                            if form == "aligned_group" else (edges, {}))
            for ew in merge.ELEMENTWISE:
                kw = dict(fkw, t_cooldown=12, elementwise=ew, **mkw)
                r = k3_large_case(n, c, off, (hb, asl, flags, vecs), senders,
                                  kw)
                bad += r["diff"]
                name = merge.kernel_form(kw.get("fanout"), 8, False, ew)
                out[(name, mode, n, c)] = r
                split = ", ".join(f"{k} {v:.4f}"
                                  for k, v in sorted(r["split"].items()))
                log(f"  [{n} x {c}] {name}, {mode}: {r['diff']} entries "
                    f"differ; kernel {r['ms']:.4f} ms a round ({split} ms a "
                    f"launch), plain {r['plain_ms']:.3f} ms, byte bound "
                    f"{r['bound_ms']:.4f} ms")
        del hb, asl, flags, vecs, bases, edges
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"K3 two-launch form at large N: {bad} entries "
                             "differ")
    log("  K3 two-launch form == plain at N = 65,536, 49,152 and over "
        "[65,536 x 8,192] (tolerance 0)")


# K2's, K1's, K4's and K5's timed shapes: (key, kernel, N, C, F, hb bytes
# (K1: view bytes), detection stats, suspect) at phases 7, 8, 14, 18, 19 and
# 36, and phase 8's van Herk case; K2's views are int8
GEOMETRY_SHAPES = (
    ("k2", "fused", 10_240, 10_240, 14, 2, True, False),
    ("k2_sus", "fused", 10_240, 10_240, 14, 2, True, True),
    ("k2_on_k5_shape", "fused", N_MAIN, N_MAIN, 14, 1, False, True),
    ("k2_block", "fused", 32_768, 16_384, 15, 2, True, False),
    ("k2_block_config4", "fused", N_CONFIG4, N_CONFIG4 // 8, 17, 2, True,
     False),
    ("k2_config4_fault", "fused", N_CAPACITY, N_CAPACITY, 16, 2, True,
     False),
    ("k1", "fanout", N_MAIN, N_MAIN, 14, 1, False, False),
    ("k4", "arc", N_MAIN, N_MAIN, 16, 1, True, False),
    ("k4_sus", "arc", N_MAIN, N_MAIN, 16, 1, True, True),
    ("k4_block", "arc", N_CAPACITY, N_CAPACITY // 8, 16, 1, True, False),
    ("k4_van_herk", "arc", N_MAIN, N_MAIN, K4_LONG_F, 1, True, False),
    ("k5", "stripe", N_MAIN, N_MAIN, 14, 1, False, True),
    ("k5_off", "stripe", N_MAIN, N_MAIN, 14, 1, False, False),
    ("k5_max_n", "stripe", 28_416, 28_416, 15, 1, False, True),
    ("k5_block", "stripe", N_MAIN, N_MAIN // 2, 14, 1, True, True),
)


def phase_merge_geometry(results: dict) -> None:
    """K2, K1, K4 and K5 at every timed shape, from the kernels' own
    fm_info / fx_info / am_info / sm_info: K2's and K1's stripe columns,
    rows an item, ring stages and slots a stage, shared memory, threads and
    blocks an SM, items; K5's CTAs a cluster, stripe columns, park row
    bytes, threads a CTA, the clusters the card holds at once
    (cudaOccupancyMaxActiveClusters) and shared memory a CTA; K4's row
    pass (stripe columns, threads and blocks an SM) and window tile
    (shared memory; 0 for the van Herk window); every kernel's registers
    and local memory (spills) a thread."""
    import ctypes

    from gossipfs_tpu_torch.ops import _build

    out = {}
    for key, kernel, n, c, f, hb_bytes, det, sus in GEOMETRY_SHAPES:
        # fm/fx_info write 11 ints, sm_info 9, am_info 8
        info = (ctypes.c_int * 12)()
        if kernel == "fused":
            rc = _build.load("fused_merge").fm_info(
                n, c, f, 1, hb_bytes, int(det), int(sus), 1,
                ctypes.byref(info))
        elif kernel == "fanout":
            rc = _build.load("fanout_max").fx_info(n, f, hb_bytes, 1,
                                                   ctypes.byref(info))
        elif kernel == "arc":
            rc = _build.load("arc_merge").am_info(
                n, c, f, 1, hb_bytes, int(det), int(sus), 1,
                ctypes.byref(info))
        else:
            rc = _build.load("stripe_merge").sm_info(
                n, c, f, hb_bytes, int(det), int(sus), 1, ctypes.byref(info))
        if rc != 0:
            raise RuntimeError(f"{kernel} info [{n} x {c}]: CUDA error {rc}")
        ms = results.get(key, {}).get("ms")
        head = f"  {key} [{n} x {c}] F={f} det={int(det)} sus={int(sus)}: "
        if kernel in ("fused", "fanout"):
            (cols, rows, depth, slots, smem, threads, per_sm, regs, local,
             items) = list(info)[:10]
            out[key] = dict(cols=cols, item_rows=rows, stages=depth,
                            slots=slots, smem=smem, threads=threads,
                            blocks_per_sm=per_sm, regs=regs,
                            local_bytes=local, items=items, ms=ms)
            line = (f"stripe {cols} cols x {rows} rows an item ({items} "
                    f"items), ring {depth} stages x {slots} slots, {smem} "
                    f"B shared memory, {threads} threads x {per_sm} blocks an "
                    f"SM, {regs} regs, {local} B local")
        elif kernel == "arc":
            cols, per_sm, regs, local, threads, tile = list(info)[:6]
            window = f"tiles, {tile} B smem" if tile else "van Herk"
            out[key] = dict(cols=cols, threads=threads, blocks_per_sm=per_sm,
                            regs=regs, local_bytes=local, tile_smem=tile,
                            ms=ms)
            line = (f"window {window}; row pass {threads} threads x "
                    f"{per_sm} blocks an SM, "
                    f"stripe {cols} cols, {regs} regs, {local} B local")
        else:
            ctas, cols, rb, held, regs, local, smem, threads = list(info)[:8]
            out[key] = dict(ctas=ctas, cols=cols, row_bytes=rb,
                            threads=threads, clusters=held, regs=regs,
                            local_bytes=local, smem=smem, ms=ms)
            line = (f"cluster {ctas} x {threads} threads, stripe {cols} cols "
                    f"({rb} B rows), {held} clusters held, {regs} regs, "
                    f"{local} B local, {smem} B smem")
        log(head + line + (f", {ms:.4f} ms" if ms is not None else ""))
    results["merge_geometry"] = out


# ---------------------------------------------------------------------------
# The obs plane on the card (phase 43): the flight recorder, the streaming
# monitor and the analyzer behind bench --trace/--monitor, the TTD/FPR
# curves, the SimDetector seam and the campaign replay.
# ---------------------------------------------------------------------------


def quiet_main(main, argv: list) -> dict:
    """An entry point's ``main(argv)`` with its JSON line kept off this
    script's output, whose last lines are read as its result."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def obs_bench(tmp: str, results: dict) -> None:
    """``bench --trace --monitor`` on the headline (3 attempts) beside the
    same bench without the flags: equal K3 launches, an ok verdict, and a
    trace whose FPR and detection counts equal ``summarize`` of the same
    run (every attempt runs the same key from a fresh state)."""
    import torch

    from gossipfs_tpu_torch import bench
    from gossipfs_tpu_torch.metrics.detection import summarize
    from gossipfs_tpu_torch.obs import timeline
    from gossipfs_tpu_torch.obs.recorder import decode_scan, load_stream

    path = f"{tmp}/bench.jsonl"
    plain = quiet_main(bench.main, ["--attempts", "3"])
    traced = quiet_main(bench.main, ["--attempts", "3", "--trace", path,
                                     "--monitor"])
    if (traced["launches"] != plain["launches"]
            or plain["launches"] != 3 * bench.ROUNDS
            or traced["form_launches"] != plain["form_launches"]):
        raise AssertionError(
            f"bench launches with the flags {traced['launches']} "
            f"{traced['form_launches']}, without {plain['launches']} "
            f"{plain['form_launches']}")
    if not traced["monitor"]["ok"]:
        raise AssertionError(f"bench monitor verdict {traced['monitor']}")
    cfg = bench.headline_config(N_MAIN, False)
    _, (state, carry, per_round) = bench.timed_run(cfg, bench.ROUNDS)
    rep = summarize(carry, per_round)
    header, events = load_stream(path)
    doc = timeline.analyze([header], events)
    again = [e.to_record() for e in decode_scan(
        per_round, carry, n=cfg.n, alive=state.alive)]
    torch.cuda.synchronize()
    same = [e.to_record() for e in events] == again
    if (not same or doc["false_positive_rate"] != rep.false_positive_rate
            or doc["true_detections"] != rep.true_detections
            or doc["false_positives"] != rep.false_positives
            or len(events) != traced["trace_events"]):
        raise AssertionError(
            f"bench trace: decode of the same run equal {same}; analyze "
            f"{doc['false_positive_rate']} / {doc['true_detections']} / "
            f"{doc['false_positives']}, summarize {rep.false_positive_rate}"
            f" / {rep.true_detections} / {rep.false_positives}")
    log(f"  bench --trace --monitor: launches {traced['form_launches']} "
        f"(without the flags {plain['form_launches']}); verdict ok, "
        f"{traced['trace_events']} events; trace {traced['trace_ms']:.3f} "
        f"ms, monitor {traced['monitor_ms']:.3f} ms (host, after the "
        "attempts)")
    log(f"  rounds/s (CUDA events, median of 3): {traced['median']:.2f} "
        f"with the flags, {plain['median']:.2f} without; phase 5 (host "
        f"clock) {results['main']['rounds_per_s']:.2f}")
    log(f"  analyze(trace) == summarize(same run): FPR "
        f"{rep.false_positive_rate:.3e}, true detections "
        f"{rep.true_detections}, false positives {rep.false_positives}")
    results["obs"]["bench"] = dict(
        rounds_per_s=traced["median"], plain_rounds_per_s=plain["median"],
        launches=traced["form_launches"], events=traced["trace_events"],
        trace_ms=traced["trace_ms"], monitor_ms=traced["monitor_ms"])


def obs_curves(tmp: str, results: dict) -> None:
    """``curves.sweep`` at N = 1,024, 4,096 and 16,384 with ``trace`` and
    ``monitor``: per row, one K2 launch a round and no other kernel's; the
    analyzer gives the row's TTD, FPR and counts from its trace alone, and
    the streaming monitor over the trace equals the analyzer."""
    import torch

    from gossipfs_tpu_torch import curves
    from gossipfs_tpu_torch.obs import timeline
    from gossipfs_tpu_torch.obs.monitor import StreamMonitor, estimator_parity

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    doc = curves.sweep(trace=f"{tmp}/curves.jsonl", monitor=True)
    wall = time.perf_counter() - t0
    rows = {}
    for row in doc["rows"]:
        n = row["n"]
        if row["launches"] != {"fused_merge_update": curves.ROUNDS}:
            raise AssertionError(f"curves N={n} launched {row['launches']}")
        post = timeline.analyze(*timeline.merge([row["trace"]]))
        mon = StreamMonitor()
        mon.feed_jsonl(row["trace"])
        parity = estimator_parity(post, mon.summary())
        bad = [k for k in ("ttd_first_median", "false_positive_rate",
                           "detected", "tracked_crashes")
               if post[k] != row[k]]
        if bad or not parity["ok"] or not row["monitor"]["ok"]:
            raise AssertionError(
                f"curves N={n}: analyze differs in {bad}, parity "
                f"{parity['mismatches']}, verdict {row['monitor']}")
        log(f"  N={n}, fanout {row['fanout']}: TTD median "
            f"{row['ttd_first_median']} (max {row['ttd_first_max']}), "
            f"converged {row['ttd_converged_median']}, detected "
            f"{row['detected']}/{row['tracked_crashes']}, FPR "
            f"{row['false_positive_rate']:.3e}; {row['trace_events']} "
            f"events, decode {row['trace_ms']:.3f} ms; launches "
            f"{row['launches']}; analyze == row, monitor == analyze")
        rows[str(n)] = {k: row[k] for k in (
            "ttd_first_median", "false_positive_rate", "trace_events",
            "trace_ms")}
    log(f"  sweep {wall:.3f} s ({curves.ROUNDS} rounds a row, the decodes "
        "and the monitor included)")
    results["obs"]["curves"] = dict(rows=rows, seconds=wall)


def obs_detector(results: dict) -> None:
    """``SimDetector`` on config 3 with a recorder: 30 interactive rounds
    on one detector, ``advance_bulk(30, snapshot_every=10)`` on another
    of the same seed, after four crashes and a leave queued at round 2.
    The ground-truth rows and the first confirm per subject agree, and
    each stream's confirm rows are its own drained detection events; a
    third detector runs the interactive rounds with no recorder."""
    import torch

    from gossipfs_tpu_torch.detector.sim import SimDetector
    from gossipfs_tpu_torch.models.presets import ALL
    from gossipfs_tpu_torch.obs.recorder import FlightRecorder

    cfg = ALL["sim-10k-crash"].config
    rounds, streams, ms = 30, {}, {}
    for mode in ("interactive", "bulk", "no recorder"):
        det = SimDetector(cfg, seed=1)
        rec = FlightRecorder(source="sim", n=cfg.n)
        if mode != "no recorder":
            det.attach_recorder(rec)
        det.advance(2)
        for node in (5, 300, 4097, 9000):
            det.crash(node)
        det.leave(777)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "bulk":
            det.advance_bulk(rounds, snapshot_every=10)
        else:
            det.advance(rounds)
        events = det.drain_events()
        torch.cuda.synchronize()
        ms[mode] = (time.perf_counter() - t0) / rounds * 1e3
        confirms = [(e.round, e.observer, e.subject) for e in rec.events
                    if e.kind == "confirm"]
        if mode != "no recorder" and confirms != [
                (e.round, e.observer, e.subject) for e in events]:
            raise AssertionError(f"{mode}: confirm rows != drained events")
        streams[mode] = rec.events

    def faults(evs):
        return sorted((e.round, e.kind, e.subject) for e in evs
                      if e.kind in ("crash", "hb_freeze", "leave"))

    def first_confirms(evs):
        out = {}
        for e in evs:
            if e.kind == "confirm":
                out.setdefault(e.subject, (e.round, e.observer))
        return out

    inter, bulk = streams["interactive"], streams["bulk"]
    firsts = first_confirms(inter)
    if (faults(inter) != faults(bulk) or len(faults(inter)) != 9
            or firsts != first_confirms(bulk)
            or not {5, 300, 4097, 9000} <= set(firsts)):
        raise AssertionError(
            f"interactive and bulk streams differ: {faults(inter)} / "
            f"{faults(bulk)}, {firsts} / {first_confirms(bulk)}")
    rec_ms = ms["interactive"] - ms["no recorder"]
    log(f"  config 3 (N={cfg.n}): {len(inter)} interactive events, "
        f"{len(bulk)} bulk; crash, hb_freeze and leave rows equal; first "
        f"confirms equal {dict(sorted(firsts.items()))}")
    log(f"  ms a round: interactive with the recorder "
        f"{ms['interactive']:.4f}, without {ms['no recorder']:.4f} "
        f"(recorder {rec_ms:.4f}); advance_bulk(30, snapshot_every=10) "
        f"{ms['bulk']:.4f}, the decode included")
    results["obs"]["detector"] = dict(
        round_ms=ms["no recorder"], recorder_ms=rec_ms,
        bulk_round_ms=ms["bulk"], events=len(inter))


def obs_campaigns(results: dict) -> None:
    """The three gossip regression cases replayed on the card, then one
    ``outage`` run (256 nodes dark for 10 rounds) at N = 16,384 on the
    campaign profile: one K2 launch a round with the scenario's edge
    rewrite, and its row equal to the same run on the plain versions."""
    import pathlib

    import torch

    from gossipfs_tpu_torch.bench import tracked_victims
    from gossipfs_tpu_torch.campaigns import driver
    from gossipfs_tpu_torch.ops import merge

    for case in ("flap_storm_n256", "outage_storm_n256",
                 "outage_absorbed_n256"):
        out = driver.run_case(pathlib.Path(__file__).resolve().parent
                              / "regressions" / f"{case}.json")
        row = out["row"]
        if not out["reproduced"]:
            raise AssertionError(f"{case} not reproduced: {row['verdict']} "
                                 f"{row['monitor']}")
        log(f"  {case}: reproduced, {row['verdict']} "
            f"{row['monitor']['by_invariant']}, FPR "
            f"{row['estimators']['false_positive_rate']:.3e}, TTD median "
            f"{row['estimators']['ttd_first_median']}")
    n = N_MAIN
    cfg = driver.campaign_config(n)
    avoid = set(tracked_victims(n, 4, cfg.introducer)) | {cfg.introducer}
    sc = driver.make_scenario("outage", n, 10, avoid=avoid, size=256,
                              length=10)
    torch.cuda.empty_cache()
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    row = driver.run_scenario(n, sc)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in merge.LAUNCH_COUNTS.items() if v}
    if launches != {"fused_merge_update": row["rounds"]}:
        raise AssertionError(f"campaign N={n} launched {launches}")
    plain = driver.run_scenario(n, sc, plain=True)
    if plain != row:
        bad = [k for k in row if row[k] != plain[k]]
        raise AssertionError(f"campaign N={n}: kernels != plain in {bad}")
    log(f"  outage size 256 x 10 rounds at N={n} (fanout {cfg.fanout}, "
        f"view {cfg.view_dtype}, hb {cfg.hb_dtype}): {row['rounds']} rounds"
        f" in {wall:.3f} s, launches {launches}; verdict {row['verdict']} "
        f"{row['monitor']['by_invariant']}; row == the plain versions' row")
    log(f"  estimators {json.dumps(row['estimators'])}")
    results["obs"]["campaign"] = dict(
        round_ms=wall / row["rounds"] * 1e3,
        rounds_per_s=row["rounds"] / wall, launches=launches,
        verdict=row["verdict"])


def phase_obs_plane(results: dict) -> None:
    import tempfile

    results["obs"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        obs_bench(tmp, results)
        obs_curves(tmp, results)
    obs_detector(results)
    obs_campaigns(results)



# ---------------------------------------------------------------------------
# The conformance, curve and scenario runners on the card (phase 44): the
# conformance tensor column, the (t_fail, t_suspect) surface, the
# suspicion A/B, the BASELINE scenario runner and the flagship step.
# ---------------------------------------------------------------------------


def runner_k2_shapes(results: dict) -> None:
    """K2 against its plain version at the shapes phase 44's paths give
    it that no earlier phase holds, both forms, detection stats on and
    off, tolerance 0 (every output is an integer): the conformance
    column's N = 8 (F = 3, int16 view, int32 hb; C = 8, far below the
    128-byte stripe) and config 1's N = 10; the (t_fail, t_suspect)
    surface's N = 16,384 (F = 14, int8 view, int16 hb), where the suspect
    form is timed (detection stats on, as the surface runs it); the
    suspicion A/B's default-kernel rows at N = 16,384 (F = 14, SimConfig's
    int16 view and int32 hb); and ``run.py``'s sim-100k cut at N = 32,768
    (F = 15, int8 view, int16 hb)."""
    import numpy as np
    import torch

    from gossipfs_tpu_torch.ops import merge_update as mu

    err = 0
    for label, n, f, seed in (("conformance", 8, 3, 44),
                              ("parity-10", 10, 3, 45)):
        view, edges, _, hb, asl, sa, sb, alive = merge_inputs(
            n, f, np.int16, np.int32, SEED + seed, statuses=4)
        args = (view, edges, hb, asl, sa, sb, alive)
        for det in (False, True):
            for sus in (False, True):
                log(f"  K2 {label}: N={n}, F={f}, view int16, hb int32, "
                    f"detect_stats={det}, suspect={sus}")
                err = max(err, compare_merge(
                    mu.fused_merge_update, mu.fused_merge_update_plain, args,
                    dict(detect_stats=det, suspect=sus)))
    timed = None
    for label, n, f, vdt, hdt, seed in (
            ("t_fail surface", N_MAIN, 14, torch.int8, torch.int16, 44),
            ("suspicion A/B xla", N_MAIN, 14, torch.int16, torch.int32, 46),
            ("sim-100k cut", 32_768, 15, torch.int8, torch.int16, 47)):
        view, edges, _, hb, asl, sa, sb, alive = big_merge_inputs(
            n, n, f, hdt, SEED + seed, vdt=vdt)
        args = (view, edges, hb, asl, sa, sb, alive)
        for det in (False, True):
            for sus in (False, True):
                kw = dict(detect_stats=det, suspect=sus)
                got = mu.fused_merge_update(view, edges, hb.clone(),
                                            asl.clone(), sa, sb, alive, **kw)
                want = mu.fused_merge_update_plain(
                    view, edges, hb.clone(), asl.clone(), sa, sb, alive,
                    **kw)
                diff = sum(count_diff(a, b)[0] for a, b in zip(got, want))
                log(f"  K2 {label}: N={n}, F={f}, view {str(vdt)[6:]}, hb "
                    f"{str(hdt)[6:]}, detect_stats={det}, suspect={sus}: "
                    f"{diff} entries differ")
                err = max(err, diff)
                del got, want
        if timed is None:
            timed = args
        else:
            del view, edges, hb, asl, args
            torch.cuda.empty_cache()
    if err:
        raise AssertionError("K2 != plain at phase 44's shapes")
    results["k2_sus_surface"] = dict(max_abs_err=0, shape=[N_MAIN, N_MAIN])
    time_merge(mu.fused_merge_update, mu.fused_merge_update_plain, timed,
               dict(detect_stats=True, suspect=True), results,
               "k2_sus_surface")
    del timed
    torch.cuda.empty_cache()


def runner_conformance(results: dict) -> None:
    """The conformance matrix over the oracle and the tensor column on the
    card (the 4 tensor families x seeds 0 and 1; the oracle self-checks
    all 24 cases): ``all_agree``, and each card bundle equal to the same
    case's bundle from the port on the CPU (the plain versions)."""
    from gossipfs_tpu_torch.conformance import (generate_corpus, harness,
                                                verdict)
    from gossipfs_tpu_torch.ops import merge

    corpus = generate_corpus((0, 1))
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    doc = verdict.run_matrix(corpus, engines=("reference", "tensor"),
                             device="cuda")
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in merge.LAUNCH_COUNTS.items() if v}
    tensor_cases = [c for c in corpus if "tensor" in c["engines"]]
    # one K2 launch an interactive round, the warm-up's included
    rounds = sum(c["rounds"] + harness._WARMUP for c in tensor_cases)
    if (not doc["all_agree"]
            or launches != {"fused_merge_update": rounds}):
        raise AssertionError(f"conformance on the card: disagreements "
                             f"{doc['disagreements']}, launches {launches}"
                             f" ({rounds} rounds)")
    for case in tensor_cases:
        card = harness.run_case_tensor(case, device="cuda")
        cpu = harness.run_case_tensor(case, device="cpu")
        if card != cpu:
            bad = [k for k in card if card[k] != cpu[k]]
            raise AssertionError(
                f"conformance {case['family']} seed {case['seed']}: the "
                f"card's bundle != the CPU's in {bad}")
    log(f"  run_matrix: {doc['cases']} cases, {len(doc['rows'])} rows "
        f"({sum(r['engine'] == 'tensor' for r in doc['rows'])} tensor), "
        f"all_agree {doc['all_agree']}, engines {doc['engines_run']}, "
        f"{wall:.3f} s; launches {launches} ({rounds} rounds)")
    log("  each tensor case's bundle on the card == the CPU port's (events, "
        "checkpoints, final)")
    results["runners"]["conformance"] = dict(
        rows=len(doc["rows"]), seconds=wall, launches=launches)


def runner_t_fail(results: dict) -> None:
    """``sweep_t_fail(n=16_384)``: 40 rounds a row over t_fail (3, 5, 8,
    12) x t_suspect (0, 2), one K2 launch a round (the suspect form where
    t_suspect = 2); the (3, 2) row re-run on the plain versions equals
    the kernels' row."""
    import torch

    from gossipfs_tpu_torch import curves

    n = N_MAIN
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    doc = curves.sweep_t_fail(n=n, rounds=SWEEP_ROUNDS)
    wall = time.perf_counter() - t0
    for row in doc["rows"]:
        if row["launches"] != {"fused_merge_update": SWEEP_ROUNDS}:
            raise AssertionError(f"t_fail surface row {row['t_fail']}/"
                                 f"{row['t_suspect']} launched "
                                 f"{row['launches']}")
        log(f"  t_fail {row['t_fail']}, t_suspect {row['t_suspect']}: TTD "
            f"median {row['ttd_first_median']}, FPR "
            f"{row['false_positive_rate']:.3e}, suspects entered "
            f"{row['suspects_entered']}, refutations {row['refutations']}, "
            f"fp suppressed {row['fp_suppressed']}; {row['launches']}")
    kw = dict(n=n, t_fails=(3,), t_suspects=(2,), rounds=SWEEP_ROUNDS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (again,) = curves.sweep_t_fail(**kw)["rows"]
    torch.cuda.synchronize()
    row_ms = (time.perf_counter() - t1) / SWEEP_ROUNDS * 1e3
    (plain,) = curves.sweep_t_fail(plain=True, **kw)["rows"]
    want = next(r for r in doc["rows"]
                if (r["t_fail"], r["t_suspect"]) == (3, 2))
    strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                       if k not in ("launches", "forms")}
    if strip(plain) != strip(want) or again != want or plain["launches"]:
        raise AssertionError(f"t_fail 3 / t_suspect 2: kernels {want}, "
                             f"again {again}, plain {plain}")
    log(f"  sweep {wall:.3f} s; the (3, 2) row (K2's suspect form) "
        f"{row_ms:.4f} ms a round (host clock, set-up and summary "
        "included); its plain re-run == the kernels' row")
    results["runners"]["t_fail"] = dict(
        seconds=wall, suspect_row_round_ms=row_ms,
        launches=doc["rows"][0]["launches"],
        rows={f"{r['t_fail']}/{r['t_suspect']}": [
            r["ttd_first_median"], r["false_positive_rate"]]
            for r in doc["rows"]})


def runner_suspicion(results: dict) -> None:
    """``suspicion_sweep(ns=(16_384,))`` on the default kernel (K2) and on
    ``pallas_rr`` + SWAR (the lean loop's K3): every row printed with the
    form it launched; the loss regime's suspect-t3 row re-run on the plain
    versions equals the kernels' row; the JAX package's two claims for
    these rows printed, not asserted."""
    import torch

    from gossipfs_tpu_torch import curves

    n = N_MAIN
    out = {}
    for label, kernel, kw in (
            ("xla", "fused_merge_update", {}),
            ("pallas_rr swar", "resident_round",
             dict(merge_kernel="pallas_rr", elementwise="swar"))):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        doc = curves.suspicion_sweep(ns=(n,), rounds=SWEEP_ROUNDS, **kw)
        wall = time.perf_counter() - t0
        for row in doc["rows"]:
            # one launch a round of the configured kernel; the resident
            # round's form is recorded, not assumed
            if row["launches"] != {kernel: SWEEP_ROUNDS}:
                raise AssertionError(f"{label} {row['fault']} "
                                     f"{row['mode']}: launched "
                                     f"{row['launches']}")
            log(f"  {label} {row['fault']} {row['mode']}: TTD median "
                f"{row['ttd_first_median']} (max {row['ttd_first_max']}), "
                f"detected {row['detected']}/{row['tracked_crashes']}, FPR "
                f"{row['false_positive_rate']:.3e} ({row['false_positives']}"
                f"), suspects {row['suspects_entered']}, refutations "
                f"{row['refutations']}; launches {row['launches']} forms "
                f"{row['forms']}")
        (plain,) = curves.suspicion_sweep(
            ns=(n,), only=("loss", "suspect-t3"), plain=True,
            rounds=SWEEP_ROUNDS, **kw)["rows"]
        want = doc["rows"][-1]
        strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                           if k not in ("launches", "forms")}
        if strip(plain) != strip(want) or plain["launches"]:
            raise AssertionError(f"{label} loss suspect-t3: kernels {want},"
                                 f" plain {plain}")
        by = {(r["fault"], r["mode"]): r for r in doc["rows"]}
        ttd = [by[f, "suspect-t3"]["ttd_first_median"]
               for f in ("churn", "loss")]
        claim_ttd = all(t is not None and t <= 3 + 2 for t in ttd)
        claim_fpr = (by["loss", "suspect-t3"]["false_positive_rate"]
                     < by["loss", "raw-t3"]["false_positive_rate"])
        log(f"  {label}: sweep {wall:.3f} s; loss suspect-t3 plain re-run "
            f"== the kernels' row; claims: TTD <= t_fail + t_suspect with "
            f"suspicion {claim_ttd} ({ttd}), under loss FPR on < off "
            f"{claim_fpr}")
        out[label] = dict(seconds=wall, claims=[claim_ttd, claim_fpr],
                          forms=[r["forms"] or r["launches"]
                                 for r in doc["rows"]])
    results["runners"]["suspicion"] = out


def runner_scenarios(results: dict) -> None:
    """``python -m gossipfs_tpu_torch.run`` for parity-10, sim-1k and
    sim-10k-crash at their full sizes and rounds, and sim-100k cut to
    ``--n 32768 --rounds 20``: each report's rounds/s and detection;
    parity-10's and sim-1k's outputs equal their plain re-runs, and their
    rounds/s three times more in turns."""
    import torch

    from gossipfs_tpu_torch import run

    out = {}
    for name, argv in (("parity-10", []), ("sim-1k", []),
                       ("sim-10k-crash", []),
                       ("sim-100k", ["--n", "32768", "--rounds", "20"])):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rep = quiet_main(run.main, ["--scenario", name] + argv)
        wall = time.perf_counter() - t0
        det = rep["detection"]
        log(f"  {name}: N={rep['n']}, {rep['topology']} fanout "
            f"{rep['fanout']}, {rep['rounds']} rounds: "
            f"{rep['rounds_per_sec']:.2f} rounds/s (CUDA events); TTD "
            f"{det['ttd_first']}, FPR {det['false_positive_rate']:.3e}, "
            f"true detections {det['true_detections']}, final alive "
            f"{det['final_alive']}; launches {rep['launches']}; "
            f"{wall:.3f} s with the warm-up")
        if rep["launches"] != {"fused_merge_update": rep["rounds"]}:
            raise AssertionError(f"{name}: launched {rep['launches']}")
        out[name] = dict(rounds_per_s=rep["rounds_per_sec"],
                         launches=rep["launches"])
        if name in ("parity-10", "sim-1k"):
            _, got = run.run_scenario(name, return_outputs=True)
            _, want = run.run_scenario(name, plain=True, return_outputs=True)
            fs, fw = got[0], want[0]
            same = (all(torch.equal(getattr(fs, f), getattr(fw, f))
                        for f in ("hb", "asl", "alive", "hb_base"))
                    and all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
                    and all(torch.equal(a, b)
                            for a, b in zip(got[2], want[2])))
            if not same:
                raise AssertionError(f"{name}: kernels != plain")
            log(f"  {name}: final lanes, carry and per-round metrics == the "
                "plain re-run's")
    # parity-10 and sim-1k again, three times each in turns: the spread
    # of their rounds/s inside one call (a round of few-µs launches)
    turns = {name: [] for name in ("parity-10", "sim-1k")}
    for _ in range(3):
        for name in turns:
            turns[name].append(run.run_scenario(name)["rounds_per_sec"])
    log(f"  rounds/s in turns (CUDA events): {turns}")
    out["turns"] = turns
    log(f"  sim-10k-crash {out['sim-10k-crash']['rounds_per_s']:.2f} "
        f"rounds/s (run.py, CUDA events, 4 tracked crashes) beside phase "
        f"10's {results['config3']['rounds_per_s']:.2f} (host clock, 8 "
        "tracked)")
    results["runners"]["scenarios"] = out


def runner_entry(results: dict) -> None:
    """``entry()``'s flagship step on the card (N = 256, K2), 20 steps,
    each equal to the same step on the plain versions."""
    import torch

    from gossipfs_tpu_torch import entry
    from gossipfs_tpu_torch.ops import merge

    step, (state, events, edges) = entry.entry()
    pstep, (pstate, _, _) = entry.entry(plain=True)
    merge.reset_launch_counts()
    for i in range(20):
        state, m = step(state, events, edges)
        pstate, pm = pstep(pstate, events, edges)
        same = (all(torch.equal(getattr(state, f), getattr(pstate, f))
                    for f in ("hb", "asl", "alive", "hb_base"))
                and all(torch.equal(a, b) for a, b in zip(m, pm)))
        if not same:
            raise AssertionError(f"entry() step {i}: kernel != plain")
    launches = {k: v for k, v in merge.LAUNCH_COUNTS.items() if v}
    if launches != {"fused_merge_update": 20}:
        raise AssertionError(f"entry() launched {launches}")
    log(f"  entry(): 20 flagship steps (N=256) == 20 plain steps; launches "
        f"{launches}")
    results["runners"]["entry"] = dict(launches=launches)


def phase_runners(results: dict) -> None:
    results["runners"] = {}
    t0 = time.perf_counter()
    runner_k2_shapes(results)
    for name, fn in (("conformance", runner_conformance),
                     ("t_fail", runner_t_fail),
                     ("suspicion", runner_suspicion),
                     ("scenarios", runner_scenarios),
                     ("entry", runner_entry)):
        t1 = time.perf_counter()
        fn(results)
        results["runners"].setdefault(name, {})["phase_s"] = (
            time.perf_counter() - t1)
    results["runners"]["seconds"] = time.perf_counter() - t0

# ---------------------------------------------------------------------------
# phase 45: the SDFS plane (the co-sim, the planners, the codec, config 5)
# ---------------------------------------------------------------------------

N_CONFIG5 = 65_536     # config 5 on one card (131,072 needs the lanes sharded)
C5_ROUNDS = 16         # its rounds, cut from 24 for the run's time limit
SDFS_TIMING = ("_ms", "elapsed_s", "rounds_per_sec", "placements_per_sec",
               "planner_ms_median", "speedup_vs_realtime")


def untimed(doc):
    """A document with its wall-clock fields dropped, at every depth."""
    if isinstance(doc, dict):
        return {k: untimed(v) for k, v in doc.items()
                if not (isinstance(k, str) and k.endswith(SDFS_TIMING))}
    if isinstance(doc, list):
        return [untimed(v) for v in doc]
    return doc


def sdfs_k2_shapes(results: dict) -> None:
    """K2 against its plain version at the shapes phase 45's paths give it
    that no earlier phase holds, detection stats and suspicion on and off,
    tolerance 0: the co-sim lane's N = 64 and the traffic case's N = 256
    (``traffic_config``: F = log2 N, SimConfig's int16 view and int32 hb),
    and one [65,536 x 16,384] column block at config 5's dtypes (int8
    view, int16 hb, F = 16).  Each timed in the paths' mode (detection
    stats on, suspicion off) beside its plain version and byte bound."""
    import numpy as np
    import torch

    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.ops import merge_update as mu

    err = 0
    for key, n, seed in (("k2_cosim_n64", 64, 451), ("k2_cosim_n256", 256,
                                                      452)):
        f = SimConfig.log_fanout(n)
        view, edges, _, hb, asl, sa, sb, alive = merge_inputs(
            n, f, np.int16, np.int32, SEED + seed, statuses=4)
        args = (view, edges, hb, asl, sa, sb, alive)
        for det in (False, True):
            for sus in (False, True):
                log(f"  K2 co-sim N={n}: F={f}, view int16, hb int32, "
                    f"detect_stats={det}, suspect={sus}")
                e = compare_merge(mu.fused_merge_update,
                                  mu.fused_merge_update_plain, args,
                                  dict(detect_stats=det, suspect=sus))
                err = max(err, e)
        results[key] = dict(max_abs_err=0, shape=[n, n])
        time_merge(mu.fused_merge_update, mu.fused_merge_update_plain, args,
                   dict(detect_stats=True), results, key)
    n, c, f = N_CONFIG5, 16_384, SimConfig.log_fanout(N_CONFIG5)
    view, edges, _, hb, asl, sa, sb, alive = big_merge_inputs(
        n, c, f, torch.int16, SEED + 453)
    for det, sus in ((False, False), (True, False), (True, True)):
        kw = dict(detect_stats=det, suspect=sus)
        got = mu.fused_merge_update(view, edges, hb.clone(), asl.clone(), sa,
                                    sb, alive, **kw)
        want = mu.fused_merge_update_plain(view, edges, hb.clone(),
                                           asl.clone(), sa, sb, alive, **kw)
        diffs = [count_diff(a, b) for a, b in zip(got, want)]
        diff = sum(d[0] for d in diffs)
        err = max([err] + [d[1] for d in diffs])
        log(f"  K2 config 5 block [{n} x {c}], F={f}, view int8, hb int16, "
            f"detect_stats={det}, suspect={sus}: {diff} entries differ")
        if diff:
            err = max(err, 1)
        del got, want
    h2, a2 = hb.clone(), asl.clone()
    run_k = lambda: mu.fused_merge_update(  # noqa: E731
        view, edges, h2, a2, sa, sb, alive, detect_stats=True)
    run_p = lambda: mu.fused_merge_update_plain(  # noqa: E731
        view, edges, h2, a2, sa, sb, alive, detect_stats=True)
    run_k()
    ms = min(cuda_ms(run_k, 10), cuda_ms(run_k, 10))
    run_p()
    plain_ms = cuda_ms(run_p, 1)
    bound = merge_block_bound_ms(view, edges, hb, 3)
    results["k2_config5_block"] = dict(max_abs_err=err, ms=ms,
                                       plain_ms=plain_ms, bound_ms=bound,
                                       shape=[n, c])
    log(f"  K2 config 5 block [{n} x {c}]: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, byte bound {bound:.4f} ms")
    del view, edges, hb, asl, h2, a2
    torch.cuda.empty_cache()
    if err:
        raise AssertionError("K2 != plain at phase 45's shapes")


def sdfs_config5(results: dict) -> None:
    """BASELINE config 5 through ``run.run_scenario`` on the card at N =
    65,536 (1,000 files, 16 rounds: the detector's warm-up and timed runs,
    then the co-sim's warm-up chunk and 3 chunks of 8 rounds, each round
    one K2 launch); then at N = 4,096 on the kernels and on the plain
    versions: the detection report and the ``cosim`` dict equal, timings
    aside."""
    import torch

    from gossipfs_tpu_torch import run

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = run.run_scenario("sim-100k-sdfs", n_override=N_CONFIG5,
                           rounds_override=C5_ROUNDS)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    cos, det = rep["cosim"], rep["detection"]
    log(f"  config 5 at N={rep['n']} (fanout {rep['fanout']}, "
        f"{rep['rounds']} rounds, {cos['files']} files): detector "
        f"{rep['rounds_per_sec']:.2f} rounds/s (CUDA events), TTD "
        f"{det['ttd_first']}, FPR {det['false_positive_rate']:.3e}, true "
        f"detections {det['true_detections']}, final alive "
        f"{det['final_alive']}; launches {rep['launches']}")
    log(f"  config 5 cosim: {json.dumps(cos)}; launches "
        f"{rep['cosim_launches']}; peak {peak:.2f} GiB; {wall:.1f} s with "
        "both warm-ups")
    want = {"fused_merge_update": rep["rounds"]}
    chunks = cos["rounds"] + 8      # the co-sim's warm-up chunk and its run
    if (rep["launches"] != want or rep["cosim_launches"]
            != {"fused_merge_update": chunks}):
        raise AssertionError(f"config 5 launched {rep['launches']} / "
                             f"{rep['cosim_launches']}")
    if cos["files_readable"] <= 0 or cos["rounds"] != C5_ROUNDS:
        raise AssertionError(f"config 5 cosim: {cos}")
    out = dict(n=rep["n"], rounds_per_s=rep["rounds_per_sec"],
               cosim_rounds_per_s=cos["rounds_per_sec"],
               launches=rep["launches"], cosim_launches=rep["cosim_launches"],
               cosim=cos, peak_gib=peak, seconds=wall)
    small = {}
    for plain in (False, True):
        small[plain] = run.run_scenario("sim-100k-sdfs", n_override=4_096,
                                        rounds_override=24, plain=plain)
    k, p = small[False], small[True]
    if (untimed(k["cosim"]) != untimed(p["cosim"])
            or k["detection"] != p["detection"]
            or p["launches"] or p["cosim_launches"]):
        raise AssertionError(f"config 5 at N=4096: kernel {k['cosim']} != "
                             f"plain {p['cosim']}")
    log(f"  config 5 at N=4096: cosim {json.dumps(untimed(k['cosim']))} and "
        f"the detection report == the plain run's; rounds/s kernel "
        f"{k['rounds_per_sec']:.2f} (cosim {k['cosim']['rounds_per_sec']}), "
        f"plain {p['rounds_per_sec']:.2f} (cosim "
        f"{p['cosim']['rounds_per_sec']})")
    out["n4096"] = dict(rounds_per_s=k["rounds_per_sec"],
                        cosim_rounds_per_s=k["cosim"]["rounds_per_sec"],
                        plain_rounds_per_s=p["rounds_per_sec"])
    results["sdfs"]["config5"] = out


def sdfs_scale_lane(results: dict) -> None:
    """The tensor planner's scale lane at ``TRAFFIC_r12.json``'s shape (N
    = 100,000, 2,048 placements a round, budget 4,096, 24 rounds) on the
    card, then the same lane on the CPU: every row, timings aside, equal."""
    from gossipfs_tpu_torch import traffic_bench

    kw = dict(n=100_000, files_per_round=2048, rounds=24, budget=4096)
    card = traffic_bench.scale_lane(**kw)
    t0 = time.perf_counter()
    cpu = traffic_bench.scale_lane(device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    if untimed(card) != untimed(cpu):
        raise AssertionError("scale lane: the card's rows != the CPU's")
    ms = [r["planner_ms"] for r in card["rows"]]
    log(f"  scale lane N={card['n']}: planner_ms_median "
        f"{card['planner_ms_median']} (rows {ms}), placements_per_sec "
        f"{card['placements_per_sec']}, placed {card['placed_total']}, "
        f"drain {card['storm_drain_rounds_post_run']} rounds, final "
        f"{json.dumps(card['final'])}; == the CPU run row for row (CPU "
        f"median {cpu['planner_ms_median']} ms, {cpu_s:.1f} s)")
    results["sdfs"]["scale"] = dict(
        planner_ms_median=card["planner_ms_median"],
        placements_per_sec=card["placements_per_sec"],
        cpu_planner_ms_median=cpu["planner_ms_median"],
        final=card["final"])


def window_latency(doc: dict) -> dict:
    """Each op's p50 / p95 ms of every load window of a harness run."""
    out = {}
    for name, win in doc.items():
        if isinstance(win, dict) and "by_op" in win:
            out[name] = {op: [r["p50_ms"], r["p95_ms"]]
                         for op, r in win["by_op"].items()}
    if "by_op" in doc:
        out["window"] = {op: [r["p50_ms"], r["p95_ms"]]
                         for op, r in doc["by_op"].items()}
    return out


def sdfs_lanes(results: dict) -> None:
    """The co-sim lane's four scenarios and the erasure matrix at n = 64
    on the card, each against the same lane on the CPU: every count,
    repair curve and durability triple equal, every ``match`` true,
    nothing lost; one K2 launch a co-sim round."""
    from gossipfs_tpu_torch import traffic_bench
    from gossipfs_tpu_torch.ops import merge

    out = {}
    for label, fn in (("cosim", traffic_bench.cosim_lane),
                      ("erasure", traffic_bench.erasure_matrix)):
        before = merge.launch_snapshot()
        t0 = time.perf_counter()
        card = fn(64, 24, 8.0, 0)
        card_s = time.perf_counter() - t0
        launches, _ = merge.launches_since(before)
        t0 = time.perf_counter()
        cpu = fn(64, 24, 8.0, 0, device="cpu")
        cpu_s = time.perf_counter() - t0
        if untimed(card) != untimed(cpu):
            raise AssertionError(f"{label} lane: the card's != the CPU's")
        rows = {k: v for k, v in card.items()
                if isinstance(v, dict) and "durability" in v}
        for name, row in rows.items():
            d = row["durability"]
            if not (d["match"] and d["monitor"]["match_events"]
                    and d["harness"]["lost"] == 0):
                raise AssertionError(f"{label} {name}: durability {d}")
            log(f"  {label} {name} ({row['redundancy']}): acked "
                f"{d['harness']['acked_writes']}, files "
                f"{d['harness']['files_acked']}, lost 0, repairs "
                f"{d['harness']['repair_events']}, repair bytes "
                f"{row['repair_bytes_written']}, match true; p50/p95 ms "
                f"{json.dumps(window_latency(row))}")
        if set(launches) != {"fused_merge_update"}:
            raise AssertionError(f"{label} lane launched {launches}")
        log(f"  {label} lane n=64 on the card == on the CPU (counts, repair "
            f"curves, durability triples); {card_s:.2f} s card, "
            f"{cpu_s:.2f} s CPU; launches {launches}")
        out[label] = dict(launches=launches, seconds=card_s,
                          cpu_seconds=cpu_s,
                          latency={k: window_latency(v)
                                   for k, v in rows.items()})
        if label == "erasure":
            out[label]["repair_bandwidth"] = card["repair_bandwidth"]
    results["sdfs"]["lanes"] = out


def sdfs_campaign(results: dict) -> None:
    """``campaigns.run_case`` on ``regressions/stripe_rackkill_n256.json``
    on the card: verdict pass, lost 0, the row equal to the CPU run's."""
    from gossipfs_tpu_torch.campaigns import run_case
    from gossipfs_tpu_torch.ops import merge

    path = "regressions/stripe_rackkill_n256.json"
    before = merge.launch_snapshot()
    card = run_case(path)
    launches, _ = merge.launches_since(before)
    cpu = run_case(path, device="cpu")
    row = card["row"]
    if (not card["reproduced"] or row["verdict"] != "pass" or row["lost"]
            or untimed(card) != untimed(cpu)):
        raise AssertionError(f"stripe_rackkill_n256 on the card: {row}")
    log(f"  stripe_rackkill_n256: verdict {row['verdict']}, lost "
        f"{row['lost']}, files acked {row['files_acked']}, repairs "
        f"{row['repairs_total']}, repair bytes "
        f"{row['repair_bytes_written']}; == the CPU run; launches "
        f"{launches}")
    results["sdfs"]["campaign"] = dict(launches=launches,
                                       verdict=row["verdict"])


def sdfs_codec(results: dict) -> None:
    """``codec.encode`` and ``decode`` of a 4 MiB blob at k = 4, m = 2 on
    the card, equal to ``encode_np`` and ``decode_np``; ms of each (CUDA
    events, the blob already on the card)."""
    import numpy as np
    import torch

    from gossipfs_tpu_torch.erasure import codec

    k, m = 4, 2
    blob = np.random.default_rng(SEED + 45).integers(
        0, 256, 4 << 20, dtype=np.uint8).tobytes()
    data = codec.split_blob(blob, k)
    dev = torch.from_numpy(data).to("cuda")
    frags = codec.encode(dev, m)
    want = codec.encode_np(data, m)
    slots = (1, 3, 4, 5)            # two data rows lost
    rows = frags[list(slots)]
    back = codec.decode(rows, slots, k, m)
    if not (np.array_equal(frags.cpu().numpy(), want)
            and np.array_equal(back.cpu().numpy(),
                               codec.decode_np(want[list(slots)], slots, k,
                                               m))
            and np.array_equal(back.cpu().numpy(), data)):
        raise AssertionError("codec on the card != the numpy twins")
    enc_ms = cuda_ms(lambda: codec.encode(dev, m), 5)
    dec_ms = cuda_ms(lambda: codec.decode(rows, slots, k, m), 5)
    log(f"  codec 4 MiB, k={k}, m={m}: encode {enc_ms:.4f} ms, decode "
        f"(slots {slots}) {dec_ms:.4f} ms on the card; both == encode_np / "
        "decode_np, and decode == the data")
    results["sdfs"]["codec"] = dict(encode_ms=enc_ms, decode_ms=dec_ms)


def phase_sdfs(results: dict) -> None:
    results["sdfs"] = {}
    t0 = time.perf_counter()
    for name, fn in (("k2", sdfs_k2_shapes), ("config5", sdfs_config5),
                     ("scale", sdfs_scale_lane), ("lanes", sdfs_lanes),
                     ("campaign", sdfs_campaign), ("codec", sdfs_codec)):
        t1 = time.perf_counter()
        fn(results)
        results["sdfs"].setdefault(name, {})["phase_s"] = (
            time.perf_counter() - t1)
    results["sdfs"]["seconds"] = time.perf_counter() - t0

# ---------------------------------------------------------------------------
# phase 46: the gRPC shim, the interactive CLI and the wire-ops runner
# ---------------------------------------------------------------------------

N_SHIM_SMALL = 1_024   # the card-against-CPU scripts (the rpc election dials
                       # one Vote a live voter: thousands at N = 16,384)
SHIM_FANOUT = 14       # the service's --topology random fanout at N_MAIN


def wire_ms(fn, reps: int = 10) -> list:
    """Host ms of ``reps`` calls of ``fn`` (each ends in a reply off the
    wire or a device read, so no work is still queued)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def shim_full_width(results: dict) -> None:
    """The service's ``--topology random`` configuration at N = 16,384 on
    the card, driven through ``ShimClient`` over a localhost socket: the
    membership, SDFS and bulk verbs, with the launch counts zeroed just
    before the server starts and read after it stopped (one K2 launch a
    round); then the wire's ``Advance(1)`` and ``Lsm`` against the
    in-process ``SimDetector.advance(1)`` and ``CoSim.tick(1)``."""
    import statistics

    import numpy as np
    import torch

    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.cosim import CoSim
    from gossipfs_tpu_torch.ops import merge
    from gossipfs_tpu_torch.shim.client import ShimClient
    from gossipfs_tpu_torch.shim.service import ShimServer, build_kernels

    cfg = SimConfig(n=N_MAIN, topology="random", fanout=SHIM_FANOUT)
    built = build_kernels(cfg)
    if built != ["fused_merge"]:
        raise AssertionError(f"the shim's config builds {built}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim = CoSim(cfg, seed=46)
    rng = np.random.default_rng(SEED + 46)
    blobs = {f"shard{i}.bin": rng.integers(0, 256, 1 << 20,
                                           dtype=np.uint8).tobytes()
             for i in range(8)}
    merge.reset_launch_counts()
    server = ShimServer(sim).start()
    client = ShimClient(server.address, timeout=120.0)
    rounds = 0
    try:
        # heartbeats past the hb <= 1 detection grace first
        rounds += 3
        client.advance(3)
        put_ms = wire_ms(lambda: [client.put(k, v) for k, v in
                                  blobs.items()], 1)[0]
        if sorted(sim.cluster.master.files) != sorted(blobs):
            raise AssertionError("the shim lost a put")
        victim = client.ls("shard0.bin")[0]
        crashed = [victim] + [x for x in (N_MAIN // 4 + 1, 3 * N_MAIN // 4,
                                          N_MAIN - 1) if x != victim][:2]
        for x in crashed:
            client.crash(x)
        rounds += 16
        client.advance(16)
        lsm = client.lsm(0)
        alive = client.alive_nodes()
        replicas = client.ls("shard0.bin")
        got = client.get("shard0.bin")
        events = client.call("Events")["events"]
        vitals = client.call("Vitals")["lines"][0]
        detected = {e["subject"] for e in events}
        if (set(crashed) & set(lsm) or set(crashed) & set(alive)
                or victim in replicas or len(replicas) != 4
                or got != blobs["shard0.bin"]
                or not set(crashed) <= detected
                or int(vitals["n_alive"]) != N_MAIN - 3):
            raise AssertionError(
                f"shim at N={N_MAIN}: crashed {crashed}, replicas "
                f"{replicas}, detected {sorted(detected)}, vitals {vitals}")
        log(f"  shim N={N_MAIN}, random fanout {SHIM_FANOUT}: 8 puts of 1 "
            f"MiB in {put_ms:.1f} ms; crashed {crashed} (a replica of "
            f"shard0.bin), Advance 16: Lsm(0) {len(lsm)} members, "
            f"AliveNodes {len(alive)}, shard0.bin on {replicas}, Get == the "
            f"bytes, {len(events)} detection events "
            f"({sum(e['false_positive'] for e in events)} false), vitals "
            f"{json.dumps(vitals)}")
        adv = wire_ms(lambda: client.advance(1))
        rounds += len(adv)
        lsm_ms = wire_ms(lambda: client.lsm(0))
        # AdvanceBulk: reads answer from its snapshots while it runs (a
        # read before the first snapshot would wait for the whole run, so
        # the first is sent once the server holds one)
        start = sim.round
        target = client.advance_bulk(20, snapshot_every=5)
        rounds += 20
        buffer = server.servicer._snapshots
        deadline = time.monotonic() + 120
        while buffer.latest() is None and time.monotonic() < deadline:
            time.sleep(0.001)
        seen = []
        while time.monotonic() < deadline:
            r = client.call("Lsm", observer=0).get("as_of_round")
            seen.append(r)
            if r == target:
                break
        served = [r for r in seen if r is not None]
        if (target != start + 20 or served != sorted(served)
                or not served or served[-1] != target
                or len(set(served)) < 2):
            raise AssertionError(f"AdvanceBulk reads {seen}, target "
                                 f"{target}")
        rounds += 1
        client.advance(1)
        if "as_of_round" in client.call("Lsm", observer=0):
            raise AssertionError("Advance did not drop the snapshot reads")
    finally:
        client.close()
        server.stop()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches != {"fused_merge_update": rounds}:
        raise AssertionError(f"the shim's {rounds} rounds launched "
                             f"{launches}")

    def detector_step():
        sim.detector.advance(1)
        torch.cuda.synchronize()

    det_ms = wire_ms(detector_step)
    tick_ms = wire_ms(lambda: sim.tick(1))
    out = dict(n=N_MAIN, rounds=rounds, launches=launches, peak_gib=peak,
               advance_ms=statistics.median(adv), advance_ms_runs=adv,
               lsm_ms=statistics.median(lsm_ms),
               detector_advance_ms=statistics.median(det_ms),
               tick_ms=statistics.median(tick_ms),
               bulk_as_of_rounds=sorted(set(served)), put_8mib_ms=put_ms)
    log(f"  shim wire: Advance(1) {out['advance_ms']:.3f} ms (median of "
        f"{len(adv)}: {[round(x, 3) for x in adv]}), in-process "
        f"SimDetector.advance(1) {out['detector_advance_ms']:.3f} ms, "
        f"CoSim.tick(1) {out['tick_ms']:.3f} ms; Lsm {out['lsm_ms']:.3f} "
        f"ms; AdvanceBulk(20, snapshot_every=5) served as_of_round "
        f"{out['bulk_as_of_rounds']}; launches {launches} over {rounds} "
        f"rounds; peak {peak:.3f} GiB")
    results["shim"]["full"] = out
    del sim
    torch.cuda.empty_cache()


def shim_service_process(results: dict) -> None:
    """``python -m gossipfs_tpu_torch.shim.service --n 16384 --topology
    random --port 0`` as its own process: it builds its kernels, prints
    its address, answers ``Advance``, ``Crash`` and ``Lsm`` from a client
    here, and stops on an interrupt."""
    import re
    import signal
    import subprocess as sp

    from gossipfs_tpu_torch.shim.client import ShimClient

    t0 = time.perf_counter()
    proc = sp.Popen([sys.executable, "-m", "gossipfs_tpu_torch.shim.service",
                     "--n", str(N_MAIN), "--topology", "random", "--port",
                     "0"], stdout=sp.PIPE, stderr=sp.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"serving gossipfs\.Shim on (\S+) \(n=(\d+), "
                      r"device=cuda\)", line)
        if m is None or int(m.group(2)) != N_MAIN:
            raise AssertionError(f"shim.service printed {line!r}")
        ready_s = time.perf_counter() - t0
        client = ShimClient(m.group(1), timeout=60.0)
        try:
            client.advance(3)
            client.crash(N_MAIN // 2)
            r = client.advance(10)
            lsm = client.lsm(0)
        finally:
            client.close()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    if r != 13 or N_MAIN // 2 in lsm or len(lsm) != N_MAIN - 1 or rc != 0:
        raise AssertionError(f"shim.service process: round {r}, {len(lsm)} "
                             f"members, exit {rc}")
    log(f"  python -m gossipfs_tpu_torch.shim.service --n {N_MAIN} "
        f"--topology random: serving after {ready_s:.2f} s, Advance to "
        f"round {r}, Lsm(0) {len(lsm)} members without {N_MAIN // 2}, "
        f"exit {rc} on SIGINT")
    results["shim"]["process"] = dict(ready_s=ready_s)


def shim_cli_packed(results: dict) -> None:
    """``python -m gossipfs_tpu_torch.shim.cli --packed --n 49152``'s own
    configuration and co-sim (``config_from_args``, ``cosim_from_args``),
    fed a REPL script through ``dispatch``: crashes detected and dropped
    from node 0's list, a put and a get, ``metrics``, ``events``; the ms
    of ``advance 1`` and the resident round's launches by form (its
    two-launch explicit-edge form at this N, held against its plain
    version at this shape by phase 41)."""
    import io
    import statistics
    import tempfile

    import numpy as np
    import torch

    from gossipfs_tpu_torch.ops import merge
    from gossipfs_tpu_torch.shim import cli

    args = cli.make_parser().parse_args(["--packed", "--n", str(N_ADVANCE)])
    cfg = cli.config_from_args(args)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim = cli.cosim_from_args(args, cfg)
    crashed = tuple(N_ADVANCE * k // 12 + 1 for k in (1, 3, 5, 8)) + (
        N_ADVANCE - 1,)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = f"{tmp}/wiki.bin", f"{tmp}/back.bin"
        blob = np.random.default_rng(SEED + 462).integers(
            0, 256, 1 << 20, dtype=np.uint8).tobytes()
        with open(src, "wb") as f:
            f.write(blob)
        out = io.StringIO()
        merge.reset_launch_counts()
        script = (["advance 2"] + [f"crash {x}" for x in crashed]
                  + ["advance 10", "lsm 0", f"put {src} wiki.bin",
                     f"get wiki.bin {dst}", "metrics", "events"])
        for line in script:
            cli.dispatch(sim, line, out=out)

        def step():
            cli.dispatch(sim, "advance 1", out=out)
            torch.cuda.synchronize()

        adv = wire_ms(step)
        launches = launch_counts()
        with open(dst, "rb") as f:
            back = f.read()
    text = out.getvalue().splitlines()
    lsm = [int(x) for x in text[2].strip("[]").split(", ")]
    rounds = 2 + 10 + len(adv)
    vitals = next(ln for ln in text if ln.startswith("engine=sim"))
    want = {"resident_round": rounds,
            "resident_round[edges]": rounds}
    if (set(crashed) & set(lsm) or len(lsm) != N_ADVANCE - len(crashed)
            or text[3] != "ok" or back != blob
            or f"n_alive={N_ADVANCE - len(crashed)}" not in vitals
            or launches != want):
        raise AssertionError(f"CLI --packed: {text[:6]}, launches "
                             f"{launches}")
    n_events = sum(1 for ln in text if ln.startswith("DetectionEvent("))
    peak = torch.cuda.max_memory_allocated() / 2**30
    res = dict(n=N_ADVANCE, fanout=cfg.fanout, rounds=rounds,
               advance_ms=statistics.median(adv), advance_ms_runs=adv,
               launches=launches, peak_gib=peak, detections=n_events)
    log(f"  CLI --packed --n {N_ADVANCE} (fanout {cfg.fanout}): crashed "
        f"{list(crashed)} at round 2, lsm 0 after advance 10 has "
        f"{len(lsm)} members and none of them; put ok, get == the bytes; "
        f"{n_events} detection events; {vitals}")
    log(f"  CLI --packed: advance 1 {res['advance_ms']:.3f} ms (median of "
        f"{len(adv)}: {[round(x, 3) for x in adv]}); launches {launches} "
        f"(K3's two-launch edges form, held against plain at [{N_ADVANCE} "
        f"x {N_ADVANCE}] by phase 41); peak {peak:.3f} GiB")
    results["shim"]["cli_packed"] = res
    del sim
    torch.cuda.empty_cache()


def shim_script(device: str, election: str = "local") -> dict:
    """One shim script at N = 1,024 (random, fanout 10) on ``device``:
    puts, three crashes (with ``election="rpc"`` the master, node 0,
    among them), 16 rounds, then every read verb.  Returns the replies,
    the event log, the detections and the master."""
    import numpy as np

    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.cosim import CoSim
    from gossipfs_tpu_torch.shim.client import ShimClient
    from gossipfs_tpu_torch.shim.service import ShimServer

    cfg = SimConfig(n=N_SHIM_SMALL, topology="random", fanout=10)
    sim = CoSim(cfg, seed=11, election=election, device=device)
    server = ShimServer(sim).start()
    client = ShimClient(server.address, timeout=120.0)
    rng = np.random.default_rng(SEED + 463)
    replies = []
    try:
        client.advance(3)
        for i in range(4):
            data = rng.integers(0, 256, 65_536, dtype=np.uint8).tobytes()
            replies.append(client.put(f"f{i}.bin", data))
        victim = client.ls("f0.bin")[0]
        crashed = ([0] if election == "rpc" else []) + [victim, 100, 900]
        for x in crashed:
            client.crash(x)
        client.advance(16)
        for method, req in (
                ("Lsm", {"observer": 1}), ("Lsm", {"observer": 512}),
                ("AliveNodes", {}), ("Ls", {"file": "f0.bin"}),
                ("Ls", {"file": "f3.bin"}), ("Get", {"file": "f0.bin"}),
                ("Get", {"file": "f2.bin"}), ("Events", {}),
                ("Vitals", {}), ("ShowMetadata", {}),
                ("Grep", {"pattern": "Elected|Re-replicated"})):
            replies.append(client.call(method, **req))
    finally:
        client.close()
        server.stop()
    return dict(replies=replies, log=sim.log.entries,
                events=[(e.round, e.observer, e.subject, e.false_positive)
                        for e in sim.events],
                master=sim.cluster.master_node, crashed=crashed)


def packed_script(device: str, tmp: str) -> dict:
    """The ``--packed`` REPL script at ``packed_rr(1024, fanout=8)``, seed
    3, on ``device``: printed text, event log, detections, vitals."""
    import io

    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.cosim import CoSim
    from gossipfs_tpu_torch.detector.sim import PackedDetector
    from gossipfs_tpu_torch.shim import cli

    cfg = SimConfig.packed_rr(N_SHIM_SMALL, fanout=8)
    sim = CoSim(cfg, seed=3, detector=PackedDetector(cfg, seed=3,
                                                     device=device))
    src = f"{tmp}/p.bin"
    with open(src, "wb") as f:
        f.write(bytes(range(256)) * 64)
    out = io.StringIO()
    for line in ("advance 2", f"put {src} p.bin", "crash 0", "crash 17",
                 "crash 512", "advance 4", "crash 900", "advance 10",
                 "lsm 0", "lsm 1", "ls p.bin", "join 17", "advance 8",
                 "lsm 17", f"get p.bin {tmp}/p_{device}.bin", "metrics",
                 "events", "grep Elected"):
        cli.dispatch(sim, line, out=out)
    return dict(text=out.getvalue(), log=sim.log.entries,
                events=[(e.round, e.observer, e.subject, e.false_positive)
                        for e in sim.events], vitals=sim.vitals())


def shim_card_vs_cpu(results: dict) -> None:
    """The same shim script on the card and on the CPU port at N = 1,024:
    replies (Lsm, Ls, Get bytes, Events, Vitals ...), event log and
    detections equal; the same with ``election="rpc"`` and the master
    crashed (the winner and the election's log line equal); and the
    ``--packed`` REPL script at ``packed_rr(1024, fanout=8)``, seed 3."""
    import pathlib
    import tempfile

    from gossipfs_tpu_torch.ops import merge

    out = {}
    for election in ("local", "rpc"):
        before = merge.launch_snapshot()
        t0 = time.perf_counter()
        card = shim_script("cuda", election)
        card_s = time.perf_counter() - t0
        launches, _ = merge.launches_since(before)
        t0 = time.perf_counter()
        cpu = shim_script("cpu", election)
        cpu_s = time.perf_counter() - t0
        if card != cpu:
            bad = [k for k in card if card[k] != cpu[k]]
            raise AssertionError(f"shim script ({election}): card != CPU "
                                 f"in {bad}")
        lines = [e["message"] for e in card["log"]
                 if e.get("kind") == "election"]
        if election == "rpc" and (card["master"] == 0 or not any(
                "Vote/AssignNewMaster" in m for m in lines)):
            raise AssertionError(f"rpc election: master {card['master']}, "
                                 f"log {lines}")
        if set(launches) != {"fused_merge_update"}:
            raise AssertionError(f"shim script launched {launches}")
        log(f"  shim script N={N_SHIM_SMALL} election={election}: crashed "
            f"{card['crashed']}, master {card['master']}, "
            f"{len(card['events'])} detections, {len(card['log'])} log "
            f"lines{' incl. ' + repr(lines[-1]) if lines else ''}; card == "
            f"CPU (replies, log, detections); {card_s:.2f} s card, "
            f"{cpu_s:.2f} s CPU; launches {launches}")
        out[election] = dict(launches=launches, seconds=card_s,
                             cpu_seconds=cpu_s, master=card["master"])
    with tempfile.TemporaryDirectory() as tmp:
        before = merge.launch_snapshot()
        card = packed_script("cuda", tmp)
        launches, forms = merge.launches_since(before)
        cpu = packed_script("cpu", tmp)
        same_bytes = (pathlib.Path(tmp, "p_cuda.bin").read_bytes()
                      == pathlib.Path(tmp, "p_cpu.bin").read_bytes())
    if card != cpu or not same_bytes:
        bad = [k for k in card if card[k] != cpu[k]]
        raise AssertionError(f"--packed script: card != CPU in {bad}")
    log(f"  --packed script packed_rr({N_SHIM_SMALL}, fanout=8), seed 3: "
        f"{len(card['events'])} detections, text, log, vitals and bytes "
        f"read == the CPU run; launches {launches} {forms}")
    out["packed"] = dict(launches=launches, forms=forms)
    results["shim"]["card_vs_cpu"] = out


def shim_k2_shapes(results: dict) -> None:
    """K2 against its plain version at the shapes phase 46's paths give
    it, detection stats and suspicion on and off, tolerance 0: the
    shim's [16,384 x 16,384] (F = 14, SimConfig's int16 view and int32
    hb), the card-against-CPU script's N = 1,024 (F = 10) and wire_ops'
    ring at N = 16 (F = 3); each timed in the paths' mode."""
    import numpy as np
    import torch

    from gossipfs_tpu_torch.ops import merge_update as mu

    err = 0
    for key, n, f, seed in (("k2_shim_n1024", N_SHIM_SMALL, 10, 464),
                            ("k2_wire_ops_n16", 16, 3, 465)):
        view, edges, _, hb, asl, sa, sb, alive = merge_inputs(
            n, f, np.int16, np.int32, SEED + seed, statuses=4)
        args = (view, edges, hb, asl, sa, sb, alive)
        for det in (False, True):
            for sus in (False, True):
                log(f"  K2 N={n}: F={f}, view int16, hb int32, "
                    f"detect_stats={det}, suspect={sus}")
                err = max(err, compare_merge(
                    mu.fused_merge_update, mu.fused_merge_update_plain, args,
                    dict(detect_stats=det, suspect=sus)))
        results[key] = dict(max_abs_err=0, shape=[n, n])
        time_merge(mu.fused_merge_update, mu.fused_merge_update_plain, args,
                   dict(detect_stats=True), results, key)
    n, f = N_MAIN, SHIM_FANOUT
    view, edges, _, hb, asl, sa, sb, alive = big_merge_inputs(
        n, n, f, torch.int32, SEED + 466, vdt=torch.int16)
    args = (view, edges, hb, asl, sa, sb, alive)
    for det in (False, True):
        for sus in (False, True):
            kw = dict(detect_stats=det, suspect=sus)
            got = mu.fused_merge_update(view, edges, hb.clone(), asl.clone(),
                                        sa, sb, alive, **kw)
            want = mu.fused_merge_update_plain(view, edges, hb.clone(),
                                               asl.clone(), sa, sb, alive,
                                               **kw)
            diff = sum(count_diff(a, b)[0] for a, b in zip(got, want))
            log(f"  K2 shim [{n} x {n}], F={f}, view int16, hb int32, "
                f"detect_stats={det}, suspect={sus}: {diff} entries differ")
            err = max(err, diff)
            del got, want
    results["k2_shim"] = dict(max_abs_err=err, shape=[n, n])
    time_merge(mu.fused_merge_update, mu.fused_merge_update_plain, args,
               dict(detect_stats=True), results, "k2_shim")
    del view, edges, hb, asl, args
    torch.cuda.empty_cache()
    if err:
        raise AssertionError("K2 != plain at phase 46's shapes")


def shim_wire_ops(results: dict) -> None:
    """``wire_ops.run`` on the card with two seeded payloads of the
    reference shards' sizes (4.0 MB and 3.2 MB), n = 16, 5 reps: insert,
    update and read ms a file, and the repair dict (healed, bytes
    identical)."""
    import tempfile

    import numpy as np

    from gossipfs_tpu_torch import wire_ops
    from gossipfs_tpu_torch.ops import merge

    rng = np.random.default_rng(SEED + 467)
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for name, size in (("file5.bin", 4_194_304),
                           ("file10.bin", 3_276_800)):
            files.append(f"{tmp}/{name}")
            with open(files[-1], "wb") as f:
                f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        before = merge.launch_snapshot()
        t0 = time.perf_counter()
        doc = wire_ops.run(files, n=16, reps=5)
        seconds = time.perf_counter() - t0
        launches, _ = merge.launches_since(before)
    rep = doc["repair"]
    if not (rep["healed"] and rep["bytes_identical_after_repair"]):
        raise AssertionError(f"wire_ops repair: {rep}")
    if set(launches) != {"fused_merge_update"}:
        raise AssertionError(f"wire_ops launched {launches}")
    for row in doc["rows"]:
        log(f"  wire_ops {json.dumps(row)}")
    log(f"  wire_ops repair {json.dumps(rep)}; {seconds:.2f} s, launches "
        f"{launches}, device {doc['device']}")
    results["shim"]["wire_ops"] = dict(rows=doc["rows"], repair=rep,
                                       launches=launches, seconds=seconds)


def phase_shim(results: dict) -> None:
    results["shim"] = {}
    t0 = time.perf_counter()
    for name, fn in (("full", shim_full_width),
                     ("process", shim_service_process),
                     ("cli_packed", shim_cli_packed),
                     ("card_vs_cpu", shim_card_vs_cpu),
                     ("k2", shim_k2_shapes), ("wire_ops", shim_wire_ops)):
        t1 = time.perf_counter()
        fn(results)
        results["shim"].setdefault(name, {})["phase_s"] = (
            time.perf_counter() - t1)
    results["shim"]["seconds"] = time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phase 47: config 5 over ranks, roundprof, the soak, checkpoint/resume and
# the profiler seam
# ---------------------------------------------------------------------------

N_SOAK = 4_096          # the soak's N (bench/soak_hb16.py)
RP_ROUNDS = 10          # roundprof's rounds a row (cut from its 100; 20
                        # until phase 49 joined the run)
# the soak cut from 10 x 5,000 (1 x 600 when phase 48 joined the run, 1 x
# 300 since phase 49 did, to keep the whole run inside its time limit: the
# int8 window of 126 rounds is still crossed twice)
SOAK_CHUNKS, SOAK_ROUNDS = 1, 300
# the port's kernels as CUPTI names them (demangled templates), by K-name
K_NAMES = (("rr_onepass_kernel", "K3 one-pass"),
           ("rr_tick_view_kernel", "K3 two-launch pass A"),
           ("rr_merge_kernel", "K3 two-launch pass B"),
           ("fused_kernel", "K2"), ("stripe_kernel", "K5"),
           ("arc_rows_kernel", "K4 rows"), ("window_tile_kernel", "K4 window"),
           ("window_max_kernel", "K4 window"), ("fanout_max_kernel", "K1"))


def k_name(name: str) -> str | None:
    """The K-name of a profiler row, None for torch's own kernels."""
    for sub, k in K_NAMES:
        if sub in name:
            return k
    return None


def block_merge_check(key: str, label: str, fn, plain, n: int, c: int,
                      f: int, hdts, timed, results: dict, seed: int,
                      **kw) -> None:
    """A merge kernel against its plain version over an [N, C] block with
    an int8 view, for each hb dtype of ``hdts``, detection stats on and
    off, tolerance 0 (``big_merge_inputs``' corner cases); kernel, plain
    and byte-bound times at ``timed``'s dtype."""
    import torch

    from gossipfs_tpu_torch.ops import merge_update as mu

    err = diff = 0
    arc = fn is mu.arc_merge_update
    for i, hdt in enumerate(hdts):
        view, edges, bases, hb, asl, sa, sb, alive = big_merge_inputs(
            n, c, f, hdt, seed + i)
        senders = bases if arc else edges
        for det in (False, True):
            got = fn(view, senders, hb.clone(), asl.clone(), sa, sb, alive,
                     detect_stats=det, **kw)
            want = plain(view, senders, hb.clone(), asl.clone(), sa, sb,
                         alive, detect_stats=det, **kw)
            diffs = [count_diff(a, b) for a, b in zip(got, want)]
            d = sum(x[0] for x in diffs)
            diff += d
            err = max([err] + [x[1] for x in diffs])
            log(f"  {label} [{n} x {c}], F={f}, view int8, hb "
                f"{str(hdt).split('.')[-1]}, detect_stats={det}: {d} "
                "entries differ")
            del got, want
        if hdt == timed:
            h2, a2 = hb.clone(), asl.clone()
            run_k = lambda: fn(view, senders, h2, a2, sa, sb, alive,  # noqa: E731
                               detect_stats=True, **kw)
            run_p = lambda: plain(view, senders, h2, a2, sa, sb, alive,  # noqa: E731
                                  detect_stats=True, **kw)
            run_k()
            ms = min(cuda_ms(run_k, 10), cuda_ms(run_k, 10))
            run_p()
            plain_ms = cuda_ms(run_p, 1)
            bound = merge_block_bound_ms(view, senders, hb, 3)
            del h2, a2
        del view, edges, bases, hb, asl
    torch.cuda.empty_cache()
    if diff or err:
        raise AssertionError(f"{label} != plain at [{n} x {c}]")
    results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, shape=[n, c])
    log(f"  {label} [{n} x {c}]: kernel {ms:.4f} ms, plain {plain_ms:.3f} "
        f"ms, byte bound {bound:.4f} ms")


def p47_kernels(results: dict) -> None:
    """The merge kernels at the shapes phase 47's paths give them that no
    earlier phase holds: K2 over config 5's [16,384 x 8,192] rank block
    (F = 14, int16 hb), at the soak's N = 4,096 (F = 12; int32, int16 and
    int8 hb) and at roundprof's N = 16,384 (F = 14; int16 and int8 hb);
    K4 at roundprof's arc rows (N = 16,384, F = 14, plain bases)."""
    import torch

    from gossipfs_tpu_torch.ops import merge_update as mu

    k2 = (mu.fused_merge_update, mu.fused_merge_update_plain)
    block_merge_check("k2_c5_ranks", "K2 config 5 rank block", *k2, N_MAIN,
                      N_MAIN // 2, 14, (torch.int16,), torch.int16, results,
                      SEED + 471)
    block_merge_check("k2_soak", "K2 soak", *k2, N_SOAK, N_SOAK, 12,
                      (torch.int32, torch.int16, torch.int8), torch.int16,
                      results, SEED + 472)
    block_merge_check("k2_roundprof", "K2 roundprof", *k2, N_MAIN, N_MAIN,
                      14, (torch.int16, torch.int8), torch.int16, results,
                      SEED + 475)
    block_merge_check("k4_roundprof", "K4 roundprof",
                      mu.arc_merge_update, mu.arc_merge_update_plain, N_MAIN,
                      N_MAIN, 14, (torch.int16, torch.int8), torch.int16,
                      results, SEED + 477, fanout=14)


def p47_config5(results: dict) -> None:
    """Config 5 at N = 16,384 (1,000 files, 24 rounds) over 2 rank
    processes sharing the card (gloo through the host: not a multi-GPU
    speed) against the one-process run on the card: the report (the
    ``cosim`` dict, the detection report, rank 0's launches) equal,
    timings aside; each rank's K2 launches over its [16,384 x 8,192]
    block, peak memory and rounds/s."""
    import torch

    from gossipfs_tpu_torch import run

    kw = dict(n_override=N_MAIN, rounds_override=24)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one = run.run_scenario("sim-100k-sdfs", **kw)
    one_peak = torch.cuda.max_memory_allocated() / 2**30
    t1 = time.perf_counter()
    two = run.run_scenario("sim-100k-sdfs", devices=2, **kw)
    t2 = time.perf_counter()
    ranks = two.pop("cosim_ranks")
    same = {k: v for k, v in untimed(two).items() if k != "devices"} == \
        {k: v for k, v in untimed(one).items() if k != "devices"}
    cos = two["cosim"]
    log(f"  config 5 over 2 ranks, N={N_MAIN}: cosim "
        f"{json.dumps(untimed(cos))}, TTD {two['detection']['ttd_first']}, "
        f"final alive {two['detection']['final_alive']}: report == the "
        f"one-process run's: {same}")
    chunks = cos["rounds"] + 8      # the co-sim's warm-up chunk and its run
    for r in ranks:
        log(f"  rank {r['rank']}: [{N_MAIN} x {r['nloc']}] block, co-sim K2 "
            f"launches {r['launches']}, peak {r['peak_bytes'] / 2**30:.2f} "
            f"GiB (detector {r['detector_peak_bytes'] / 2**30:.2f} GiB), "
            f"{r['collectives']['calls']} all-reduces")
        if r["launches"] != {"fused_merge_update": chunks}:
            raise AssertionError(f"config 5 rank {r['rank']} launched "
                                 f"{r['launches']}")
    log(f"  rounds/s: detector {two['rounds_per_sec']:.2f} over 2 ranks "
        f"(host clock), {one['rounds_per_sec']:.2f} in one process (CUDA "
        f"events); co-sim {cos['rounds_per_sec']} over 2 ranks, "
        f"{one['cosim']['rounds_per_sec']} in one process; one-process "
        f"peak {one_peak:.2f} GiB; {t1 - t0:.1f} s and {t2 - t1:.1f} s")
    if not same or two["launches"] != {"fused_merge_update": 24}:
        raise AssertionError(f"config 5 over ranks: {two} != {one}")
    results["c5_ranks"] = dict(
        n=N_MAIN, rounds_per_s=two["rounds_per_sec"],
        cosim_rounds_per_s=cos["rounds_per_sec"],
        one_rounds_per_s=one["rounds_per_sec"],
        one_cosim_rounds_per_s=one["cosim"]["rounds_per_sec"],
        peak_gib=[max(r["peak_bytes"], r["detector_peak_bytes"]) / 2**30
                  for r in ranks],
        launches=two["launches"], cosim_launches=two["cosim_launches"],
        seconds=t2 - t0)


def p47_roundprof(results: dict) -> None:
    """``roundprof`` at N = 16,384: every row of ``variants`` and of
    ``suspicion_variants(interpret=False)``, 20 rounds (cut from 100), one
    run from a fresh state on CUDA events after a 2-round warm-up (the
    CLI: best of 3 after a full-length one): its route, launches (one
    of the route's kernel a round, none other), ms a round, and the
    bandwidth block against the H100's 3,350 GB/s; a lean row also its
    two-launch twin.  Each row (and twin) then runs 2 rounds on the
    kernels and on the plain versions from the same state and key: lanes,
    carry and metrics equal."""
    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch import roundprof
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state

    dev = torch.device("cuda")
    key = trandom.PRNGKey(0, device="cuda")

    def two_rounds(cfg, plain: bool = False):
        return run_rounds(init_state(cfg), cfg, 2, key, plain=plain,
                          crash_rate=roundprof.CRASH_RATE)

    def want_launches(route) -> tuple[dict, dict]:
        loop, form = route
        if loop == "lean":
            return {"resident_round": RP_ROUNDS}, {form: RP_ROUNDS}
        return {form: RP_ROUNDS}, {}

    rows = {}
    t0 = time.perf_counter()
    tables = (roundprof.variants(N_MAIN),
              roundprof.suspicion_variants(N_MAIN, interpret=False))
    for table in tables:
        for name, cfg in table.items():
            t1 = time.perf_counter()
            row = roundprof.profile_row(name, cfg, RP_ROUNDS, dev, "gpu",
                                        reps=1, warm=2)
            parts = [row] + ([row["two_launch"]] if "two_launch" in row
                             else [])
            cfgs = [cfg] + ([dataclasses.replace(cfg, rr_resident="off")]
                            if "two_launch" in row else [])
            # a lean row and its two-launch twin share one plain run,
            # held on the card and compared there
            plain = two_rounds(cfg, plain=True)
            for part, c in zip(parts, cfgs):
                launches, forms = want_launches(part["route"])
                eq = runs_equal(two_rounds(c), plain)
                log(f"  {name}{' off' if part is not row else ''}: route "
                    f"{'/'.join(part['route'])}, launches "
                    f"{part['launches']} {part['forms']}, "
                    f"{part['ms_per_round']:.4f} ms a round, "
                    f"{part['achieved_gb_per_s']:.1f} GB/s of "
                    f"{part['modeled_bytes_per_round'] / 1e9:.3f} GB = "
                    f"{part['pct_of_peak_hbm']:.2f} % of "
                    f"{roundprof.HBM_PEAK_GBS:.0f} GB/s (floor ceiling "
                    f"{part['floor_implied_ceiling_rounds_per_sec']:.1f} "
                    f"rounds/s); 2 rounds kernels == plain: {eq}; "
                    f"{time.perf_counter() - t1:.1f} s")
                if (part["launches"] != launches or part["forms"] != forms
                        or not eq):
                    raise AssertionError(f"roundprof {name}: {part}")
            rows[name] = row
            del plain
    results["roundprof"] = dict(rows=rows, seconds=time.perf_counter() - t0)


def p47_soak(results: dict) -> None:
    """The soak cut: int8 and int16 against int32 at N = 4,096, one chunk
    of 300 rounds on K2: PASS, one K2 launch a round."""
    from gossipfs_tpu_torch import soak_hb16
    from gossipfs_tpu_torch.ops import merge

    before = merge.launch_snapshot()
    t0 = time.perf_counter()
    doc = soak_hb16.main(["--n", str(N_SOAK), "--chunks", str(SOAK_CHUNKS),
                          "--chunk-rounds", str(SOAK_ROUNDS)])
    seconds = time.perf_counter() - t0
    launches, _ = merge.launches_since(before)
    rounds = SOAK_CHUNKS * SOAK_ROUNDS
    log(f"  soak N={N_SOAK}, {SOAK_CHUNKS} x {SOAK_ROUNDS} rounds: "
        f"{'PASS' if doc['ok'] else 'FAIL'} in {seconds:.1f} s; launches "
        f"{launches}; largest counter {doc['max_true_hb']}: the int8 "
        f"window (126 rounds) crossed ~{doc['max_true_hb'] // 126} times, "
        "the int16 window (16,384 rounds) not crossed")
    if not doc["ok"] or launches != {"fused_merge_update": 3 * rounds}:
        raise AssertionError(f"soak: {doc} {launches}")
    results["soak"] = dict(seconds=seconds, launches=launches,
                           mode_seconds=doc["seconds"],
                           store_base=doc["store_base"])


def p47_checkpoint(results: dict) -> None:
    """Checkpoint/resume on the card: the headline (lean, K3) and config 3
    (K2), 1 % crash churn; saved at round 10, restored, 10 more rounds ==
    the uninterrupted 20 (lanes, 0 entries differ); restored into another
    hb_dtype (headline int16, config 3 int32), 10 more: status, age,
    alive, live MEMBER true counters and detections equal; then restored
    onto 2 rank processes and resumed: the gathered run == the resumed
    run in this process."""
    import tempfile

    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import MEMBER, init_state
    from gossipfs_tpu_torch.models import presets
    from gossipfs_tpu_torch.parallel import distributed
    from gossipfs_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)

    key = trandom.PRNGKey(SEED, device="cuda")
    kw = dict(crash_rate=0.01)
    cases = (("headline", SimConfig.headline(N_MAIN), "int16"),
             ("config 3", presets.ALL["sim-10k-crash"].config, "int32"))

    def lanes_diff(a, b) -> int:
        return sum(count_diff(x, y)[0] for x, y in
                   ((a.hb, b.hb), (a.asl, b.asl), (a.alive, b.alive),
                    (a.hb_base, b.hb_base))) + int(a.round != b.round)

    def cross_diff(a, ac, am, b, bc, bm) -> int:
        """The soak's criteria: status, age, alive, live MEMBER true
        counters, first_detect, converged and the detection counts."""
        live = a.alive[:, None] & ((a.asl & 3) == MEMBER)
        ta = a.hb.to(torch.int32) + a.hb_base[None, :]
        tb = b.hb.to(torch.int32) + b.hb_base[None, :]
        d = int((live & (ta != tb)).sum())
        d += int(((a.asl & 3) != (b.asl & 3)).sum())
        d += int((a.age != b.age).sum()) + int((a.alive != b.alive).sum())
        d += int((ac.first_detect != bc.first_detect).sum())
        d += int((ac.converged != bc.converged).sum())
        for f in ("true_detections", "false_positives"):
            d += int((getattr(am, f) != getattr(bm, f)).sum())
        return d

    jobs, want = [], []
    tmp = tempfile.mkdtemp(prefix="ckpt-", dir=distributed.BUILD_DIR)
    t0 = time.perf_counter()
    try:
        for label, cfg, other in cases:
            full = run_rounds(init_state(cfg), cfg, 20, key, **kw)[0]
            half = run_rounds(init_state(cfg), cfg, 10, key, **kw)[0]
            path = f"{tmp}/{label.replace(' ', '')}"
            t1 = time.perf_counter()
            save_checkpoint(path, half, key)
            st, rk = restore_checkpoint(path, cfg)
            io_s = time.perf_counter() - t1
            del half
            res = run_rounds(st, cfg, 10, rk, **kw)
            d = lanes_diff(full, res[0])
            log(f"  checkpoint {label} (N={cfg.n}, hb {cfg.hb_dtype}): "
                f"saved at round 10, restored ({io_s:.2f} s with the "
                f"save), 10 more rounds == the uninterrupted 20: {d} "
                "entries differ")
            del full
            cfg2 = dataclasses.replace(cfg, hb_dtype=other)
            st2, rk2 = restore_checkpoint(path, cfg2)
            res2 = run_rounds(st2, cfg2, 10, rk2, **kw)
            d2 = cross_diff(*res, *res2)
            log(f"  checkpoint {label} restored into hb {other}, 10 more "
                f"rounds: status, age, alive, live MEMBER counters and "
                f"detections == the {cfg.hb_dtype} resume: {d2} entries "
                "differ")
            if d or d2:
                raise AssertionError(f"checkpoint {label}: {d} / {d2}")
            want.append(run_digest(*res))
            jobs.append(dict(config=cfg, rounds=10, restore=path, **kw))
            del res, res2, st2
            torch.cuda.empty_cache()
        ranks = distributed.launch(shard_ranks, 2, (jobs,), timeout=600)
        for (label, _, _), got, w in zip(cases, ranks[0], want):
            ok = got["digest"] == w
            log(f"  checkpoint {label} restored onto 2 ranks ([N x "
                f"{got['nloc']}] blocks, route {got['route']}), 10 rounds: "
                f"gathered lanes, carry and metrics == the resume in this "
                f"process: {ok}; launches {got['launches']}")
            if not ok:
                raise AssertionError(f"checkpoint {label} over ranks")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    results["checkpoint"] = dict(seconds=time.perf_counter() - t0)


def p47_profiler(results: dict) -> None:
    """The profiler seam: ``utils.profiling.trace`` around 10 headline
    rounds (its top device rows name K3's kernel; K3's row count equals
    ``ops/merge``'s launch count), ``time_rounds`` beside
    ``bench.timed_run``'s rate, ``python -m gossipfs_tpu_torch.bench
    --xprof DIR`` and ``sweep_merge --hb-dtype int8 --elementwise lanes
    swar``."""
    import contextlib
    import io
    import shutil
    import tempfile

    from gossipfs_tpu_torch import bench, sweep_merge
    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.ops import merge
    from gossipfs_tpu_torch.parallel import distributed
    from gossipfs_tpu_torch.utils import profiling

    cfg = bench.headline_config(N_MAIN, False)
    tmp = tempfile.mkdtemp(prefix="prof-", dir=distributed.BUILD_DIR)
    out = {}
    try:
        bench.timed_run(cfg, 10)
        before = merge.launch_snapshot()
        with profiling.trace(f"{tmp}/trace"):
            bench.timed_run(cfg, 10)
        launches, forms = merge.launches_since(before)
        rows = profiling.op_breakdown(f"{tmp}/trace", top=8)
        for r in rows:
            log(f"  profiler: {r['total_ms']:9.3f} ms x{r['count']:<4d} "
                f"[{k_name(r['name']) or 'torch'}] {r['name'][:110]}")
        k3 = sum(r["count"] for r in rows
                 if (k_name(r["name"]) or "").startswith("K3"))
        log(f"  profiler: K3 rows count {k3} launches; ops/merge counted "
            f"{launches} {forms}")
        if (not rows or not (k_name(rows[0]["name"]) or "").startswith("K3")
                or k3 != launches.get("resident_round")):
            raise AssertionError(f"profiler rows {rows} != {launches}")
        out["top"] = [[k_name(r["name"]), r["total_ms"], r["count"]]
                      for r in rows[:3]]
        tr = profiling.time_rounds(None, cfg, trandom.PRNGKey(0,
                                                              device="cuda"),
                                   short=10, long=50, crash_rate=0.01)
        sec, _ = bench.timed_run(cfg, 50)
        out.update(time_rounds_rps=tr["rounds_per_sec"],
                   timed_run_rps=50 / sec)
        log(f"  time_rounds (slope of 10 and 50 rounds, host clock): "
            f"{tr['rounds_per_sec']:.1f} rounds/s, fixed cost "
            f"{tr['dispatch_overhead_s'] * 1e3:.3f} ms a call; "
            f"bench.timed_run (50 rounds, CUDA events): {50 / sec:.1f} "
            "rounds/s")
        doc = quiet_main(bench.main, ["--rounds", "20", "--attempts", "2",
                                      "--xprof", f"{tmp}/xprof"])
        log(f"  bench --xprof: {doc['value']:.1f} rounds/s, xprof "
            f"{doc['xprof']}, top "
            f"{[(k_name(r['name']), r['total_ms'], r['count']) for r in doc['xprof_top'][:3]]}")
        if not doc["xprof_top"] or not (
                k_name(doc["xprof_top"][0]["name"]) or "").startswith("K3"):
            raise AssertionError(f"bench --xprof: {doc['xprof_top']}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = sweep_merge.main(["--hb-dtype", "int8", "--elementwise",
                                    "lanes", "swar"])
        for line in buf.getvalue().strip().splitlines():
            log(f"  sweep_merge: {line}")
        if len(res) != 2:
            raise AssertionError("sweep_merge: a row failed")
        out["sweep"] = {tag: rps for rps, tag in res}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results["profiler"] = out


def phase_bench_tail(results: dict) -> None:
    results["p47"] = {}
    t0 = time.perf_counter()
    for name, fn in (("kernels", p47_kernels), ("config5", p47_config5),
                     ("roundprof", p47_roundprof), ("soak", p47_soak),
                     ("checkpoint", p47_checkpoint),
                     ("profiler", p47_profiler)):
        t1 = time.perf_counter()
        fn(results)
        results["p47"][name] = time.perf_counter() - t1
        log(f"  47 {name} in {results['p47'][name]:.2f} s")
    results["p47"]["seconds"] = time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phase 48: the socket engines.  The campaign CLI replays committed cases
# over the native C++ engine (n = 256, at its committed n) and the asyncio
# udp engine (n = 24), each verdict held against the tensor replay on the
# card; the conformance CLI replays three schedules over all four columns;
# native_rt; the deploy lane.  The engines are host code on the wall
# clock: nothing else runs while they do.
# ---------------------------------------------------------------------------

SOCKET_CASES = (("native", "outage_storm_n256"), ("udp", "outage_mild_udp_n24"))
# the three conformance families of the tensor column with the fewest
# rounds (8, 16, 22), seed 0: with suspicion (leave_broadcast,
# refute_race, a blackout scenario in the latter) and without
# (direct_confirm)
SOCKET_FAMILIES = ("leave_broadcast", "direct_confirm", "refute_race")
ENGINES4 = ("reference", "tensor", "udp", "native")


def repo_path(*parts: str):
    import pathlib

    return pathlib.Path(__file__).resolve().parent.joinpath(*parts)


def cli_json(main, argv: list) -> tuple[int, dict]:
    """Call a CLI's ``main(argv)`` (the function ``python -m`` runs) with
    its standard output captured; (exit code, its last JSON line)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def socket_k2_shapes(results: dict) -> None:
    """K2 against its plain version at the shapes phase 48's paths give
    it: the campaign replays' n = 256 and n = 24 (the campaign profile's
    log fanout, int16 view, int32 hb; the crash-only form, as the
    committed cases arm no suspicion) and the conformance column's N = 8
    (F = 3, both forms), detection stats on and off, tolerance 0; kernel,
    plain and byte-bound times in the form each path runs."""
    import numpy as np

    from gossipfs_tpu_torch.campaigns import driver
    from gossipfs_tpu_torch.ops import merge_update as mu

    npdt = {"int8": np.int8, "int16": np.int16, "int32": np.int32}
    shapes = [("k2_campaign_n256", 256, (False,), 481),
              ("k2_campaign_n24", 24, (False,), 482),
              ("k2_conformance_n8", 8, (False, True), 483)]
    for key, n, forms, seed in shapes:
        cfg = driver.campaign_config(n)   # N = 8: the conformance F = 3
        f = cfg.fanout
        view, edges, _, hb, asl, sa, sb, alive = merge_inputs(
            n, f, npdt[cfg.view_dtype], npdt[cfg.hb_dtype], SEED + seed,
            statuses=4 if True in forms else 3)
        args = (view, edges, hb, asl, sa, sb, alive)
        err = 0
        for det in (False, True):
            for sus in forms:
                log(f"  K2 {key}: N={n}, F={f}, view {cfg.view_dtype}, hb "
                    f"{cfg.hb_dtype}, detect_stats={det}, suspect={sus}")
                err = max(err, compare_merge(
                    mu.fused_merge_update, mu.fused_merge_update_plain,
                    args, dict(detect_stats=det, suspect=sus)))
        if err:
            raise AssertionError(f"K2 != plain at {key}")
        results[key] = dict(max_abs_err=0, shape=[n, n])
        time_merge(mu.fused_merge_update, mu.fused_merge_update_plain, args,
                   dict(detect_stats=True, suspect=forms[-1]), results, key)


def case_scan(doc: dict, plain: bool):
    """The campaign replay's scan of one case doc (``run_scenario``'s
    ``run_rounds`` call): (final, carry, per_round) and its device ms a
    round (CUDA events)."""
    import torch

    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.bench import tracked_crash_events
    from gossipfs_tpu_torch.campaigns import driver
    from gossipfs_tpu_torch.core.rounds import run_rounds
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch.obs.monitor import MonitorParams
    from gossipfs_tpu_torch.scenarios.schedule import FaultScenario
    from gossipfs_tpu_torch.scenarios.tensor import compile_tensor

    c = doc["config"]
    sc = FaultScenario.from_json(json.dumps(doc["scenario"]))
    cfg = driver.campaign_config(
        c["n"], t_fail=c["t_fail"], t_suspect=c["t_suspect"],
        lh_multiplier=int(c.get("lh_multiplier", 0)),
        lh_frac=float(c.get("lh_frac", 0.25)))
    params = MonitorParams.from_dict(doc["monitor"])
    bound = params.reconverge_bound or (cfg.t_fail + 6)
    rounds = driver.campaign_rounds(sc.horizon, int(c.get("crash_at", 10)),
                                    bound)
    events, _, _ = tracked_crash_events(cfg, rounds, c["track"],
                                        int(c.get("crash_at", 10)),
                                        device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run_rounds(init_state(cfg, device="cuda"), cfg, rounds,
                     trandom.PRNGKey(c["seed"], device="cuda"),
                     events=events, crash_only_events=True,
                     scenario=compile_tensor(sc, device="cuda"), plain=plain)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / rounds, rounds


def socket_campaign(engine: str, case: str, results: dict) -> None:
    """``python -m gossipfs_tpu_torch.campaigns --case <case> --engine
    <engine>`` (its ``main``): launch counts zeroed just before and read
    just after, one K2 launch a replay round; ``reproduced`` and the
    verdict agreement required."""
    from gossipfs_tpu_torch.campaigns import __main__ as cli
    from gossipfs_tpu_torch.campaigns import driver, engines
    from gossipfs_tpu_torch.ops import merge

    path = repo_path("regressions", f"{case}.json")
    rounds = engines._case_plan(driver.load_case(path))[3]
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    rc, out = cli_json(cli.main, ["--case", str(path), "--engine", engine])
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in merge.LAUNCH_COUNTS.items() if v}
    row = out["engine_row"]
    log(f"  {case} --engine {engine}: n={out['n']}, exit {rc}, reproduced "
        f"{out['reproduced']}, verdicts tensor {out['tensor_verdict']} / "
        f"{engine} {out['engine_verdict']}, agreement "
        f"{out['agreement']}, period {row['period']} s, {wall:.1f} s; "
        f"launches {launches} ({rounds} replay rounds)")
    if engine == "native":
        log(f"  native tick_ms histogram {json.dumps(row['tick_ms'])}")
    log(f"  wire {json.dumps(row['wire'])}")
    if (rc != 0 or not out["reproduced"] or not out["agreement"]["match"]
            or launches != {"fused_merge_update": rounds}):
        raise AssertionError(f"{case} over {engine}: {out['agreement']}, "
                             f"launches {launches}")
    results["sockets"][engine] = dict(
        case=case, n=out["n"], seconds=wall, launches=launches,
        period=row["period"], verdict=out["engine_verdict"],
        tensor_verdict=out["tensor_verdict"], tick_ms=row.get("tick_ms"),
        wire=row["wire"])


def socket_replay_vs_plain(engine: str, case: str, results: dict) -> None:
    """The case's tensor replay on the kernels against the same replay on
    the plain versions: the scan (lanes, carry and every per-round
    metric: 0 entries differ) and the monitor row, whose verdict is the
    one the socket engine's agreed with."""
    import torch

    from gossipfs_tpu_torch.campaigns import driver
    from gossipfs_tpu_torch.obs.monitor import MonitorParams
    from gossipfs_tpu_torch.scenarios.schedule import FaultScenario

    doc = driver.load_case(repo_path("regressions", f"{case}.json"))
    (got, k_ms, _), (want, p_ms, _) = case_scan(doc, False), case_scan(
        doc, True)
    diff = sum(count_diff(a, b)[0] for a, b in zip(run_tensors(*got),
                                                   run_tensors(*want)))
    c = doc["config"]
    row_k = driver.run_case_doc(doc, device="cuda")["row"]
    row_p = driver.run_scenario(
        c["n"], FaultScenario.from_json(json.dumps(doc["scenario"])),
        t_fail=c["t_fail"], t_suspect=c["t_suspect"],
        lh_multiplier=int(c.get("lh_multiplier", 0)),
        lh_frac=float(c.get("lh_frac", 0.25)), seed=c["seed"],
        track=c["track"], crash_at=int(c.get("crash_at", 10)),
        params=MonitorParams.from_dict(doc["monitor"]), device="cuda",
        plain=True)
    so = results["sockets"][engine]
    log(f"  {case} replay on the kernels against the plain versions: "
        f"{diff} entries differ (lanes, carry, per-round metrics); monitor "
        f"row {'==' if row_k == row_p else '!='} the plain row, verdict "
        f"{row_k['verdict']} (the {engine} run's replay: "
        f"{so['tensor_verdict']}); {k_ms:.4f} ms a round on the kernels, "
        f"{p_ms:.4f} ms plain (CUDA events)")
    if diff or row_k != row_p or row_k["verdict"] != so["tensor_verdict"]:
        raise AssertionError(f"{case}: kernels != plain")
    del got, want
    torch.cuda.empty_cache()
    so.update(replay_round_ms=k_ms, plain_round_ms=p_ms)


def socket_conformance(results: dict) -> None:
    """``python -m gossipfs_tpu_torch.conformance --replay <case>
    --engines reference tensor udp native`` (its ``main``) for three
    schedules at seed 0: every row ok (``all_agree``) over all four
    columns, one K2 launch a tensor round (the warm-up's included); each
    tensor bundle on the card equal to the same bundle on the CPU (the
    plain versions)."""
    import os
    import tempfile

    from gossipfs_tpu_torch.conformance import __main__ as conf_cli
    from gossipfs_tpu_torch.conformance import harness, schedules
    from gossipfs_tpu_torch.ops import merge

    corpus = [schedules.generate(f, 0) for f in SOCKET_FAMILIES]
    rows, engines_run, bad = 0, set(), []
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for case in corpus:
            path = os.path.join(tmp, f"{case['family']}.json")
            with open(path, "w", encoding="utf-8") as f:
                f.write(schedules.serialize(case))
            rc, doc = cli_json(conf_cli.main, ["--replay", path, "--engines",
                                               *ENGINES4])
            rows += doc["rows"]
            engines_run |= set(doc["engines_run"])
            if rc != 0 or not doc["ok"]:
                bad.append((case["family"], doc["disagreements"]))
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in merge.LAUNCH_COUNTS.items() if v}
    rounds = sum(c["rounds"] + harness._WARMUP for c in corpus)
    log(f"  conformance {list(SOCKET_FAMILIES)} x seed 0 over "
        f"{sorted(engines_run)}: {rows} rows, all_agree {not bad}, "
        f"{wall:.1f} s; launches {launches} ({rounds} tensor rounds)")
    if (bad or engines_run != set(ENGINES4)
            or launches != {"fused_merge_update": rounds}):
        raise AssertionError(f"conformance over the socket columns: {bad}, "
                             f"{sorted(engines_run)}, {launches}")
    for case in corpus:
        if harness.run_case_tensor(case, device="cuda") != \
                harness.run_case_tensor(case, device="cpu"):
            raise AssertionError(f"conformance {case['family']}: the card's "
                                 "bundle != the CPU's")
    log("  each tensor bundle on the card == the CPU's (events, checkpoints, "
        "final)")
    results["sockets"]["conformance"] = dict(
        rows=rows, seconds=wall, launches=launches,
        udp_period=harness.udp_case_period(8))


def socket_native_rt(results: dict) -> None:
    """``python -m gossipfs_tpu_torch.native_rt --n 32 --period 0.005
    --rounds 200`` (its ``main``): the crash detected within 15 rounds."""
    from gossipfs_tpu_torch import native_rt

    _, doc = cli_json(native_rt.main, ["--n", "32", "--period", "0.005",
                                       "--rounds", "200"])
    log(f"  native_rt: {json.dumps(doc)}")
    if not 0 <= doc["detection_rounds"] <= 15:
        raise AssertionError(f"native_rt: {doc}")
    results["sockets"]["native_rt"] = doc


def socket_deploy(results: dict) -> None:
    """``--case outage_mild_udp_n24 --engine deploy --scale-n 8``: eight
    node processes (no torch in them) with gRPC control planes; the
    verdict agrees with the tensor replay of the scaled case on the
    invariants a deploy stream carries."""
    from gossipfs_tpu_torch.campaigns import __main__ as cli
    from gossipfs_tpu_torch.ops import merge

    path = repo_path("regressions", "outage_mild_udp_n24.json")
    merge.reset_launch_counts()
    t0 = time.perf_counter()
    rc, out = cli_json(cli.main, ["--case", str(path), "--engine", "deploy",
                                  "--scale-n", "8", "--period", "0.1"])
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in merge.LAUNCH_COUNTS.items() if v}
    log(f"  deploy --scale-n 8: exit {rc}, agreement {out['agreement']}, "
        f"verdicts tensor {out['tensor_verdict']} / deploy "
        f"{out['engine_verdict']}, {wall:.1f} s; launches {launches}")
    if not out["agreement"]["match"]:
        raise AssertionError(f"deploy lane: {out['agreement']}")
    results["sockets"]["deploy"] = dict(seconds=wall, launches=launches,
                                        verdict=out["engine_verdict"])


def phase_socket_engines(results: dict) -> None:
    results["sockets"] = {}
    t0 = time.perf_counter()
    socket_k2_shapes(results)
    for engine, case in SOCKET_CASES:
        socket_campaign(engine, case, results)
        socket_replay_vs_plain(engine, case, results)
    socket_conformance(results)
    socket_native_rt(results)
    socket_deploy(results)
    results["sockets"]["seconds"] = time.perf_counter() - t0


# ---------------------------------------------------------------------------
# The static analyzer and the parity soak on the card (phase 49):
# gossipfs-lint over the port with the shared-memory budget probe on the
# card, spec_verify, and the lean loop (K3) against the separate-pass loop
# (K4) at N = 16,384 in four variants.
# ---------------------------------------------------------------------------

PARITY_ROUNDS = 100     # rounds a soak variant (the full 300-round soak
                        # ran by itself: PERF.md section 6)
PARITY_VARIANTS = (("lanes", []), ("swar", ["--elementwise", "swar"]),
                   ("suspicion", ["--suspicion"]),
                   ("scenario", ["--scenario"]))


def analysis_lint(results: dict) -> None:
    """``python -m gossipfs_tpu_torch.analysis --probe`` (its main, in
    this process) on the card's tree: every AST rule clean and the budget
    probe's card half -- exit 0, no finding.  Then the probe's
    reconciliation from that run, kernel by kernel: the Python formula's
    bytes, the kernel's own info and ``cudaFuncGetAttributes``' opt-in
    maximum, and the edge-shape launches (each zeroed just before and
    read just after)."""
    from gossipfs_tpu_torch.analysis import REGISTRY, probes
    from gossipfs_tpu_torch.analysis.__main__ import main as lint_main

    t0 = time.perf_counter()
    probes.last_report.clear()
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lint_main(["--probe", "--json"])
    rep = dict(probes.last_report)
    if rc != 0 or json.loads(buf.getvalue()) != [] or not rep:
        raise AssertionError(f"gossipfs-lint --probe exited {rc}: "
                             f"{buf.getvalue()[-3000:]}")
    log(f"  python -m gossipfs_tpu_torch.analysis --probe: exit 0, "
        f"{len(REGISTRY)} rules clean in {time.perf_counter() - t0:.2f} s")
    for key, r in rep.items():
        attr = r.get("python_attr", r["python"])
        log(f"  {key}: Python {r['python']} B == info {r['info']} B; "
            f"opt-in attribute {r['attr']} B == {attr} B; "
            f"{r.get('launched', 0)} launch(es)")
    results["analysis"]["lint"] = dict(
        rc=rc, rules=len(REGISTRY),
        probe={k: [r["python"], r["info"], r["attr"], r.get("launched", 0)]
               for k, r in rep.items()},
        seconds=time.perf_counter() - t0)


def analysis_spec(results: dict) -> None:
    """``python -m gossipfs_tpu_torch.analysis.spec_verify``'s main: the
    tree clean, every spec rule red on its fixture."""
    from gossipfs_tpu_torch.analysis import spec_verify

    t0 = time.perf_counter()
    rc, doc = cli_json(spec_verify.main, [])
    if rc != 0 or not doc["ok"]:
        raise AssertionError(f"spec_verify: {doc}")
    results["analysis"]["spec_verify"] = dict(
        ok=doc["ok"], red=doc["fixtures_red"], total=doc["fixtures_total"],
        seconds=time.perf_counter() - t0)
    log(f"  spec_verify: ok, repo clean, {doc['fixtures_red']} of "
        f"{doc['fixtures_total']} spec rules red on their fixtures")


def analysis_soak(results: dict, rounds: int = PARITY_ROUNDS) -> None:
    """``python -m gossipfs_tpu_torch.parity_soak`` (its main) at N =
    16,384, 0.5 % crash churn, lanes, SWAR, --suspicion, --scenario: the
    lean loop's and the separate-pass loop's launch counts zeroed just
    before and read just after each; every lane, the carry and every
    metric bit-equal."""
    from gossipfs_tpu_torch import parity_soak

    out = results["analysis"]["soak"] = {}
    for name, flags in PARITY_VARIANTS:
        rc, doc = cli_json(parity_soak.main, [
            "--n", str(N_MAIN), "--rounds", str(rounds), *flags])
        lean = doc["lean_launches"].get("resident_round", 0)
        sep = doc["separate_launches"]
        want_sep = ({} if doc["scenario"]
                    else {"arc_merge_update": rounds})
        if rc != 0 or not doc["all_equal"] or lean != rounds \
                or sep != want_sep:
            raise AssertionError(f"parity soak {name}: {doc}")
        out[name] = {k: doc[k] for k in (
            "route", "separate_kernel", "lean_s", "separate_s",
            "total_detections", "lean_launches", "separate_launches")}
        for k in ("total_suspects", "total_refutations"):
            if k in doc:
                out[name][k] = doc[k]
        log(f"  soak {name}: {rounds} rounds, lean {doc['route']} "
            f"({lean} K3 launches, {doc['lean_s']:.3f} s) against "
            f"separate-pass {doc['separate_kernel']} ({sep}, "
            f"{doc['separate_s']:.3f} s): lanes, carry and metrics 0 "
            f"entries differ; {doc['total_detections']} detections")


def phase_analysis(results: dict) -> None:
    results["analysis"] = {}
    t0 = time.perf_counter()
    analysis_lint(results)
    analysis_spec(results)
    analysis_soak(results)
    results["analysis"]["seconds"] = time.perf_counter() - t0


def onepass_summary(results: dict) -> dict:
    """Phase 40 in one JSON object: each one-pass instantiation's ms beside
    the two-launch form's and its own before the redesign (timed on other
    inputs: ONEPASS_MS_BEFORE), its static SASS counts, its step timeline
    where timed, the column blocks of F/F', and the clusters the card
    holds at once."""
    out = {}
    for key, r in results["k3_onepass"].items():
        if key == "clusters":
            out["clusters"] = r
        elif key != "sass":
            row = {"ms": r["ms"], "two_launch_ms": r["two_launch_ms"],
                   "clusters": r["clusters"]}
            if r.get("before_ms") is not None:
                row["before_ms"] = r["before_ms"]
            if r.get("sass"):
                # static SASS: the kernel, step 1, step 2
                row["sass"] = [r["sass"].get(k) for k in
                               ("total", "step1", "step2")]
            if r.get("split"):
                row["us_a_stripe"] = r["split"]
            out[", ".join(key)] = row
    return out


def main_path_summary(results: dict) -> dict:
    """Every main path's ms a round, rounds/s and launch counts, by phase
    (``"<phase> off"``: the same path with ``rr_resident="off"``), for the
    one JSON line beside the kernels line."""
    rows = {"5": "main", "10": "config3", "11": "arc", "16": "sus_main",
            "17": "k5_main", "21": "main_c", "27": "main_d", "28": "main_d2",
            "32 E": "main_e", "32 E'": "main_e2", "37 F": "main_f",
            "37 F'": "main_f2", "38 G": "main_g",
            "38 B sharded": "main_b_sharded", "39 full_scale": "full_scale"}
    out = {}
    for phase, key in rows.items():
        r = results[key]
        out[phase] = {"round_ms": r["round_ms"],
                      "rounds_per_s": r["rounds_per_s"],
                      "launches": r["launch_counts"]}
        if "off" in r:
            # the same path with rr_resident="off" (K3's two-launch form)
            o = r["off"]
            out[phase + " off"] = {"round_ms": o["round_ms"],
                                   "rounds_per_s": o["rounds_per_s"],
                                   "launches": o["launch_counts"]}
    # the paths only K3's two-launch form runs (N past the one-pass form's
    # reach): capacity, the frontier (lanes, SWAR), the PackedDetector's
    # quiet advance at N = 49,152
    for phase, key in (("6", "capacity"), ("23", "advance")):
        r = results[key]
        out[phase] = {"round_ms": r["round_ms"],
                      "rounds_per_s": r["rounds_per_s"],
                      "launches": r["launch_counts"]}
    # config 4's fault model at N = 65,536 (the largest K2 a path launches),
    # with K2's device ms a round
    r = results["config4"]
    out["12"] = {"round_ms": r["round_ms"], "rounds_per_s": r["rounds_per_s"],
                 "launches": r["launch_counts"], "k2_ms": r["kernel_ms"]}
    for phase, ew in (("22", "lanes"), ("34", "swar")):
        d = results["frontier_" + ew]
        out[phase] = {"round_ms": d["seconds_per_round"] * 1e3,
                      "rounds_per_s": d["rounds_per_sec"],
                      "launches": d["launches"]}
    p = results["partition"]
    out["29"] = {"round_ms": p["seconds"] / p["rounds"] * 1e3,
                 "rounds_per_s": p["rounds"] / p["seconds"],
                 "launches": {"fused_merge_update": p["rounds"]}}
    # the obs plane (phase 43): bench --trace --monitor (CUDA events, with
    # and without the flags), each curve row's decode, the detector's
    # recorder, the campaign run at N = 16,384
    obs = results["obs"]
    out["43 bench"] = obs["bench"]
    out["43 curves"] = obs["curves"]
    out["43 detector"] = obs["detector"]
    out["43 campaign"] = obs["campaign"]
    # the runners (phase 44): each part's seconds and launches, the
    # (t_fail, t_suspect) surface's suspect-form round and K2's ms in it,
    # each scenario's rounds/s (CUDA events)
    run = results["runners"]
    out["44"] = {"seconds": run["seconds"],
                 "k2_suspect_ms": results["k2_sus_surface"]["ms"],
                 "k2_suspect_bound_ms":
                     results["k2_sus_surface"]["bound_ms"]}
    for part in ("conformance", "t_fail", "suspicion", "scenarios",
                 "entry"):
        out["44 " + part] = run[part]
    # the SDFS plane (phase 45): config 5's detector and co-sim rounds/s
    # and launches, the scale lane's planner ms, the n = 64 lanes' and the
    # traffic case's launches, the codec's ms
    sd = results["sdfs"]
    c5 = sd["config5"]
    out["45 config5"] = {
        "n": c5["n"], "rounds_per_s": c5["rounds_per_s"],
        "cosim_rounds_per_s": c5["cosim_rounds_per_s"],
        "launches": c5["launches"], "cosim_launches": c5["cosim_launches"],
        "cosim": c5["cosim"], "peak_gib": c5["peak_gib"],
        "n4096": c5["n4096"]}
    out["45 scale"] = sd["scale"]
    # the lanes' launches and seconds, and each op's p50 / p95 ms of the
    # steady window (every window's are in the phase's log lines)
    out["45 lanes"] = {
        label: {"launches": r["launches"], "seconds": r["seconds"],
                "cpu_seconds": r["cpu_seconds"],
                "steady_p50_p95_ms": r["latency"]["steady"]["window"]}
        for label, r in sd["lanes"].items() if label != "phase_s"}
    for part in ("campaign", "codec"):
        out["45 " + part] = sd[part]
    out["45"] = {"seconds": sd["seconds"]}
    # the shim and the CLI (phase 46): the wire's Advance(1) and Lsm ms
    # against the in-process round, the CLI --packed advance, the card
    # against CPU scripts' launches, wire_ops' rows and repair
    sh = results["shim"]
    full, cli = sh["full"], sh["cli_packed"]
    out["shim"] = {
        "n": full["n"], "advance_ms": full["advance_ms"],
        "detector_advance_ms": full["detector_advance_ms"],
        "tick_ms": full["tick_ms"], "lsm_ms": full["lsm_ms"],
        "rounds": full["rounds"], "launches": full["launches"],
        "peak_gib": full["peak_gib"],
        "bulk_as_of_rounds": full["bulk_as_of_rounds"],
        "cli_packed": {k: cli[k] for k in ("n", "advance_ms", "rounds",
                                          "launches", "peak_gib")},
        "card_vs_cpu": {k: v["launches"] for k, v in
                        sh["card_vs_cpu"].items() if k != "phase_s"},
        "wire_ops": {"rows": sh["wire_ops"]["rows"],
                     "healed": sh["wire_ops"]["repair"]["healed"],
                     "bytes_identical_after_repair":
                         sh["wire_ops"]["repair"][
                             "bytes_identical_after_repair"]},
        "seconds": sh["seconds"]}
    # the bench and utils tail (phase 47): config 5 over 2 ranks beside
    # its one-process run, roundprof's rows (ms a round; a lean row's
    # two-launch twin beside), the soak cut's seconds, the profiler's top
    # rows and its two rates
    c5 = results["c5_ranks"]
    out["47 config5 ranks"] = {
        k: c5[k] for k in ("n", "rounds_per_s", "cosim_rounds_per_s",
                           "one_rounds_per_s", "one_cosim_rounds_per_s",
                           "peak_gib", "launches", "cosim_launches")}
    out["47 roundprof"] = {
        name: ([r["ms_per_round"], r["two_launch"]["ms_per_round"]]
               if "two_launch" in r else r["ms_per_round"])
        for name, r in results["roundprof"]["rows"].items()}
    out["47 soak"] = {"seconds": results["soak"]["seconds"],
                      "launches": results["soak"]["launches"]}
    out["47 profiler"] = results["profiler"]
    out["47"] = {"seconds": results["p47"]["seconds"]}
    # the socket engines (phase 48): each part's document (launches,
    # periods, the native tick histogram, wire bytes, the replay's ms a
    # round on the kernels and plain)
    so = results["sockets"]
    for part in ("native", "udp", "conformance", "native_rt", "deploy"):
        out["48 " + part] = so[part]
    out["48"] = {"seconds": so["seconds"]}
    # the analyzer and the parity soak (phase 49): its whole document
    out["49 analysis"] = results["analysis"]
    return out


def sdfs_kernel_rows(results: dict, src: str, mp: str) -> list:
    """Phase 45's K2 rows: the co-sim lane's N = 64 (its launches: the
    replica lane's and the erasure matrix's rounds on the card), the
    traffic case's N = 256, config 5's square N = 65,536 (phase 12's
    shape and dtypes, timed in phase 36, with config 5's launches) and
    its [65,536 x 16,384] column block (no path of this script runs the
    block: a sharded config 5 would)."""
    sd = results["sdfs"]
    k2 = src + "fused_merge.cu"
    lanes = sum(sd["lanes"][p]["launches"].get("fused_merge_update", 0)
                for p in ("cosim", "erasure"))
    c5 = sd["config5"]
    c5_launches = (c5["launches"]["fused_merge_update"]
                   + c5["cosim_launches"]["fused_merge_update"])
    return [
        shard_line("fused_merge_update[co-sim n = 64]", k2, mp + "387",
                   lanes, results["k2_cosim_n64"]),
        shard_line("fused_merge_update[traffic case n = 256]", k2,
                   mp + "387",
                   sd["campaign"]["launches"].get("fused_merge_update", 0),
                   results["k2_cosim_n256"]),
        shard_line("fused_merge_update[config 5]", k2, mp + "387",
                   c5_launches, results["k2_config4_fault"]),
        shard_line("fused_merge_update[config 5 column block]", k2,
                   mp + "387", 0, results["k2_config5_block"]),
    ]


def shim_kernel_rows(results: dict, src: str, mp: str) -> list:
    """Phase 46's rows: K2 at the shim's N = 16,384 (its launches: the
    service's rounds through the wire), at the card-against-CPU scripts'
    N = 1,024 and at wire_ops' ring N = 16; K3's two-launch explicit-edge
    form at the CLI --packed's N = 49,152 (phase 41's measurement, the
    CLI's launches)."""
    sh = results["shim"]
    k2 = src + "fused_merge.cu"
    small = sum(sh["card_vs_cpu"][e]["launches"].get("fused_merge_update",
                                                     0)
                for e in ("local", "rpc"))
    return [
        shard_line("fused_merge_update[shim n = 16,384]", k2, mp + "387",
                   sh["full"]["launches"]["fused_merge_update"],
                   results["k2_shim"]),
        shard_line("fused_merge_update[shim n = 1,024]", k2, mp + "387",
                   small, results["k2_shim_n1024"]),
        shard_line("fused_merge_update[wire_ops n = 16]", k2, mp + "387",
                   sh["wire_ops"]["launches"]["fused_merge_update"],
                   results["k2_wire_ops_n16"]),
        shard_line(f"resident_round[two-launch {N_ADVANCE} x {N_ADVANCE}: "
                   "edges, crash-only, CLI --packed]",
                   src + "resident_round.cu", mp + "2611",
                   sh["cli_packed"]["launches"]["resident_round"],
                   results["k3_large"][("edges", "crash-only", N_ADVANCE,
                                        N_ADVANCE)]),
    ]


# main-path entries printed on the details line before the kernels line
# (each path's "off" twin, phases 43-46's per-part documents)
DETAIL_KEYS = ("43 curves", "44 conformance", "44 t_fail", "44 suspicion",
               "44 scenarios", "44 entry", "45 scale", "45 lanes",
               "45 campaign", "45 codec", "47 roundprof", "48 native",
               "48 udp", "48 conformance", "48 native_rt", "48 deploy",
               "49 analysis")


def split_details(out: dict) -> tuple[dict, dict]:
    """The main-paths summary split in two: (the paths' rates and
    launches, the details).  The shim's and each "off" twin's documents
    go to the details, a short form of the shim's stays."""
    details = {k: v for k, v in out.items()
               if k in DETAIL_KEYS or k.endswith(" off") or k == "shim"}
    paths = {k: v for k, v in out.items() if k not in details}
    sh = out["shim"]
    paths["shim"] = {k: sh[k] for k in ("n", "advance_ms", "rounds",
                                        "launches", "seconds")}
    return paths, details


def compact_json(doc) -> str:
    """One JSON line with no spaces and floats to 5 significant digits."""
    def fix(x):
        if isinstance(x, float):
            return float(f"{x:.5g}")
        if isinstance(x, dict):
            return {k: fix(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [fix(v) for v in x]
        return x

    return json.dumps(fix(doc), separators=(",", ":"))


def tail_kernel_rows(results: dict, src: str, mp: str) -> list:
    """Phase 47's rows: K2 over config 5's [16,384 x 8,192] rank block
    (rank 0's launches: its detector's and its co-sim's), at the soak's
    N = 4,096 and roundprof's N = 16,384, K4 at roundprof's arc rows (the
    launches of the rows the route sends to each)."""
    c5 = results["c5_ranks"]
    rows = results["roundprof"]["rows"].values()

    def rp(kernel: str) -> int:
        return sum(r["launches"].get(kernel, 0) for r in rows)

    k2 = src + "fused_merge.cu"
    return [
        shard_line("fused_merge_update[config 5 over 2 ranks]", k2,
                   mp + "387", c5["launches"]["fused_merge_update"]
                   + c5["cosim_launches"]["fused_merge_update"],
                   results["k2_c5_ranks"]),
        shard_line("fused_merge_update[soak]", k2, mp + "387",
                   results["soak"]["launches"]["fused_merge_update"],
                   results["k2_soak"]),
        shard_line("fused_merge_update[roundprof]", k2, mp + "387",
                   rp("fused_merge_update"), results["k2_roundprof"]),
        shard_line("arc_merge_update[roundprof]", src + "arc_merge.cu",
                   mp + "1248", rp("arc_merge_update"),
                   results["k4_roundprof"]),
    ]


def socket_kernel_rows(results: dict, src: str, mp: str) -> list:
    """Phase 48's K2 rows: the campaign replays' n = 256 (the native
    case's launches) and n = 24 (the udp case's), and N = 8 (the
    conformance column's launches and the deploy lane's scaled replay)."""
    so = results["sockets"]
    k2 = src + "fused_merge.cu"

    def k2_launches(*parts: str) -> int:
        return sum(so[p]["launches"].get("fused_merge_update", 0)
                   for p in parts)

    return [
        shard_line("fused_merge_update[campaign n=256]", k2, mp + "387",
                   k2_launches("native"), results["k2_campaign_n256"]),
        shard_line("fused_merge_update[campaign n=24]", k2, mp + "387",
                   k2_launches("udp"), results["k2_campaign_n24"]),
        shard_line("fused_merge_update[n=8: conformance, deploy]", k2,
                   mp + "387", k2_launches("conformance", "deploy"),
                   results["k2_conformance_n8"]),
    ]


def kernel_line(name: str, source: str, replaces: str, launches: int,
                r: dict) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None}


def shard_line(name: str, source: str, replaces: str, launches: int,
               r: dict) -> dict:
    """A column-shard row of the kernels line, with its [N, C] shape."""
    return dict(kernel_line(name, source, replaces, launches, r),
                shape=r["shape"])


def main() -> int:
    import faulthandler

    import torch

    # a fault in native code (the kernels, the C++ engine, a library)
    # prints every thread's Python stack instead of dying silently
    faulthandler.enable(all_threads=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from gossipfs_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[1] device {name}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  nvidia-smi: {smi}")
    t0 = time.perf_counter()
    # the native C++ engine (phase 48) compiles with g++ beside the nvcc
    # builds; a failed build raises here
    import concurrent.futures

    from gossipfs_tpu_torch import native

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.load_library)
        _build.build(verbose=True)
        host.result()
    log(f"[2] built {sorted(_build.SIGNATURES)} and the native engine "
        f"({native._LIB_PATH.name}) in {time.perf_counter() - t0:.2f} s")
    for kernel, text in _build.build_logs.items():
        for line in text.strip().splitlines():
            log(f"  {kernel}: {line}")
    results: dict = {}
    log(f"[3] resident_round kernel vs plain, one round, N={N_MAIN}")
    phase_kernel_vs_plain(N_MAIN, results)
    scan = scan_rounds()
    log(f"[4] run_rounds kernel vs plain, {scan} rounds, N={N_MAIN}")
    phase_scan_vs_plain(scan)
    log(f"[5] main path: headline, N={N_MAIN}, 100 rounds")
    phase_main_path(results)
    log(f"[6] K3 capacity: N={N_CAPACITY}, 10 rounds")
    phase_capacity(10, results)
    log("[7] K2 fused_merge_update vs plain, three shapes")
    phase_k2(results)
    log(f"[8] K4 arc_merge_update vs plain, N={N_MAIN}")
    phase_k4(results)
    log(f"[9] separate-pass run_rounds, kernels vs plain, {scan} "
        "rounds")
    phase_general_scan_vs_plain(scan)
    phase_flagship_step_vs_plain(scan)
    log("[10] main path: config 3 sim-10k-crash, N=10240, 120 rounds")
    phase_config3_main(results)
    log(f"[11] eventful arc path: headline N={N_MAIN}, 1% crash, 1% rejoin, "
        f"{EVENTFUL_ROUNDS} rounds")
    phase_eventful_arc(results, EVENTFUL_ROUNDS)
    log(f"[12] capacity, config 4 fault model: N={N_CAPACITY}, 10 rounds")
    phase_config4_capacity(10, results)
    log(f"[13] K3 suspicion + Lifeguard form vs plain, one round, "
        f"N={N_MAIN}")
    phase_k3_suspicion(N_MAIN, results)
    log("[14] suspect forms of K2 and K4, and K5 stripe_merge_update, vs "
        "plain")
    phase_suspect_merges(results)
    log(f"[15] suspicion run_rounds, kernels vs plain, {scan} rounds")
    phase_suspicion_scans(scan)
    log(f"[16] main path A: bench --suspicion headline, N={N_MAIN}, 100 "
        "rounds")
    phase_suspicion_main(results)
    log(f"[17] main path B: suspicion_rr, N={N_MAIN}, 1% crash, 1% rejoin, "
        f"{EVENTFUL_ROUNDS} rounds")
    phase_suspicion_rr_main(results, EVENTFUL_ROUNDS)
    log(f"[18] K1 fanout_max_merge vs plain, N={N_MAIN} and ragged")
    phase_k1(results)
    log(f"[19] K3 explicit-edge and plain-arc forms vs plain, one round, "
        f"N={N_MAIN}")
    phase_k3_forms(N_MAIN, results)
    log(f"[20] lean run_rounds, kernel vs plain, {scan} rounds: "
        "packed_rr, "
        "suspicion_rr (lh off, on), plain arcs, headline(arc_align=4)")
    phase_lean_scans(scan, results)
    log(f"[21] main path C: packed_rr, N={N_MAIN}, 1% crash, 8 tracked "
        "crashes, 100 rounds")
    phase_packed_main(results)
    log(f"[22] capacity frontier: python -m gossipfs_tpu_torch.frontier "
        f"(N={N_CAPACITY}, 20 rounds)")
    phase_frontier(results)
    log("[23] PackedDetector: N=49152 session, N=16384 against run_rounds")
    phase_packed_detector(N_ADVANCE, results)
    log("[24] SimDetector: config 3, advance_bulk with and without "
        "snapshots, interactive")
    phase_sim_detector()
    log(f"[25] K3 edge_filter form vs plain, one round, N={N_MAIN}, align 8 "
        "and 4")
    phase_k3_edge_filter(N_MAIN, results)
    log("[26] lean run_rounds under a scenario, kernel vs plain, 20 rounds: "
        "suspicion headline, suspicion_rr, headline(arc_align=4)")
    phase_scenario_scans(20, results)
    log(f"[27] main path D: suspicion headline under split + flap + outage, "
        f"N={N_MAIN}, 100 rounds")
    phase_scenario_main(results)
    log(f"[28] main path D': suspicion_rr under split + loss + slow, "
        f"N={N_MAIN}, 100 rounds")
    phase_scenario_rr_main(results)
    log(f"[29] curves --partition, N={N_MAIN}, through "
        "SimDetector.load_scenario")
    phase_partition_sweep(results)
    log(f"[30] K3 SWAR form vs SWAR plain and vs the lanes kernel, one "
        f"round, N={N_MAIN}, 5 forms x 3 modes")
    phase_k3_swar(N_MAIN, results)
    log(f"[31] lean run_rounds with elementwise='swar', {scan} "
        "rounds: SWAR "
        "kernel vs SWAR plain vs lanes kernel")
    phase_swar_scans(scan, results)
    log(f"[32] main paths E and E': headline and suspicion headline with "
        f"elementwise='swar', N={N_MAIN}, 100 rounds")
    phase_swar_main(results)
    log(f"[33] separate-pass round with elementwise='swar': eventful "
        f"headline N={N_MAIN}, 1% crash, 1% rejoin, {scan} rounds")
    phase_swar_separate(results, scan)
    log(f"[34] capacity frontier, SWAR form: python -m "
        f"gossipfs_tpu_torch.frontier --elementwise swar (N={N_CAPACITY}, "
        "20 rounds)")
    phase_frontier(results, "swar")
    log(f"[35] K3 column-shard form vs the square launch and plain: 30 "
        f"instantiations over 4 shards [{N_MAIN} x {N_SHARD_TALL}], config "
        f"4's layout [{N_CONFIG4} x {N_CONFIG4 // 8}]")
    phase_k3_column_shard(results)
    log("[36] K2, K4, K5 over column blocks vs plain")
    phase_merge_column_blocks(results)
    log(f"[37] main paths F and F': the headline sharded over 2 rank "
        f"processes, N={N_MAIN}, 100 rounds, lanes and SWAR")
    phase_sharded_headline(results)
    log("[38] main path G: config 4's fault model at N=32768 over 2 rank "
        "processes, 10 rounds; main path B sharded")
    phase_sharded_config4(results)
    log("[39] python -m gossipfs_tpu_torch.full_scale --n 65536 --rounds 16 "
        "--devices 8")
    phase_full_scale(results)
    log(f"[40] K3 one-pass form (f) vs plain and vs the two-launch form: 30 "
        f"instantiations, N={N_MAIN}, square and the 2 shards "
        f"[{N_MAIN} x {N_MAIN // 2}]")
    phase_k3_onepass(results)
    log(f"[41] K3 two-launch form at the N only it runs: N={N_CAPACITY} "
        f"(aligned, edges; lanes, SWAR; crash-only, suspicion), "
        f"N={N_ADVANCE} (edges), [{N_CAPACITY} x {N_CAPACITY // 8}]")
    phase_k3_two_launch_large(results)
    print(json.dumps({"onepass": onepass_summary(results)}))
    log("[42] K2, K1, K4 and K5 at every timed shape: stripe, ring, "
        "items, cluster, blocks held, registers, spills")
    phase_merge_geometry(results)
    log(f"[43] the obs plane: bench --trace --monitor (N={N_MAIN}), "
        "curves.sweep with trace and monitor, the SimDetector recorder on "
        "config 3, the campaign replay")
    t0 = time.perf_counter()
    phase_obs_plane(results)
    log(f"  phase 43 in {time.perf_counter() - t0:.2f} s")
    log(f"[44] the conformance, curve and scenario runners: K2 at their "
        f"shapes, the conformance matrix (reference, tensor), "
        f"curves.sweep_t_fail and suspicion_sweep (N={N_MAIN}), "
        "python -m gossipfs_tpu_torch.run (parity-10, sim-1k, "
        "sim-10k-crash, sim-100k --n 32768), entry()")
    phase_runners(results)
    log(f"  phase 44 in {results['runners']['seconds']:.2f} s")
    log(f"[45] the SDFS plane: K2 at its shapes, config 5 sim-100k-sdfs "
        f"(N={N_CONFIG5}, 1,000 files, {C5_ROUNDS} rounds; N=4096 kernel vs "
        "plain), "
        "the planner's scale lane (N=100000), the co-sim lane and the "
        "erasure matrix (n=64), the traffic case, the codec")
    phase_sdfs(results)
    log(f"  phase 45 in {results['sdfs']['seconds']:.2f} s")
    log(f"[46] the shim and the CLI: the gRPC service at N={N_MAIN} "
        f"(random, fanout {SHIM_FANOUT}) through ShimClient, the CLI "
        f"--packed --n {N_ADVANCE}, card against CPU at N={N_SHIM_SMALL} "
        "(local and rpc election, --packed), K2 at its shapes, wire_ops")
    phase_shim(results)
    log(f"  phase 46 in {results['shim']['seconds']:.2f} s")
    log(f"[47] the bench and utils tail: K2 and K4 at their shapes, config 5 "
        f"over 2 rank processes (N={N_MAIN}), roundprof (N={N_MAIN}, "
        f"{RP_ROUNDS} rounds a row), the soak cut (N={N_SOAK}, "
        f"{SOAK_CHUNKS} x {SOAK_ROUNDS} rounds), checkpoint/resume, the "
        "profiler seam")
    phase_bench_tail(results)
    log(f"  phase 47 in {results['p47']['seconds']:.2f} s")
    log("[48] the socket engines: K2 at their shapes, python -m "
        "gossipfs_tpu_torch.campaigns --case outage_storm_n256 --engine "
        "native and --case outage_mild_udp_n24 --engine udp (the tensor "
        "replay on the card), python -m gossipfs_tpu_torch.conformance "
        f"over {list(ENGINES4)} for {len(SOCKET_FAMILIES)} schedules, "
        "native_rt, the deploy lane (--scale-n 8)")
    phase_socket_engines(results)
    log(f"  phase 48 in {results['sockets']['seconds']:.2f} s")
    log("[49] the static analyzer and the parity soak: python -m "
        "gossipfs_tpu_torch.analysis --probe (the budget probe on the "
        "card), the probe's per-kernel bytes, spec_verify, python -m "
        f"gossipfs_tpu_torch.parity_soak at N={N_MAIN} ({PARITY_ROUNDS} "
        f"rounds: {', '.join(n for n, _ in PARITY_VARIANTS)})")
    phase_analysis(results)
    log(f"  phase 49 in {results['analysis']['seconds']:.2f} s")
    src = "gossipfs_tpu_torch/csrc/"
    mp = "gossipfs_tpu/ops/merge_pallas.py:"
    swar = results["k3_swar"]
    # the two-launch form's launches: main paths' rr_resident="off" runs
    # and the scans' two-launch runs (phases 20, 26, 31)
    swar_launches = {f: results["swar_scan_launches"][f + "/swar"]
                     for f in SWAR_ROW_MODE}
    swar_launches["aligned_group"] = results["main_e"]["off"]["launches"]
    shard = results["k3_shard"]
    onepass = results["k3_onepass"]
    scans = dict(results["scan_launches"], **results["swar_scan_launches"])
    path_launches = {
        ("aligned_group", "crash-only"): results["main"]["launches"],
        ("aligned_group", "suspicion"): results["sus_main"]["launches"],
        ("edges", "crash-only"): results["main_c"]["launches"],
        ("edges", "suspicion"): results["main_d2"]["launches"],
        ("filter_group", "suspicion"): results["main_d"]["launches"],
        ("aligned_group/swar", "crash-only"): results["main_e"]["launches"],
        ("aligned_group/swar", "suspicion"): results["main_e2"]["launches"],
    }
    onepass_rows = [
        # K3 (f) in the mode of each path that launches it (the main paths'
        # launches, else the 20-round scans' of phases 20, 26 and 31), then
        # over main paths F and F''s [16,384 x 8,192] blocks
        kernel_line(f"resident_round[one-pass: {form}, {mode}]",
                    src + "rr_onepass.cu", mp + "2611",
                    path_launches.get((form, mode)) or scans[form + ONEPASS],
                    onepass[(form, mode)])
        for form, mode in ONEPASS_ROWS] + [
        shard_line(f"resident_round[one-pass column block: {form}, "
                   "crash-only]", src + "rr_onepass.cu", mp + "2611",
                   results[key]["launches"],
                   onepass[(form, "crash-only", "block")])
        for form, key in (("aligned_group", "main_f"),
                          ("aligned_group/swar", "main_f2"))]
    shard_rows = [
        # each column-shard row at the shape of the main path that
        # launches it, with that path's launches a rank: K3 (g) at the
        # [16,384 x 8,192] of main paths F and F' (phase 35), K2 at G's
        # [32,768 x 16,384], K4 at full_scale's [65,536 x 8,192], K5 at B
        # sharded's [16,384 x 8,192] (phase 36)
        shard_line("resident_round[column shard: aligned_group, "
                   "crash-only]", src + "resident_round.cu", mp + "2611",
                   results["main_f"]["off"]["launches"],
                   shard[("aligned_group", "crash-only", "main")]),
        shard_line("resident_round[column shard: aligned_group/swar, "
                   "crash-only]", src + "resident_round.cu", mp + "2611",
                   results["main_f2"]["off"]["launches"],
                   shard[("aligned_group/swar", "crash-only", "main")]),
        shard_line("fused_merge_update[column block]",
                   src + "fused_merge.cu", mp + "387",
                   results["main_g"]["launches"], results["k2_block"]),
        shard_line("arc_merge_update[column block]", src + "arc_merge.cu",
                   mp + "1248", results["full_scale"]["launches"],
                   results["k4_block"]),
        shard_line("stripe_merge_update[column block]",
                   src + "stripe_merge.cu", mp + "998",
                   results["main_b_sharded"]["launches"],
                   results["k5_block"]),
        # K5 at the largest N the route sends it (packed_rr(28_416)): no
        # main path of this script runs that N
        shard_line("stripe_merge_update[N = 28,416]",
                   src + "stripe_merge.cu", mp + "998", 0,
                   results["k5_max_n"]),
        # config 4's own shard [131,072 x 16,384]: no main path of this
        # script runs it, so it launched no time there
        shard_line("fused_merge_update[column block, config 4 shard]",
                   src + "fused_merge.cu", mp + "387", 0,
                   results["k2_block_config4"]),
        # phase 12's square N = 65,536 (config 4's fault model), with
        # phase 12's launches
        shard_line("fused_merge_update[config 4 fault model]",
                   src + "fused_merge.cu", mp + "387",
                   results["config4"]["launch_counts"]["fused_merge_update"],
                   results["k2_config4_fault"]),
    ]
    large = results["k3_large"]
    large_launches = {
        # the launches of the main path that runs each shape and form
        ("aligned_group", "crash-only", N_CAPACITY, N_CAPACITY):
            results["capacity"]["launches"],
        ("edges", "crash-only", N_CAPACITY, N_CAPACITY):
            results["frontier_lanes"]["launches"]["edges"],
        ("edges/swar", "crash-only", N_CAPACITY, N_CAPACITY):
            results["frontier_swar"]["launches"]["edges/swar"],
        ("edges", "crash-only", N_ADVANCE, N_ADVANCE):
            results["advance"]["launches"],
    }
    large_rows = [
        # K3's two-launch form at the N only it runs (phase 41), with the
        # launches of the path that runs each (0: none of this script's
        # paths runs that form at that shape)
        shard_line(f"resident_round[two-launch {n} x {c}: {form}, {mode}]",
                   src + "resident_round.cu", mp + "2611",
                   large_launches.get((form, mode, n, c), 0), r)
        for (form, mode, n, c), r in large.items()]
    swar_rows = onepass_rows + shard_rows + large_rows + [
        # each SWAR form in the mode of the path that launches it: the
        # aligned form main path E's rr_resident="off" run (E' adds 100
        # suspicion ones), the others phase 31's 20-round two-launch scans
        kernel_line(f"resident_round[{form}/swar, {SWAR_ROW_MODE[form]}]",
                    src + "resident_round.cu", mp + "2611",
                    swar_launches[form], swar[(form, SWAR_ROW_MODE[form])])
        for form in SWAR_ROW_MODE]
    # the paths' detail first; the kernels line, the main paths, the card
    # and the device line last, within the last 24,000 bytes of output
    paths, details = split_details(main_path_summary(results))
    print(compact_json({"phase_details": details}))
    print(compact_json({"kernels": swar_rows + [
        # K3's two-launch form, each merge form with the launches of the
        # rr_resident="off" run of the main path that runs it (phases 16,
        # 5, 21, 27); the plain-arc and filter_rows forms are on no main
        # path: theirs are the 20-round two-launch scans' of phases 20 and
        # 26 (headline(arc_align=4))
        kernel_line("resident_round", src + "resident_round.cu", mp + "2611",
                    results["sus_main"]["off"]["launches"],
                    results["k3_sus"]),
        kernel_line("resident_round[aligned_group, crash-only]",
                    src + "resident_round.cu", mp + "2611",
                    results["main"]["off"]["launches"], results["kernel"]),
        kernel_line("resident_round[edges]", src + "resident_round.cu",
                    mp + "2611", results["main_c"]["off"]["launches"],
                    results["k3_edges"]),
        kernel_line("resident_round[arc]", src + "resident_round.cu",
                    mp + "2611", results["scan_launches"]["arc"],
                    results["k3_arc"]),
        kernel_line("resident_round[edge_filter: filter_group]",
                    src + "resident_round.cu", mp + "2611",
                    results["main_d"]["off"]["launches"],
                    results["k3_filter_sus"]),
        kernel_line("resident_round[edge_filter: filter_rows]",
                    src + "resident_round.cu", mp + "2611",
                    results["scan_launches"]["filter_rows"],
                    results["k3_filter_rows_sus"]),
        kernel_line("fused_merge_update", src + "fused_merge.cu", mp + "387",
                    results["config3"]["launches"], results["k2"]),
        kernel_line("arc_merge_update", src + "arc_merge.cu", mp + "1248",
                    results["arc"]["launches"], results["k4"]),
        kernel_line("stripe_merge_update", src + "stripe_merge.cu",
                    mp + "998", results["k5_main"]["launches"],
                    results["k5"]),
        # only tests call K1 (in both packages): its gather runs on the
        # main path inside K3's explicit-edge form, so main path C's run
        # launches it no time
        kernel_line("fanout_max_merge", src + "fanout_max.cu", mp + "146",
                    results["main_c"]["fanout_max_launches"], results["k1"]),
    ] + sdfs_kernel_rows(results, src, mp) + shim_kernel_rows(
        results, src, mp) + tail_kernel_rows(results, src, mp)
        + socket_kernel_rows(results, src, mp)}))
    # after the kernels line, so that it ends within the last 24,000 bytes
    print(compact_json({"main_paths": paths}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
