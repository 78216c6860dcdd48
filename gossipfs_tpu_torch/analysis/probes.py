"""The shared-memory budget probe: each Python budget formula of ``ops/``
against the kernel allocation it budgets.

The port's twin of the JAX package's ``rr-scratch-budget`` probe, which
reconciled ``rr_align_scratch_bytes`` with the scratch the Pallas kernel
really allocated.  Here the route decides from Python formulas whether a
kernel takes a shape (``ops/merge.onepass_fits`` for K3's one-pass form,
``ops/merge_update.stripe_admits`` for K5, the ring and tile sizes of K2,
K1 and K4), while the launchers ask the card for the bytes the budget
functions of the ``csrc/*.cuh`` headers compute.  The pairs:

* ``merge.onepass_smem`` / ``ONEPASS_SMEM`` against
  ``onepass::smem_bytes`` / ``mstripe::kSmemLimit``, in both blockings
  (``Cluster8x32`` and ``Cluster16x16``);
* ``merge_update.stripe_smem`` / ``stripe_row_bytes`` and
  ``STRIPE_MAX_N`` against ``mstripe::smem_bytes`` / ``stripe_row_bytes``;
* ``merge_update.arc_tile_smem`` against ``mstripe::tile_smem_bytes``;
* ``merge_update.ring_smem`` / ``RING_SMEM_MAX`` / ``MAX_KERNEL_FANOUT``
  against ``gring::ring_bytes`` / ``max_smem_bytes`` / ``kMaxStagedFanout``.

Everywhere (``device="cpu"`` included), g++ compiles the headers into a
small harness (their budget functions are host code too) and each pair
must agree over a grid of N, F and forms, inside the acceptance envelope
(``onepass_blocking`` gives the narrow blocking at N = 16,384 and
19,264, the wide one at 19,328, 65,536 and up to 115,712 in the
full-view forms and 109,056 in the aligned ones, and refuses the next N;
``stripe_admits`` takes ``STRIPE_MAX_N`` and refuses the next N, which
K5's park still holds).  On the card (``device="cuda"``) the built
kernels' own reports must say the same: the ``*_info`` entry points'
bytes and ``cudaFuncGetAttributes``' opt-in maximum after the launcher
raised it, and a launch at each edge shape must succeed and be counted.
Nothing falls back to a plain version there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

from gossipfs_tpu_torch.analysis.framework import (
    REPO_ROOT,
    Finding,
    RepoIndex,
    rule,
)

_PKG = "gossipfs_tpu_torch"
_MERGE = f"{_PKG}/ops/merge.py"
_MU = f"{_PKG}/ops/merge_update.py"
CSRC = REPO_ROOT / _PKG / "csrc"
BUILD = REPO_ROOT / _PKG / "_build" / "probe"

# the Python formula terms the fixture may drop (each names a term of one
# formula; dropping it is the drift the probe exists to catch)
DROP_TERMS = ("onepass_stack", "stripe_count_blocks", "ring_depth")

HARNESS = r"""
#include <cstdint>
#include "gather_ring.cuh"

extern "C" {
long op_smem(long n, int form, int wide) {
  const bool full = onepass::full_view(form);
  return wide ? onepass::smem_bytes<onepass::Cluster16x16>(n, full)
              : onepass::smem_bytes<onepass::Cluster8x32>(n, full);
}
long ms_limit() { return mstripe::kSmemLimit; }
long ms_cta_rows(long n) { return mstripe::cta_rows(n); }
long ms_row_bytes(long n) { return mstripe::stripe_row_bytes(n); }
long ms_smem(long n) {
  return mstripe::smem_bytes(mstripe::cta_rows(n),
                             mstripe::stripe_row_bytes(n));
}
long ms_tile_smem(long f) { return mstripe::tile_smem_bytes(f); }
int ms_tile_fits(long f) { return mstripe::tile_fits(f); }
long gr_ring_bytes(int f) { return gring::ring_bytes(gring::plan(f).chunk); }
long gr_max_smem() { return gring::max_smem_bytes(); }
long gr_max_staged_fanout() { return gring::kMaxStagedFanout; }
}
"""
_L, _I = ctypes.c_long, ctypes.c_int
# the harness's exports: name -> (restype, argtypes)
_FUNCS = {"op_smem": (_L, [_L, _I, _I]), "ms_limit": (_L, []),
          "ms_cta_rows": (_L, [_L]), "ms_row_bytes": (_L, [_L]),
          "ms_smem": (_L, [_L]), "ms_tile_smem": (_L, [_L]),
          "ms_tile_fits": (_I, [_L]), "gr_ring_bytes": (_L, [_I]),
          "gr_max_smem": (_L, []), "gr_max_staged_fanout": (_L, [])}

# the card half's report of the last reconcile() on the card, kernel by
# kernel (what chip_smoke.py phase 49 prints after the CLI's run)
last_report: dict = {}

# the grids the formulas are held equal over
ONEPASS_NS = (64, 1_024, 8_192, 16_384, 19_264, 19_328, 32_768, 65_536,
              98_304, 104_448, 109_056, 109_184, 115_712, 115_840)
# K3 (f)'s acceptance envelope: (N, the blocking onepass_blocking gives the
# square round in every form), and each wide-blocking form's last N
ONEPASS_EDGES = ((16_384, "8x32"), (19_264, "8x32"), (19_328, "16x16"),
                 (65_536, "16x16"), (104_448, "16x16"), (131_072, None))
ONEPASS_WIDE_LAST = {"full": 115_712, "aligned": 109_056}
STRIPE_NS = (256, 4_096, 16_384, 28_416, 28_420, 65_536, 113_600, 113_664)
TILE_FANOUTS = (1, 2, 16, 128, 1_024, 1_305, 1_306, 2_048)
RING_FANOUTS = tuple(range(1, 25)) + (31, 64, 100, 255, 511, 512)


def _harness() -> ctypes.CDLL:
    """The headers' budget functions, built by g++ into ``_build/probe``
    (keyed by a hash of the headers; built once, atomically)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found: the smem-budget probe "
                                "compiles the csrc headers' budget functions")
    h = hashlib.sha256(HARNESS.encode())
    for src in sorted(CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    so = BUILD / f"libsmem-{h.hexdigest()[:12]}.so"
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        cpp = BUILD / f"harness.{os.getpid()}.cpp"
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cpp.write_text(HARNESS)
        try:
            subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                            f"-I{CSRC}", "-o", str(tmp), str(cpp)],
                           check=True, capture_output=True, text=True)
            tmp.replace(so)
        finally:
            cpp.unlink(missing_ok=True)
            tmp.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(so))
    for name, (res, args) in _FUNCS.items():
        getattr(lib, name).restype = res
        getattr(lib, name).argtypes = args
    return lib


def python_budgets(drop: str | None = None) -> dict:
    """The Python formulas, with one term dropped where ``drop`` names
    one of :data:`DROP_TERMS` (the fixture's injected drift)."""
    from gossipfs_tpu_torch.ops import merge, merge_update as mu

    def onepass(n, form, blocking="8x32"):
        stack = 12 * merge.ONEPASS_BLOCKINGS[blocking].cols
        return merge.onepass_smem(n, form, blocking) - (
            stack if drop == "onepass_stack" else 0)

    def stripe(n):
        return mu.stripe_smem(n) - (
            2 * mu.COUNT_BLOCK_BYTES if drop == "stripe_count_blocks" else 0)

    def ring(f):
        return mu.ring_smem(f) // (mu.RING_DEPTH if drop == "ring_depth"
                                   else 1)

    return dict(onepass=onepass, stripe=stripe, ring=ring)


def _cpu_findings(drop: str | None) -> list[Finding]:
    from gossipfs_tpu_torch.ops import merge, merge_update as mu

    lib = _harness()
    py = python_budgets(drop)
    out: list[Finding] = []

    def bad(path, msg):
        out.append(Finding("smem-budget-probe", path, 1, msg))

    # K3's one-pass form: every form over the N grid, and the card limit
    if merge.ONEPASS_SMEM != lib.ms_limit():
        bad(_MERGE, f"ONEPASS_SMEM {merge.ONEPASS_SMEM} != the headers' "
                    f"kSmemLimit {lib.ms_limit()}")
    for form_id, form in enumerate(merge.FORMS):
        for wide, blocking in enumerate(merge.ONEPASS_BLOCKINGS):
            for n in ONEPASS_NS:
                want = lib.op_smem(n, form_id, wide)
                got = py["onepass"](n, form, blocking)
                if got != want:
                    bad(_MERGE, f"onepass_smem({n}, {form!r}, "
                                f"{blocking!r}) = {got} B but "
                                f"onepass::smem_bytes = {want} B -- the "
                                "route admits shapes the kernel cannot "
                                "hold (or refuses ones it can)")
        last = ONEPASS_WIDE_LAST["full" if form in merge.FULL_VIEW_FORMS
                                 else "aligned"]
        for n, want in ONEPASS_EDGES + ((last, "16x16"), (last + 128, None)):
            got = merge.onepass_blocking(n, n, form)
            if got != want:
                bad(_MERGE, f"onepass_blocking({n}, {n}, {form!r}) is "
                            f"{got}, expected {want} -- the one-pass "
                            "acceptance envelope moved")
    # K5: park rows, row bytes and bytes a CTA, and STRIPE_MAX_N's edge
    for n in STRIPE_NS:
        got = (mu.stripe_cta_rows(n), mu.stripe_row_bytes(n), py["stripe"](n))
        want = (lib.ms_cta_rows(n), lib.ms_row_bytes(n), lib.ms_smem(n))
        if got != want:
            bad(_MU, f"K5 at N={n}: Python (rows, row bytes, smem) {got} "
                     f"!= merge_stripe.cuh's {want}")
    edge = mu.STRIPE_MAX_N
    if not (mu.stripe_admits(edge, "int8")
            and not mu.stripe_admits(edge + 1, "int8")
            and lib.ms_row_bytes(edge) > 0):
        bad(_MU, f"STRIPE_MAX_N={edge}: stripe_admits must take it and "
                 f"refuse {edge + 1}, and K5's park must hold it (row bytes "
                 f"{lib.ms_row_bytes(edge)})")
    # K4's window tile
    for f in TILE_FANOUTS:
        got = (mu.arc_tile_smem(f), mu.arc_tile_fits(f))
        want = (lib.ms_tile_smem(f), bool(lib.ms_tile_fits(f)))
        if got != want:
            bad(_MU, f"K4's tile at F={f}: Python (smem, fits) {got} != "
                     f"merge_stripe.cuh's {want}")
    # K2's and K1's ring
    for f in RING_FANOUTS:
        if py["ring"](f) != lib.gr_ring_bytes(f):
            bad(_MU, f"ring_smem({f}) = {py['ring'](f)} B but "
                     f"gring::ring_bytes = {lib.gr_ring_bytes(f)} B")
    if mu.RING_SMEM_MAX != lib.gr_max_smem():
        bad(_MU, f"RING_SMEM_MAX {mu.RING_SMEM_MAX} != "
                 f"gring::max_smem_bytes {lib.gr_max_smem()}")
    if mu.MAX_KERNEL_FANOUT != lib.gr_max_staged_fanout():
        bad(_MU, f"MAX_KERNEL_FANOUT {mu.MAX_KERNEL_FANOUT} != "
                 f"gring::kMaxStagedFanout {lib.gr_max_staged_fanout()}")
    return out


def card_report(drop: str | None = None) -> dict:
    """What the built kernels report on the card, beside the Python
    formulas, and the edge-shape launches: one entry a kernel, each with
    ``python``, ``info`` and ``attr`` bytes and its ``launched`` count.
    Raises where a kernel does not build or launch."""
    import torch

    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.core import rounds as R
    from gossipfs_tpu_torch.core.state import init_state
    from gossipfs_tpu_torch import random as trandom
    from gossipfs_tpu_torch.ops import _build, merge, merge_update as mu
    from gossipfs_tpu_torch.ops.fanout_max import fanout_max_merge

    py = python_budgets(drop)
    rep: dict = {}

    def launches(name, run):
        merge.reset_launch_counts()
        run()
        torch.cuda.synchronize()
        return merge.LAUNCH_COUNTS.get(name, 0)

    def one_round(cfg, general=False):
        key = trandom.PRNGKey(7)
        st = init_state(cfg)
        if general:
            return lambda: R._run_general(st, cfg, 1, key, None, 0.0, 0.0,
                                          None, None, False, False)
        return lambda: R.run_rounds(st, cfg, 1, key)

    # K3 one-pass at the envelope's edges: the narrow blocking's 16,384
    # and 19,264, the wide one's 19,328 and its last N (aligned 109,056,
    # full view 115,712), each edge launched once in the form it bounds
    edges = ((16_384, ("aligned_group", "edges"), "aligned_group"),
             (19_264, ("aligned_group", "edges"), "aligned_group"),
             (19_328, ("aligned_group", "edges"), "edges"),
             (ONEPASS_WIDE_LAST["aligned"], ("aligned_group",),
              "aligned_group"),
             (ONEPASS_WIDE_LAST["full"], ("edges",), "edges"))
    for n, forms, run_form in edges:
        for form in forms:
            info = merge.onepass_info(
                n, n, form, fanout=16,
                arc_align=8 if form == "aligned_group" else 1)
            rep[f"K3 onepass {form} N={n}"] = dict(
                python=py["onepass"](n, form, info["blocking"]),
                info=info["smem"], attr=info["smem_attr"],
                clusters=info["clusters"], blocking=info["blocking"])
        cfg = (SimConfig.headline(n, rr_resident="on")
               if run_form == "aligned_group"
               else SimConfig.packed_rr(n, rr_resident="on"))
        rep[f"K3 onepass {run_form} N={n}"]["launched"] = launches(
            "resident_round", one_round(cfg))
        torch.cuda.empty_cache()
    # K5 at STRIPE_MAX_N
    n = mu.STRIPE_MAX_N
    info = (ctypes.c_int * 12)()
    check = merge.check_rc
    check("sm_info", _build.load("stripe_merge").sm_info(
        n, n, 15, 1, 1, 0, 1, info))
    rep[f"K5 N={n}"] = dict(python=py["stripe"](n), info=info[6],
                            attr=info[8], row_bytes=info[2],
                            python_row_bytes=mu.stripe_row_bytes(n))
    rep[f"K5 N={n}"]["launched"] = launches(
        "stripe_merge_update", one_round(SimConfig.packed_rr(n), True))
    torch.cuda.empty_cache()
    # K4's tile at the largest F it holds, and the van Herk form past it
    fit = max(f for f in range(1, 4_096) if mu.arc_tile_fits(f))
    for f in (fit, fit + 1):
        info = (ctypes.c_int * 12)()
        check("am_info", _build.load("arc_merge").am_info(
            4_096, 4_096, f, 2, 4, 1, 0, 1, info))
        rep[f"K4 F={f}"] = dict(
            python=mu.arc_tile_smem(f) if mu.arc_tile_fits(f) else 0,
            info=info[5], attr=info[6])
        cfg = SimConfig(n=4_096, topology="random_arc", fanout=f)
        rep[f"K4 F={f}"]["launched"] = launches(
            "arc_merge_update", one_round(cfg, True))
    # K2 and K1 at the largest staged fanout
    f = mu.MAX_KERNEL_FANOUT
    info = (ctypes.c_int * 12)()
    check("fm_info", _build.load("fused_merge").fm_info(
        4_096, 4_096, f, 2, 4, 1, 0, 1, info))
    rep[f"K2 F={f}"] = dict(python=py["ring"](f) + 4 * info[1] * f,
                            info=info[4], attr=info[10],
                            python_attr=mu.RING_SMEM_MAX)
    cfg = SimConfig(n=4_096, topology="random", fanout=f)
    rep[f"K2 F={f}"]["launched"] = launches("fused_merge_update",
                                            one_round(cfg, True))
    info = (ctypes.c_int * 12)()
    check("fx_info", _build.load("fanout_max").fx_info(4_096, f, 4, 1, info))
    rep[f"K1 F={f}"] = dict(python=py["ring"](f), info=info[4],
                            attr=info[10], python_attr=mu.RING_SMEM_MAX)
    gen = torch.Generator(device="cuda").manual_seed(3)
    view = torch.randint(-1, 100, (4_096, 4_096), dtype=torch.int32,
                         device="cuda", generator=gen)
    edges = torch.randint(0, 4_096, (4_096, f), dtype=torch.int32,
                          device="cuda", generator=gen)
    rep[f"K1 F={f}"]["launched"] = launches(
        "fanout_max_merge", lambda: fanout_max_merge(view, edges))
    return rep


def card_findings(rep: dict) -> list[Finding]:
    """The disagreements of a :func:`card_report`."""
    out = []
    for key, r in rep.items():
        attr_want = r.get("python_attr", r["python"])
        problems = []
        if r["info"] != r["python"]:
            problems.append(f"the kernel's info reports {r['info']} B, the "
                            f"Python formula {r['python']} B")
        if r["attr"] != attr_want:
            problems.append(f"cudaFuncGetAttributes reports {r['attr']} B "
                            f"opt-in, the Python formula {attr_want} B")
        if r.get("row_bytes", 0) != r.get("python_row_bytes", 0):
            problems.append(f"row bytes {r['row_bytes']} vs "
                            f"{r['python_row_bytes']}")
        if "launched" in r and r["launched"] < 1:
            problems.append("the edge-shape launch was not counted")
        if problems:
            out.append(Finding("smem-budget-probe", _MU, 1,
                               f"{key}: " + "; ".join(problems)))
    return out


def reconcile(device: str = "cuda", drop: str | None = None):
    """Every finding of the probe: the CPU half always, the card half
    where ``device`` is ``"cuda"``.  Returns (findings, card report or
    None)."""
    if drop is not None and drop not in DROP_TERMS:
        raise ValueError(f"drop must be one of {DROP_TERMS}, got {drop!r}")
    out = _cpu_findings(drop)
    rep = None
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise OSError("smem-budget-probe: no CUDA device (pass "
                          "--device cpu for the headers' half alone)")
        rep = card_report(drop)
        last_report.clear()
        last_report.update(rep)
        out += card_findings(rep)
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return out, rep


@rule(
    "smem-budget-probe",
    "each Python shared-memory budget of ops/ (onepass_smem/ONEPASS_SMEM, "
    "stripe_smem/STRIPE_MAX_N, arc_tile_smem, ring_smem/RING_SMEM_MAX/"
    "MAX_KERNEL_FANOUT) equals its csrc header budget function over a grid "
    "of N, F and forms (g++), inside the acceptance envelope; on the card "
    "the kernels' *_info bytes and cudaFuncGetAttributes agree and an "
    "edge-shape launch of each succeeds",
    kind="probe",
    fixture="lint_torch/smem_budget_probe.py",
    fixture_at=None,    # a probe fires through fixture_findings
)
def check_smem_budget_probe(index: RepoIndex) -> list[Finding]:
    return reconcile(index.device)[0]


def fixture_findings(fixture: str | pathlib.Path,
                     device: str = "cpu") -> list[Finding]:
    """The probe's committed trigger case: the fixture names a Python
    formula term (``DROP = "..."``) to drop, and the probe must fire."""
    ns: dict = {}
    exec(pathlib.Path(fixture).read_text(), ns)
    return reconcile(device, drop=ns["DROP"])[0]
