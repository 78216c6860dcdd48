"""K3 (f)'s 16 x 16 walk against an earlier tree's, on one H100.

Builds the working tree's one-pass libraries (csrc/rr_onepass_wide.cu with
``ptxas -v``: registers and spills of each instantiation) and the earlier
tree's wide library from its csrc/ unpacked under
``gossipfs_tpu_torch/_build/parent`` (C entry ``rr_onepass`` taking the
lockstep turns buffer and a launch number, or without them as this
tree's), checks the narrow library's
static SASS digest against ``chip_smoke.ONEPASS_SASS_UNTEMPLATED`` and the
wide kernel against the plain version (``chip_smoke.onepass_wide_vs_plain``
and ``onepass_wide_block_sus``), then at N = 65,536 and 98,304 (crash-only,
chip_smoke's inputs) times the working tree's launch, the earlier tree's
and the two-launch form in turns (3 x a, b, c, c, b, a; 4 rounds a
timing, each from the same inputs), each compared with the two-launch
round (every count, the lanes by their on-card digest), and the working
tree's step timeline.  Run from the repository root:

    mkdir -p gossipfs_tpu_torch/_build/parent
    git archive <earlier commit> gossipfs_tpu_torch/csrc | \\
        tar -x -C gossipfs_tpu_torch/_build/parent
    python gossipfs_tpu_torch/wide_ablation/ahead_probe.py [OUT.json]
        # the whole record to OUT.json (default ahead_probe.json)
"""
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, ".")

SHAPES = ((65_536, "edges", "lanes"), (65_536, "edges", "swar"),
          (65_536, "aligned_group", "lanes"), (65_536, "aligned_group", "swar"),
          (98_304, "edges", "lanes"), (98_304, "aligned_group", "lanes"))


def registers(log: str) -> list:
    """Each rr_onepass_kernel instantiation's registers and spill bytes
    from a ``ptxas -v`` log: "<template flags> r<regs>[ s<stores>/<loads>]"."""
    rows = []
    for chunk in log.split("Compiling entry function")[1:]:
        m = re.search(r"rr_onepass_kernelILb(\d)ELb(\d)ELi(\d)ELb(\d)ELb(\d)E",
                      chunk)
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       chunk)
        rg = re.search(r"Used (\d+) registers", chunk)
        if m and rg:
            spill = f" s{sp.group(1)}/{sp.group(2)}" if sp else ""
            rows.append("".join(m.groups()) + f" r{rg.group(1)}" + spill)
    return rows


def main():
    import torch

    import chip_smoke as cs
    from gossipfs_tpu_torch.ops import _build, merge

    out = {"smi": cs.nvidia_smi()}
    print(out["smi"], flush=True)
    t0 = time.perf_counter()
    so = Path("gossipfs_tpu_torch/_build/libparent_wide.so")
    parent_src = Path("gossipfs_tpu_torch/_build/parent/gossipfs_tpu_torch/"
                      "csrc/rr_onepass_wide.cu")
    par = subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                            str(parent_src)], stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    names = ["rr_onepass", "rr_onepass_wide", "resident_round"]
    _build.start(names, verbose=True)
    _build.build(names, verbose=True)
    text = par.communicate()[0]
    if par.returncode:
        print(text[:5000])
        raise SystemExit(1)
    P, I = ctypes.c_void_p, ctypes.c_int
    parent = ctypes.CDLL(str(so))
    parent.rr_onepass.restype = I
    # the earlier tree's C entry: with the lockstep turns buffer and a
    # launch number before the stream, or without them (the turns kept
    # after the per-receiver counts, or in the library as this tree's:
    # recv has room for 64 words more)
    own_turns = "void* turns, int seq" in (
        parent_src.parent / "rr_onepass.cu").read_text()
    parent.rr_onepass.argtypes = [P] * 8 + [I] * 14 + (
        [P, I, P] if own_turns else [P])
    out["parent_abi"] = "turns, seq" if own_turns else "counts block"
    out["build_s"] = time.perf_counter() - t0
    out["regs"] = registers(_build.build_logs.get("rr_onepass_wide", ""))
    print("built", out["build_s"], "wide regs", out["regs"], flush=True)
    cs.start_sass_dump(str(_build.lib_path("rr_onepass")))
    out["narrow_digest"] = cs.sass_digest(
        cs.onepass_sass(str(_build.lib_path("rr_onepass"))))
    print("narrow SASS digest", out["narrow_digest"], "want",
          cs.ONEPASS_SASS_UNTEMPLATED, flush=True)
    checks = {}
    cs.onepass_wide_vs_plain(checks)
    cs.onepass_wide_block_sus(checks)
    out["checks"] = checks
    print("wide vs plain", checks, flush=True)

    turns = torch.zeros(64, dtype=torch.int64, device="cuda")
    seq = [0]

    def run_parent(hb, asl, flags, vecs, senders, kw):
        n, c = hb.shape
        form = merge.kernel_form(kw.get("fanout"), kw.get("arc_align", 1),
                                 False, kw["elementwise"]).split("/")[0]
        width = senders.shape[1] if kw.get("fanout") is None else kw["fanout"]
        subj = torch.empty((3, c), dtype=torch.int32, device="cuda")
        recv = torch.empty(n + 64, dtype=torch.int32, device="cuda")
        thr, hi = merge._sus_thresholds(kw["t_fail"], False, 0, 0, 63)
        seq[0] += 1
        tail = ((turns.data_ptr(), seq[0]) if own_turns else ())
        rc = parent.rr_onepass(
            hb.data_ptr(), asl.data_ptr(), flags.data_ptr(), vecs.data_ptr(),
            senders.data_ptr(), subj.data_ptr(), recv.data_ptr(), None, n, c,
            0, width, merge.FORMS.index(form), kw.get("arc_align", 1),
            kw["t_fail"], 12, 63, 0, 0, thr, hi,
            int(kw["elementwise"] == "swar"), *tail,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return (hb, asl, *subj, recv[:n])

    timing = {}
    for n, form, ew in SHAPES:
        torch.cuda.empty_cache()
        lanes, fkw = cs.wide_inputs(n, form, False, cs.SEED + 3 * n)
        hb0, asl0, flags, vecs, senders = lanes
        kw = dict(fkw, t_cooldown=12, elementwise=ew, t_fail=5)
        hb, asl = hb0.clone(), asl0.clone()

        def reset():
            hb.copy_(hb0)
            asl.copy_(asl0)

        runs = {
            "tree": lambda: merge.resident_round(
                hb, asl, flags, vecs, senders, onepass=True, **kw),
            "parent": lambda: run_parent(hb, asl, flags, vecs, senders, kw),
            "two-launch": lambda: merge.resident_round(
                hb, asl, flags, vecs, senders, **kw),
        }
        outs = {}
        for k, f in runs.items():
            reset()
            o = f()
            outs[k] = ([x.clone() for x in o[2:6]], cs.lane_digest(hb),
                       cs.lane_digest(asl))
        diff = {}
        for k in ("tree", "parent"):
            a, b = outs[k], outs["two-launch"]
            diff[k] = sum(cs.count_diff(x, y)[0] for x, y in zip(a[0], b[0]))
            diff[k] += int((a[1] != b[1]).sum()) + int((a[2] != b[2]).sum())
        del outs
        ms = {k: [] for k in runs}
        order = list(runs)
        for _ in range(3):
            for k in order + order[::-1]:
                ms[k].append(cs.cuda_ms(runs[k], 4, reset))
        reset()
        tl = torch.zeros((n // 16, 16, merge.ONEPASS_STAMPS),
                         dtype=torch.int64, device="cuda")
        merge.resident_round(hb, asl, flags, vecs, senders, onepass=True,
                             timeline=tl, **kw)
        torch.cuda.synchronize()
        split = merge.onepass_timeline_split(tl)
        key = f"{n} {form} {ew}"
        timing[key] = {"min_ms": {k: min(v) for k, v in ms.items()},
                       "all_ms": ms, "diff": diff, "split": split}
        print(key, "entries differing from two-launch", diff,
              {k: round(min(v), 4) for k, v in ms.items()},
              {k: round(v, 2) for k, v in split.items()}, flush=True)
        del hb, asl, hb0, asl0, lanes
    out["timing"] = timing
    out["smi_end"] = cs.sm_clock()
    out["seconds"] = time.perf_counter() - t0
    dest = Path(sys.argv[1] if len(sys.argv) > 1 else "ahead_probe.json")
    dest.parent.mkdir(parents=True, exist_ok=True)
    with open(dest, "w") as fh:
        json.dump(out, fh, indent=1, default=str)
    # (the checks above raise where an entry differs)
    bad = [k for k, v in timing.items() if any(v["diff"].values())]
    print("done", out["seconds"], out["smi_end"], "bad", bad, flush=True)
    if bad or out["narrow_digest"] != cs.ONEPASS_SASS_UNTEMPLATED:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
