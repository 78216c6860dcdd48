"""Time the K2 merge route per elementwise form, on the card.

The port of the JAX package's ``bench/sweep_merge.py``, which swept the
Pallas merge kernel's TPU tiles (``merge_block_r`` x ``merge_block_c`` x
``merge_slots``: 27 points an elementwise form) to pick ``config.py``'s
defaults.  The port's K2 (``csrc/fused_merge.cu``) chooses its own
geometry and ignores those three fields, so 27 points would time one
kernel 27 times: this runs one row for each ``--elementwise`` form at the
given ``--hb-dtype`` (N = 16,384, random fanout log2 N, 1 % crash churn),
timed by ``utils/profiling.time_rounds`` (the slope of two run lengths,
each from a fresh state), and prints the best.

    python -m gossipfs_tpu_torch.sweep_merge --hb-dtype int8 \\
        --elementwise lanes swar
    python -m gossipfs_tpu_torch.sweep_merge --n 256 --device cpu
"""

from __future__ import annotations

import argparse

import torch

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.utils.profiling import time_rounds

N = 16_384


def sweep_config(n: int, hb_dtype: str, elementwise: str) -> SimConfig:
    """The swept configuration, with the TPU tile fields at their
    defaults."""
    return SimConfig(
        n=n, topology="random", fanout=SimConfig.log_fanout(n),
        remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
        merge_kernel="pallas", hb_dtype=hb_dtype,
        view_dtype="int8" if hb_dtype == "int8" else "int16",
        elementwise=elementwise,
    )


def timed(cfg: SimConfig, key: torch.Tensor) -> float:
    """Slope-timed rounds/s (``utils/profiling.time_rounds``: every run
    from a fresh state)."""
    return time_rounds(None, cfg, key, crash_rate=0.01)["rounds_per_sec"]


def main(argv=None) -> list[tuple[float, str]]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--hb-dtype", choices=("int32", "int16", "int8"),
                   default="int32")
    p.add_argument("--elementwise", nargs="*", choices=("lanes", "swar"),
                   default=["lanes"],
                   help="elementwise forms to time (swar needs --hb-dtype "
                        "int8; see config.SimConfig.elementwise)")
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("gossipfs_tpu_torch.sweep_merge needs a CUDA "
                         "device (or --device cpu)")
    print("merge_block_r, merge_block_c, merge_slots: TPU tile knobs with "
          "no counterpart in the port (its K2 picks its own geometry); "
          "one row per elementwise form", flush=True)
    key = trandom.PRNGKey(0, device=dev)
    results = []
    for ew in args.elementwise:
        tag = f"hb={args.hb_dtype} ew={ew}"
        try:
            rps = timed(sweep_config(args.n, args.hb_dtype, ew), key)
        except ValueError as e:  # e.g. swar without int8 lanes
            print(f"{tag}: FAIL {type(e).__name__}: {e}", flush=True)
            continue
        results.append((rps, tag))
        print(f"{tag}: {rps:.1f} rounds/s", flush=True)
    if not results:
        print("no configuration succeeded")
        return results
    rps, tag = max(results)
    print(f"best: {rps:.1f} rounds/s at {tag}")
    return results


if __name__ == "__main__":
    main()
