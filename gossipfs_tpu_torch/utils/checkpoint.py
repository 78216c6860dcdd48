"""Checkpoint/resume for long simulation runs.

The port of the JAX package's ``utils/checkpoint.py``.  A run's whole
state is a :class:`~gossipfs_tpu_torch.core.state.SimState` plus its
threefry key, and resume is exact: every round's randomness folds the key
with the round index, so a restored (state, key) pair continues the
identical trajectory.  That holds for both round loops, since the lean
resident-round loop (``packed_rr``, ``headline``) runs on the same
``SimState`` lanes as the separate-pass one.

The format is the port's own: one ``torch.save`` of host copies in a
directory (``state.pt``).  The round loops update the lanes in place, so
the save copies them off the device at the call; the run may go on at
once.  The payload holds the lanes (``hb``, the packed ``asl``), ``alive``,
``round``, ``hb_base``, the key and ``hb_floor``, the storage dtype's
floor-sentinel value (0 for absolute int32 storage), so restore never
infers the saved era.

Restore carries the JAX package's migrations: a payload may hold the
unpacked ``age``/``status`` lanes instead of ``asl`` (wide legacy ages are
clipped to AGE_CLAMP before they are packed); a payload without
``hb_base`` is the legacy absolute-int32 era; the heartbeat lanes are
re-encoded for the config's ``hb_dtype`` from the true counters
``hb + hb_base``, anchored on each subject's own diagonal counter, with
floor sentinels kept as sentinels (or parked at 2**30 on an int32
restore).  Under subject-axis sharding, rank 0 saves the ranks' column
blocks gathered (``parallel/mesh.gather_state``, in ``run_job(save=)``),
and :func:`restore_checkpoint` hands each rank its block.
"""

from __future__ import annotations

import pathlib

import torch

from gossipfs_tpu_torch.config import (
    AGE_CLAMP, INT8_REBASE_WINDOW, REBASE_WINDOW, SimConfig)
from gossipfs_tpu_torch.core.state import HB_DTYPES, SimState
from gossipfs_tpu_torch.ops.merge import pack_age_status, unpack_age_status

PAYLOAD = "state.pt"
# an int32 restore parks narrow-era floor sentinels here: far above any
# reachable counter, so they never gossip, age out and stay detectable
QUARANTINE = 2 ** 30


def _floor(dtype: torch.dtype) -> int:
    """The storage dtype's floor-sentinel value (0: absolute int32)."""
    return 0 if dtype == torch.int32 else torch.iinfo(dtype).min


def save_checkpoint(path: str | pathlib.Path, state: SimState,
                    key: torch.Tensor) -> None:
    """Write (state, key) under ``path``, a directory (created if needed;
    an earlier payload there is replaced).  A sharded run saves its
    gathered state from rank 0 (``parallel/mesh.run_job(save=)``)."""
    payload = {
        "state": {
            "hb": state.hb.cpu().clone(),
            "asl": state.asl.cpu().clone(),
            "alive": state.alive.cpu().clone(),
            "round": int(state.round),
            "hb_base": state.hb_base.cpu().clone(),
        },
        "key": key.cpu().clone(),
        "hb_floor": _floor(state.hb.dtype),
    }
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (PAYLOAD + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path / PAYLOAD)


def _cols(t: torch.Tensor, ctx) -> torch.Tensor:
    """The shard's columns of a whole lane or per-subject vector."""
    if ctx is None or ctx.nloc is None:
        return t
    return t[..., ctx.offset:ctx.offset + ctx.nloc]


def restore_checkpoint(path: str | pathlib.Path, config: SimConfig,
                       ctx=None, device="cuda"
                       ) -> tuple[SimState, torch.Tensor]:
    """Load (state, key) saved by :func:`save_checkpoint` for this
    config's N, re-encoded for its ``hb_dtype``, on ``device``.

    ``ctx`` (a ``core.rounds.ShardCtx``) returns the rank's column block
    (``[N, nloc]`` lanes, ``hb_base`` ``[nloc]``; ``alive`` whole), ready
    for ``parallel/mesh.run_rounds_sharded``.  A payload whose ``hb_floor``
    says absolute int32 storage while its ``hb_base`` is positive carries
    narrow lanes with no identifiable floor: it raises ``ValueError``
    rather than decode floor sentinels into counters."""
    path = pathlib.Path(path)
    payload = torch.load(path / PAYLOAD, map_location="cpu",
                         weights_only=True)
    st = payload["state"]
    n = config.n
    if st["hb"].shape[0] != n:
        raise ValueError(f"checkpoint at {path} holds N="
                         f"{st['hb'].shape[0]}, config n={n}")
    dev = torch.device(device)
    offset = 0 if ctx is None or ctx.nloc is None else ctx.offset
    # migrations run per column block on the target device, int32 wide
    hb = _cols(st["hb"], ctx).to(dev).to(torch.int32)
    saved_dtype = st["hb"].dtype
    cols = hb.shape[1]
    if "hb_base" in st:
        base = _cols(st["hb_base"], ctx).to(dev).to(torch.int32)
    else:
        # the payload predates the base lane: absolute int32 storage
        base = torch.zeros((cols,), dtype=torch.int32, device=dev)
    if "asl" in st:
        age, status = unpack_age_status(_cols(st["asl"], ctx).to(dev))
    else:
        # the unpacked lanes, possibly a wide legacy age: clip, then pack
        age = _cols(st["age"], ctx).to(dev).to(torch.int32)
        status = _cols(st["status"], ctx).to(dev).to(torch.int32)
    asl = pack_age_status(age.clamp(0, AGE_CLAMP), status)
    # the true counter of every era is the stored value plus the base
    true_hb = hb + base[None, :]
    if "hb_floor" in payload:
        saved_min = payload["hb_floor"] or None
    else:
        # a payload from before the field: the stored lane's own minimum
        # (the JAX package reads it off the checkpoint's metadata)
        saved_min = torch.iinfo(saved_dtype).min
    positive = base > 0
    if saved_min is None and bool(positive.any()):
        raise ValueError(
            f"checkpoint at {path} says absolute int32 storage (hb_floor 0) "
            "but carries a positive hb_base: its floor sentinels cannot be "
            "identified; refusing to fabricate counters")
    if saved_min is None:
        sentinel = torch.zeros_like(hb, dtype=torch.bool)
    else:
        sentinel = (hb == saved_min) & positive[None, :]
    if config.hb_dtype != "int32":
        # anchor the new base as the in-round rebase does: on the
        # subject's own diagonal counter, the only legitimate maximum of
        # its current incarnation
        tgt = HB_DTYPES[config.hb_dtype]
        info = torch.iinfo(tgt)
        window = (REBASE_WINDOW if config.hb_dtype == "int16"
                  else INT8_REBASE_WINDOW)
        j = torch.arange(cols, device=dev)
        diag = true_hb[offset + j, j]
        new_base = torch.clamp(diag + 1 - window, min=0)
        enc = torch.clamp(true_hb - new_base[None, :], info.min, info.max)
        hb_out = torch.where(sentinel, info.min, enc).to(tgt)
        base_out = new_base.to(torch.int32)
    else:
        hb_out = torch.where(sentinel, QUARANTINE, true_hb).to(torch.int32)
        base_out = torch.zeros_like(base)
    state = SimState(hb=hb_out.contiguous(), asl=asl.contiguous(),
                     alive=st["alive"].to(dev, torch.bool),
                     round=int(st["round"]), hb_base=base_out.contiguous())
    return state, payload["key"].to(dev)
