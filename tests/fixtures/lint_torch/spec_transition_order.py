"""Seeded drift for the port's spec-transition-order rule: the lanes
tick, chunked over rows with in-place masked status writes, writes
SUSPECT BEFORE it computes the confirm mask, so a same-round entry can
satisfy the confirm compare and skip its suspect window (the SWAR tick
keeps the contract order).  Mounted over gossipfs_tpu_torch/core/rounds.py
by tests/test_torch_analysis.py only -- never imported."""

import torch

from gossipfs_tpu_torch.core.state import FAILED, MEMBER, SUSPECT
from gossipfs_tpu_torch.ops import swar


def _tick(state, config, active, degraded, row_chunks):
    sus = config.suspicion
    for r0, r1 in row_chunks:
        st = state.status[r0:r1]
        age = state.age[r0:r1]
        confirm_thr = (config.t_fail + sus.t_suspect * (
            1 + torch.where(degraded[r0:r1], sus.lh_multiplier, 0)))[:, None]
        stale = active[r0:r1, None] & (age > config.t_fail)
        suspect_new = stale & (st == MEMBER)
        # DRIFT: SUSPECT written in place first -- the mask below sees
        # post-write status
        st[suspect_new] = SUSPECT
        fail = (st == SUSPECT) & (age > confirm_thr)
        st[fail] = FAILED


def _tick_swar(state, config, active, degraded, row_chunks):
    w = swar.word
    sus = config.suspicion
    for r0, r1 in row_chunks:
        aslw = swar.pack(state.asl[r0:r1])
        st = aslw & w(3)
        stm = swar.eq(st, w(MEMBER))
        sus_pre = swar.eq(st, w(SUSPECT))
        age_thr = config.t_fail + sus.t_suspect * (
            1 + torch.where(degraded[r0:r1], sus.lh_multiplier, 0))
        confirm_w = swar.splat((age_thr << 2 | SUSPECT) - 128)[:, None]
        stale = active & stm
        fail = active & sus_pre & swar.gts(aslw, confirm_w)
        aslw = aslw | (swar.to_bytes(stale) & w(2))
        aslw = swar.sel(swar.to_bytes(fail), w(FAILED), aslw)
        state.asl[r0:r1] = swar.unpack(aslw)
