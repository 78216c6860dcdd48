"""Trigger fixture for the device-hygiene rule: a stand-in for
core/rounds.py whose lean loop draws host randomness, syncs with the card
and branches on a device value every round, and whose round function
reads a tensor back to the host.  Mounted (shadowing core/rounds.py) by
tests/test_torch_analysis.py only -- never imported."""

import random

import torch


def _round_core(state, config):
    n_det = state.hb.sum(dim=0)
    return n_det.cpu()  # the whole vector to the host, once a round


def run_lean_packed(hb, asl, config, num_rounds: int):
    for r in range(num_rounds):
        jitter = random.random()  # host randomness: no threefry key
        noise = torch.rand(hb.shape[0], device=hb.device)  # global RNG
        counts = hb.sum(dim=1)
        if counts.max() > 0:  # a Python branch on a device value
            hb = hb + 1
        total = counts.sum().item()  # a per-round host sync
        _round_core(hb, config)
    return hb, total, jitter, noise


def _run_general(state, config, num_rounds):
    for r in range(num_rounds):
        state = _round_core(state, config)
    return state
