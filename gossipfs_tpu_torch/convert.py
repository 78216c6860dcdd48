"""Carry a simulation across the two packages.

The JAX package keeps three ``[N, N]`` lanes (``hb``, ``age``,
``status``); the port keeps ``hb`` and the packed age|status byte.  These
two functions move a state (and its metrics carry) between the forms,
through numpy, so a run started in one package continues in the other;
:func:`shard_from_jax_arrays` hands one rank the column shard of a JAX
state (``parallel/mesh.py``).
:func:`scenario_from_jax` carries a compiled fault scenario across (an
armed run keeps its rule table and its arming round).
"""

from __future__ import annotations

import numpy as np
import torch

from gossipfs_tpu_torch.core.rounds import MetricsCarry
from gossipfs_tpu_torch.core.state import HB_DTYPES, SimState
from gossipfs_tpu_torch.ops.merge import pack_age_status, unpack_age_status
from gossipfs_tpu_torch.scenarios.tensor import TensorScenario

CARRY_FIELDS = MetricsCarry._fields


def from_jax_arrays(hb, age, status, alive, hb_base, round, first_detect=None,
                    first_observer=None, converged=None, first_suspect=None,
                    device="cuda"):
    """Port state (and carry) from the JAX package's ``SimState`` and
    ``MetricsCarry`` fields, given as numpy arrays.

    Returns ``(SimState, MetricsCarry | None)``: the carry when all four
    of its fields are given, else None."""
    hb = np.asarray(hb)
    if hb.dtype.name not in HB_DTYPES:
        raise ValueError(f"hb dtype {hb.dtype}: the lanes are int8, int16 "
                         "or int32")

    def t(a, dtype):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    state = SimState(
        hb=t(hb, HB_DTYPES[hb.dtype.name]),
        asl=pack_age_status(t(age, torch.int32), t(status, torch.int32)),
        alive=t(alive, torch.bool),
        round=int(np.asarray(round)),
        hb_base=t(hb_base, torch.int32),
    )
    fields = (first_detect, first_observer, converged, first_suspect)
    carry = None
    if all(f is not None for f in fields):
        carry = MetricsCarry(*(t(f, torch.int32) for f in fields))
    elif any(f is not None for f in fields):
        raise ValueError("give all four carry fields or none")
    return state, carry


def shard_from_jax_arrays(ctx, hb, age, status, alive, hb_base, round,
                          first_detect=None, first_observer=None,
                          converged=None, first_suspect=None,
                          device="cuda"):
    """:func:`from_jax_arrays` for one rank's column shard (``ctx``, a
    ``core.rounds.ShardCtx``): the JAX state's columns ``offset..offset +
    nloc`` of the lanes, its ``hb_base`` and carry slices, and the whole
    ``alive``.  Returns ``(SimState, MetricsCarry | None)`` of the shard,
    ``[N, nloc]`` lanes."""
    sl = slice(ctx.offset, ctx.offset + ctx.cols(np.asarray(alive).shape[0]))
    cols = lambda a: None if a is None else np.asarray(a)[..., sl]  # noqa: E731
    return from_jax_arrays(
        cols(hb), cols(age), cols(status), alive, cols(hb_base), round,
        cols(first_detect), cols(first_observer), cols(converged),
        cols(first_suspect), device=device)


def to_numpy(state: SimState, carry: MetricsCarry | None = None) -> dict:
    """The JAX package's field names and dtypes as numpy arrays: hb (its
    lane dtype), age, status (int8), alive (bool), hb_base (int32), round
    (int32), and the carry's four int32 fields when ``carry`` is given."""
    age, status = unpack_age_status(state.asl)
    out = {
        "hb": state.hb.cpu().numpy(),
        "age": age.to(torch.int8).cpu().numpy(),
        "status": status.to(torch.int8).cpu().numpy(),
        "alive": state.alive.cpu().numpy().astype(bool),
        "hb_base": state.hb_base.to(torch.int32).cpu().numpy(),
        "round": np.int32(state.round),
    }
    if carry is not None:
        for name, val in zip(CARRY_FIELDS, carry):
            out[name] = val.to(torch.int32).cpu().numpy()
    return out


def scenario_from_jax(leaves: dict, device="cuda") -> TensorScenario:
    """The port's ``TensorScenario`` from the JAX package's, given as its
    leaves in numpy (``{name: np.asarray(leaf)}`` over the NamedTuple's
    ``_asdict()``).  Names, shapes and dtypes are the same on both sides
    (int32 windows and ids, float32 rates, bool node masks), so each leaf
    moves as it is."""
    if set(leaves) != set(TensorScenario._fields):
        raise ValueError(
            f"scenario leaves must be {TensorScenario._fields}, got "
            f"{tuple(leaves)}")
    return TensorScenario(**{
        name: torch.from_numpy(np.array(leaves[name])).to(device)
        for name in TensorScenario._fields})
