"""Gossip topologies: who merges whose membership table each round.

In-edge form, as in the JAX package: receiver ``i`` merges the tables of
its senders.  Three topologies:

* ``ring`` (the reference's parity mode): each receiver takes the next
  member above it and the two below it in id order, over its OWN list, so
  the edges derive from the post-tick tables every round;
* ``random``: F uniform peers per receiver, never itself, explicit
  ``[N, F]`` edges;
* ``random_arc``: one arc start per receiver, merging the F consecutive
  rows from there; aligned arcs draw the start as a multiple of ``align``,
  so the merge reduces to ``F/align`` whole sender groups.

Every draw takes a batch of keys (gossipfs_tpu_torch.random), so a caller
can draw a whole horizon's edges in one pass.
"""

from __future__ import annotations

import torch

from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core.state import listed
from gossipfs_tpu_torch.ops.merge_update import row_chunks


def ring_edges_from_status(status: torch.Tensor,
                           include_suspects: bool = False) -> torch.Tensor:
    """int32 ``[N, 3]`` ring in-edges over each receiver's own list:
    (next member above, first below, second below) in cyclic id order.
    Under suspicion (``include_suspects``) SUSPECT entries are still list
    positions and stay ring targets: excluding them would keep every
    refutation away from the suspecting side.

    Receivers with too few other members fall back to self-edges, which
    merge as no-ops.  Each minimum is the first one in id order, as
    ``jnp.argmin`` resolves ties (distances to listed peers are distinct,
    so ties only arise among unlisted columns).  Works in row chunks."""
    n = status.shape[0]
    dev = status.device
    out = torch.empty((n, 3), dtype=torch.int32, device=dev)
    j = torch.arange(n, device=dev)[None, :]
    big = n + 1
    for r0, r1 in row_chunks(n, n):
        i = torch.arange(r0, r1, device=dev)[:, None]
        m = listed(status[r0:r1], include_suspects) & (j != i)
        dn = torch.where(m, (j - i) % n, big)
        dp = torch.where(m, (i - j) % n, big)
        next1 = dn.argmin(dim=1)
        prev1 = dp.argmin(dim=1)
        dp.scatter_(1, prev1[:, None], big)
        prev2 = dp.argmin(dim=1)
        cnt = m.sum(dim=1)
        me = i[:, 0]
        out[r0:r1] = torch.stack([
            torch.where(cnt >= 1, next1, me),
            torch.where(cnt >= 1, prev1, me),
            torch.where(cnt >= 2, prev2, me),
        ], dim=1).to(torch.int32)
    return out


def random_in_edges(keys: torch.Tensor, n: int, fanout: int) -> torch.Tensor:
    """int32 ``[..., N, F]`` uniform random peers, never self: a draw in
    ``[0, n-1)`` shifted up by one at and above the receiver.

    The JAX package draws in uint16 while ``n - 1`` fits; jax samples
    8- and 16-bit ``randint`` at 32 bits (bounds clipped to the narrow
    type, which ``[0, n-1)`` already is) and casts, so that draw is this
    int32 one bit for bit (tests/test_torch_general_rounds.py holds it
    against jax for ``n`` around 2^16)."""
    draw = trandom.randint(keys, (n, fanout), 0, n - 1)
    me = torch.arange(n, dtype=torch.int32, device=keys.device)[:, None]
    return draw + (draw >= me).to(torch.int32)


def random_arc_bases(keys: torch.Tensor, n: int, fanout: int) -> torch.Tensor:
    """int32 ``[..., N]`` arc starts, uniform over the n-F starts whose
    window of F consecutive senders excludes the receiver."""
    draw = trandom.randint(keys, (n,), 0, n - fanout)
    i = torch.arange(n, dtype=torch.int32, device=keys.device)
    return (i + 1 + draw) % n


def random_arc_bases_aligned(keys: torch.Tensor, n: int, fanout: int,
                             align: int) -> torch.Tensor:
    """int32 ``[..., N]`` arc starts drawn as multiples of ``align``.

    An aligned arc may include the receiver itself, which merges as a
    no-op (the view holds exactly what the receiver already holds)."""
    if fanout % align or n % align:
        raise ValueError(
            f"aligned arc needs align | fanout and align | n "
            f"(align={align}, fanout={fanout}, n={n})"
        )
    return trandom.randint(keys, (n,), 0, n // align) * align


def arc_edges(bases: torch.Tensor, fanout: int) -> torch.Tensor:
    """Expand arc bases ``[..., N]`` to explicit ``[..., N, F]`` in-edges."""
    n = bases.shape[-1]
    offs = torch.arange(fanout, dtype=torch.int32, device=bases.device)
    return (bases[..., None] + offs) % n


def in_edges(config: SimConfig, keys: torch.Tensor | None,
             status: torch.Tensor | None = None) -> torch.Tensor:
    """Per-round in-edges in the form the round consumes: arc BASES
    ``[..., N]`` for ``random_arc`` (expand with :func:`arc_edges`),
    explicit ``[..., N, F]`` edges for ``random``, and for ``ring`` the
    ``[N, 3]`` edges over ``status`` (the unpacked post-tick status)."""
    if config.topology == "ring":
        return ring_edges_from_status(status, config.suspicion is not None)
    if config.topology == "random":
        return random_in_edges(keys, config.n, config.fanout)
    if config.arc_align > 1:
        return random_arc_bases_aligned(keys, config.n, config.fanout,
                                        config.arc_align)
    return random_arc_bases(keys, config.n, config.fanout)


def churn_masks(keys: torch.Tensor, alive: torch.Tensor, crash_rate: float,
                rejoin_rate: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Random crash-stop and rejoin masks, one ``[N]`` pair per key.

    ``crash_rate`` is the per-round probability that an alive node
    crashes; ``rejoin_rate`` that a dead node rejoins.  Both uniforms are
    drawn, from the two halves of one split, as in the JAX package."""
    ks = trandom.split(keys)
    n = alive.shape[-1]
    u = trandom.uniform(ks[..., 0, :], (n,))
    v = trandom.uniform(ks[..., 1, :], (n,))
    f32 = dict(dtype=torch.float32, device=alive.device)
    crash = alive & (u < torch.tensor(crash_rate, **f32))
    join = ~alive & (v < torch.tensor(rejoin_rate, **f32))
    return crash, join
