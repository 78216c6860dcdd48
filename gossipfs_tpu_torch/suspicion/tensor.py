"""The dissemination mode the SWIM lifecycle needs (the port's copy of the
JAX package's ``suspicion/tensor.py: require_suspicion_config``)."""

from __future__ import annotations


def require_suspicion_config(config) -> None:
    """Reject protocol modes the SWIM lifecycle cannot compose with."""
    if config.remove_broadcast:
        raise ValueError(
            "suspicion requires remove_broadcast=False: the REMOVE broadcast "
            "is an instantaneous column-OR that would confirm a failure "
            "cluster-wide before any observer's SUSPECT window could refute "
            "it (use gossip-only dissemination + fresh_cooldown)")
    if not config.fresh_cooldown:
        raise ValueError(
            "suspicion requires fresh_cooldown=True: the stale-timestamp "
            "fail list gives confirmed removals a ~zero cooldown and zombie "
            "re-add cycles, which would re-suspect the same corpse forever")
