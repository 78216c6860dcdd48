"""Master election + metadata rebuild, as pure functions.

Reference: when the master vanishes from the member list, everyone votes for
``MemberList[0]``; the candidate becomes master on a strict majority of
distinct voters, then reconstructs file metadata from every surviving node's
local registry (reference: slave/slave.go:930-1051).  The report calls this a
"bully algorithm"; in fact it is fixed-candidate majority voting — the
lowest-ordered member always wins (SURVEY §2.2 E1).  We keep the real
semantics and the name ``successor``.
"""

from __future__ import annotations

from gossipfs_tpu_torch.sdfs.types import REPLICATION_FACTOR, FileInfo


def successor(members: list[int]) -> int | None:
    """Who everyone votes for: the first member of the list (slave.go:936-947)."""
    return min(members) if members else None


def tally(votes: set[int], n_members: int) -> bool:
    """Strict majority of distinct voters elects the candidate
    (Receive_vote, slave.go:968-984)."""
    return len(votes) > n_members // 2


def rebuild_metadata(
    registries: dict[int, dict[str, int]], now: int
) -> dict[str, FileInfo]:
    """Reconstruct the file->replica map from surviving local registries.

    For each file: holders sorted by their local version, keep the top 4 as
    the replica set, version = max seen (rebuild_file_meta + sortByValue,
    slave/slave.go:986-1043, 120-143).  Recovery-by-reconstruction — the
    reference has no checkpointing (SURVEY §5).
    """
    holders: dict[str, list[tuple[int, int]]] = {}
    for node, registry in registries.items():
        for name, version in registry.items():
            holders.setdefault(name, []).append((node, version))
    meta: dict[str, FileInfo] = {}
    for name, pairs in holders.items():
        # highest version first; node id breaks ties deterministically
        pairs.sort(key=lambda p: (-p[1], p[0]))
        top = pairs[:REPLICATION_FACTOR]
        meta[name] = FileInfo(
            node_list=[node for node, _ in top],
            version=max(v for _, v in pairs),
            timestamp=now,
        )
    return meta
