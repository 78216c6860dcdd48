"""Per-node local SDFS store: filename -> version registry plus blob storage.

Reference: ``sdfs_slave.SDFSSLAVE`` keeps a ``map[string]int`` of local file
versions and reads/writes files under a hardcoded home directory
(sdfs_slave/sdfs_slave.go:10-96; note its ``get_file`` reads only a 4096-byte
buffer — a latent truncation bug the reference sidesteps by moving real data
over scp).  Here the registry and the bytes live together; transfers are
byte-complete.
"""

from __future__ import annotations

import pathlib


class LocalStore:
    """One node's SDFS-local registry + content."""

    def __init__(self, root: str | pathlib.Path | None = None):
        """In-memory by default; pass ``root`` to persist blobs on disk
        (the CLI's equivalent of the reference's sdfs/ directory)."""
        self.versions: dict[str, int] = {}
        self.root = pathlib.Path(root) if root is not None else None
        self._blobs: dict[str, bytes] = {}
        if self.root is not None:
            self.root.mkdir(parents=True, exist_ok=True)

    # -- registry (Update_file_version, sdfs_slave.go:20-25) ---------------
    def set_version(self, name: str, version: int) -> None:
        self.versions[name] = version

    def version(self, name: str) -> int:
        """-1 when the file isn't stored locally (Ls_file returns ok=false)."""
        return self.versions.get(name, -1)

    # -- data (Put_file / get_file / Delete_file_data) ---------------------
    def put(self, name: str, data: bytes, version: int) -> None:
        if self.root is not None:
            (self.root / name).write_bytes(data)
        else:
            # defensive byte copy: each replica owns its content, like the
            # reference's per-replica scp (and a caller-held bytearray can't
            # mutate the store later); also what makes bench/sdfs_ops.py's
            # latency-vs-size curves measure an actual per-replica transfer
            self._blobs[name] = bytes(memoryview(data))
        self.versions[name] = version

    def get(self, name: str) -> bytes | None:
        if name not in self.versions:
            return None
        if self.root is not None:
            path = self.root / name
            return path.read_bytes() if path.exists() else None
        return self._blobs.get(name)

    def delete(self, name: str) -> bool:
        existed = name in self.versions
        self.versions.pop(name, None)
        self._blobs.pop(name, None)
        if self.root is not None:
            (self.root / name).unlink(missing_ok=True)
        return existed

    def listing(self) -> dict[str, int]:
        """filename -> version for every locally stored file (Ls_localfile)."""
        return dict(self.versions)
