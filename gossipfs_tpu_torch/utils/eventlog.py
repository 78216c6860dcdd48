"""Structured event log + grep — the observability layer.

Reference: every MACHINE appends its own text lines to a local
``Machine.log`` (reopening the file per call — logger/logger.go:28-44), and
the distributed grep RPC searches each machine's log separately
(``TCPServer.Response``, server/server.go:55-72; the report's stated test
methodology greps ACROSS machines and compares what each observer saw).
Here events are structured (kind + round + attributes) with a text
rendering, the file handle stays open, and grep is a method.  The node
dimension survives: every entry carries the ``node`` that would have
written it to its own Machine.log (the detecting observer, the
re-replication source, the election winner, the put-handling master), so
:meth:`grep` with a node filter is the analog of grepping that one
machine's log, and :meth:`node_view` is the analog of reading it.  The sim
emits the same event kinds the Go cluster logs, so log-grep assertions
port over.
"""

from __future__ import annotations

import json
import pathlib
import re


class EventLog:
    """Append-only structured log, in-memory with optional file mirroring."""

    def __init__(self, path: str | pathlib.Path | None = None):
        self.entries: list[dict] = []
        self._fh = open(path, "a", encoding="utf-8") if path is not None else None

    def write(self, message: str, **fields) -> None:
        """Append an entry; ``node=<id>`` names the machine whose local log
        the reference would have written this line to."""
        entry = {"message": message, **fields}
        self.entries.append(entry)
        if self._fh is not None:
            self._fh.write(json.dumps(entry) + "\n")
            self._fh.flush()

    def grep(self, pattern: str, node: int | None = None) -> list[dict]:
        """Regex search over rendered messages (the MP1 remote-grep verb).

        ``node`` restricts the search to that machine's own log view — the
        reference's per-machine grep (server.go:55-72); None searches the
        whole cluster's stream.
        """
        rx = re.compile(pattern)
        return [
            e for e in self.entries
            if rx.search(e["message"])
            and (node is None or e.get("node") == node)
        ]

    def node_view(self, node: int) -> list[dict]:
        """Everything machine ``node`` wrote — its Machine.log, read back."""
        return [e for e in self.entries if e.get("node") == node]

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
