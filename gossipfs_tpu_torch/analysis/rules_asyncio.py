"""asyncio-hygiene: the port's socket-engine event loop must never block.

The port's asyncio UDP engine (``detector/udp.py``) is one loop carrying
every node's heartbeat task: one blocking call inside a coroutine stalls
the whole cohort's clock (heartbeats stop, peers see mass staleness), and
an un-retained ``create_task`` handle can be garbage-collected mid-flight.
The JAX package's rule, over the port's sources.
"""

from __future__ import annotations

import ast

from gossipfs_tpu_torch.analysis.framework import (
    Finding,
    RepoIndex,
    dotted,
    rule,
)

# Calls that block the event loop outright.
_BLOCKING = {
    "time.sleep", "subprocess.run", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output", "os.system",
    "socket.create_connection", "urllib.request.urlopen",
}


@rule(
    "asyncio-hygiene",
    "no blocking calls (time.sleep, subprocess.*, ...) inside "
    "coroutines, and every asyncio.create_task handle is retained "
    "(assigned/awaited), never dropped as a bare expression",
    fixture="lint/asyncio_hygiene.py",
    fixture_at="gossipfs_tpu_torch/detector/_lint_fixture.py",
)
def check_asyncio(index: RepoIndex) -> list[Finding]:
    out = []
    for rel in index.py_files():
        for fn in ast.walk(index.tree(rel)):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and dotted(node.func) in _BLOCKING:
                    out.append(Finding(
                        "asyncio-hygiene", rel, node.lineno,
                        f"blocking call {dotted(node.func)}() inside "
                        f"coroutine {fn.name}() -- it stalls every "
                        "node's heartbeat task on the shared loop "
                        "(use await asyncio.sleep / an executor)",
                    ))
                if isinstance(node, ast.Expr) \
                        and isinstance(node.value, ast.Call) \
                        and isinstance(node.value.func, ast.Attribute) \
                        and node.value.func.attr == "create_task":
                    out.append(Finding(
                        "asyncio-hygiene", rel, node.lineno,
                        f"create_task handle dropped in {fn.name}() -- "
                        "an unreferenced task may be garbage-collected "
                        "mid-flight; retain or await it",
                    ))
    return out
