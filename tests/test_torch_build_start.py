"""``ops/_build.start``: builds started together and waited for later.

nvcc is not on this machine, so each test stands a shell command in for
it (``_build._command`` patched) and checks the bookkeeping: ``start``
returns before the build ends, ``build`` and ``load``'s path wait for a
started build instead of starting it again, a failed build raises and
leaves no library, and ``nice`` prefixes the command.
"""

from __future__ import annotations

import pytest

from gossipfs_tpu_torch.ops import _build


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """Build into ``tmp_path`` with a shell command for nvcc: it sleeps,
    logs a line and writes the output file (or fails for a ``FAIL``
    define).  Returns the list of commands started."""
    started = []

    def command(name, out, verbose, defines=()):
        code = 1 if "FAIL" in defines else 0
        cmd = ["sh", "-c", f"sleep 0.3; echo built {name} {' '.join(defines)};"
               f" echo lib > '{out}'; exit {code}"]
        started.append((name, tuple(defines)))
        return cmd

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_command", command)
    monkeypatch.setattr(_build, "_pending", {})
    monkeypatch.setattr(_build, "build_logs", {})
    return started


def test_start_returns_before_the_build_and_build_waits(fake_nvcc):
    items = ["fused_merge", ("rr_onepass", ("RR_STUB=1",))]
    paths = _build.start(items)
    assert not any(p.exists() for p in paths.values())
    assert set(_build._pending) == {"fused_merge",
                                    ("rr_onepass", ("RR_STUB=1",))}
    # a second start of the same items starts nothing
    _build.start(items)
    assert len(fake_nvcc) == 2
    got = _build.build(items)
    assert got == paths and all(p.exists() for p in paths.values())
    assert not _build._pending
    assert not list(_build.BUILD_DIR.glob("*.tmp.*"))
    assert _build.build_logs["fused_merge"].strip() == "built fused_merge"
    assert len(fake_nvcc) == 2


def test_build_of_one_item_waits_only_for_it(fake_nvcc):
    _build.start(["fused_merge", "arc_merge"])
    one = _build.build(["arc_merge"])
    assert one["arc_merge"].exists()
    assert set(_build._pending) == {"fused_merge"}
    # a variant is waited for by its (name, defines) item, and load's item
    # form is the same key
    _build.start([("rr_onepass", ("RR_STUB=2",))])
    assert ("rr_onepass", ("RR_STUB=2",)) in _build._pending
    _build.build([("rr_onepass", ("RR_STUB=2",))])
    assert _build.lib_path("rr_onepass", ("RR_STUB=2",)).exists()
    _build.build(["fused_merge"])
    assert len(fake_nvcc) == 3 and not _build._pending


def test_failed_build_raises_and_leaves_no_library(fake_nvcc):
    _build.start([("rr_onepass", ("FAIL",))])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build([("rr_onepass", ("FAIL",))])
    assert not _build.lib_path("rr_onepass", ("FAIL",)).exists()
    assert not list(_build.BUILD_DIR.glob("*.tmp.*"))


def test_nice_prefixes_the_command(fake_nvcc, monkeypatch):
    seen = []
    real = _build.subprocess.Popen

    def popen(cmd, **kw):
        seen.append(cmd)
        return real(cmd, **kw)

    monkeypatch.setattr(_build.subprocess, "Popen", popen)
    monkeypatch.setattr(_build.shutil, "which",
                        lambda name: "/usr/bin/nice" if name == "nice"
                        else None)
    _build.start(["stripe_merge"], nice=10)
    _build.start(["fanout_max"])
    _build.build(["stripe_merge", "fanout_max"])
    assert seen[0][:3] == ["/usr/bin/nice", "-n", "10"]
    assert seen[0][3:5] == ["sh", "-c"] and seen[1][:2] == ["sh", "-c"]
