"""The port's build of the native C++ engine (``gossipfs_tpu_torch/native.py``).

* ``load_library()`` compiles ``native/{codec,engine}.cc`` with the C++
  compiler itself (no ``make``) into ``gossipfs_tpu_torch/_build/native/``
  and leaves ``native/`` as it was: no new or changed source there;
* a forced rebuild from ``native/`` writes only its output file, through a
  temporary name, and leaves no temporary behind;
* a broken source (shown on a copied source tree) raises
  ``NativeBuildError`` and leaves no library: nothing falls back; the
  compiler is g++ from PATH, whatever ``$CXX`` names;
* the stale rule: a source at or newer than the library asks for a
  rebuild.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess

import pytest

from gossipfs_tpu_torch import native

REPO = pathlib.Path(__file__).resolve().parents[1]
NATIVE = REPO / "native"
# what the JAX package's own build writes into native/ (its tests may run
# at the same time in another worker): not the port's business
JAX_BUILD_OUTPUTS = {"libgossipfs_native.so", "sanitize_tsan",
                     "sanitize_asan"}


def _snapshot() -> dict[str, tuple[int, str]]:
    out = {}
    for p in sorted(NATIVE.iterdir()):
        if p.is_file() and p.name not in JAX_BUILD_OUTPUTS:
            out[p.name] = (p.stat().st_mtime_ns,
                           hashlib.sha256(p.read_bytes()).hexdigest())
    return out


def test_load_library_builds_into_the_port_build_dir():
    before = _snapshot()
    lib = native.load_library()
    assert native._LIB_PATH == \
        REPO / "gossipfs_tpu_torch" / "_build" / "native" / \
        "libgossipfs_native.so"
    assert native._LIB_PATH.is_file()
    assert lib.gfs_cluster_create is not None
    assert not native._stale()
    assert _snapshot() == before
    assert native.codec_decode(native.codec_encode(
        [("127.0.0.1:1", 3, 1.5)])) == [("127.0.0.1:1", 3, 1.5)]


def test_forced_rebuild_uses_the_compiler_not_make(tmp_path, monkeypatch):
    calls = []
    real_run = subprocess.run

    def spy(cmd, *a, **kw):
        calls.append(list(cmd))
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(native.subprocess, "run", spy)
    before = _snapshot()
    out = tmp_path / "out" / "libgossipfs_native.so"
    native._build(NATIVE, out)
    assert out.is_file() and out.stat().st_size > 0
    assert _snapshot() == before
    assert [p.name for p in out.parent.iterdir()] == [out.name]
    (cmd,) = calls
    assert pathlib.Path(cmd[0]).name == "g++"
    assert "make" not in cmd
    assert {"-O2", "-std=c++17", "-fPIC", "-shared", "-pthread"} <= set(cmd)
    assert str(NATIVE / "engine.cc") in cmd


def test_broken_source_raises_and_leaves_no_library(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in ("codec.cc", "codec.h", "engine.cc", "tsa.h"):
        shutil.copy(NATIVE / name, src / name)
    with open(src / "engine.cc", "a") as f:
        f.write("\nthis is not C++;\n")
    out = tmp_path / "out" / "libgossipfs_native.so"
    with pytest.raises(native.NativeBuildError, match="native build failed"):
        native._build(src, out)
    assert not out.exists()
    assert list(out.parent.iterdir()) == []


def test_the_compiler_is_g_plus_plus_from_path(tmp_path, monkeypatch):
    """``$CXX`` is not read (a compiler that links libstdc++ statically
    puts a second copy beside torch's); without g++ on PATH the build
    raises."""
    calls = []

    def fake_run(cmd, *a, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "stopped here")

    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    with pytest.raises(native.NativeBuildError, match="stopped here"):
        native._build(NATIVE, tmp_path / "lib.so")
    assert calls[0][0] == shutil.which("g++")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(native.NativeBuildError, match="needs g\\+\\+"):
        native._build(NATIVE, tmp_path / "lib2.so")


def test_stale_rule_counts_ties(tmp_path, monkeypatch):
    lib = tmp_path / "lib.so"
    monkeypatch.setattr(native, "_LIB_PATH", lib)
    assert native._stale()                 # no library yet
    lib.write_bytes(b"x")
    newest = max(s.stat().st_mtime for s in native._sources())
    os.utime(lib, (newest + 10, newest + 10))
    assert not native._stale()
    os.utime(lib, (newest, newest))        # a tie rebuilds
    assert native._stale()
