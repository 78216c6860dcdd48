"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources, so an edited kernel never
loads a stale build.  The build directory (``gossipfs_tpu_torch/_build``)
is listed in .gitignore.  There is no fallback: a missing nvcc or a failed
build raises.

A variant build adds ``-D`` defines to that command, ``load(name,
defines=("RR_STUB=4", ...))``, into a library of its own whose name
hashes the defines too; the default library (no define) is built from
the command above.  The variant sources are K3 (f)'s two libraries,
``rr_onepass`` and ``rr_onepass_wide`` (its blockings): the stripe walk
with stages compiled out (``RR_STUB``, csrc/rr_onepass.cuh) and only the
one instantiation it is timed in (``RR_ONLY_*``, csrc/rr_onepass.cu),
so a variant builds in seconds where the default library instantiates
every form and mode (ops/merge.onepass_defines; python -m
gossipfs_tpu_torch.stub_bisect).

``start`` launches builds and returns at once; ``build`` and ``load``
wait for a build that ``start`` began, so a caller can run work that
needs other kernels while the long builds (K3's) finish.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# C signatures: source name (csrc/<name>.cu) -> function -> (restype,
# argtypes).  Pointers and the stream are c_void_p (a plain int would be
# cut to 32 bits).
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "resident_round": {
        "rr_round": (_I, [_P] * 8 + [_I] * 14 + [_P]),
    },
    "rr_onepass": {
        "rr_onepass": (_I, [_P] * 8 + [_I] * 14 + [_P]),
        "rr_onepass_clusters": (_I, [_I] * 9 + [_P]),
    },
    # the wide blocking: rr_onepass.cu's launcher over Cluster16x16
    "rr_onepass_wide": {
        "rr_onepass": (_I, [_P] * 8 + [_I] * 14 + [_P]),
        "rr_onepass_clusters": (_I, [_I] * 9 + [_P]),
    },
    "fanout_max": {
        "fx_fanout_max": (_I, [_P] * 3 + [_I] * 4 + [_P]),
        "fx_info": (_I, [_I] * 4 + [_P]),
    },
    "fused_merge": {
        "fm_merge": (_I, [_P] * 8 + [_I] * 9 + [_P]),
        "fm_info": (_I, [_I] * 8 + [_P]),
    },
    "stripe_merge": {
        "sm_merge": (_I, [_P] * 8 + [_I] * 9 + [_P]),
        "sm_info": (_I, [_I] * 7 + [_P]),
    },
    "arc_merge": {
        "am_merge": (_I, [_P] * 9 + [_I] * 9 + [_P]),
        "am_info": (_I, [_I] * 8 + [_P]),
    },
}

# loaded libraries and the ptxas report of each build (verbose), by
# source name, or (name, defines) for a variant
_loaded: dict = {}
build_logs: dict = {}
# builds started and not yet waited for: item -> (temporary library, its
# log, the nvcc process, the library path)
_pending: dict = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def lib_path(name: str, defines: tuple = ()) -> Path:
    """The library file of kernel ``name`` built with ``defines``."""
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    if defines:
        h.update(" ".join(defines).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path, verbose: bool,
             defines: tuple = ()) -> list[str]:
    cmd = [nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
           str(out), str(CSRC / f"{name}.cu")]
    return cmd + (["-Xptxas", "-v"] if verbose else [])


def _split(item) -> tuple[str, tuple]:
    """A build item, a source name or (name, defines), as (name,
    defines)."""
    return (item, ()) if isinstance(item, str) else (item[0],
                                                    tuple(item[1]))


def _item(item):
    """A build item in its one key form: the source name, or (name,
    defines) for a variant."""
    src, defines = _split(item)
    return (src, defines) if defines else src


def start(names=None, verbose: bool = False, nice: int = 0) -> dict:
    """Start the named kernels' builds (default: all), one nvcc process per
    source or variant (an item ``(name, defines)``), all together, and
    return at once: item -> library path.  ``build`` and ``load`` wait for
    an item started here instead of starting it again.  ``nice`` > 0 runs
    the compilers under ``nice -n`` so that the caller's own process keeps
    its core while they run."""
    names = list(SIGNATURES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    prefix = []
    if nice and shutil.which("nice"):
        prefix = [shutil.which("nice"), "-n", str(nice)]
    paths = {}
    for name in names:
        src, defines = _split(name)
        out = lib_path(src, defines)
        paths[name] = out
        key = _item(name)
        if out.exists() or key in _pending:
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = tmp.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                prefix + _command(src, tmp, verbose, defines), stdout=fh,
                stderr=subprocess.STDOUT)
        _pending[key] = (tmp, log, proc, out)
    return paths


def build(names=None, verbose: bool = False) -> dict:
    """Compile the named kernels (default: all), one nvcc process per
    source or variant (an item ``(name, defines)``), all started together
    (or earlier, by ``start``), and wait for them.  Returns item ->
    library path."""
    paths = start(names, verbose)
    failed = []
    for name in paths:
        done = _pending.pop(_item(name), None)
        if done is None:
            continue
        tmp, log, proc, out = done
        proc.wait()
        text = log.read_text()
        log.unlink(missing_ok=True)
        build_logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built with ``defines``: a
    variant), building it if needed."""
    item = (name, tuple(defines)) if defines else name
    lib = _loaded.get(item)
    if lib is None:
        lib = ctypes.CDLL(str(build([item])[item]))
        for fn, (res, args) in SIGNATURES[name].items():
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = args
        _loaded[item] = lib
    return lib
