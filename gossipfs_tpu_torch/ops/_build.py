"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources, so an edited kernel never
loads a stale build.  The build directory (``gossipfs_tpu_torch/_build``)
is listed in .gitignore.  There is no fallback: a missing nvcc or a failed
build raises.
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

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # ptxas report of each build (verbose)


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


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path, verbose: bool) -> list[str]:
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]
    return cmd + (["-Xptxas", "-v"] if verbose else [])


def build(names=None, verbose: bool = False) -> dict[str, Path]:
    """Compile the named kernels (default: all), one nvcc process per
    source, all started together.  Returns name -> library path."""
    names = list(SIGNATURES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, paths = {}, {}
    for name in names:
        out = _lib_path(name)
        paths[name] = out
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[name] = (tmp, subprocess.Popen(
            _command(name, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, (res, args) in SIGNATURES[name].items():
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = args
        _loaded[name] = lib
    return lib
