"""Multi-process runs of the port on ``torch.distributed``.

The JAX package scales N by sharding the ``[N, N]`` state over a device
mesh (``gossipfs_tpu/parallel/distributed.py``: ``initialize``,
``global_mesh``).  The port runs one process per shard: each rank holds
a column block of the lanes on its own device and the ranks sum their
``[N]`` partial counts over a process group (``parallel/mesh.py``).

Backend: ``nccl`` when each rank has a card of its own, ``gloo`` when
ranks share one card or run on the CPU (the tests).  Each rank's device
is ``cuda:(rank % device_count)`` unless the caller names another
(``"cpu"`` for the tests).  A rank that raises must end the whole run: the
process group carries a finite collective timeout, and :func:`launch`
kills every rank on the first failure.

    from gossipfs_tpu_torch.parallel import distributed, mesh
    distributed.initialize()      # torch's env:// variables, or a no-op
    ctx = mesh.shard_ctx(distributed.global_group(), config.n)

:func:`launch` starts ``world`` ranks of a function on this host (the
entry point ``full_scale.py`` and ``chip_smoke.py`` use it), with a file
rendezvous under the package's gitignored build directory.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a collective that waits longer than this raises on every rank still in it
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def device_for_rank(rank: int, device="cuda") -> torch.device:
    """The rank's device: ``cuda:(rank % device_count)`` for ``"cuda"``
    (raises without a card), else ``device`` as named."""
    if str(device) != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(world: int, device) -> str:
    """``nccl`` when every rank has a card of its own, ``gloo`` when ranks
    share one card or run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, *, backend: str | None = None,
               device="cuda", timeout=COLLECTIVE_TIMEOUT) -> bool:
    """Join the process group of a multi-process run; a no-op (False) for
    a single process.

    The arguments default from torch's standard variables (``WORLD_SIZE``,
    ``RANK``, and ``MASTER_ADDR``/``MASTER_PORT`` for ``env://``).
    ``backend`` defaults from :func:`backend_for` over this rank's device
    (:func:`device_for_rank`, or ``device``).  Returns True when the group
    is up."""
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if world_size is None or world_size <= 1:
        return False
    if init_method is None:
        init_method = "env://"
    kw = {}
    if backend in (None, "nccl"):
        dev = device_for_rank(rank or 0, device)
        backend = backend or backend_for(world_size, dev)
        if backend == "nccl":
            # one card a rank: "cuda" then means this rank's card, and
            # NCCL is told which one
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout, **kw)
    return True


def global_group():
    """The process group over every rank of the run (the JAX package's
    ``global_mesh``), None for a single process."""
    if not dist.is_available() or not dist.is_initialized():
        return None
    return dist.group.WORLD


def _rank_main(rank: int, fn, world: int, init_method: str, device,
               threads, args, out: str) -> None:
    if threads:
        torch.set_num_threads(threads)
    dev = device_for_rank(rank, device)
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        initialize(init_method, world, rank, backend=backend_for(world, dev),
                   device=dev)
        res = fn(rank, world, dev, *args)
        path = os.path.join(out, f"rank{rank}.pt")
        torch.save(res, path + ".tmp")
        os.replace(path + ".tmp", path)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, world: int, args=(), *, timeout: float = 600.0,
           device="cuda", threads: int | None = None) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` fresh processes
    (one rank each, in one process group) and return their results, by
    rank.  ``fn`` must be importable (a module-level function); each
    rank's device is :func:`device_for_rank` (``device="cpu"`` for CPU
    ranks); ``threads`` sets each rank's intra-op threads.  The first
    rank to fail, or ``timeout`` seconds, ends every rank still running
    and raises RuntimeError with the failure's traceback."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="dist-", dir=BUILD_DIR)
    init = f"file://{tmp}/rendezvous"
    ranks = mp.start_processes(
        _rank_main, args=(fn, world, init, device, threads, args, tmp),
        nprocs=world, join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + timeout
        try:
            while not ranks.join(max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"launch of {world} ranks: timed out "
                                       f"after {timeout:.0f} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(f"launch of {world} ranks: a rank failed: "
                               f"{e}") from e
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        for p in ranks.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
