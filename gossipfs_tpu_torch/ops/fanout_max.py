"""K1: the F-way row gather-max ``out[i, :] = max_f view[edges[i, f], :]``.

Port of the TPU kernel ``gossipfs_tpu/ops/merge_pallas.py:
fanout_max_merge`` (:146): each receiver's F sender rows of an int8,
int16 or int32 view, gathered and maxed.  The max has no floor, as the
TPU kernel computes it; the JAX package's XLA oracle
``fanout_max_merge_xla`` starts its max at -1 instead, so the two agree
only where the view is >= -1 (every gossip view is: -1 means absent).

:func:`fanout_max_merge_plain` is the function in plain PyTorch;
:func:`fanout_max_merge` runs it for CPU tensors and launches the CUDA
kernel (``csrc/fanout_max.cu``) for CUDA tensors.  Its gather
(``csrc/gather_ring.cuh``) is K2's: 16 bytes a thread of a 128-byte
column stripe, each receiver's sender segments copied asynchronously into
a ring in shared memory ahead of the fold.

Source note.  Replaces ``fanout_max_merge`` (merge_pallas.py:146).  Bound
on the H100: bytes, the view read once and the output written once
(0.54 GB at N = 16,384 in int8: 0.16 ms at 3.35 TB/s); the kernel reads F
view rows per output row and leans on L2 for them.  Its time and bound
are in PERF.md (from chip_smoke.py).  The port takes any N (no N % 128
admissibility, which is the TPU's lane tiling).
"""

from __future__ import annotations

import torch

from gossipfs_tpu_torch.ops.merge import check_rc, counted_launch

VIEW_DTYPES = (torch.int8, torch.int16, torch.int32)


def fanout_max_merge_plain(view: torch.Tensor,
                           edges: torch.Tensor) -> torch.Tensor:
    """``out[i, :] = max over f of view[edges[i, f], :]``, a new tensor
    like ``view``.  Works in row chunks, so the gathered ``[rows, F, N]``
    block stays ~16M elements at any N."""
    n, fanout = edges.shape
    out = torch.empty_like(view)
    step = max(1, (1 << 24) // max(1, fanout * view.shape[1]))
    for r0 in range(0, n, step):
        e = edges[r0:r0 + step].to(torch.int64)
        out[r0:r0 + step] = view[e].amax(dim=1)
    return out


def _check_inputs(view: torch.Tensor, edges: torch.Tensor) -> None:
    if view.dim() != 2 or view.shape[0] != view.shape[1]:
        raise ValueError(f"fanout_max_merge: view must be square [N, N], "
                         f"got {tuple(view.shape)}")
    n = view.shape[0]
    if view.dtype not in VIEW_DTYPES:
        raise ValueError(f"fanout_max_merge: view must be int8, int16 or "
                         f"int32, got {view.dtype}")
    if (edges.dtype != torch.int32 or edges.dim() != 2
            or edges.shape[0] != n or edges.shape[1] < 1):
        raise ValueError(f"fanout_max_merge: edges must be int32 [{n}, F] "
                         f"with F >= 1, got {edges.dtype} "
                         f"{tuple(edges.shape)}")
    for name, t in (("view", view), ("edges", edges)):
        if not t.is_contiguous():
            raise ValueError(f"fanout_max_merge: {name} must be contiguous")
    if edges.device != view.device:
        raise ValueError(f"fanout_max_merge: edges is on {edges.device}, "
                         f"view on {view.device}")


def fanout_max_merge(view: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """:func:`fanout_max_merge_plain` for CPU tensors, the CUDA kernel for
    CUDA tensors (same contract; ``edges`` in ``[0, N)``)."""
    _check_inputs(view, edges)
    if view.device.type == "cpu":
        return fanout_max_merge_plain(view, edges)
    if view.device.type != "cuda":
        raise ValueError(f"fanout_max_merge: no kernel for {view.device}")
    from gossipfs_tpu_torch.ops import _build

    n, fanout = edges.shape
    lib = _build.load("fanout_max")
    with torch.cuda.device(view.device):
        out = torch.empty_like(view)
        aligned = n % 4 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (view, out))
        stream = torch.cuda.current_stream(view.device)
        with counted_launch("fanout_max_merge", stream):
            check_rc("fanout_max_merge", lib.fx_fanout_max(
                view.data_ptr(), edges.data_ptr(), out.data_ptr(), n, fanout,
                view.element_size(), int(aligned), stream.cuda_stream))
    return out
