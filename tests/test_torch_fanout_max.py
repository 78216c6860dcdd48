"""K1 (``fanout_max_merge``): the port's plain version against the JAX
package's Pallas kernel in interpret mode and its XLA oracle.

* the JAX test grid (``tests/test_merge_pallas.py``: int8/int16/int32
  views drawn in ``[-1, 100)``, (N, F) = (128, 3) and (256, 8)): the plain
  version equals the interpret-mode kernel and the XLA oracle exactly;
* a ragged N (the port takes any N; the TPU kernel takes N % 128 == 0),
  against the XLA oracle;
* the divergence inside the reference below -1: the kernel's max has no
  floor, the oracle's starts at -1.  The port follows the kernel;
* the wrapper runs the plain version for CPU tensors (no launch counted)
  and checks its inputs; the CUDA kernel itself is held against the plain
  version on the card (``test_cuda_kernel_matches_plain``, chip_smoke.py
  phase 18).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.ops.merge_pallas import fanout_max_merge as jax_k1
from gossipfs_tpu.ops.merge_pallas import fanout_max_merge_xla
from gossipfs_tpu_torch.ops import fanout_max as fx
from gossipfs_tpu_torch.ops import merge

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

DTYPES = {"int32": (np.int32, torch.int32), "int16": (np.int16, torch.int16),
          "int8": (np.int8, torch.int8)}


def draw(n: int, fanout: int, dtype, lo: int = -1, hi: int = 100,
         seed: int = 0):
    rng = np.random.default_rng(seed + n + fanout)
    view = rng.integers(lo, hi, (n, n)).astype(dtype)
    edges = rng.integers(0, n, (n, fanout)).astype(np.int32)
    return view, edges


def plain(view: np.ndarray, edges: np.ndarray) -> np.ndarray:
    return fx.fanout_max_merge_plain(torch.from_numpy(view),
                                     torch.from_numpy(edges)).numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,fanout", [(128, 3), (256, 8)])
def test_plain_matches_pallas_interpret_and_xla(n, fanout, dtype):
    view, edges = draw(n, fanout, DTYPES[dtype][0])
    got = plain(view, edges)
    assert got.dtype == view.dtype
    kernel = np.asarray(jax_k1(jnp.asarray(view), jnp.asarray(edges),
                               interpret=True))
    oracle = np.asarray(fanout_max_merge_xla(jnp.asarray(view),
                                             jnp.asarray(edges)))
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ragged_n_matches_xla(dtype):
    """N = 130 (not a multiple of 4 or 128) and F = 5: the element-load
    path of the CUDA kernel, held here in its plain form."""
    view, edges = draw(130, 5, DTYPES[dtype][0])
    oracle = np.asarray(fanout_max_merge_xla(jnp.asarray(view),
                                             jnp.asarray(edges)))
    np.testing.assert_array_equal(plain(view, edges), oracle)


def test_below_minus_one_follows_the_kernel_not_the_oracle():
    """Views below -1 (no gossip view holds one: -1 means absent): where
    every gathered value is below -1 the oracle answers -1, the kernel and
    the port the true max.  A divergence inside the reference, recorded in
    ROADMAP Queue 3."""
    n, fanout = 128, 3
    view, edges = draw(n, fanout, np.int16, lo=-300, hi=-2, seed=5)
    view[: n // 2] = np.abs(view[: n // 2])      # some rows non-negative
    got = plain(view, edges)
    kernel = np.asarray(jax_k1(jnp.asarray(view), jnp.asarray(edges),
                               interpret=True))
    oracle = np.asarray(fanout_max_merge_xla(jnp.asarray(view),
                                             jnp.asarray(edges)))
    np.testing.assert_array_equal(got, kernel)
    differ = got != oracle
    assert differ.any()
    np.testing.assert_array_equal(oracle[differ], -1)
    assert (got[differ] < -1).all()
    np.testing.assert_array_equal(got[~differ], oracle[~differ])


def test_wrapper_runs_plain_on_cpu_and_checks_inputs():
    view, edges = draw(64, 4, np.int8)
    v, e = torch.from_numpy(view), torch.from_numpy(edges)
    merge.reset_launch_counts()
    assert torch.equal(fx.fanout_max_merge(v, e),
                       fx.fanout_max_merge_plain(v, e))
    assert merge.LAUNCH_COUNTS["fanout_max_merge"] == 0
    with pytest.raises(ValueError, match="edges"):
        fx.fanout_max_merge(v, e.long())
    with pytest.raises(ValueError, match="edges"):
        fx.fanout_max_merge(v, e[:, :0].contiguous())
    with pytest.raises(ValueError, match="int8, int16 or int32"):
        fx.fanout_max_merge(v.to(torch.int64), e)
    with pytest.raises(ValueError, match="square"):
        fx.fanout_max_merge(v[:32], e)
    with pytest.raises(ValueError, match="contiguous"):
        fx.fanout_max_merge(v.t(), e)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against the plain version on the card (skips without
    one; chip_smoke.py phase 18 runs the same check at N = 16,384)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    for n, fanout in ((1024, 14), (1030, 5)):
        for np_dt, _ in DTYPES.values():
            view, edges = draw(n, fanout, np_dt)
            v, e = torch.from_numpy(view).cuda(), torch.from_numpy(edges).cuda()
            assert torch.equal(fx.fanout_max_merge(v, e),
                               fx.fanout_max_merge_plain(v, e))
