"""The port's GEMM against the reference Pallas GEMM (interpret mode).

On the CPU the port's wrapper computes its plain version (the CUDA kernel
runs only on the card, where tests/test_torch_card.py and chip_smoke.py
hold it against that plain version).  Inputs are made with numpy from a
seed and handed to both packages; tolerances are the reference's own
(tests/test_kernels.py): f32 rtol 1e-4 / atol 8e-4, bf16 2e-2 / 1.6e-1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gemm import gemm as ref_gemm
from repro.kernels.gemm import pick_block_shape as ref_pick
from repro_torch import resolve_device
from repro_torch.kernels import gemm as port_gemm
from repro_torch.kernels import ops

SHAPES = [(128, 128, 128), (256, 512, 128), (64, 384, 256), (8, 128, 128),
          (256, 256, 1024), (40, 120, 72)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _operands(seed, m, n, k):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gemm_matches_reference(m, n, k, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, w = _operands(0, m, n, k)
    want = ref_gemm(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
                    interpret=True)
    got = port_gemm.gemm(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 8)


@pytest.mark.parametrize("block", [(64, 64, 64), (128, 128, 128),
                                   (32, 128, 256)])
def test_gemm_block_shapes(block):
    """A CrossFlow-chosen block shape must not change the numerics."""
    x, w = _operands(2, 256, 256, 256)
    want = ref_gemm(jnp.asarray(x), jnp.asarray(w), block_shape=block,
                    interpret=True)
    got = port_gemm.gemm(torch.from_numpy(x), torch.from_numpy(w),
                         block_shape=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)
    assert port_gemm.LAST_BLOCK_SHAPE == ref_pick(256, 256, 256, *block)


def test_pick_block_shape_matches_reference():
    rng = np.random.default_rng(3)
    for m, n, k, bm, bn, bk in rng.integers(1, 600, size=(300, 6)):
        args = tuple(int(v) for v in (m, n, k, bm, bn, bk))
        assert port_gemm.pick_block_shape(*args) == ref_pick(*args)


def test_gemm_out_dtype_and_checks():
    x, w = _operands(4, 40, 24, 72)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = port_gemm.gemm(tx, tw, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, port_gemm.gemm_plain(tx, tw,
                                                         torch.bfloat16))
    with pytest.raises(ValueError):
        port_gemm.gemm(tx, tx)                          # inner dims differ
    with pytest.raises(TypeError):
        port_gemm.gemm(tx, tw.to(torch.bfloat16))       # mixed dtypes
    with pytest.raises(TypeError):
        port_gemm.gemm(tx.double(), tw.double())
    with pytest.raises(ValueError):
        port_gemm.gemm(tx[None], tw)
    with pytest.raises(ValueError):
        port_gemm.gemm(tx, tw, block_shape=(0, 64, 64))
    with pytest.raises(ValueError, match="empty"):
        port_gemm.gemm(tx[:0], tw)


def test_launch_counter_stays_zero_on_cpu():
    port_gemm.reset_launches()
    x, w = _operands(5, 64, 64, 64)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    port_gemm.gemm(tx, tw)
    ops.matmul(tx, tw, use_kernel=True)
    assert port_gemm.LAUNCHES == 0
    torch.testing.assert_close(ops.matmul(tx, tw), torch.matmul(tx, tw))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert resolve_device("cpu") == torch.device("cpu")
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(dev)
