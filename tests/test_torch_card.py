"""The hand-written CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one.  The file imports
torch and the port only (the card machine has no JAX), so it runs there:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

Inputs come from numpy with a seed; tolerances are the reference's
(tests/test_kernels.py): f32 rtol 1e-4 / atol 8e-4, bf16 2e-2 / 1.6e-1.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import gemm as port_gemm

SHAPES = [(128, 128, 128), (256, 512, 128), (64, 384, 256), (8, 128, 128),
          (256, 256, 1024), (40, 120, 72), (4096, 1024, 2816),
          (4096, 5632, 1024)]
DTYPES = {"float32": (torch.float32, 1e-4), "bfloat16": (torch.bfloat16, 2e-2)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _operands(seed, m, n, k, dev, dtype):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((m, k), np.float32))
            .to(dev, dtype),
            torch.from_numpy(rng.standard_normal((k, n), np.float32))
            .to(dev, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gemm_kernel_matches_plain(dtype):
    dev = _card()
    tdt, tol = DTYPES[dtype]
    before = port_gemm.LAUNCHES
    for i, (m, n, k) in enumerate(SHAPES):
        x, w = _operands(10 + i, m, n, k, dev, tdt)
        for block in (None, (64, 64, 64)):
            got = port_gemm.gemm(x, w, block_shape=block)
            torch.cuda.synchronize()
            assert got.dtype == tdt and tuple(got.shape) == (m, n)
            torch.testing.assert_close(got.float(),
                                       port_gemm.gemm_plain(x, w).float(),
                                       rtol=tol, atol=tol * 8)
    assert port_gemm.LAUNCHES == before + 2 * len(SHAPES)


@pytest.mark.cuda
def test_gemm_kernel_out_dtype_and_refusals():
    dev = _card()
    x, w = _operands(0, 72, 40, 24, dev, torch.float32)
    got = port_gemm.gemm(x, w, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, port_gemm.gemm_plain(x, w,
                                                         torch.bfloat16))
    column_major = x.t().contiguous().t()          # same values, not row-major
    with pytest.raises(ValueError, match="contiguous"):
        port_gemm.gemm(column_major, w)
    with pytest.raises(ValueError):
        port_gemm.gemm(x, w.cpu())
