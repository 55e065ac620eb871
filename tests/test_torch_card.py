"""The hand-written CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one.  The file imports
torch and the port only (the card machine has no JAX), so it runs there:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

Inputs come from numpy with a seed; tolerances are the reference's
(tests/test_kernels.py): GEMM f32 rtol 1e-4 / atol 8e-4, bf16 2e-2 /
1.6e-1; attention 2e-3 for f32, 3e-2 for bf16.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as port_fa
from repro_torch.kernels import gemm as port_gemm
from repro_torch.kernels.ref import attention_ref

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


ATTN_DTYPES = {"float32": (torch.float32, 2e-3),
               "bfloat16": (torch.bfloat16, 3e-2)}


def _qkv(seed, b, h, hkv, sq, skv, d, dev, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s, np.float32))
                 .to(dev, dtype)
                 for s in ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


def _attn_case(seed, shape, dtype, **kw):
    dev = _card()
    tdt, tol = ATTN_DTYPES[dtype]
    q, k, v = _qkv(seed, *shape, dev, tdt)
    want = attention_ref(q, k, v, **kw).float()
    before = port_fa.LAUNCHES
    for bq, bkv in ((128, 128), (32, 64)):
        got = port_fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv, **kw)
        torch.cuda.synchronize()
        assert got.dtype == tdt and tuple(got.shape) == tuple(q.shape)
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    assert port_fa.LAUNCHES == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(ATTN_DTYPES))
@pytest.mark.parametrize("shape", [
    (1, 4, 4, 128, 128, 64), (2, 8, 2, 128, 128, 64), (1, 4, 1, 256, 256, 32),
    (1, 2, 2, 128, 384, 64), (1, 2, 1, 100, 77, 128), (2, 16, 16, 300, 300, 64)])
def test_flash_attention_kernel_matches_plain(shape, dtype):
    _attn_case(20, shape, dtype, causal=shape[3] == shape[4])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(ATTN_DTYPES))
@pytest.mark.parametrize("window", [32, 128])
def test_flash_attention_kernel_window(window, dtype):
    _attn_case(21, (1, 2, 2, 256, 256, 32), dtype, causal=True,
               window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(ATTN_DTYPES))
@pytest.mark.parametrize("kv_len", [1, 17, 64, 80, 160])
def test_flash_attention_kernel_decode(kv_len, dtype):
    """One query over a cache, masked at kv_len, as decode calls it."""
    _attn_case(22, (8, 16, 16, 1, 160, 64), dtype, causal=False,
               q_offset=kv_len - 1, kv_len=kv_len)
    _attn_case(23, (2, 4, 2, 1, 64, 32), dtype, causal=False,
               q_offset=kv_len - 1, kv_len=min(kv_len, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("q_offset,window", [(48, None), (48, 24), (100, 32)])
def test_flash_attention_kernel_q_offset(q_offset, window):
    """Causal with q[0] at q_offset; (100, 32) leaves every row with no
    visible key, where the kernel averages every key as the plain version
    does."""
    _attn_case(24, (1, 4, 2, 16, 64, 64), "float32", causal=True,
               q_offset=q_offset, window=window)


@pytest.mark.cuda
def test_flash_attention_kernel_strided_inputs_and_refusals():
    dev = _card()
    rng = np.random.default_rng(25)
    x = torch.from_numpy(rng.standard_normal((2, 40, 3, 4, 64), np.float32)
                         ).to(dev)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))  # strided
    got = port_fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, attention_ref(q, k, v), rtol=2e-3,
                               atol=2e-3)
    q96 = torch.zeros((1, 2, 8, 96), device=dev)
    with pytest.raises(ValueError, match="head dim 96"):
        port_fa.flash_attention(q96, q96, q96)
    with pytest.raises(ValueError, match="unit stride"):
        port_fa.flash_attention(q.transpose(2, 3).contiguous()
                                .transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        port_fa.flash_attention(q, k.cpu(), v)
