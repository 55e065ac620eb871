"""The hand-written CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one.  The file imports
torch and the port only (the card machine has no JAX), so it runs there:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

Inputs come from numpy with a seed; tolerances are the reference's
(tests/test_kernels.py): GEMM f32 rtol 1e-4 / atol 8e-4, bf16 2e-2 /
1.6e-1; attention 2e-3 for f32, 3e-2 for bf16; mLSTM 3e-3 for f32 and
3e-2 for bf16 (the kernel rounds the weights to bf16 before w.V, as the
TPU kernel does, and the plain version does not: one bf16 rounding).  The
RG-LRU scan takes the plain version's product then sum at every step, on
both of its variants, so it is held to it bit for bit (the TPU kernel's
own test allows 1e-4).

The models on the card are held to the reference's own outputs in
tests/test_torch_golden.npz (written from CPU JAX by
tests/test_torch_golden.py) at tests/test_torch_models.py's tolerances:
1e-4 in float32, 3e-2 of max |logit| in bfloat16.  xlstm-125m, chaotic in
bfloat16, is held to tests/test_torch_golden_xlstm.npz part by part: its
first mLSTM and sLSTM blocks in both dtypes (float32 at 1e-4), its stack's
logits in float32 (2e-4 of max |logit|: `XLSTM_STACK_TOL`), and the TPU
kernel's own bfloat16 output at head dim 192.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import flash_attention as port_fa
from repro_torch.kernels import gemm as port_gemm
from repro_torch.kernels import mlstm as port_mlstm
from repro_torch.kernels import rglru as port_rglru
from repro_torch.kernels.ref import (attention_ref, mlstm_parallel_ref,
                                     rglru_scan_ref)
from repro_torch.models import build_model, common, xlstm
from repro_torch.models.convert import params_from_numpy


def _load_chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_chip_smoke()
golden_weights = CS.golden_weights      # the golden files' numpy weights

SHAPES = [(128, 128, 128), (256, 512, 128), (64, 384, 256), (8, 128, 128),
          (256, 256, 1024), (40, 120, 72), (4096, 1024, 2816),
          (4096, 5632, 1024),
          # ragged edges of the 128 x 128 tile and m < 16; unaligned rows
          # for the 16-byte copies: k % 4 != 0 (f32, bf16), n % 8 != 0
          # (bf16), k % 8 != 0 (bf16 only)
          (33, 65, 31), (1, 1, 1), (17, 9, 129), (96, 64, 70),
          (48, 100, 64), (130, 260, 36)]
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
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("out", list(DTYPES))
def test_gemm_kernel_in_out_dtypes(dtype, out):
    """All four input / output dtype pairs, on aligned and unaligned
    shapes, held at the tolerance of the coarser of the two."""
    dev = _card()
    tdt, odt = DTYPES[dtype][0], DTYPES[out][0]
    tol = max(DTYPES[dtype][1], DTYPES[out][1])
    before = port_gemm.LAUNCHES
    shapes = [(256, 512, 128), (33, 65, 31), (96, 64, 70), (48, 100, 64)]
    for i, (m, n, k) in enumerate(shapes):
        x, w = _operands(40 + i, m, n, k, dev, tdt)
        got = port_gemm.gemm(x, w, out_dtype=odt)
        torch.cuda.synchronize()
        assert got.dtype == odt and tuple(got.shape) == (m, n)
        torch.testing.assert_close(
            got.float(), port_gemm.gemm_plain(x, w, odt).float(),
            rtol=tol, atol=tol * 8)
    assert port_gemm.LAUNCHES == before + len(shapes)


@pytest.mark.cuda
def test_gemm_kernel_f32_error_at_k_2816_is_the_ffma_products():
    """3xTF32 against the float64 product at k = 2816 (the qwen1.5-0.5b
    down projection's depth): within 4x of torch.matmul's error (IEEE f32,
    TF32 off) and inside the reference's f32 tolerance."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w = _operands(50, 256, 1024, 2816, dev, torch.float32)
    want = x.double() @ w.double()
    got = port_gemm.gemm(x, w)
    lib = torch.matmul(x, w)
    torch.cuda.synchronize()
    err = (got.double() - want).abs().max().item()
    lib_err = (lib.double() - want).abs().max().item()
    assert err <= 4 * lib_err, (err, lib_err)
    torch.testing.assert_close(got, want.float(), rtol=1e-4, atol=8e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,n,k", [(96, 128, 64), (33, 65, 31)])
def test_gemm_kernel_inf_and_nan_match_plain(m, n, k, dtype):
    """NaN and +-Inf made by CUDA ops (sqrt of -1, 1 / 0) in A and B, on
    the 16-byte-copy and the element-wise variant: the kernel gives plain's
    NaN and +-Inf at the same places (also where an Inf meets a TF32 value,
    a zero or another Inf) and plain's values everywhere else."""
    dev = _card()
    tdt, tol = DTYPES[dtype]
    x, w = _operands(60, m, n, k, dev, torch.float32)
    nan = torch.sqrt(torch.full((), -1.0, device=dev))
    inf = torch.reciprocal(torch.zeros((), device=dev))
    x[1, 3], x[2, 5], x[3, 7], x[5, 10] = inf, -inf, nan, 0.0
    w[3, 0], w[3, 1], w[3, 2], w[3, 5] = 1.0, 0.0, -2.0, inf
    w[5, 4], w[10, 6], w[11, 8] = -inf, -inf, nan
    x, w = x.to(tdt), w.to(tdt)
    before = port_gemm.LAUNCHES
    got = port_gemm.gemm(x, w).float()
    want = port_gemm.gemm_plain(x, w).float()
    torch.cuda.synchronize()
    assert port_gemm.LAUNCHES == before + 1
    assert want.isnan().any() and want.isinf().any()
    assert torch.equal(got.isnan(), want.isnan())
    inf_at = want.isinf()
    assert torch.equal(got.isinf(), inf_at)
    assert torch.equal(got[inf_at], want[inf_at])
    fin = want.isfinite()
    torch.testing.assert_close(got[fin], want[fin], rtol=tol, atol=tol * 8)


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
@pytest.mark.parametrize("window", [32, 128, 24])
def test_flash_attention_kernel_window(window, dtype):
    """24 puts the window's leading edge inside a 64-key tile."""
    _attn_case(21, (1, 2, 2, 256, 256, 32), dtype, causal=True,
               window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("d", port_fa.HEAD_DIMS)
@pytest.mark.parametrize("sq,skv", [(1, 1), (15, 15), (17, 17), (65, 65),
                                    (100, 77), (300, 300)])
def test_flash_attention_kernel_bf16_ragged_edges(sq, skv, d):
    """bf16 (the tensor-core kernel) at lengths that are no multiple of
    the 16-row warp tile or the 32- / 64-key tile: rows past sq neither
    load nor store, keys past skv count for nothing; causal where square,
    and a window of 24 (no multiple of a tile) inside 64-key tiles."""
    _attn_case(27, (2, 4, 2, sq, skv, d), "bfloat16", causal=sq == skv)
    if sq == skv:
        _attn_case(28, (1, 2, 1, sq, skv, d), "bfloat16", causal=True,
                   window=24)



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
@pytest.mark.parametrize("dtype", list(ATTN_DTYPES))
@pytest.mark.parametrize("q_offset,window", [(48, None), (48, 24), (100, 32)])
def test_flash_attention_kernel_q_offset(q_offset, window, dtype):
    """Causal with q[0] at q_offset; (100, 32) leaves every row with no
    visible key, where the kernel averages every key as the plain version
    does."""
    _attn_case(24, (1, 4, 2, 16, 64, 64), dtype, causal=True,
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
    # bf16 views split off one projection: aligned, not contiguous
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    xb = x.to(torch.bfloat16)
    qs, ks, vs = (xb[:, :, i].transpose(1, 2) for i in range(3))
    assert not qs.is_contiguous() and qs.stride(2) % 8 == 0
    got = port_fa.flash_attention(qs, ks, vs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), attention_ref(qb, kb, vb).float(),
                               rtol=3e-2, atol=3e-2)
    q96 = torch.zeros((1, 2, 8, 96), device=dev)
    with pytest.raises(ValueError, match="head dim 96"):
        port_fa.flash_attention(q96, q96, q96)
    with pytest.raises(ValueError, match="unit stride"):
        port_fa.flash_attention(q.transpose(2, 3).contiguous()
                                .transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        port_fa.flash_attention(q, k.cpu(), v)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_unaligned_bf16():
    """The bf16 kernel's 16-byte copies need 16-byte rows: the wrapper
    raises, naming the stride or the start, and launches nothing."""
    dev = _card()
    x = torch.zeros((1, 2, 40, 72), dtype=torch.bfloat16, device=dev)
    q = x[..., :64]
    assert q.stride(2) == 72
    ok = torch.zeros((1, 2, 40, 64), dtype=torch.bfloat16, device=dev)
    before = port_fa.LAUNCHES
    flat = torch.zeros(2 * 40 * 64 + 4, dtype=torch.bfloat16, device=dev)
    shifted = flat[4:].view(1, 2, 40, 64)      # starts 8 bytes in
    odd = torch.zeros((1, 2, 40, 68), dtype=torch.bfloat16,
                      device=dev)[..., :64]     # seq stride 68
    with pytest.raises(ValueError, match="stride 68"):
        port_fa.flash_attention(odd, ok, ok)
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        port_fa.flash_attention(ok, shifted, ok)
    assert port_fa.LAUNCHES == before
    got = port_fa.flash_attention(q, ok, ok)   # stride 72: aligned
    torch.cuda.synchronize()
    assert port_fa.LAUNCHES == before + 1 and bool(torch.isfinite(
        got.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(ATTN_DTYPES))
@pytest.mark.parametrize("shape,kw", [
    ((1, 10, 1, 300, 300, 256), dict(causal=True)),          # recurrentgemma
    ((2, 4, 1, 256, 256, 256), dict(causal=True, window=64)),
    ((1, 2, 2, 100, 77, 256), dict(causal=False)),
    ((8, 10, 1, 1, 160, 256), dict(causal=False, q_offset=79, kv_len=80)),
    ((1, 4, 2, 16, 64, 256), dict(causal=True, q_offset=48)),
    ((1, 4, 2, 16, 64, 256), dict(causal=True, q_offset=100, window=32)),
    ((2, 20, 2, 77, 77, 256), dict(causal=True)),             # GQA group 10
    ((2, 20, 2, 1, 77, 256), dict(causal=False, q_offset=76)),
])
def test_flash_attention_kernel_head_dim_256(shape, kw, dtype):
    """recurrentgemma-2b's head dim: prefill, window, decode at kv_len,
    q_offset (the sixth case leaves every row with no visible key), and
    recurrentgemma's grouping of ten q heads on one kv head, ragged."""
    _attn_case(26, shape, dtype, **kw)


def _rglru_inputs(seed, batch, seq, width, dev, dtype):
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal((batch, seq, width))))
    b = rng.standard_normal((batch, seq, width))
    h0 = rng.standard_normal((batch, width))
    return tuple(torch.from_numpy(x.astype(np.float32)).to(dev, t)
                 for x, t in ((a, dtype), (b, dtype), (h0, torch.float32)))


def _same_bits(got, want):
    """Bit for bit where ``want`` is a number; NaN where it is NaN (a
    NaN's payload aside)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.masked_fill(nan, 0).view(torch.int32),
                       want.masked_fill(nan, 0).view(torch.int32))


# (batch, seq, width, f32 variant, bf16 variant): the path's prefill and
# phase 6's check; a partial channel block (36, 40); widths the 16-byte
# copies cannot take (37; 100 and 36 in bf16); batch 3; seq shorter than
# one 64-row tile (1, 7) and than the ring's four tiles (100, 130, 200)
RING, ELEM = port_rglru.RING, port_rglru.ELEMENTWISE
RGLRU_SHAPES = [(1, 1, 64, RING, RING), (3, 7, 100, RING, ELEM),
                (2, 2048, 2560, RING, RING), (2, 2047, 2560, RING, RING),
                (1, 333, 37, ELEM, ELEM), (2, 200, 36, RING, ELEM),
                (3, 130, 96, RING, RING), (1, 100, 40, RING, RING)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(ATTN_DTYPES))
@pytest.mark.parametrize("batch,seq,width,f32_variant,bf16_variant",
                         RGLRU_SHAPES)
def test_rglru_scan_kernel_matches_plain(batch, seq, width, f32_variant,
                                         bf16_variant, dtype):
    """Bit for bit the plain version, on either variant, at every
    block_t."""
    dev = _card()
    tdt = ATTN_DTYPES[dtype][0]
    variant = f32_variant if dtype == "float32" else bf16_variant
    a, b, h0 = _rglru_inputs(30, batch, seq, width, dev, tdt)
    want = rglru_scan_ref(a, b, h0)
    before = port_rglru.LAUNCHES
    for block_t in (1, 16, 128):
        got = port_rglru.rglru_scan(a, b, h0, block_t=block_t)
        torch.cuda.synchronize()
        assert port_rglru.LAST_VARIANT == variant
        assert got.dtype == torch.float32 and got.shape == a.shape
        _same_bits(got, want)
    assert port_rglru.LAUNCHES == before + 3
    got = port_rglru.rglru_scan(a, b, h0.to(tdt))        # h0 in a's dtype
    torch.cuda.synchronize()
    _same_bits(got, rglru_scan_ref(a, b, h0.to(tdt)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(ATTN_DTYPES))
@pytest.mark.parametrize("width", [96, 99])
def test_rglru_scan_kernel_non_finite_inputs(width, dtype):
    """A NaN or Inf in a or b at one step gives plain's non-finite
    positions, in that channel from that step on, on either variant."""
    dev = _card()
    tdt = ATTN_DTYPES[dtype][0]
    a, b, h0 = _rglru_inputs(31, 2, 150, width, dev, tdt)
    a[0, 5, 3] = float("nan")
    b[0, 9, 40] = float("inf")
    a[1, 20, 70] = float("inf")
    b[1, 64, 90] = float("-inf")
    want = rglru_scan_ref(a, b, h0)
    got = port_rglru.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    per_copy = 16 // a.element_size()
    assert port_rglru.LAST_VARIANT == (RING if width % per_copy == 0
                                       else ELEM)
    _same_bits(got, want)
    for n, t, c in ((0, 5, 3), (0, 9, 40), (1, 20, 70), (1, 64, 90)):
        assert bool(torch.isfinite(got[n, :t, c]).all())
        assert not bool(torch.isfinite(got[n, t:, c]).any())
    assert int((~torch.isfinite(got)).sum()) == int(
        (~torch.isfinite(want)).sum())


@pytest.mark.cuda
def test_rglru_scan_kernel_unaligned_inputs_take_elementwise():
    """a and b that do not start 16-byte aligned take the element-wise
    kernel; the C entry refuses the ring for them, and for a width that
    is no whole number of 16-byte copies."""
    dev = _card()
    a, b, h0 = _rglru_inputs(32, 2, 70, 64, dev, torch.float32)
    flat = torch.empty(2 * a.numel() + 2, device=dev)
    ua = flat[1:1 + a.numel()].view(a.shape)
    ub = flat[2 + a.numel():].view(b.shape)
    ua.copy_(a)
    ub.copy_(b)
    assert port_rglru.kernel_variant(ua, ub) == ELEM
    got = port_rglru.rglru_scan(ua, ub, h0)
    torch.cuda.synchronize()
    assert port_rglru.LAST_VARIANT == ELEM
    _same_bits(got, rglru_scan_ref(a, b, h0))
    lib = port_rglru._lib()
    out = torch.empty_like(got)
    stream = torch.cuda.current_stream().cuda_stream
    for x, y, width in ((ua, ub, 64), (a, b, 62)):
        rc = lib.repro_rglru_scan(x.data_ptr(), y.data_ptr(), h0.data_ptr(),
                                  out.data_ptr(), 2, 70, width, 0, 1, stream)
        assert rc != 0


@pytest.mark.cuda
def test_rglru_scan_kernel_decay_and_refusals():
    dev = _card()
    a = torch.full((1, 64, 16), 0.9, device=dev)
    h = port_rglru.rglru_scan(a, torch.zeros_like(a),
                              torch.ones((1, 16), device=dev))[0]
    norms = torch.linalg.vector_norm(h, dim=-1).cpu().numpy()
    assert np.all(np.diff(norms) < 0)
    with pytest.raises(ValueError, match="contiguous"):
        port_rglru.rglru_scan(a.expand(2, 64, 16), a.expand(2, 64, 16),
                              torch.zeros((2, 16), device=dev))
    with pytest.raises(ValueError):
        port_rglru.rglru_scan(a, a, torch.zeros((1, 16)))
    with pytest.raises(TypeError):
        port_rglru.rglru_scan(a, a.to(torch.bfloat16),
                              torch.zeros((1, 16), device=dev))
    with pytest.raises(ValueError, match="block_t"):
        port_rglru.rglru_scan(a, a, torch.zeros((1, 16), device=dev),
                              block_t=0)


MLSTM_DTYPES = {"float32": (torch.float32, 3e-3),
                "bfloat16": (torch.bfloat16, 3e-2)}


def _mlstm_inputs(seed, b, h, s, d, dev, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d),
                                                    np.float32)).to(dev, dtype)
               for _ in range(3))
    f = rng.standard_normal((b, h, s)).astype(np.float32) + 1.0
    log_f = torch.nn.functional.logsigmoid(torch.from_numpy(f))
    log_i = torch.from_numpy(rng.standard_normal((b, h, s))
                             .astype(np.float32)) * 0.3
    return q, k, v, torch.cumsum(log_f, -1).to(dev), log_i.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(MLSTM_DTYPES))
@pytest.mark.parametrize("b,h,s,d", [
    (1, 2, 128, 64), (2, 4, 256, 32), (1, 2, 1, 32), (2, 4, 100, 192),
    (2, 4, 2048, 192), (1, 1, 77, 128),
    # every head dim at lengths that are no multiple of the 16-row warp
    # tile, the 64-row q tile or the 64-key kv tile
    *((2, 3, s, d) for d in port_mlstm.HEAD_DIMS for s in (15, 65, 200)),
    (1, 2, 2047, 192)])
def test_mlstm_kernel_matches_plain(b, h, s, d, dtype):
    dev = _card()
    tdt, tol = MLSTM_DTYPES[dtype]
    q, k, v, f_cum, log_i = _mlstm_inputs(40, b, h, s, d, dev, tdt)
    want = mlstm_parallel_ref(q, k, v, f_cum, log_i).float()
    before = port_mlstm.LAUNCHES
    for bq, bkv in ((128, 128), (32, 64)):
        got = port_mlstm.mlstm_parallel(q, k, v, f_cum, log_i, block_q=bq,
                                        block_kv=bkv)
        torch.cuda.synchronize()
        assert got.dtype == tdt and tuple(got.shape) == tuple(q.shape)
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    assert port_mlstm.LAUNCHES == before + 2


@pytest.mark.cuda
def test_mlstm_kernel_strided_inputs_and_refusals():
    """q, k, v as the block makes them (heads split off a (b, s, h*d)
    projection) and f_cum / log_i transposed from (b, s, h)."""
    dev = _card()
    rng = np.random.default_rng(41)
    x = torch.from_numpy(rng.standard_normal((2, 90, 3, 4, 64), np.float32)
                         ).to(dev)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    g = torch.from_numpy(rng.standard_normal((2, 90, 4), np.float32)).to(dev)
    f_cum = torch.cumsum(torch.nn.functional.logsigmoid(g + 1).transpose(1, 2),
                         -1)
    log_i = (0.3 * g).transpose(1, 2)
    got = port_mlstm.mlstm_parallel(q, k, v, f_cum, log_i)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, mlstm_parallel_ref(q, k, v, f_cum, log_i),
                               rtol=3e-3, atol=3e-3)
    q96 = torch.zeros((1, 2, 8, 96), device=dev)
    z = torch.zeros((1, 2, 8), device=dev)
    with pytest.raises(ValueError, match="head dim 96"):
        port_mlstm.mlstm_parallel(q96, q96, q96, z, z)
    with pytest.raises(ValueError, match="unit stride"):
        port_mlstm.mlstm_parallel(q.transpose(2, 3).contiguous()
                                  .transpose(2, 3), k, v, f_cum, log_i)
    with pytest.raises(ValueError):
        port_mlstm.mlstm_parallel(q, k, v.cpu(), f_cum, log_i)
    # bf16 as xlstm-125m's block makes them: heads of 192 split off three
    # (b, s, 768) projections (aligned, not contiguous)
    xb = [torch.from_numpy(rng.standard_normal((2, 90, 768), np.float32))
          .to(dev, torch.bfloat16) for _ in range(3)]
    qb, kb, vb = (t.reshape(2, 90, 4, 192).transpose(1, 2) for t in xb)
    assert not qb.is_contiguous() and qb.stride(2) == 768
    got = port_mlstm.mlstm_parallel(qb, kb, vb, f_cum, log_i)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), mlstm_parallel_ref(qb, kb, vb, f_cum, log_i).float(),
        rtol=3e-2, atol=3e-2)


@pytest.mark.cuda
def test_mlstm_kernel_refuses_unaligned_bf16():
    """The bf16 kernel's 16-byte copies need 16-byte rows: the wrapper
    raises, naming the stride or the start, and launches nothing."""
    dev = _card()
    z = torch.zeros((1, 2, 40), device=dev)
    ok = torch.zeros((1, 2, 40, 64), dtype=torch.bfloat16, device=dev)
    flat = torch.zeros(2 * 40 * 64 + 4, dtype=torch.bfloat16, device=dev)
    shifted = flat[4:].view(1, 2, 40, 64)      # starts 8 bytes in
    odd = torch.zeros((1, 2, 40, 68), dtype=torch.bfloat16,
                      device=dev)[..., :64]     # seq stride 68
    wide = torch.zeros((1, 2, 40, 72), dtype=torch.bfloat16,
                       device=dev)[..., :64]    # seq stride 72: aligned
    before = port_mlstm.LAUNCHES
    with pytest.raises(ValueError, match="stride 68"):
        port_mlstm.mlstm_parallel(ok, odd, ok, z, z)
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        port_mlstm.mlstm_parallel(ok, ok, shifted, z, z)
    assert port_mlstm.LAUNCHES == before
    got = port_mlstm.mlstm_parallel(wide, ok, ok, z, z)
    torch.cuda.synchronize()
    assert port_mlstm.LAUNCHES == before + 1 and bool(torch.isfinite(
        got.float()).all())


def _poisoned(seed, d, dev, dtype, which, row, value):
    """(1, 2, 200, d) inputs with ``value`` (NaN or Inf, made by CUDA ops)
    in one element of row ``row`` of head 0's q or k."""
    q, k, v, f_cum, log_i = _mlstm_inputs(seed, 1, 2, 200, d, dev,
                                          torch.float32)
    bad = {"nan": torch.sqrt(torch.full((), -1.0, device=dev)),
           "inf": torch.reciprocal(torch.zeros((), device=dev))}[value]
    (q if which == "q" else k)[0, 0, row, 3] = bad
    return (*(t.to(dtype) for t in (q, k, v)), f_cum, log_i)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(MLSTM_DTYPES))
@pytest.mark.parametrize("d", [64, 192])
@pytest.mark.parametrize("which,row", [("q", 70), ("k", 5)])
@pytest.mark.parametrize("value", ["nan", "inf"])
def test_mlstm_kernel_nan_and_inf_match_plain(value, which, row, d, dtype):
    """NaN or Inf in one q row (that row only is non-finite) or in one k
    row of the first kv tile (every row of the head: a masked entry is
    S * 0, as in plain): the kernel's non-finite outputs are plain's, and
    its finite ones are plain's within the tolerance."""
    dev = _card()
    tdt, tol = MLSTM_DTYPES[dtype]
    ins = _poisoned(42, d, dev, tdt, which, row, value)
    want = mlstm_parallel_ref(*ins).float()
    got = port_mlstm.mlstm_parallel(*ins).float()
    torch.cuda.synchronize()
    odd = ~want.isfinite()
    assert bool(odd.any()) and bool(want[0, 1].isfinite().all())
    assert torch.equal(~got.isfinite(), odd)
    torch.testing.assert_close(got[~odd], want[~odd], rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(MLSTM_DTYPES))
@pytest.mark.parametrize("d", [64, 192])
def test_mlstm_kernel_nan_key_past_the_first_tile(d, dtype):
    """Where the kernel and plain part: a NaN key j = 150 poisons every
    row in plain (0 * NaN above the diagonal), in the kernel only the rows
    whose walk reaches j's kv tile (the 64-row q tiles from row 128 on);
    the rows before skip that tile and are plain's output with key j
    zeroed (which they never see)."""
    dev = _card()
    tdt, tol = MLSTM_DTYPES[dtype]
    ins = _poisoned(43, d, dev, tdt, "k", 150, "nan")
    assert bool(mlstm_parallel_ref(*ins)[0, 0].isnan().all())
    got = port_mlstm.mlstm_parallel(*ins).float()
    torch.cuda.synchronize()
    assert bool(got[0, 0, 128:].isnan().all())
    k = ins[1].clone()
    k[0, 0, 150] = 0
    want = mlstm_parallel_ref(ins[0], k, *ins[2:]).float()
    torch.testing.assert_close(got[0, 0, :128], want[0, 0, :128], rtol=tol,
                               atol=tol)
    torch.testing.assert_close(got[0, 1], want[0, 1], rtol=tol, atol=tol)


KERNEL_CALLS = {    # name -> (wrapper module, inputs on a device -> call)
    "gemm": (port_gemm, lambda dev: (
        port_gemm.gemm, _operands(50, 64, 32, 16, dev, torch.float32))),
    "flash_attention": (port_fa, lambda dev: (
        port_fa.flash_attention,
        _qkv(51, 1, 2, 2, 16, 16, 32, dev, torch.bfloat16))),
    "rglru_scan": (port_rglru, lambda dev: (
        port_rglru.rglru_scan,
        _rglru_inputs(52, 1, 8, 16, dev, torch.float32))),
    "mlstm_parallel": (port_mlstm, lambda dev: (
        port_mlstm.mlstm_parallel,
        _mlstm_inputs(53, 1, 2, 16, 32, dev, torch.float32))),
}


GRAD_CASES = {      # name -> cases on the card (shapes as _qkv etc. take)
    "flash_attention": [
        ((1, 4, 4, 128, 128, 64), dict(causal=True)),
        ((2, 8, 2, 128, 128, 64), dict(causal=True)),
        ((1, 2, 2, 256, 256, 32), dict(causal=True, window=32)),
        ((1, 2, 1, 100, 77, 128), dict(causal=False)),
        ((2, 4, 2, 1, 64, 32), dict(causal=False, q_offset=16, kv_len=17)),
        ((2, 4, 1, 256, 256, 256), dict(causal=True, window=64))],
    "rglru_scan": [(1, 128, 64), (3, 96, 32), (2, 7, 37), (1, 100, 40)],
    "mlstm_parallel": [(1, 2, 128, 64), (2, 4, 100, 192), (1, 1, 77, 128),
                       (2, 3, 65, 32)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_kernel_refuses_inputs_that_require_grad(name, dtype):
    """Attention, the scan and the mLSTM are autograd Functions on the
    card: a CUDA input that requires grad launches the forward kernel (the
    scan's backward launches it again, reversed), the forward is the
    kernel's and the gradients are autograd's through the plain version
    (``chip_smoke.function_grads``: float32 within 1e-5, bfloat16 within
    1e-2 of max |gradient|); the GEMM, which has no backward, still
    refuses such an input and launches nothing."""
    dev = _card()
    tdt = getattr(torch, dtype)
    for i, case in enumerate(GRAD_CASES[name]):
        if name == "flash_attention":
            args, kw = _qkv(60 + i, *case[0], dev, tdt), case[1]
        elif name == "rglru_scan":
            args, kw = _rglru_inputs(60 + i, *case, dev, tdt), {}
        else:
            args, kw = _mlstm_inputs(60 + i, *case, dev, tdt), {}
        launches, _ = CS.function_grads(name, args, kw, seed=i)
        assert launches == CS.GRAD_LAUNCHES[name], (case, launches)
    mod, make = KERNEL_CALLS["gemm"]
    fn, args = make(dev)
    args[0].requires_grad_(True)
    before = mod.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward yet"):
        fn(*args)
    assert mod.LAUNCHES == before
    with torch.no_grad():
        out = fn(*args)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 1 and not out.requires_grad
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "recurrentgemma-2b",
                                  "xlstm-125m"])
def test_card_training_matches_the_golden_training_file(arch):
    """Five AdamW steps of the reduced model in float32 on the card,
    through the kernels' autograd Functions, on the file's batches,
    against the reference's losses and first-step gradient norms in
    tests/test_torch_golden_train.npz (``chip_smoke.TRAIN_GOLDEN_TOLS``)."""
    dev = _card()
    with np.load(CS.GOLDEN_TRAIN) as f:
        golden = dict(f)
    before = port_fa.LAUNCHES + port_rglru.LAUNCHES + port_mlstm.LAUNCHES
    got = CS.train_golden_port(arch, dev, batches=tuple(
        golden[f"{arch}/{key}"] for key in ("tokens", "labels")))
    assert port_fa.LAUNCHES + port_rglru.LAUNCHES + port_mlstm.LAUNCHES \
        > before
    CS.hold_to_train_golden(got, golden, arch)


@pytest.mark.cuda
def test_card_mesh_path_matches_the_golden_training_file():
    """The mesh path on the card: a process group at world size 1 (NCCL),
    a 1x1 ``DeviceMesh``, and five AdamW steps of the reduced
    qwen1.5-0.5b in float32 with DTensor parameters, moments and batches
    (the attention kernel on each rank's shards), against the reference's
    losses and gradient norms in tests/test_torch_golden_train.npz
    (``chip_smoke.TRAIN_GOLDEN_TOLS``)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    dev = _card()
    arch = "qwen1.5-0.5b"
    with np.load(CS.GOLDEN_TRAIN) as f:
        golden = dict(f)
    mesh_lib.init_distributed(dev)
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        mesh = mesh_lib.make_mesh((1, 1), device=dev)
        before = port_fa.LAUNCHES
        got = CS.train_golden_port(arch, dev, batches=tuple(
            golden[f"{arch}/{key}"] for key in ("tokens", "labels")),
            mesh=mesh)
        assert port_fa.LAUNCHES > before
    finally:
        dist.destroy_process_group()
    CS.hold_to_train_golden(got, golden, arch)


GOLDEN = Path(__file__).with_name("test_torch_golden.npz")
GOLDEN_ARCHS = ("qwen1.5-0.5b", "recurrentgemma-2b")
GOLDEN_BATCH, GOLDEN_PROMPT, GOLDEN_STEPS = 2, 40, 8


def golden_tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, vocab, (GOLDEN_BATCH, GOLDEN_PROMPT + GOLDEN_STEPS)
    ).astype(np.int32)


def port_golden_outputs(arch: str, dtype: str, device) -> dict:
    """The port's logits on ``device`` for what the golden file holds: a
    forward over the prompt into fresh caches, then the decode steps."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    model = build_model(cfg, device)
    params = params_from_numpy(golden_weights(model.defs), device)
    toks = torch.from_numpy(golden_tokens(cfg.vocab_size)).to(device)
    n, steps = GOLDEN_PROMPT, []
    with torch.no_grad():
        logits, caches, _ = model.forward(
            params, {"tokens": toks[:, :n]},
            caches=model.init_cache(GOLDEN_BATCH, n + GOLDEN_STEPS))
        for t in range(n, n + GOLDEN_STEPS):
            step, caches = model.decode_step(params, caches,
                                             toks[:, t:t + 1], t)
            steps.append(step[:, 0])
    v = cfg.vocab_size
    return {"prefill": logits[..., :v].float().cpu().numpy(),
            "steps": torch.stack(steps)[..., :v].float().cpu().numpy()}


def hold_to_golden(got: dict, golden, arch: str, dtype: str) -> None:
    """tests/test_torch_models.py's tolerances: 1e-4 in float32, 3e-2 of
    max |logit| in bfloat16."""
    for key, val in got.items():
        want = golden[f"{arch}/{dtype}/{key}"]
        assert val.shape == want.shape, (key, val.shape, want.shape)
        if dtype == "float32":
            np.testing.assert_allclose(val, want, rtol=1e-4, atol=1e-4)
        else:
            err = np.abs(val - want).max()
            assert err <= 3e-2 * np.abs(want).max(), (key, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", GOLDEN_ARCHS)
def test_card_matches_the_references_golden_outputs(arch, dtype):
    """The reduced model on the card, through the attention kernel (and,
    for recurrentgemma, the scan kernel), against the reference's own
    logits."""
    dev = _card()
    before = port_fa.LAUNCHES
    got = port_golden_outputs(arch, dtype, dev)
    assert port_fa.LAUNCHES > before
    with np.load(GOLDEN) as golden:
        hold_to_golden(got, golden, arch, dtype)


GOLDEN_XLSTM = Path(__file__).with_name("test_torch_golden_xlstm.npz")
XLSTM = "xlstm-125m"
XLSTM_PARTS = ("mlstm", "slstm", "stack", "kernel")
# the blocks' input: 100 positions cross the kernel's 64-key tile at the
# reduced head dim 32, raggedly; the TPU kernel's: the full head dim 192,
# 200 positions against the 64-row q and 64-key kv tiles
XLSTM_BLOCK_SEQ = 100
XLSTM_KERNEL_SHAPE = (1, 2, 200, 192)


def xlstm_block_input(d_model: int) -> np.ndarray:
    return np.random.default_rng(0).standard_normal(
        (GOLDEN_BATCH, XLSTM_BLOCK_SEQ, d_model)).astype(np.float32)


def xlstm_kernel_inputs():
    """q, k, v, f_cum, log_i as float32 numpy (q, k, v go in as
    bfloat16), made as tests/test_torch_scan_kernels.py makes them."""
    rng = np.random.default_rng(0)
    b, h, s, d = XLSTM_KERNEL_SHAPE
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    f = rng.standard_normal((b, h, s)).astype(np.float32) + 1.0
    log_f = -np.logaddexp(0.0, -f).astype(np.float32)        # log sigmoid
    log_i = (rng.standard_normal((b, h, s)) * 0.3).astype(np.float32)
    return q, k, v, np.cumsum(log_f, axis=-1).astype(np.float32), log_i


def first_block(group: dict, kind: str):
    """The parameters of a layer group's first block of ``kind``."""
    j = min(int(key[1:]) for key, blk in group.items() if kind in blk)
    return group[f"b{j}"][kind]


def port_xlstm_golden_outputs(part: str, device) -> dict:
    """The port's outputs on ``device`` for one part of the xlstm golden
    file (`XLSTM_PARTS`), by the file's keys."""
    if part == "stack":
        return {f"stack/float32/{key}": val for key, val in
                port_golden_outputs(XLSTM, "float32", device).items()}
    if part == "kernel":
        q, k, v, f_cum, log_i = (torch.from_numpy(x).to(device)
                                 for x in xlstm_kernel_inputs())
        out = port_mlstm.mlstm_parallel(*(t.to(torch.bfloat16)
                                          for t in (q, k, v)), f_cum, log_i)
        return {"kernel/bfloat16": out.float().cpu().numpy()}
    apply = {"mlstm": xlstm.mlstm_apply, "slstm": xlstm.slstm_apply}[part]
    got = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(reduced(get_config(XLSTM)), dtype=dtype)
        params = params_from_numpy(
            golden_weights(build_model(cfg, device).defs), device)
        p = first_block(common.tree_index(params["groups"], 0), part)
        x = torch.from_numpy(xlstm_block_input(cfg.d_model)).to(
            device, getattr(torch, dtype))
        with torch.no_grad():
            got[f"{part}/{dtype}"] = apply(p, x, cfg).float().cpu().numpy()
    return got


# The reduced stack amplifies float32 summation-order differences: half an
# ulp on every weight moves the reference's own logits by 3.6e-5 of max
# |logit| (test_torch_golden.py::
# test_xlstm_f32_stack_noise_is_the_references_own), and on an H100 one
# logit of 40,960 lay 1.07e-4 from the file, with the mLSTM kernel or its
# plain version alike.  So the stack is held to 2e-4 of max |logit|, the
# blocks to 1e-4.
XLSTM_STACK_TOL = 2e-4


def hold_to_xlstm_golden(got: dict, golden) -> None:
    """The stack's float32 logits to `XLSTM_STACK_TOL` of max |logit|; the
    blocks in float32 to 1e-4 (rtol and atol); bfloat16 to 3e-2 of max
    |value|."""
    for key, val in got.items():
        want = golden[key]
        assert val.shape == want.shape, (key, val.shape, want.shape)
        if key.startswith("stack/"):
            err = np.abs(val - want).max()
            assert err <= XLSTM_STACK_TOL * np.abs(want).max(), (key, err)
        elif "float32" in key:
            np.testing.assert_allclose(val, want, rtol=1e-4, atol=1e-4,
                                       err_msg=key)
        else:
            err = np.abs(val - want).max()
            assert err <= 3e-2 * np.abs(want).max(), (key, err)


@pytest.mark.cuda
@pytest.mark.parametrize("part", XLSTM_PARTS)
def test_card_matches_the_xlstm_golden_outputs(part):
    """The reduced xlstm-125m on the card against the reference's own
    outputs: the first mLSTM block (through the bf16 tensor-core kernel and
    the f32 FFMA one) and sLSTM block in both dtypes, the stack's f32
    logits, and the bf16 kernel against the TPU kernel at head dim 192."""
    dev = _card()
    before = port_mlstm.LAUNCHES
    got = port_xlstm_golden_outputs(part, dev)
    assert (port_mlstm.LAUNCHES > before) == (part != "slstm")
    with np.load(GOLDEN_XLSTM) as golden:
        hold_to_xlstm_golden(got, golden)


GOLDEN_RUNNER = Path(__file__).with_name("test_torch_golden_runner.jsonl")


@pytest.mark.cuda
def test_card_runner_records_match_the_golden_records(tmp_path):
    """``pathfind sweep --out DIR`` on the card over the golden file's grid
    (chip_smoke.py's phase-4 (d) axes on its golden archs), every scenario:
    labels, keys, flags and the non-finite pattern exactly the reference's
    records in tests/test_torch_golden_runner.jsonl, numbers within
    1e-4."""
    import json
    _card()
    golden = {}
    for line in GOLDEN_RUNNER.read_text().splitlines():
        rec = json.loads(line)
        golden.setdefault(rec.pop("scenario"), []).append(rec)
    runner = dict(CS.RUNNER, arches=CS.RUNNER["golden_arches"])
    assert list(golden) == list(runner["scenarios"])
    for scenario, want in golden.items():
        d = tmp_path / scenario
        CS._cli(CS.runner_argv(scenario, runner) + ["--out", d, "--device",
                                                    "cuda"])
        got = [{k: v for k, v in r.items() if k != "chunk"}
               for r in CS._jsonl(d / "results.jsonl")]
        assert CS._held_records(got, want, scenario) > 0


@pytest.mark.cuda
def test_card_pipeline_records_match_the_golden_records(tmp_path):
    """The golden file's grid on the card through each executor: the
    pipeline (superbatches of one chunk) and the serial backend hold their
    records to the reference's in tests/test_torch_golden_runner.jsonl
    (1e-4) and write the same ``spec.json`` and ``checkpoint.jsonl``
    bytes; ``--frontier-only`` writes exactly the keys of the golden
    records' `pareto_records`, nothing overflowed."""
    import json
    from repro_torch.core import sweeprunner
    _card()
    golden = {}
    for line in GOLDEN_RUNNER.read_text().splitlines():
        rec = json.loads(line)
        golden.setdefault(rec.pop("scenario"), []).append(rec)
    runner = dict(CS.RUNNER, arches=CS.RUNNER["golden_arches"])
    for scenario, want in golden.items():
        argv = CS.runner_argv(scenario, runner) + ["--device", "cuda"]
        dirs = {}
        for backend in ("pipeline", "serial"):
            d = dirs[backend] = tmp_path / f"{scenario}-{backend}"
            CS._cli(argv + ["--out", d, "--backend", backend,
                            "--superbatch", 8])
            got = [{k: v for k, v in r.items() if k != "chunk"}
                   for r in CS._jsonl(d / "results.jsonl")]
            assert CS._held_records(got, want, (scenario, backend)) > 0
        for name in ("spec.json", "checkpoint.jsonl"):
            assert (dirs["pipeline"] / name).read_bytes() == \
                (dirs["serial"] / name).read_bytes(), (scenario, name)
        d = tmp_path / f"{scenario}-frontier"
        _, _, err, _ = CS._cli(argv + ["--out", d, "--frontier-only"])
        assert "overflowed" not in err
        spec, _ = sweeprunner.load_sweep(str(dirs["pipeline"]))
        objectives = spec.scenario_spec.variants()[0].resolve().objectives
        assert sorted(r["key"] for r in CS._jsonl(d / "frontier.jsonl")) \
            == sorted(r["key"] for r in sweeprunner.pareto_records(
                want, objectives))


GOLDEN_SOE = Path(__file__).with_name("test_torch_golden_soe.json")


@pytest.mark.cuda
def test_card_soe_objectives_match_the_golden_file():
    """The SOE's and the refinement's objectives on the card at the points
    of tests/test_torch_golden_soe.json (the reference's own values and
    gradients), through one vmap of grad_and_value each, and its
    three-step batched descent: values within 1e-4 relative, gradients
    within 1e-3 of their norm, iterates within 1e-4
    (``chip_smoke.SOE_TOLS``)."""
    import json
    dev = _card()
    golden = json.loads(GOLDEN_SOE.read_text())
    got = CS.soe_golden_port(golden, dev)
    assert CS.hold_to_soe_golden(got, golden, CS.SOE_TOLS) == 504
