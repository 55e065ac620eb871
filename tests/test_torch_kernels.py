"""The port's GEMM against the reference Pallas GEMM (interpret mode).

On the CPU the port's wrapper computes its plain version (the CUDA kernel
runs only on the card, where tests/test_torch_card.py and chip_smoke.py
hold it against that plain version).  Inputs are made with numpy from a
seed and handed to both packages; tolerances are the reference's own
(tests/test_kernels.py): f32 rtol 1e-4 / atol 8e-4, bf16 2e-2 / 1.6e-1.
"""

import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gemm import gemm as ref_gemm
from repro.kernels.gemm import pick_block_shape as ref_pick
from repro_torch import resolve_device
from repro_torch.kernels import build
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


def _tf32_rna(x):
    """float32 -> TF32 (10 mantissa bits), round to nearest, ties away from
    zero, as cvt.rna.tf32.f32: add half a unit of the 13 bits dropped to
    the magnitude, then clear them; Inf and NaN stay as they are."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def _bits(*words):
    return torch.tensor(words, dtype=torch.int64).to(torch.int32) \
        .view(torch.float32)


def _kernel_split(x):
    """csrc/gemm.cu's split_tf32: x = hi + lo, hi = tf32(x), lo = tf32(x -
    hi); where x is Inf or NaN or rounds past FLT_MAX, hi = +-1 and lo =
    x - hi, unrounded."""
    big = ~(x.abs() < _bits(0x7F7FF000))
    sign = torch.where(x.view(torch.int32) < 0, -1.0, 1.0)
    hi = torch.where(big, sign, _tf32_rna(x))
    rest = x - hi
    return hi, torch.where(big, rest, _tf32_rna(rest))


def _3xtf32(x, w):
    """The kernel's f32 product, emulated: lo.hi + hi.lo + hi.hi in f32."""
    (x_hi, x_lo), (w_hi, w_lo) = _kernel_split(x), _kernel_split(w)
    return x_lo @ w_hi + x_hi @ w_lo + x_hi @ w_hi


def test_3xtf32_split_meets_the_reference_f32_tolerance():
    """Why the kernel takes three TF32 products for f32 inputs: emulated on
    the CPU, hi.hi + hi.lo + lo.hi (hi = tf32(x), lo = tf32(x - hi)),
    summed in f32, passes the reference's f32 tolerance against the
    reference GEMM at k = 2816; one TF32 product does not."""
    x, w = _operands(6, 256, 256, 2816)
    want = np.asarray(ref_gemm(jnp.asarray(x), jnp.asarray(w),
                               interpret=True), np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for t in (*_kernel_split(tx), *_kernel_split(tw)):   # 10 mantissa bits
        assert not (t.view(torch.int32) & 0x1FFF).any()
    np.testing.assert_allclose(_3xtf32(tx, tw).numpy(), want, rtol=1e-4,
                               atol=8e-4)
    one = (_tf32_rna(tx) @ _tf32_rna(tw)).numpy()
    assert not np.allclose(one, want, rtol=1e-4, atol=8e-4)


@pytest.mark.parametrize("m,n,k", [(12, 10, 16), (33, 65, 31),
                                   (17, 9, 129), (96, 128, 64)])
def test_3xtf32_split_keeps_inf_and_nan_as_the_f32_product(m, n, k):
    """Inf and NaN in either operand (NaNs as a CUDA op and the CPU make
    them, 0x7fffffff and 0xffc00000) give the plain f32 product's NaN and
    +-Inf at the same places, also where an Inf meets a TF32 value
    (lo = 0), a zero or another Inf; a split that keeps hi = Inf gives a
    NaN where the product is Inf."""
    x, w = (torch.from_numpy(t) for t in _operands(7, m, n, k))
    nan_cuda, nan_cpu = _bits(0x7FFFFFFF, 0xFFC00000)
    x[1, 3], x[2, 5], x[3, 7], x[5, 10] = (float("inf"), -float("inf"),
                                           nan_cuda, 0.0)
    w[3, 0], w[3, 1], w[3, 2], w[3, 5] = 1.0, 0.0, -2.0, float("inf")
    w[5, 4], w[10, 6], w[11, 8] = -float("inf"), -float("inf"), nan_cpu
    want = port_gemm.gemm_plain(x, w)
    got = _3xtf32(x, w)
    assert want.isnan().any() and want.isinf().any() \
        and want.isfinite().any()
    assert torch.equal(got.isnan(), want.isnan())
    inf = want.isinf()
    assert torch.equal(got.isinf(), inf) and torch.equal(got[inf], want[inf])
    fin = want.isfinite()
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4, atol=8e-4)
    # past FLT_MAX's last TF32 value: hi = 1, and the product stays finite
    big = _bits(0x7F7FFFFF).reshape(1, 1)
    quarter = torch.full((1, 1), 0.25)
    torch.testing.assert_close(_3xtf32(big, quarter), big * quarter)
    # hi = Inf, lo = 0 instead: Inf . 1.0 = Inf + Inf * 0 is a NaN
    naive_hi = _tf32_rna(x)
    naive_lo = torch.where(torch.isfinite(x), _tf32_rna(x - naive_hi), 0.0)
    w_hi, w_lo = _kernel_split(w)
    naive = naive_lo @ w_hi + naive_hi @ w_lo + naive_hi @ w_hi
    assert naive[1, 0].isnan() and want[1, 0].isinf()


@pytest.mark.parametrize("name,includes", [
    ("gemm", True), ("flash_attention", True), ("rglru_scan", True),
    ("mlstm", True), ("standalone", False)])
def test_library_name_hashes_the_included_headers(name, includes, tmp_path,
                                                  monkeypatch):
    """A library's name follows its source and the csrc headers it
    includes: an edited shared header renames the libraries of the
    sources that include it and no other (``standalone.cu``, written here,
    includes none)."""
    for path in Path(build.CSRC).iterdir():
        shutil.copy(path, tmp_path)
    (tmp_path / "standalone.cu").write_text(
        "#include <cuda_runtime.h>\n__global__ void k() {}\n")
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    before = build._target(name)
    with open(tmp_path / "mma_sync.cuh", "a") as fh:
        fh.write("// edited\n")
    assert (build._target(name) != before) is includes
