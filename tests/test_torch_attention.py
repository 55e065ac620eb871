"""The port's attention against the reference's, on the CPU.

``ops.attention(use_kernel=True)`` on CPU tensors computes the kernel's
plain version (the CUDA kernel runs only on the card, where
tests/test_torch_card.py and chip_smoke.py hold it against that plain
version).  Here it is held against the reference Pallas kernel in interpret
mode, at the shapes of tests/test_kernels.py, and against the reference
``common.chunked_attention`` for the decode arguments ``q_offset`` and
``kv_len``.  Inputs are numpy from a seed, handed to both packages;
tolerances are the reference's (tests/test_kernels.py): 2e-3 for float32,
3e-2 for bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models import common as ref_common
from repro_torch.kernels import flash_attention as port_fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import common

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv(seed, b, h, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,h,hkv,sq,skv,d", [
    (1, 4, 4, 128, 128, 64),        # MHA square
    (2, 8, 2, 128, 128, 64),        # GQA 4:1
    (1, 4, 1, 256, 256, 32),        # MQA
    (1, 2, 2, 128, 384, 64),        # cross/prefix: skv > sq
])
def test_attention_matches_reference_kernel(b, h, hkv, sq, skv, d):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0, b, h, hkv, sq, skv, d),
                                       "float32")
    causal = sq == skv
    want = ref_flash(jq, jk, jv, causal=causal, interpret=True)
    got = ops.attention(tq, tk, tv, causal=causal, use_kernel=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, sq, d)
    _close(got, want, 2e-3)


@pytest.mark.parametrize("window", [32, 128])
def test_attention_local_window(window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 1, 2, 2, 256, 256, 32),
                                       "float32")
    want = ref_flash(jq, jk, jv, causal=True, window=window, interpret=True)
    got = ops.attention(tq, tk, tv, causal=True, window=window,
                        use_kernel=True)
    _close(got, want, 2e-3)


def test_attention_bf16():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 1, 4, 4, 128, 128, 64),
                                       "bfloat16")
    want = ref_flash(jq, jk, jv, causal=True, interpret=True)
    got = ops.attention(tq, tk, tv, causal=True, use_kernel=True)
    assert got.dtype == torch.bfloat16
    _close(got, want, 3e-2)


@pytest.mark.parametrize("bq,bkv", [(32, 128), (64, 64), (128, 32)])
def test_attention_block_invariance(bq, bkv):
    """The block shape must not change the output (property)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, 1, 2, 2, 128, 128, 32),
                                       "float32")
    want = ref_flash(jq, jk, jv, causal=True, block_q=bq, block_kv=bkv,
                     interpret=True)
    got = ops.attention(tq, tk, tv, causal=True, use_kernel=True,
                        block_q=bq, block_kv=bkv)
    _close(got, want, 2e-3)
    torch.testing.assert_close(got, ops.attention(tq, tk, tv,
                                                  use_kernel=True))


@pytest.mark.parametrize("kv_len", [1, 17, 64])
def test_decode_kv_len_matches_chunked_attention(kv_len):
    """One query over a 64-entry cache, GQA 2:1, as decode calls it."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(4, 2, 4, 2, 1, 64, 32),
                                       "float32")
    pos = kv_len - 1
    want = ref_common.chunked_attention(jq, jk, jv, causal=False,
                                        q_offset=pos,
                                        kv_len=jnp.asarray(kv_len))
    got = common.chunked_attention(tq, tk, tv, causal=False, q_offset=pos,
                                   kv_len=kv_len)
    _close(got, want, 2e-3)


@pytest.mark.parametrize("q_offset,window", [(48, None), (48, 24),
                                             (100, 32)])
def test_causal_q_offset_matches_chunked_attention(q_offset, window):
    """Causal with q[0] at ``q_offset``; (100, 32) leaves every row with no
    visible key, where both average every key."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(5, 1, 4, 2, 16, 64, 64),
                                       "float32")
    want = ref_common.chunked_attention(jq, jk, jv, causal=True,
                                        window=window, q_offset=q_offset)
    got = common.chunked_attention(tq, tk, tv, causal=True, window=window,
                                   q_offset=q_offset)
    _close(got, want, 2e-3)


def test_cpu_branch_keeps_gradients():
    """On the CPU the wrapper computes its plain version, which autograd
    differentiates: the gradients of a loss through it are the reference
    ``chunked_attention``'s (the CUDA branch refuses inputs that require
    grad instead: tests/test_torch_card.py)."""
    arrays = _qkv(9, 1, 4, 2, 48, 48, 32)
    (jq, jk, jv), tensors = _both(arrays, "float32")
    tensors = [t.requires_grad_() for t in tensors]
    out = port_fa.flash_attention(*tensors, causal=True, window=16)
    torch.square(out).sum().backward()

    def loss(q, k, v):
        return jnp.sum(jnp.square(ref_common.chunked_attention(
            q, k, v, causal=True, window=16)))
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    for t, w in zip(tensors, want):
        assert t.grad is not None
        _close(t.grad, w, 2e-3)


def test_launch_counter_stays_zero_on_cpu():
    port_fa.reset_launches()
    _, (tq, tk, tv) = _both(_qkv(6, 1, 2, 1, 8, 8, 32), "float32")
    port_fa.flash_attention(tq, tk, tv)
    ops.attention(tq, tk, tv, use_kernel=True, kv_len=4, q_offset=3)
    common.chunked_attention(tq, tk, tv)
    assert port_fa.LAUNCHES == 0
    torch.testing.assert_close(ops.attention(tq, tk, tv),
                               attention_ref(tq, tk, tv))


def test_wrapper_refusals():
    _, (tq, tk, tv) = _both(_qkv(7, 1, 2, 1, 8, 8, 32), "float32")
    rng = np.random.default_rng(8)
    q96 = torch.from_numpy(rng.standard_normal((1, 2, 8, 96),
                                               dtype=np.float32))
    with pytest.raises(ValueError, match="head dim 96"):
        port_fa.flash_attention(q96, q96, q96)
    with pytest.raises(TypeError):
        port_fa.flash_attention(tq, tk.double(), tv)
    with pytest.raises(ValueError):
        port_fa.flash_attention(tq, tk[:, :, :4], tv)
    with pytest.raises(ValueError, match="kv_len"):
        port_fa.flash_attention(tq, tk, tv, kv_len=torch.tensor(3))
    with pytest.raises(ValueError, match="window"):
        port_fa.flash_attention(tq, tk, tv, window=0)
    with pytest.raises(ValueError, match="block_q"):
        port_fa.flash_attention(tq, tk, tv, block_q=0)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import build_model
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(reduced(get_config("qwen1.5-0.5b")))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(reduced(get_config("qwen1.5-0.5b")), device="cuda")
