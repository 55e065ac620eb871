"""The hand-written kernels' fake-tensor rules (the dry-run's path to them).

Under ``FakeTensorMode`` a ``cuda`` fake tensor takes each wrapper's rule:
the kernel's output (shape, dtype, layout), its formula FLOPs and bytes
and one call reported to the dry-run's counters, no library loaded and
``LAUNCHES`` unmoved.  The backward runs on ``meta`` fakes, the dry-run's
card path (autograd over a ``cuda`` tensor needs a card's device guard):
attention's and the mLSTM's backward recompute the
plain version under autograd, the scan's runs the kernel reversed (its
rule again).  Each formula is held to the plain version's dot FLOPs at the
same shapes (the scan, which has no product, to its multiply-adds).
"""

from __future__ import annotations

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import build, flash_attention as fa, mlstm as ml, \
    rglru as rg
from repro_torch.kernels.ref import attention_ref, mlstm_parallel_ref
from repro_torch.launch.counters import StepCounter


@pytest.fixture
def no_library(monkeypatch):
    """Fails the test if any kernel library is loaded or built."""
    def refuse(name):
        raise AssertionError(f"the {name} library was loaded")
    monkeypatch.setattr(build, "library", refuse)
    for mod in (fa, ml, rg):
        monkeypatch.setattr(mod, "_LIB", None)
        mod.reset_launches()
    yield
    for mod in (fa, ml, rg):
        assert mod.LAUNCHES == 0 and mod._LIB is None


def _forward(fn, shapes, dtype, device="cuda"):
    """``fn`` on fake tensors of ``shapes`` (of ``dtype``, or one dtype
    each) under a counter -> (output, counter)."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,) * len(shapes)
    with FakeTensorMode():
        ins = [torch.empty(s, dtype=t, device=device)
               for s, t in zip(shapes, dtypes)]
        with StepCounter(ins) as counter:
            out = fn(*ins)
    return out, counter


def _backward(fn, shapes, dtype):
    """Gradients of ``fn`` on ``meta`` fakes under a counter -> (grads,
    counter)."""
    with FakeTensorMode():
        ins = [torch.empty(s, dtype=dtype, device="meta",
                           requires_grad=True) for s in shapes]
        out = fn(*ins)
        with StepCounter(ins) as counter:
            grads = torch.autograd.grad(out.float().sum(), ins)
    return grads, counter


def _dot_flops(fn, shapes, dtype):
    """The plain version's dot FLOPs on CPU fakes."""
    return _forward(fn, shapes, dtype, "cpu")[1].flops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_rule(no_library, dtype):
    b, h, hkv, sq, skv, d = 2, 8, 2, 64, 96, 64
    shapes = ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))
    kw = dict(causal=True, window=None, q_offset=skv - sq)
    out, c = _forward(lambda q, k, v: fa.flash_attention(q, k, v, **kw),
                      shapes, dtype)
    assert out.shape == (b, h, sq, d) and out.dtype == dtype
    assert out.device.type == "cuda"
    # the kernel's layout: (b, sq, h, d) in memory
    assert out.stride() == (sq * h * d, d, h * d, 1)
    assert c.kernels == {"flash_attention": 1}
    assert c.flops == fa.flops(b, h, sq, skv, d) == 4.0 * b * h * sq * skv * d
    assert c.bytes == fa.io_bytes(b, h, hkv, sq, skv, d,
                                  torch.tensor([], dtype=dtype).element_size())
    assert c.flops == _dot_flops(lambda q, k, v: attention_ref(q, k, v, **kw),
                                 shapes, dtype)
    # decode: keys past kv_len are not read
    _, c = _forward(lambda q, k, v: fa.flash_attention(
        q, k, v, causal=False, q_offset=40, kv_len=41),
        ((b, h, 1, d), (b, hkv, skv, d), (b, hkv, skv, d)), dtype)
    assert c.bytes == fa.io_bytes(b, h, hkv, 1, 41, d,
                                  2 if dtype == torch.bfloat16 else 4)
    # the backward: the plain recompute of attention_ref under autograd
    grads, c = _backward(lambda q, k, v: fa.flash_attention(q, k, v, **kw),
                         shapes, dtype)
    assert [g.shape for g in grads] == [torch.Size(s) for s in shapes]
    assert all(g.dtype == dtype for g in grads)
    assert c.kernels == {}
    # recompute (4 b h sq skv d) and its gradient to q, k, v (8 more)
    assert c.flops == 12.0 * b * h * sq * skv * d


def test_rglru_scan_rule(no_library):
    batch, seq, width = 2, 48, 64
    shapes = ((batch, seq, width), (batch, seq, width), (batch, width))
    for dtype, itemsize in ((torch.float32, 4), (torch.bfloat16, 2)):
        # h0 in float32, as the model gives it (the wrapper casts others)
        out, c = _forward(rg.rglru_scan, shapes,
                          (dtype, dtype, torch.float32))
        assert out.shape == (batch, seq, width)
        assert out.dtype == torch.float32 and out.device.type == "cuda"
        assert c.kernels == {"rglru_scan": 1}
        assert c.flops == rg.flops(batch, seq, width) == 2.0 * batch * seq \
            * width
        assert c.bytes == rg.io_bytes(batch, seq, width, itemsize)
    assert rg.LAST_VARIANT is None
    # the plain loop: a product and a sum per element, no dot
    assert _dot_flops(lambda a, b, h0: rg.rglru_scan(a, b, h0), shapes,
                      torch.float32) == 0.0
    # the backward launches the kernel again, reversed: its rule again
    grads, c = _backward(rg.rglru_scan, shapes, torch.float32)
    assert [g.shape for g in grads] == [torch.Size(s) for s in shapes]
    assert c.kernels == {"rglru_scan": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_rule(no_library, dtype):
    b, h, s, d = 2, 4, 80, 64
    shapes = ((b, h, s, d),) * 3 + ((b, h, s),) * 2
    # f_cum and log_i in float32, as the model gives them
    out, c = _forward(ml.mlstm_parallel, shapes,
                      (dtype,) * 3 + (torch.float32,) * 2)
    assert out.shape == (b, h, s, d) and out.dtype == dtype
    assert out.stride() == (s * h * d, d, h * d, 1)
    assert c.kernels == {"mlstm_parallel": 1}
    assert c.flops == ml.flops(b, h, s, d) == 4.0 * b * h * s * s * d
    assert c.bytes == ml.io_bytes(b, h, s, d,
                                  2 if dtype == torch.bfloat16 else 4)
    assert c.flops == _dot_flops(mlstm_parallel_ref, shapes,
                                 (dtype,) * 3 + (torch.float32,) * 2)
    grads, c = _backward(ml.mlstm_parallel, shapes, dtype)
    assert [g.shape for g in grads] == [torch.Size(x) for x in shapes]
    assert c.kernels == {} and c.flops == 12.0 * b * h * s * s * d
