"""Flash attention: the hand-written Hopper kernel and its plain version.

The port of ``repro/kernels/flash_attention.py:flash_attention`` (a Pallas
TPU kernel): blocked online-softmax attention with causal and local-window
masks and GQA, m, l and the accumulator in fp32.  On the serving path it
also stands in for ``models/common.py:chunked_attention``, so it takes that
function's ``q_offset`` and ``kv_len`` as host ints (passed to the kernel by
value: the decode loop never synchronises on them).

`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA tensors and
computes `repro_torch.kernels.ref.attention_ref` for CPU tensors; there is
no other path.  bf16 runs on the tensor cores (``mma.sync``), f32 on FFMA;
each kernel picks its own tiles, so ``block_q`` / ``block_kv`` are
validated and do not change the output.  `LAUNCHES` counts kernel
launches: it rises by one where the kernel is launched and nowhere else.

On the card the kernel is differentiable (`FlashAttention`): its forward
is the kernel, its backward the gradient of `attention_ref` recomputed
from the saved q, k and v (the function the reference's training path
differentiates), which holds one (b, h, sq, skv) float32 score matrix and
its gradient at a time.  A backward kernel is ROADMAP queue 2 item 6.

Tensors without data (the dry-run's fake or meta tensors,
`build.no_data`) take the kernel's fake-tensor rule: the checks of a CUDA
call, then the output the kernel allocates, its `flops` and `io_bytes`
reported to the dry-run's counters (`build.kernel_call`), and no launch
(`LAUNCHES` does not move); the backward's plain recompute runs on them as
it is.
"""

from __future__ import annotations

import ctypes
import numbers
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
_MAX_BATCH_HEADS = 65535        # grid.y limit

LAUNCHES = 0                    # kernel launches since the last reset
# the profiler's range around the backward
BACKWARD_SPAN = "repro_torch::flash_attention_backward"


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def flops(b: int, h: int, sq: int, skv: int, d: int,
          pairs: Optional[int] = None) -> float:
    """The kernel's FLOPs: q k^T and p v, 4 d per (query, key) pair of each
    (batch, head).  ``pairs`` defaults to every pair, sq skv: the dense
    products of the function, as the reference's jnp path computes them
    (the dry-run's count); a bound passes the pairs the masks leave
    visible (the kernel skips fully masked tiles)."""
    return 4.0 * b * h * d * (sq * skv if pairs is None else pairs)


def io_bytes(b: int, h: int, h_kv: int, sq: int, kv_len: int, d: int,
             itemsize: int) -> float:
    """The bytes the kernel must move: q read and the output written
    (b, h, sq, d), k and v read up to ``kv_len`` keys."""
    return float(itemsize * (2 * b * h * sq * d + 2 * b * h_kv * kv_len * d))


_LIB = None


def _lib():
    """The kernel's library with its C signature declared (built at first
    use; never at import)."""
    global _LIB
    if _LIB is None:
        lib = build.library("flash_attention")
        lib.repro_flash_attention.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
            + [ctypes.c_float, ctypes.c_void_p])
        lib.repro_flash_attention.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(q, k, v, window, block_q, block_kv, q_offset, kv_len):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes 4-D q, k, v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    bk, h_kv, skv, dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or bk != b or dk != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} disagree")
    if min(b, h, sq, h_kv, skv) < 1 or h % h_kv:
        raise ValueError(f"flash_attention: bad head or sequence counts: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one of "
                         f"{HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q, k, v on {q.device}, "
                         f"{k.device}, {v.device}")
    for name, val, lo in (("block_q", block_q, 1), ("block_kv", block_kv, 1),
                          ("q_offset", q_offset, 0)):
        if not isinstance(val, numbers.Integral) or val < lo:
            raise ValueError(f"flash_attention: bad {name} {val!r}")
    if window is not None and (not isinstance(window, numbers.Integral)
                               or window < 1):
        raise ValueError(f"flash_attention: bad window {window!r}")
    if kv_len is not None and (not isinstance(kv_len, numbers.Integral)
                               or kv_len < 0):
        raise ValueError(f"flash_attention: kv_len must be a host int >= 0, "
                         f"got {kv_len!r}")


def _launch(q, k, v, causal, window, scale, q_offset, kv_len):
    """One launch of the kernel on the current stream; returns the
    (b, h, sq, d) output, laid out (b, sq, h, d) in memory."""
    global LAUNCHES
    b, h, sq, d = q.shape
    _, h_kv, skv, _ = k.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if build.no_data(q):                # the fake-tensor rule
        kvl = skv if kv_len is None else min(int(kv_len), skv)
        build.kernel_call("flash_attention", flops(b, h, sq, skv, d),
                             io_bytes(b, h, h_kv, sq, kvl, d,
                                      q.element_size()))
        return out
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides), b, h, h_kv, sq, skv, d,
            _DTYPE_CODES[q.dtype], int(causal), int(window or 0),
            int(q_offset), skv if kv_len is None else min(int(kv_len), skv),
            scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} "
                           f"({lib.repro_cuda_error_string(rc).decode()})")
    LAUNCHES += 1
    return out


class FlashAttention(torch.autograd.Function):
    """The kernel forward; the backward recomputes `attention_ref` from the
    saved q, k, v under autograd and returns its gradients (in the inputs'
    dtypes)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(causal=causal, window=window, scale=scale,
                        q_offset=q_offset, kv_len=kv_len)
        return _launch(q, k, v, causal, window, scale, q_offset, kv_len)

    @staticmethod
    def backward(ctx, grad):
        with torch.profiler.record_function(BACKWARD_SPAN):
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
            with torch.enable_grad():
                out = attention_ref(*ins, **ctx.args)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, grad))
        return (*(next(grads) if t.requires_grad else None for t in ins),
                None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 128, block_kv: int = 128,
                    scale: Optional[float] = None, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (b, h, sq, d); k/v: (b, h_kv, skv, d) with h % h_kv == 0.

    Returns (b, h, sq, d) in q's dtype.  ``window``: keys with q_pos - k_pos
    >= window are masked; ``q_offset``: absolute position of q[0];
    ``kv_len``: keys at positions >= kv_len are masked.  Head dims 32, 64,
    128, 256; float32 or bfloat16.  CUDA tensors launch the Hopper kernel
    on the current stream or raise (bf16 ones must start 16-byte aligned,
    with strides that are multiples of 8), through `FlashAttention`, whose
    backward recomputes the plain version; CPU tensors take
    `attention_ref`; tensors without data take the fake-tensor rule
    (the module's doc).  The CUDA output is laid out (b, sq, h, d) in
    memory (a transposed view), which is the layout the output projection
    reads.
    """
    _check(q, k, v, window, block_q, block_kv, q_offset, kv_len)
    b, h, sq, d = q.shape
    scale = float(scale) if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset, kv_len=kv_len)
    if q.device.type != "cuda" and not build.no_data(q):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v need unit stride over "
                         "the head dim")
    if b * h > _MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention: batch x heads = {b * h} exceeds "
                         f"the kernel's grid ({_MAX_BATCH_HEADS})")
    if q.dtype == torch.bfloat16:
        build.check_aligned("flash_attention", q=q, k=k, v=v)
    return FlashAttention.apply(q, k, v, causal, window, scale, q_offset,
                                kv_len)
