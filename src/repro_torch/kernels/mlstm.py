"""mLSTM parallel form: the hand-written Hopper kernel and its plain version.

The port of ``repro/kernels/mlstm.py:mlstm_parallel`` (a Pallas TPU
kernel): xLSTM's stabilised decay-weighted causal linear attention, which
the mLSTM block (`repro_torch.models.xlstm.mlstm_apply`) runs over a
prompt.

`mlstm_parallel` launches ``csrc/mlstm.cu`` for CUDA tensors and computes
`repro_torch.kernels.ref.mlstm_parallel_ref` for CPU tensors; there is no
other path.  bf16 (the model path) runs on the tensor cores
(``mlstm_mma_kernel``: ``mma.sync`` fed by ``cp.async``, so bf16 q, k, v
must start 16-byte aligned with strides that are multiples of 8, else the
wrapper raises), f32 on FFMA (``mlstm_kernel``).  Each kernel picks its
own tiles, so ``block_q`` / ``block_kv`` are validated and do not change
the output.  `LAUNCHES` counts kernel launches: it rises by one where the
kernel is launched and nowhere else.

On the card the kernel is differentiable (`MLSTMParallel`): its forward is
the kernel, its backward the gradient of `mlstm_parallel_ref` recomputed
from the saved inputs, to q, k, v, ``f_cum`` and ``log_i`` (the function
the reference's training path differentiates, ``_mlstm_parallel``).  A
backward kernel is ROADMAP queue 2 item 6.

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
from repro_torch.kernels.ref import mlstm_parallel_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 192)
_MAX_BATCH_HEADS = 65535        # grid.y limit

LAUNCHES = 0                    # kernel launches since the last reset
# the profiler's range around the backward
BACKWARD_SPAN = "repro_torch::mlstm_parallel_backward"


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def flops(b: int, h: int, s: int, d: int,
          pairs: Optional[int] = None) -> float:
    """The kernel's FLOPs: q k^T and the weighted sum of v, 4 d per (query,
    key) pair of each (batch, head).  ``pairs`` defaults to every pair,
    s^2: the dense products of the function, as the reference's jnp path
    computes them (the dry-run's count); a bound passes the causal pairs
    (the kernel skips tiles above the diagonal)."""
    return 4.0 * b * h * d * (s * s if pairs is None else pairs)


def io_bytes(b: int, h: int, s: int, d: int, itemsize: int) -> float:
    """The bytes the kernel must move: q, k, v read and the output written
    (b, h, s, d) in their dtype, f_cum and log_i (b, h, s) read in
    float32."""
    return float(itemsize * 4 * b * h * s * d + 4 * 2 * b * h * s)


_LIB = None


def _lib():
    """The kernel's library with its C signature declared (built at first
    use; never at import)."""
    global _LIB
    if _LIB is None:
        lib = build.library("mlstm")
        lib.repro_mlstm.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p])
        lib.repro_mlstm.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(q, k, v, f_cum, log_i, block_q, block_kv):
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) \
            or tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"mlstm_parallel takes q, k, v of one (b, h, s, d) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    if min(b, h, s) < 1:
        raise ValueError(f"mlstm_parallel: empty input {tuple(q.shape)}")
    for name, t in (("f_cum", f_cum), ("log_i", log_i)):
        if tuple(t.shape) != (b, h, s):
            raise ValueError(f"mlstm_parallel: {name} {tuple(t.shape)} is "
                             f"not (b, h, s) = {(b, h, s)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"mlstm_parallel: head dim {d} is not one of "
                         f"{HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"mlstm_parallel takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (f_cum.is_floating_point() and log_i.is_floating_point()):
        raise TypeError("mlstm_parallel: f_cum and log_i must be floating")
    if len({t.device for t in (q, k, v, f_cum, log_i)}) != 1:
        raise ValueError("mlstm_parallel: inputs on more than one device")
    for name, val in (("block_q", block_q), ("block_kv", block_kv)):
        if not isinstance(val, numbers.Integral) or val < 1:
            raise ValueError(f"mlstm_parallel: bad {name} {val!r}")


def _launch(q, k, v, f_cum, log_i):
    """One launch of the kernel on the current stream; returns the
    (b, h, s, d) output, laid out (b, s, h, d) in memory."""
    global LAUNCHES
    b, h, s, d = q.shape
    f_cum, log_i = f_cum.float(), log_i.float()
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if build.no_data(q):                # the fake-tensor rule
        build.kernel_call("mlstm_parallel", flops(b, h, s, d),
                             io_bytes(b, h, s, d, q.element_size()))
        return out
    strides = (ctypes.c_longlong * 18)(
        *(x for t in (q, k, v, out) for x in t.stride()[:3]),
        *f_cum.stride(), *log_i.stride())
    # the TPU kernel scales q in q's dtype, the scale rounded to it first
    scale = torch.tensor(d ** -0.5, dtype=q.dtype).item()
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_mlstm(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            f_cum.data_ptr(), log_i.data_ptr(), ctypes.addressof(strides),
            b, h, s, d, _DTYPE_CODES[q.dtype], scale, stream)
    if rc != 0:
        raise RuntimeError(f"mlstm_parallel kernel launch failed: CUDA error "
                           f"{rc} ({lib.repro_cuda_error_string(rc).decode()})")
    LAUNCHES += 1
    return out


class MLSTMParallel(torch.autograd.Function):
    """The kernel forward; the backward recomputes `mlstm_parallel_ref`
    from the saved inputs under autograd and returns its gradients (in the
    inputs' dtypes)."""

    @staticmethod
    def forward(ctx, q, k, v, f_cum, log_i):
        ctx.save_for_backward(q, k, v, f_cum, log_i)
        return _launch(q, k, v, f_cum, log_i)

    @staticmethod
    def backward(ctx, grad):
        with torch.profiler.record_function(BACKWARD_SPAN):
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip(ctx.saved_tensors, ctx.needs_input_grad)]
            with torch.enable_grad():
                out = mlstm_parallel_ref(*ins)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, grad))
        return tuple(next(grads) if t.requires_grad else None for t in ins)


def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   f_cum: torch.Tensor, log_i: torch.Tensor,
                   block_q: int = 128, block_kv: int = 128) -> torch.Tensor:
    """q/k/v: (b, h, s, d); f_cum (cumsum of log f) and log_i: (b, h, s).

    Returns (b, h, s, d) in q's dtype.  Head dims 32, 64, 128, 192; any s;
    float32 or bfloat16 q, k, v (f_cum and log_i are read in float32).
    CUDA tensors launch the Hopper kernel on the current stream or raise
    (bf16 ones must start 16-byte aligned, with strides that are multiples
    of 8), through `MLSTMParallel`, whose backward recomputes the plain
    version; CPU tensors take `mlstm_parallel_ref`, tensors without data
    the fake-tensor rule (the module's doc).  The CUDA output is laid out
    (b, s, h, d) in memory (a transposed view), the layout the block's
    output projection reads.
    """
    _check(q, k, v, f_cum, log_i, block_q, block_kv)
    b, h, s, d = q.shape
    if q.device.type == "cpu":
        return mlstm_parallel_ref(q, k, v, f_cum, log_i)
    if q.device.type != "cuda" and not build.no_data(q):
        raise ValueError(f"mlstm_parallel: unsupported device {q.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("mlstm_parallel: q, k, v need unit stride over the "
                         "head dim")
    if b * h > _MAX_BATCH_HEADS:
        raise ValueError(f"mlstm_parallel: batch x heads = {b * h} exceeds "
                         f"the kernel's grid ({_MAX_BATCH_HEADS})")
    if q.dtype == torch.bfloat16:
        build.check_aligned("mlstm_parallel", q=q, k=k, v=v)
    return MLSTMParallel.apply(q, k, v, f_cum, log_i)
