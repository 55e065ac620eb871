"""RG-LRU scan: the hand-written Hopper kernel and its plain version.

The port of ``repro/kernels/rglru.py:rglru_scan`` (a Pallas TPU kernel):
the first-order diagonal linear recurrence h_t = a_t h_{t-1} + b_t from a
given h0, to which recurrentgemma's RG-LRU reduces once its gates are
computed (`repro_torch.models.rglru`).

`rglru_scan` launches ``csrc/rglru_scan.cu`` for CUDA tensors and computes
`repro_torch.kernels.ref.rglru_scan_ref` for CPU tensors; there is no other
path.  The source has two variants, both bit for bit the plain version:
the ring (one warp walks 32 channels of one batch row through the whole
sequence, fed by a ring of 16-byte ``cp.async`` copies in shared memory)
and the element-wise kernel for shapes the 16-byte copies cannot take.
`kernel_variant` chooses between them; the launch records its choice in
`LAST_VARIANT`.  Each channel's sequence is walked in order from h0, so
``block_t`` (the TPU kernel's sequence block) is validated, clamped like
the reference's and recorded in `LAST_BLOCK_T`, and does not change the
output.  `LAUNCHES` counts kernel launches: it rises by one where a kernel
is launched and nowhere else.

On the card the scan is differentiable (`RGLRUScan`): the adjoint of a
first-order linear recurrence is the same recurrence run backward, so the
backward launches the same kernel once more, on reversed inputs.  A
forward and its backward are two launches.

Tensors without data (the dry-run's fake or meta tensors,
`build.no_data`) take the kernel's fake-tensor rule, in the forward and in
the reversed backward alike: the checks of a CUDA call, then the output
the kernel allocates, its `flops` and `io_bytes` reported to
the dry-run's counters (`build.kernel_call`), and no launch (`LAUNCHES` and
`LAST_VARIANT` do not move).
"""

from __future__ import annotations

import ctypes
import numbers
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rglru_scan_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 65535              # grid.y limit
RING, ELEMENTWISE = "ring", "elementwise"
_VARIANT_CODES = {ELEMENTWISE: 0, RING: 1}

LAUNCHES = 0                    # kernel launches since the last reset
# the profiler's range around the backward
BACKWARD_SPAN = "repro_torch::rglru_scan_backward"
LAST_BLOCK_T: Optional[int] = None
LAST_VARIANT: Optional[str] = None  # the last launch's; None on the host


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def flops(batch: int, seq: int, width: int) -> float:
    """The kernel's FLOPs: a product and a sum per element."""
    return 2.0 * batch * seq * width


def io_bytes(batch: int, seq: int, width: int, itemsize: int) -> float:
    """The bytes the kernel must move: a and b read in their dtype, h0
    read and h written in float32."""
    n = batch * seq * width
    return float(itemsize * 2 * n + 4 * n + 4 * batch * width)


_LIB = None


def _lib():
    """The kernel's library with its C signature declared (built at first
    use; never at import)."""
    global _LIB
    if _LIB is None:
        lib = build.library("rglru_scan")
        lib.repro_rglru_scan.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.repro_rglru_scan.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _block_t(block_t, seq: int) -> int:
    """The reference's sequence block: the largest divisor of ``seq`` not
    above ``block_t``."""
    if not isinstance(block_t, numbers.Integral) or block_t < 1:
        raise ValueError(f"rglru_scan: bad block_t {block_t!r}")
    bt = min(int(block_t), seq)
    while seq % bt:
        bt -= 1
    return bt


def kernel_variant(a: torch.Tensor, b: torch.Tensor) -> str:
    """`RING` where the ring's 16-byte copies can take a and b (a width of
    whole copies, 4 float32 or 8 bfloat16 channels, and both 16-byte
    aligned), else `ELEMENTWISE`."""
    per_copy = 16 // a.element_size()
    if a.shape[-1] % per_copy == 0 and build.aligned16(a) \
            and build.aligned16(b):
        return RING
    return ELEMENTWISE


def _launch(a: torch.Tensor, b: torch.Tensor,
            h0: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel's `kernel_variant` on the current stream:
    a, b contiguous CUDA tensors of one dtype; returns float32 h."""
    global LAUNCHES, LAST_VARIANT
    batch, seq, width = a.shape
    h0 = h0.to(torch.float32).contiguous()
    out = torch.empty((batch, seq, width), dtype=torch.float32,
                      device=a.device)
    if build.no_data(a):                # the fake-tensor rule
        build.kernel_call("rglru_scan", flops(batch, seq, width),
                             io_bytes(batch, seq, width, a.element_size()))
        return out
    variant = kernel_variant(a, b)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.repro_rglru_scan(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                                  out.data_ptr(), batch, seq, width,
                                  _DTYPE_CODES[a.dtype],
                                  _VARIANT_CODES[variant], stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan {variant} kernel launch failed: CUDA "
                           f"error {rc} "
                           f"({lib.repro_cuda_error_string(rc).decode()})")
    LAUNCHES += 1
    LAST_VARIANT = variant
    return out


def _scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, `rglru_scan_ref` for CPU ones."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    return _launch(a, b, h0)


class RGLRUScan(torch.autograd.Function):
    """h = scan(a, b, h0) with the reversed scan as its backward.

    With c_t = dL/dh_t + a_{t+1} c_{t+1} (c_T = dL/dh_T), the gradients are
    db = c, da = c h_{t-1} (h_{-1} = h0) and dh0 = a_0 c_0; c is the same
    recurrence over the reversed sequence, multipliers a_{t+1} (0 past the
    end) and a zero initial state: one more launch of the kernel (of
    `rglru_scan_ref` for CPU tensors, where the tests run it)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _scan(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        ctx.dtypes = (b.dtype,)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h0, h = ctx.saved_tensors
        da = db = dh0 = None
        with torch.profiler.record_function(BACKWARD_SPAN):
            a32 = a.float()
            mult = torch.cat([a32[:, 1:], torch.zeros_like(a32[:, :1])],
                             dim=1)
            c = _scan(mult.flip(1), g.float().flip(1),
                      torch.zeros_like(h0, dtype=torch.float32)).flip(1)
            if ctx.needs_input_grad[0]:
                prev = torch.cat([h0.float()[:, None], h[:, :-1]], dim=1)
                da = (c * prev).to(a.dtype)
            if ctx.needs_input_grad[1]:
                db = c.to(ctx.dtypes[0])
            if ctx.needs_input_grad[2]:
                dh0 = (a32[:, 0] * c[:, 0]).to(h0.dtype)
        return da, db, dh0


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
               block_t: int = 128) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t, h_0 given.

    a/b: (batch, seq, width), float32 or bfloat16 (one dtype); h0: (batch,
    width), float32 or bfloat16.  Returns float32 (batch, seq, width).
    CUDA tensors launch the `kernel_variant` of the Hopper kernel on the
    current stream or raise, through `RGLRUScan` (whose backward launches
    the kernel again, reversed); CPU tensors take `rglru_scan_ref`,
    tensors without data the fake-tensor rule (the module's doc).
    """
    global LAST_BLOCK_T, LAST_VARIANT
    if a.dim() != 3 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"rglru_scan takes a and b of one (batch, seq, "
                         f"width) shape, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    batch, seq, width = a.shape
    if min(batch, seq, width) < 1:
        raise ValueError(f"rglru_scan: empty input {tuple(a.shape)}")
    if tuple(h0.shape) != (batch, width):
        raise ValueError(f"rglru_scan: h0 {tuple(h0.shape)} is not "
                         f"(batch, width) = {(batch, width)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES \
            or h0.dtype not in _DTYPE_CODES:
        raise TypeError(f"rglru_scan takes float32 or bfloat16 a, b of one "
                        f"dtype and h0, got {a.dtype}, {b.dtype}, "
                        f"{h0.dtype}")
    if not (a.device == b.device == h0.device):
        raise ValueError(f"rglru_scan: a, b, h0 on {a.device}, {b.device}, "
                         f"{h0.device}")
    LAST_BLOCK_T = _block_t(block_t, seq)
    LAST_VARIANT = None
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if a.device.type != "cuda" and not build.no_data(a):
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan: a and b must be contiguous")
    if batch > _MAX_BATCH:
        raise ValueError(f"rglru_scan: batch {batch} exceeds the kernel's "
                         f"grid ({_MAX_BATCH})")
    return RGLRUScan.apply(a, b, h0)
