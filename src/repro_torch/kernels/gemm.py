"""Tensor-core GEMM: the hand-written Hopper kernel and its plain version.

The port of ``repro/kernels/gemm.py:gemm`` (a Pallas TPU kernel).  CrossFlow's
hierarchical-roofline tiling search (`repro_torch.core.roofline.
best_gemm_tiling`) emits an (L2, L1, L0) tile triple whose L1 triple is the
kernel's block shape (bm, bn, bk).

`gemm` launches ``csrc/gemm.cu`` for CUDA tensors and computes `gemm_plain`
for CPU tensors; there is no other path.  The kernel runs on the tensor
cores (``mma.sync``): bf16 inputs directly, f32 inputs as three TF32
products (3xTF32), which keep the reference's f32 tolerance where one TF32
product would not.  It is compiled with one 128 x 128 block tile, so a
requested ``block_shape`` is validated, clamped like the reference's and
recorded in `LAST_BLOCK_SHAPE`, and does not change the numerics
(honouring it is a ROADMAP item).  The C entry takes the kernel's
16-byte-copy variant where the operands' alignment and row lengths allow
it, else its element-wise variant.  `LAUNCHES` counts kernel launches: it
rises by one where the kernel is launched and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_M = 65535 * 128            # grid.y limit times the block tile's rows

LAUNCHES = 0                    # kernel launches since the last reset
LAST_BLOCK_SHAPE: Optional[Tuple[int, int, int]] = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def pick_block_shape(m: int, n: int, k: int,
                     bm: int = 256, bn: int = 256, bk: int = 512,
                     ) -> Tuple[int, int, int]:
    """Clamp requested tiles to the problem size and divisor alignment."""
    def clamp(b: int, dim: int) -> int:
        b = min(b, dim)
        while dim % b:
            b -= 1
        return max(b, 1)
    return clamp(bm, m), clamp(bn, n), clamp(bk, k)


def gemm_plain(x: torch.Tensor, w: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """fp32-accumulated ``x @ w`` cast to ``out_dtype`` (default x's dtype):
    the function the kernel computes, as `repro.kernels.ref.gemm_ref`."""
    return (x.float() @ w.float()).to(out_dtype or x.dtype)


_LIB = None


def _lib():
    """The kernel's library with its C signatures declared (built at first
    use; never at import)."""
    global _LIB
    if _LIB is None:
        lib = build.library("gemm")
        lib.repro_gemm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        lib.repro_gemm.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def gemm(x: torch.Tensor, w: torch.Tensor,
         block_shape: Optional[Tuple[int, int, int]] = None,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C[m, n] = A[m, k] @ B[k, n] with an fp32 accumulator.

    f32 or bf16 inputs (both the same), output in ``out_dtype`` (default:
    A's dtype).  CUDA tensors launch the Hopper kernel on the current
    stream or raise; CPU tensors take `gemm_plain`.
    """
    global LAUNCHES, LAST_BLOCK_SHAPE
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"gemm takes 2-D operands, got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"gemm: inner dims differ: {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if min(m, n, k) < 1:
        raise ValueError(f"gemm: empty operand {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"gemm takes float32 or bfloat16 operands of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"gemm: unsupported out_dtype {out_dtype}")
    if x.device != w.device:
        raise ValueError(f"gemm: operands on {x.device} and {w.device}")
    req = block_shape or (256, 256, 512)
    if len(req) != 3 or any(int(b) < 1 for b in req):
        raise ValueError(f"gemm: bad block_shape {block_shape}")
    LAST_BLOCK_SHAPE = pick_block_shape(m, n, k, *(int(b) for b in req))
    if x.device.type == "cpu":
        return gemm_plain(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"gemm: unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemm: operands must be contiguous (row-major)")
    if m > _MAX_M:
        raise ValueError(f"gemm: m={m} exceeds the kernel's grid ({_MAX_M})")
    build.refuse_autograd("gemm", x, w)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_gemm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                            m, n, k, _DTYPE_CODES[x.dtype],
                            _DTYPE_CODES[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(f"gemm kernel launch failed: CUDA error {rc} "
                           f"({lib.repro_cuda_error_string(rc).decode()})")
    LAUNCHES += 1
    return out
