"""Public wrappers for the kernels.

Every op takes a ``use_kernel`` switch (the reference's ``use_pallas`` /
``interpret`` pair): ``use_kernel=True`` goes to the hand-written kernel
(launched for CUDA tensors, its plain version for CPU tensors), the default
to the plain or library call that the reference leaves to XLA.  CrossFlow's
tiling search feeds ``block_shape``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.ref import attention_ref


def matmul(x: torch.Tensor, w: torch.Tensor,
           block_shape: Optional[Tuple[int, int, int]] = None,
           use_kernel: bool = False) -> torch.Tensor:
    if use_kernel:
        return gemm(x, w, block_shape=block_shape)
    return torch.matmul(x, w)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              use_kernel: bool = False, block_q: int = 128,
              block_kv: int = 128, q_offset: int = 0,
              kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (b, h, sq, d); k/v: (b, h_kv, skv, d).  ``q_offset`` and
    ``kv_len`` (host ints) have ``chunked_attention``'s meaning."""
    if use_kernel:
        return flash_attention(q, k, v, causal=causal, window=window,
                               block_q=block_q, block_kv=block_kv,
                               q_offset=q_offset, kv_len=kv_len)
    return attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, kv_len=kv_len)
