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
from repro_torch.kernels.mlstm import mlstm_parallel
from repro_torch.kernels.ref import (attention_ref, mlstm_parallel_ref,
                                     rglru_scan_ref)
from repro_torch.kernels.rglru import rglru_scan as rglru_kernel


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


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
               use_kernel: bool = False) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h0; fp32 (batch, seq, width)."""
    if use_kernel:
        return rglru_kernel(a, b, h0)
    return rglru_scan_ref(a, b, h0)


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          f_cum: torch.Tensor, log_i: torch.Tensor, use_kernel: bool = False,
          block_q: int = 128, block_kv: int = 128) -> torch.Tensor:
    """xLSTM's parallel form; q/k/v (b, h, s, d), f_cum/log_i (b, h, s)."""
    if use_kernel:
        return mlstm_parallel(q, k, v, f_cum, log_i, block_q=block_q,
                              block_kv=block_kv)
    return mlstm_parallel_ref(q, k, v, f_cum, log_i)
