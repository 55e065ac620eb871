"""Public wrappers for the kernels.

Every op takes a ``use_kernel`` switch (the reference's ``use_pallas`` /
``interpret`` pair): ``use_kernel=True`` goes to the hand-written kernel
(launched for CUDA tensors, its plain version for CPU tensors), the default
to the library call that the reference leaves to XLA.  CrossFlow's tiling
search feeds ``block_shape``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.gemm import gemm


def matmul(x: torch.Tensor, w: torch.Tensor,
           block_shape: Optional[Tuple[int, int, int]] = None,
           use_kernel: bool = False) -> torch.Tensor:
    if use_kernel:
        return gemm(x, w, block_shape=block_shape)
    return torch.matmul(x, w)
