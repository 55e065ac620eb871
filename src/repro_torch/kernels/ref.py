"""Plain PyTorch oracles for the kernels (the allclose targets)."""

from __future__ import annotations

from repro_torch.kernels.gemm import gemm_plain as gemm_ref

__all__ = ["gemm_ref"]
