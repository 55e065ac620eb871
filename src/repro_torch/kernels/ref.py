"""Plain PyTorch oracles for the kernels (the allclose targets)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gemm import gemm_plain as gemm_ref

NEG_INF = -1e30                 # the masked score, as in both references

__all__ = ["NEG_INF", "attention_ref", "gemm_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None, q_offset: int = 0,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """Naive fp32 softmax attention with GQA + causal + local-window masks.

    q: (b, h, sq, d); k/v: (b, h_kv, skv, d), h % h_kv == 0 (kv head of
    q head i is i // (h / h_kv)).  ``q_offset`` is the absolute position of
    q[0] for the causal and window masks; keys at positions >= ``kv_len``
    are masked (``chunked_attention``'s meaning).  Masked scores are -1e30,
    so a row with no visible key averages every key, as the references do.
    Output in q's dtype.
    """
    b, h, sq, d = q.shape
    _, h_kv, skv, _ = k.shape
    group = h // h_kv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    if kv_len is not None:
        mask &= k_pos < kv_len
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
