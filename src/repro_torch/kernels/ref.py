"""Plain PyTorch oracles for the kernels (the allclose targets)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gemm import gemm_plain as gemm_ref

NEG_INF = -1e30                 # the masked score, as in both references

__all__ = ["NEG_INF", "attention_ref", "gemm_ref", "mlstm_parallel_ref",
           "rglru_scan_ref"]


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


def mlstm_parallel_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       f_cum: torch.Tensor,
                       log_i: torch.Tensor) -> torch.Tensor:
    """Naive decay-weighted causal linear attention (xLSTM parallel form).

    q/k/v: (b, h, s, d); f_cum (F = cumsum log f) and log_i: (b, h, s).
    a_tj = F_t - F_j + i_j for j <= t (-1e30 above the diagonal), m_t =
    max_j a_tj, w_tj = exp(a_tj - m_t) (q_t . k_j) d^-1/2, out_t =
    sum_j w_tj v_j / max(|sum_j w_tj|, exp(-m_t)).  fp32 throughout, the
    (b, h, s, s) matrices materialised; output in q's dtype.
    """
    s, d = q.shape[-2], q.shape[-1]
    fc, li = f_cum.float(), log_i.float()
    a = fc[..., :, None] - fc[..., None, :] + li[..., None, :]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    a = torch.where(causal, a, torch.full((), NEG_INF, device=q.device))
    m = torch.amax(a, dim=-1, keepdim=True)
    dmat = torch.exp(a - m)
    qk = torch.einsum("bhqd,bhkd->bhqk", q.float() * d ** -0.5, k.float())
    w = qk * dmat
    num = torch.einsum("bhqk,bhkd->bhqd", w, v.float())
    den = torch.maximum(torch.abs(torch.sum(w, dim=-1, keepdim=True)),
                        torch.exp(-m))
    return (num / den).to(q.dtype)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h0, a sequential loop over t in fp32
    (a product, then a sum: the kernel's order).  a/b: (batch, seq, width),
    h0: (batch, width).  Returns fp32 (batch, seq, width)."""
    a32, b32 = a.float(), b.float()
    h = h0.float()
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out
