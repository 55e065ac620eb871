"""Gradient compression for the data-parallel all-reduce: int8
quantization with error feedback, as ``repro.runtime.compression``, on
trees (nested dicts) of tensors.

int8 with one float32 scale per block of ``BLOCK`` elements cuts the
payload 4x against float32; error feedback (Karimireddy et al.) carries
the quantization residual to the next step, so the compressed direction
stays unbiased in the long run.  On one card there is no all-reduce
(ROADMAP queue 1 item 9): the train step compresses and decompresses, so
the optimizer sees what a compressed all-reduce would deliver.

    comp, state = compress(grads, state)     # quantize + residual update
    grads = decompress(comp, grads)
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

BLOCK = 2048                       # elements per quantization scale


class CompressedTree(NamedTuple):
    q: Any                          # int8 payloads (same structure)
    scales: Any                     # float32 per-block scales


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1).float()
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def _dequantize(q: torch.Tensor, scale: torch.Tensor,
                shape: Tuple[int, ...]) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def compress(grads: Any, error_state: Optional[Any] = None
             ) -> Tuple[CompressedTree, Any]:
    """Quantize grads (+ error feedback). Returns (compressed, new_state)."""
    if error_state is None:
        error_state = init_error_state(grads)
    corrected = tree_map(lambda g, e: g.float() + e, grads, error_state)
    qs = tree_map(_quantize, corrected)
    q = tree_map(lambda t: t[0], qs)
    scales = tree_map(lambda t: t[1], qs)
    new_err = tree_map(lambda c, qq, ss: c - _dequantize(qq, ss, c.shape),
                       corrected, q, scales)
    return CompressedTree(q=q, scales=scales), new_err


def decompress(comp: CompressedTree, like: Any) -> Any:
    return tree_map(
        lambda q, s, g: _dequantize(q, s, tuple(g.shape)).to(g.dtype),
        comp.q, comp.scales, like)


def compression_ratio(grads: Any) -> float:
    leaves = tree_leaves(grads)
    raw = sum(g.numel() * g.element_size() for g in leaves)
    comp = sum(g.numel() + -(-g.numel() // BLOCK) * 4 for g in leaves)
    return raw / comp
