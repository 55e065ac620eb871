"""Gradient compression for the data-parallel all-reduce: int8
quantization with error feedback, as ``repro.runtime.compression``, on
trees (nested dicts) of tensors.

int8 with one float32 scale per block of ``BLOCK`` elements cuts the
payload 4x against float32; error feedback (Karimireddy et al.) carries
the quantization residual to the next step, so the compressed direction
stays unbiased in the long run.  The train step compresses and
decompresses the gradient after its data-parallel mean, as the
reference's ``compress`` sees the gradient GSPMD has already reduced, so
the optimizer sees what a compressed all-reduce would deliver.  On a
mesh the gradients and the error state are DTensors, and each rank
quantizes its own shard: the blocks stay those of ``BLOCK`` elements of
the full logical array in row-major order (the one-device step's), each
block's scale the largest magnitude over its elements on every rank (one
max all-reduce of the per-block maxima, a 2048th of the gradient, per
mesh dim), so a compressed step on a mesh is the one-device compressed
step within float32 rounding and no rank holds more than its shards.
The payloads are then local int8 tensors and the scales each leaf's full
per-block vector.  int8 on the wire is not done here.

    comp, state = compress(grads, state)     # quantize + residual update
    grads = decompress(comp, grads)
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import is_dtensor, tree_leaves, tree_map, \
    tree_unflatten

BLOCK = 2048                       # elements per quantization scale


class CompressedTree(NamedTuple):
    q: Any                          # int8 payloads (same structure)
    scales: Any                     # float32 per-block scales


def init_error_state(params: Any) -> Any:
    """Zero float32 residuals shaped and placed as the parameters."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


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


def _block_ids(x) -> torch.Tensor:
    """The block (of the full logical array, row-major) of each element
    of the DTensor ``x``'s local shard, flattened."""
    from repro_torch.parallel.sharding import local_box
    box = local_box(tuple(x.shape), x.device_mesh, x.placements)
    idx = torch.zeros((), dtype=torch.int64, device=x.to_local().device)
    stride = 1
    for d in reversed(range(x.ndim)):
        r = torch.arange(box[d].start, box[d].stop, device=idx.device)
        idx = idx + (r * stride).reshape((-1,) + (1,) * (x.ndim - 1 - d))
        stride *= x.shape[d]
    return idx.reshape(-1) // BLOCK


def _from_local(x: torch.Tensor, like) -> Any:
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def _compress_shards(grads: Any, error_state: Any
                     ) -> Tuple[CompressedTree, Any]:
    """`compress` on DTensor leaves, each rank on its shards."""
    import torch.distributed as dist
    gl, el = tree_leaves(grads), tree_leaves(error_state)
    corrected = [g.to_local().float() + e.to_local()
                 for g, e in zip(gl, el)]
    n_blocks = [-(-g.numel() // BLOCK) for g in gl]
    amax = torch.zeros(sum(n_blocks), device=corrected[0].device)
    off = 0
    for g, c, n in zip(gl, corrected, n_blocks):
        amax[off:off + n].scatter_reduce_(0, _block_ids(g),
                                          torch.abs(c).reshape(-1), "amax")
        off += n
    mesh = gl[0].device_mesh
    for dim in range(mesh.ndim):
        if mesh.size(dim) > 1:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                            group=mesh.get_group(dim))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q, scales, new_err, off = [], [], [], 0
    for g, e, c, n in zip(gl, el, corrected, n_blocks):
        s = scale[off:off + n]
        off += n
        per = s[_block_ids(g)].reshape(c.shape)
        qq = torch.clamp(torch.round(c / per), -127, 127).to(torch.int8)
        q.append(qq)
        scales.append(s)
        new_err.append(_from_local(c - qq.float() * per, e))
    return (CompressedTree(q=tree_unflatten(grads, q),
                           scales=tree_unflatten(grads, scales)),
            tree_unflatten(error_state, new_err))


def compress(grads: Any, error_state: Optional[Any] = None
             ) -> Tuple[CompressedTree, Any]:
    """Quantize grads (+ error feedback). Returns (compressed, new_state)."""
    if error_state is None:
        error_state = init_error_state(grads)
    if any(is_dtensor(g) for g in tree_leaves(grads)):
        return _compress_shards(grads, error_state)
    corrected = tree_map(lambda g, e: g.float() + e, grads, error_state)
    qs = tree_map(_quantize, corrected)
    q = tree_map(lambda t: t[0], qs)
    scales = tree_map(lambda t: t[1], qs)
    new_err = tree_map(lambda c, qq, ss: c - _dequantize(qq, ss, c.shape),
                       corrected, q, scales)
    return CompressedTree(q=q, scales=scales), new_err


def decompress(comp: CompressedTree, like: Any) -> Any:
    """The gradients ``comp`` carries, in ``like``'s dtypes (and, on a
    mesh, placements)."""
    def one(q, s, g):
        if is_dtensor(g):
            per = s[_block_ids(g)].reshape(q.shape)
            return _from_local((q.float() * per).to(g.dtype), g)
        return _dequantize(q, s, tuple(g.shape)).to(g.dtype)
    return tree_map(one, comp.q, comp.scales, like)


def compression_ratio(grads: Any) -> float:
    leaves = tree_leaves(grads)
    raw = sum(g.numel() * g.element_size() for g in leaves)
    comp = sum(g.numel() + -(-g.numel() // BLOCK) * 4 for g in leaves)
    return raw / comp
