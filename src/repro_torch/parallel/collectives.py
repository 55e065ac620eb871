"""Collective helpers: the bucketed gradient all-reduce and the mean
all-reduce, as ``repro.parallel.collectives``.

On the mesh path the gradient reduction is implicit in the placements
(DTensor reduces a ``Partial`` gradient when it is pinned to the
parameter's layout); these helpers serve the explicit paths (the
pipeline's stages, the ``collective`` microbenchmark) and bucket the
reduction so that few large collectives replace many small ones.

`flatten_to_buckets` groups leaves per dtype (first-seen order), so a
mixed bf16 / f32 tree is never upcast; an empty tree gives no bucket;
`unflatten_buckets` gives back every leaf's dtype and shape.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_unflatten


def flatten_to_buckets(tree: Any, bucket_bytes: int = 4 << 20
                       ) -> Tuple[List[torch.Tensor], Any]:
    """A tree -> (1-D buckets of about ``bucket_bytes``, the spec that
    reassembles it), leaves in `tree_leaves` order."""
    leaves = tree_leaves(tree)
    flat = [leaf.reshape(-1) for leaf in leaves]
    by_dtype: dict = {}
    for i, f in enumerate(flat):
        by_dtype.setdefault(f.dtype, []).append(i)
    buckets: List[torch.Tensor] = []
    groups = []
    for dtype, idxs in by_dtype.items():
        big = torch.cat([flat[i] for i in idxs])
        per = max(bucket_bytes // max(big.element_size(), 1), 1)
        n_buckets = max(-(-big.numel() // per), 1)
        buckets.extend(big[i:i + per] for i in range(0, big.numel(), per))
        if big.numel() == 0:            # zero-size leaves still get a bucket
            buckets.append(big)
        groups.append((idxs, [flat[i].numel() for i in idxs],
                       [tuple(leaves[i].shape) for i in idxs], big.numel(),
                       n_buckets))
    return buckets, (tree, len(leaves), groups)


def unflatten_buckets(buckets: List[torch.Tensor], spec) -> Any:
    like, n_leaves, groups = spec
    leaves: List[Any] = [None] * n_leaves
    pos = 0
    for idxs, sizes, shapes, total, n_buckets in groups:
        big = torch.cat(buckets[pos:pos + n_buckets])[:total]
        pos += n_buckets
        off = 0
        for i, n, shp in zip(idxs, sizes, shapes):
            leaves[i] = big[off:off + n].reshape(shp)
            off += n
    return tree_unflatten(like, leaves)


def bucketed_all_reduce(tree: Any, group=None, bucket_bytes: int = 4 << 20
                        ) -> Any:
    """Sum ``tree`` over the ranks of ``group`` (default: the world), one
    all-reduce per bucket; the counterpart of ``bucketed_psum``.  The
    leaves are not changed; the sums come back as a new tree."""
    buckets, spec = flatten_to_buckets(tree, bucket_bytes)
    reduced = []
    for b in buckets:
        b = b.clone()
        dist.all_reduce(b, op=dist.ReduceOp.SUM, group=group)
        reduced.append(b)
    return unflatten_buckets(reduced, spec)


def mean_all_reduce(tree: Any, group=None) -> Any:
    """The mean of ``tree`` over the ranks of ``group``; the counterpart
    of ``mean_psum``."""
    n = dist.get_world_size(group)
    summed = bucketed_all_reduce(tree, group)
    return tree_unflatten(summed, [t / n for t in tree_leaves(summed)])
