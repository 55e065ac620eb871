"""Weights across packages: the reference's parameter and cache trees (as
numpy, ``jax.tree.map(np.asarray, tree)``) to the port's tensors and back.

Both packages keep the same tree layout (nested dicts, stacked ``groups``
with the leading layers axis), so conversion is leaf for leaf.  bfloat16
leaves (the reference's KV caches) arrive as numpy's ``bfloat16`` extension
dtype and are reinterpreted bit for bit; `params_to_numpy` widens bfloat16
to float32 (exactly), since numpy itself has no bfloat16.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_map


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")          # owned and writable
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Dict, device=None) -> Dict:
    """A tree of numpy arrays -> the same tree of tensors on ``device``
    (default: the card)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)


cache_from_numpy = params_from_numpy     # caches are trees of the same kind


def params_to_numpy(tree: Dict) -> Dict:
    """A tree of tensors -> the same tree of numpy arrays on the host."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(leaf, tree)
