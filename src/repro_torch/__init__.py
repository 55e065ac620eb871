"""repro_torch — the DeepFlow / CrossFlow reproduction in PyTorch for NVIDIA
Hopper (H100).

The package mirrors ``repro`` (the JAX reference) module for module:

  configs/    architecture and shape-cell configs (copied data)
  core/       CrossFlow: graph IR, parallelism, transform, techlib, AGE,
              placement, hierarchical roofline, event-driven simulation
  kernels/    hand-written CUDA kernels for sm_90a with their plain PyTorch
              versions, bound through ctypes (``kernels/csrc``)
  calibrate/  measure -> fit -> profile -> report on the card
  models/     the LM runtime of every family; launch/ serve and train
  parallel/   the planner's rules as DTensor placements, collectives,
              the pipeline, the kernels on each rank's shards
  pathfind.py the CLI (``calibrate`` and ``validate`` subcommands)

Every entry point takes ``device`` and runs on the card unless the caller
asks for ``"cpu"``: `resolve_device` raises when a CUDA device is asked for
(the default) and none is present, instead of carrying on on the host.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card.  Raises if the card is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: a CUDA device was asked for (the default) but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "(CLI: --device cpu) to run on the host")
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev
