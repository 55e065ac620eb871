"""AdamW with global-norm clipping and a warmup-cosine schedule, as
``repro.optim.adamw``, on trees (nested dicts) of tensors.

The same update: gradients clipped to ``clip_norm`` by their global norm,
bias-corrected float32 moments, decoupled weight decay, the parameter
updated in float32 and cast back to its dtype.  ``step`` is an int32
tensor on the parameters' device, so the schedule and the bias correction
are computed there and the loop never synchronises on them.  `apply`
updates the parameters and moments in place (see there).  The
reference's ZeRO-1 sharding of the moments comes with sharding (ROADMAP
queue 1 item 9); on one card the moments sit beside the parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32: linear warmup,
    then a cosine down to ``min_lr_frac`` of ``lr``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Any) -> AdamWState:
    """Zero float32 moments shaped as the parameters, step 0."""
    some = tree_leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=some.device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def apply(cfg: AdamWConfig, state: AdamWState, params: Any, grads: Any
          ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step -> (params, state, {"grad_norm", "lr"}).

    The parameters and moments are donated, as the reference's jitted step
    donates its buffers: each leaf is updated in place and the same tensors
    come back (one leaf's temporaries at a time, so a step never holds two
    copies of the optimizer state); ``grads`` and ``state.step`` are left
    as they were."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    b2c = 1 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)
    for p, g, m, v in zip(*map(tree_leaves, (params, grads, state.mu,
                                             state.nu))):
        g32 = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g32)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g32))
        p32 = p.float()
        p.copy_(p32 - lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                            + cfg.weight_decay * p32))
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
