"""The paper's validation / case-study workload, as ``repro.models.lstm``:
an N-layer LSTM language model (§8-§9: 2 layers, hidden 16K, vocab 800K,
seq 20), built by `build_model` as any other arch.

It has no decode path (the reference's ``init_cache`` and
``decode_step`` are None) and runs no hand-written kernel: the reference's
time loop is ``lax.scan`` of plain ``jnp``, here a Python loop over time.
It runs in the parameters' dtype: the embedding rows are not cast to the
configured activation dtype, as in the reference.  The gates split i, f,
g, o in that order.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common
from repro_torch.models.common import ParamDef


def lstm_defs(cfg: ArchConfig) -> Dict:
    h = cfg.d_model
    layers = {
        "wx": ParamDef((cfg.n_layers, h, 4 * h), ("layers", "fsdp", "mlp")),
        "wh": ParamDef((cfg.n_layers, h, 4 * h), ("layers", "fsdp", "mlp")),
        "b": ParamDef((cfg.n_layers, 4 * h), ("layers", "mlp"),
                      init="zeros"),
    }
    return {
        "embed": ParamDef((cfg.padded_vocab, h), ("vocab", "fsdp"), scale=0.02),
        "layers": layers,
        "head": ParamDef((h, cfg.padded_vocab), ("fsdp", "vocab")),
    }


def _lstm_layer(wx, wh, b, x):
    """x: (batch, seq, h) -> (batch, seq, h), one step per position."""
    bsz, seq, h = x.shape
    xw = x @ wx.to(x.dtype) + b.to(x.dtype)            # (b, s, 4h)
    wh = wh.to(x.dtype)
    hprev = torch.zeros((bsz, h), dtype=x.dtype, device=x.device)
    c = hprev
    out = []
    for t in range(seq):
        gates = xw[:, t] + hprev @ wh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        hprev = torch.sigmoid(o) * torch.tanh(c)
        out.append(hprev)
    return torch.stack(out, dim=1)


def forward(params: Dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            rules=None, mesh=None) -> torch.Tensor:
    x = common.lookup(params["embed"], tokens)
    x = common.logical(x, ("batch", "act_seq", "act_embed"), rules, mesh)
    lp = common.gather_dp(params["layers"])
    for i in range(cfg.n_layers):
        x = _lstm_layer(lp["wx"][i], lp["wh"][i], lp["b"][i], x)
    return common.mask_padded_vocab(
        (x @ common.gather_dp(params["head"]).to(x.dtype)).float(),
        cfg.vocab_size)


def loss_fn(params: Dict, batch: Dict, cfg: ArchConfig, *, remat=False,
            rules=None, mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy; ``remat`` is accepted and unused,
    as in the reference."""
    logits = forward(params, batch["tokens"], cfg, rules=rules, mesh=mesh)
    ce = common.cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}
