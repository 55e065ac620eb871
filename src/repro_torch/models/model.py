"""Unified model API: `build_model(cfg, device)` -> `Model` with init /
``loss_fn(params, batch, remat=False)`` / forward / prefill / init_cache /
decode_step, as ``repro.models.model``.  The loss is differentiable on the
card (the kernels are autograd Functions) and on the host; ``remat``
(False, True or ``"dots"``) checkpoints each pattern group as the
reference's does.

The port covers the decoder-only families: attention (dense, GQA,
local/global), hybrid (recurrentgemma: RG-LRU + local attention) and ssm
(xLSTM: mLSTM + sLSTM).  MoE, the LSTM baseline and the encoder-decoder
(whisper) raise NotImplementedError naming the ROADMAP item that ports
them.  A `Model` holds the device it was built for (the
card unless the caller asks for ``"cpu"``): `init` and `init_cache` make
their tensors there, and the step functions run wherever their inputs are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import common, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    defs: Any                                    # ParamDef tree
    device: torch.device

    def init(self, seed: int = 0, dtype: torch.dtype = torch.float32):
        return common.tree_init(self.defs, seed, dtype, self.device)

    def loss_fn(self, params: Dict, batch: Dict, remat=False
                ) -> Tuple[torch.Tensor, Dict]:
        return transformer.loss_fn(params, batch, self.cfg, remat=remat)

    def forward(self, params: Dict, batch: Dict,
                caches: Optional[Dict] = None):
        """-> (logits, caches, aux); ``caches`` are filled in place."""
        return transformer.forward(params, batch["tokens"], self.cfg,
                                   embeds=batch.get("embeds"), caches=caches)

    def prefill(self, params: Dict, batch: Dict) -> Dict:
        """Caches of a forward over ``batch["tokens"]``, sized to it (KV
        caches and recurrent states)."""
        b, s = batch["tokens"].shape
        return self.forward(params, batch, caches=self.init_cache(b, s))[1]

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> Dict:
        return transformer.init_cache(self.cfg, batch, max_len, dtype,
                                      self.device)

    def decode_step(self, params: Dict, caches: Dict, tokens: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Dict]:
        return transformer.decode_step(params, caches, tokens, pos, self.cfg)


def build_model(cfg: ArchConfig, device=None) -> Model:
    if cfg.family == "lstm":
        raise NotImplementedError(
            f"{cfg.name}: the LSTM baseline (models/lstm.py) is not ported "
            f"yet: ROADMAP queue 1 item 10")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models (models/encdec.py) are not "
            f"ported yet: ROADMAP queue 1 item 9")
    return Model(cfg=cfg, defs=transformer.lm_defs(cfg),
                 device=resolve_device(device))
