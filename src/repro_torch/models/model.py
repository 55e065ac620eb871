"""Unified model API: `build_model(cfg, device)` -> `Model` with init /
``loss_fn(params, batch, remat=False)`` / forward / prefill / init_cache /
decode_step, as ``repro.models.model``.  The loss is differentiable on the
card (the kernels are autograd Functions) and on the host; ``remat``
(False, True or ``"dots"``) checkpoints each pattern group (each decoder
layer of the encoder-decoder) as the reference's does.

Every config builds: the decoder-only families (`transformer`: dense,
GQA, local/global, MoE, hybrid, xLSTM), the encoder-decoder (`encdec`:
whisper) and the LSTM baseline (`lstm`: paper-lm).  The API is the same
for all, so serving, training and the microbenchmarks need no family
branches: `forward` returns ``(logits, caches, aux)``; a batch holds
``tokens`` (and ``labels`` for the loss), plus ``frames`` for the
encoder-decoder, whose `prefill` encodes them into the cross caches.  The
LSTM has no decode path: its `init_cache`, `decode_step` and `prefill`
raise, where the reference's are None.

A `Model` holds the device it was built for (the card unless the caller
asks for ``"cpu"``): `init` and `init_cache` make their tensors there, and
the step functions run wherever their inputs are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import common, encdec, lstm, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    defs: Any                                    # ParamDef tree
    device: torch.device

    @property
    def kind(self) -> str:
        """``"lm"`` (decoder-only), ``"encdec"`` or ``"lstm"``."""
        if self.cfg.family == "lstm":
            return "lstm"
        return "encdec" if self.cfg.is_encoder_decoder else "lm"

    @property
    def has_decode(self) -> bool:
        return self.kind != "lstm"

    def _no_decode(self, what: str):
        raise ValueError(f"{self.cfg.name} has no decode path ({what})")

    def init(self, seed: int = 0, dtype: torch.dtype = torch.float32):
        return common.tree_init(self.defs, seed, dtype, self.device)

    def loss_fn(self, params: Dict, batch: Dict, remat=False
                ) -> Tuple[torch.Tensor, Dict]:
        mod = {"lm": transformer, "encdec": encdec, "lstm": lstm}[self.kind]
        return mod.loss_fn(params, batch, self.cfg, remat=remat)

    def forward(self, params: Dict, batch: Dict,
                caches: Optional[Dict] = None):
        """-> (logits, caches, aux); ``caches`` are filled in place (the
        decoder-only families only)."""
        if self.kind == "lm":
            return transformer.forward(params, batch["tokens"], self.cfg,
                                       embeds=batch.get("embeds"),
                                       caches=caches)
        if caches is not None:
            raise ValueError(f"{self.cfg.name}: forward fills no caches "
                             f"(the encoder-decoder's come from prefill)")
        if self.kind == "encdec":
            logits = encdec.forward(params, batch["frames"], batch["tokens"],
                                    self.cfg)
        else:
            logits = lstm.forward(params, batch["tokens"], self.cfg)
        return logits, None, torch.zeros((), dtype=torch.float32,
                                         device=logits.device)

    def prefill(self, params: Dict, batch: Dict) -> Dict:
        """Caches of a forward over ``batch["tokens"]``, sized to it (KV
        caches and recurrent states); for the encoder-decoder, the encoded
        ``batch["frames"]``' cross K/V and empty self caches."""
        if self.kind == "encdec":
            return encdec.prefill(params, batch["frames"], self.cfg)
        if self.kind == "lstm":
            self._no_decode("prefill")
        b, s = batch["tokens"].shape
        return self.forward(params, batch, caches=self.init_cache(b, s))[1]

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> Dict:
        """Zero caches; the encoder-decoder reads ``max_len`` as the
        encoder length, as the reference's does."""
        if self.kind == "encdec":
            return encdec.init_cache(self.cfg, batch, max_len, dtype,
                                     self.device)
        if self.kind == "lstm":
            self._no_decode("init_cache")
        return transformer.init_cache(self.cfg, batch, max_len, dtype,
                                      self.device)

    def decode_step(self, params: Dict, caches: Dict, tokens: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Dict]:
        if self.kind == "encdec":
            return encdec.decode_step(params, caches, tokens, pos, self.cfg)
        if self.kind == "lstm":
            self._no_decode("decode_step")
        return transformer.decode_step(params, caches, tokens, pos, self.cfg)


def build_model(cfg: ArchConfig, device=None) -> Model:
    if cfg.family == "lstm":
        defs = lstm.lstm_defs(cfg)
    elif cfg.is_encoder_decoder:
        defs = encdec.encdec_defs(cfg)
    else:
        defs = transformer.lm_defs(cfg)
    return Model(cfg=cfg, defs=defs, device=resolve_device(device))
