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

On a mesh every step function takes the reference's ``rules`` (resolved
on the mesh, `repro_torch.parallel.sharding.resolve_rules`) and ``mesh``
(a ``DeviceMesh``); parameters, batch and caches are then DTensors (`init`
with ``shardings`` makes each rank's shard of the one-device init), and
the step runs under DTensor's implicit replication, so the plain tensors
the model makes (masks, positions, zero states) act as replicated ones.
Without them nothing here touches DTensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import common, encdec, lstm, transformer
from repro_torch.parallel import replicating


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

    def init(self, seed: int = 0, dtype: torch.dtype = torch.float32,
             shardings=None, mesh=None):
        """The seed's parameters; with ``shardings`` (a tree of placements,
        `repro_torch.parallel.sharding.param_shardings`) and ``mesh``,
        DTensors of which each rank holds its shard, drawn leaf by leaf."""
        place = None
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor

            def place(path, t):
                pl = shardings
                for key in path:
                    pl = pl[key]
                return distribute_tensor(t, mesh, pl, src_data_rank=None)
        return common.tree_init(self.defs, seed, dtype, self.device, place)

    def abstract_params(self, dtype: torch.dtype = torch.float32):
        """Meta tensors of the parameters' shapes (no storage)."""
        return common.tree_abstract(self.defs, dtype)

    def param_pspecs(self, rules: Dict):
        """The parameters' specs under resolved ``rules``."""
        return common.tree_pspecs(self.defs, rules)

    def loss_fn(self, params: Dict, batch: Dict, remat=False, rules=None,
                mesh=None) -> Tuple[torch.Tensor, Dict]:
        mod = {"lm": transformer, "encdec": encdec, "lstm": lstm}[self.kind]
        with replicating(mesh is not None):
            return mod.loss_fn(params, batch, self.cfg, remat=remat,
                               rules=rules, mesh=mesh)

    def forward(self, params: Dict, batch: Dict,
                caches: Optional[Dict] = None, rules=None, mesh=None):
        """-> (logits, caches, aux); ``caches`` are filled in place (the
        decoder-only families only)."""
        with replicating(mesh is not None):
            return self._forward(params, batch, caches, rules, mesh)

    def _forward(self, params, batch, caches, rules, mesh):
        if self.kind == "lm":
            return transformer.forward(params, batch["tokens"], self.cfg,
                                       embeds=batch.get("embeds"),
                                       caches=caches, rules=rules,
                                       mesh=mesh)
        if caches is not None:
            raise ValueError(f"{self.cfg.name}: forward fills no caches "
                             f"(the encoder-decoder's come from prefill)")
        if self.kind == "encdec":
            logits = encdec.forward(params, batch["frames"], batch["tokens"],
                                    self.cfg, rules=rules, mesh=mesh)
        else:
            logits = lstm.forward(params, batch["tokens"], self.cfg)
        return logits, None, torch.zeros((), dtype=torch.float32,
                                         device=logits.device)

    def prefill(self, params: Dict, batch: Dict, caches: Optional[Dict] = None,
                rules=None, mesh=None) -> Dict:
        """Caches of a forward over ``batch["tokens"]``, sized to it (KV
        caches and recurrent states); for the encoder-decoder, the encoded
        ``batch["frames"]``' cross K/V and empty self caches.  ``caches``
        (default `init_cache`'s) are filled in place; on a mesh the caller
        gives them laid out by `repro_torch.parallel.sharding.
        cache_shardings`."""
        if self.kind == "lstm":
            self._no_decode("prefill")
        if self.kind == "encdec":
            with replicating(mesh is not None):
                return encdec.prefill(params, batch["frames"], self.cfg,
                                      rules=rules, mesh=mesh, caches=caches)
        b, s = batch["tokens"].shape
        if caches is None:
            caches = self.init_cache(b, s)
        return self.forward(params, batch, caches=caches, rules=rules,
                            mesh=mesh)[1]

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
                    pos: int, rules=None, mesh=None
                    ) -> Tuple[torch.Tensor, Dict]:
        if self.kind == "lstm":
            self._no_decode("decode_step")
        mod = encdec if self.kind == "encdec" else transformer
        with replicating(mesh is not None):
            return mod.decode_step(params, caches, tokens, pos, self.cfg,
                                   rules=rules, mesh=mesh)


def build_model(cfg: ArchConfig, device=None) -> Model:
    if cfg.family == "lstm":
        defs = lstm.lstm_defs(cfg)
    elif cfg.is_encoder_decoder:
        defs = encdec.encdec_defs(cfg)
    else:
        defs = transformer.lm_defs(cfg)
    return Model(cfg=cfg, defs=defs, device=resolve_device(device))


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """Meta tensors of every model input of a shape cell (shapes and
    dtypes, no storage), as the reference's ``input_specs``."""
    b, s = cell.global_batch, cell.seq_len
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                            device="meta")
    if cell.kind == "decode":
        return {"tokens": meta((b, 1), torch.int32)}
    if cfg.is_encoder_decoder:
        d = min(cfg.decoder_len, s)
        specs = {"frames": meta((b, s, cfg.d_model), act),
                 "tokens": meta((b, d), torch.int32),
                 "labels": meta((b, d), torch.int32)}
    else:
        specs = {"tokens": meta((b, s), torch.int32),
                 "labels": meta((b, s), torch.int32)}
        if cfg.frontend == "vision_stub" and cfg.n_patch_tokens:
            specs["embeds"] = meta((b, min(cfg.n_patch_tokens, s),
                                    cfg.d_model), act)
    if cell.kind == "prefill":
        specs.pop("labels")
    return specs
