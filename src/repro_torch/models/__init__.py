"""repro_torch.models — the LM runtime (decoder-only attention families).

  common.py       ParamDef trees, norms, RoPE, the attention call (the
                  hand-written flash-attention kernel)
  transformer.py  lm_defs / forward / init_cache / decode_step
  model.py        build_model(cfg, device) -> Model
  convert.py      the reference's weights and caches (numpy) <-> tensors
"""

from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
