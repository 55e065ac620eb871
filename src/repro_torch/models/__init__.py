"""repro_torch.models — the LM runtime (the decoder-only families).

  common.py       ParamDef trees, norms, RoPE, the attention call (the
                  hand-written flash-attention kernel)
  rglru.py        the RG-LRU block (recurrentgemma; the scan kernel)
  xlstm.py        the mLSTM (the parallel-form kernel) and sLSTM blocks
  transformer.py  lm_defs / forward / init_cache / decode_step
  model.py        build_model(cfg, device) -> Model
  convert.py      the reference's weights and caches (numpy) <-> tensors
"""

from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
