"""repro_torch.models — the LM runtime (every family of the reference).

  common.py       ParamDef trees, norms, RoPE, sinusoidal positions, the
                  attention call (the hand-written flash-attention kernel)
  moe.py          the MoE layer: top-k routing, the capacity-bounded sort
                  dispatch (scatter_ep and grouped_tp), the Switch aux loss
  rglru.py        the RG-LRU block (recurrentgemma; the scan kernel)
  xlstm.py        the mLSTM (the parallel-form kernel) and sLSTM blocks
  transformer.py  lm_defs / forward / init_cache / decode_step (the
                  decoder-only families, MoE included)
  encdec.py       the encoder-decoder (whisper): encode, forward, prefill
                  of the cross caches, decode_step
  lstm.py         the paper's LSTM LM (paper-lm; no decode path)
  model.py        build_model(cfg, device) -> Model
  convert.py      the reference's weights and caches (numpy) <-> tensors
"""

from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
