"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (~7:1 mLSTM:sLSTM).

12L d_model=768 4H (kv=4) d_ff=0 vocab=50304. d_ff=0: the xLSTM block's
up/down projection replaces a separate FFN. sLSTM at layer indices {1, 7}.
[arXiv:2405.04517; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm", "mlstm", "mlstm", "mlstm", "mlstm"),
    ffn_kind="gelu",
    norm_kind="layernorm",
    tie_embeddings=True,
    rope_theta=0.0,                 # xLSTM uses no positional encoding
    supports_long_context=True,     # O(1) matrix/scalar recurrent state
    source="arXiv:2405.04517; unverified",
)
