"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent.

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.
[arXiv:2402.19427; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    attn_pattern=("local",),
    local_window=2048,
    block_pattern=("rglru", "rglru", "attn"),   # 2 recurrent : 1 attention
    lru_width=2560,
    conv1d_width=4,
    ffn_kind="gelu",                # recurrentgemma uses GeGLU
    norm_kind="rmsnorm",
    tie_embeddings=True,
    supports_long_context=True,     # O(1) recurrent state + bounded window
    source="arXiv:2402.19427; hf",
)
