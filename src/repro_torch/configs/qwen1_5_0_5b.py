"""qwen1.5-0.5b [dense] — QKV bias, full attention.

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936.
[hf:Qwen/Qwen1.5-0.5B; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    tie_embeddings=True,
    supports_long_context=False,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
