"""qwen3-moe-30b-a3b [moe] — 128 routed experts, top-8.

48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768 vocab=151936.
[hf:Qwen/Qwen3-30B-A3B; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                       # per-expert intermediate
    vocab_size=151936,
    n_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    n_shared_experts=0,
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    tie_embeddings=False,
    supports_long_context=False,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
