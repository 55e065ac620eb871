"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts.

24L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408 vocab=151936.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                      # per-expert intermediate
    vocab_size=151936,
    qkv_bias=True,
    n_experts=60,
    experts_per_token=4,
    moe_d_ff=1408,
    n_shared_experts=4,
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    tie_embeddings=True,
    supports_long_context=False,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)
