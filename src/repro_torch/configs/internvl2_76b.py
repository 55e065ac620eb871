"""internvl2-76b [vlm] — InternViT (stub) + InternLM2 backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. The ViT frontend is
a STUB per the assignment: `input_specs()` supplies precomputed patch
embeddings occupying the first `n_patch_tokens` positions.
[arXiv:2404.16821; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision_stub",
    n_patch_tokens=256,
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    tie_embeddings=False,
    supports_long_context=False,
    source="arXiv:2404.16821; unverified",
)
