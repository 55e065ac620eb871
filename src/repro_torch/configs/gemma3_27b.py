"""gemma3-27b [dense] — 5 local : 1 global attention pattern, 128k context.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
[hf:google/gemma-3-1b-pt; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    local_window=1024,
    ffn_kind="gelu",                # gemma GeGLU
    norm_kind="rmsnorm",
    tie_embeddings=True,
    logits_softcap=30.0,
    # long_500k RUNS: 5/6 of layers have a bounded 1024-token window; the
    # ~10 global layers hold a sharded KV cache and decode is linear.
    supports_long_context=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)
