"""whisper-large-v3 [audio] — enc-dec transformer backbone.

32L d_model=1280 20H (GQA kv=20) d_ff=5120 vocab=51866. Conv/audio frontend
is a STUB per the assignment: `input_specs()` supplies precomputed 1280-d
frame embeddings. [arXiv:2212.04356; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,                    # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    attn_pattern=("global",),
    qkv_bias=True,
    block_pattern=("attn",),
    is_encoder_decoder=True,
    n_encoder_layers=32,
    decoder_len=448,
    frontend="audio_stub",
    ffn_kind="gelu",
    norm_kind="layernorm",
    tie_embeddings=True,
    rope_theta=0.0,                 # sinusoidal positions, no RoPE
    supports_long_context=False,    # full-attention encoder: long_500k skipped
    source="arXiv:2212.04356; unverified",
)
