"""The paper's own case-study workload (§9): 2-layer LSTM language model,
hidden 16K, global batch 16K, vocab 800K, seq 20, across 512 nodes.

Used by the CrossFlow benchmarks (fig9/fig10/fig11) and, in reduced form, by
the measured-vs-predicted CPU validation (fig8).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paper-lm",
    family="lstm",
    n_layers=2,
    d_model=16384,                  # hidden dim
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=800000,
    block_pattern=("lstm",),
    ffn_kind="gelu",
    norm_kind="layernorm",
    tie_embeddings=False,
    rope_theta=0.0,
    supports_long_context=False,
    source="DeepFlow paper §9",
)

# the paper's iteration shape
SEQ_LEN = 20
GLOBAL_BATCH = 16384
N_NODES = 512
