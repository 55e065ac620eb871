"""Architecture / shape-cell config schema and registry.

Every assigned architecture gets one module in this package defining
``CONFIG = ArchConfig(...)`` with the exact published dimensions; the
registry maps ``--arch <id>`` to it. ``reduced()`` shrinks any config to a
CPU-smoke-testable size of the *same family* (same block pattern, same
attention kinds, fewer/smaller everything).
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention structure -------------------------------------------------
    attn_pattern: Tuple[str, ...] = ("global",)   # cycled over attn layers
    local_window: int = 1024
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # block structure (cycled over layers) ---------------------------------
    block_pattern: Tuple[str, ...] = ("attn",)    # attn | rglru | mlstm | slstm
    lru_width: Optional[int] = None               # rglru recurrence width
    conv1d_width: int = 4
    # MoE -------------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # scatter_ep: global scatter into an expert-sharded buffer (baseline);
    # grouped_tp: per-DP-group local dispatch + tensor-parallel expert
    # weights — the §Perf hillclimb winner (no cross-shard scatter)
    moe_impl: str = "scatter_ep"
    moe_groups: int = 0             # grouped_tp: groups (0 -> DP degree)
    # encoder-decoder ---------------------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    decoder_len: int = 448          # trained decoder length (whisper: 448)
    # modality stubs ----------------------------------------------------------
    frontend: str = "none"          # none | audio_stub | vision_stub
    n_patch_tokens: int = 0         # vlm: stubbed ViT patch embeddings
    # misc --------------------------------------------------------------------
    ffn_kind: str = "swiglu"        # swiglu | gelu
    norm_kind: str = "rmsnorm"      # rmsnorm | layernorm
    tie_embeddings: bool = True
    logits_softcap: float = 0.0
    supports_long_context: bool = False
    dtype: str = "bfloat16"
    source: str = ""                # provenance tag from the assignment

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 256 multiple: MXU-aligned and divisible by the
        model mesh axis (whisper's 51866 is not). Padded logit slots are
        masked to -inf in the head."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    def attn_kind(self, layer: int) -> str:
        return self.attn_pattern[layer % len(self.attn_pattern)]

    # ---- parameter accounting (used for 6ND MODEL_FLOPS, roofline) -------
    def param_count(self) -> int:
        return _params(self, active_only=False)

    def active_param_count(self) -> int:
        return _params(self, active_only=True)


def _attn_params(cfg: ArchConfig) -> int:
    hd = cfg.resolved_head_dim
    q = cfg.d_model * cfg.n_heads * hd
    kv = 2 * cfg.d_model * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * cfg.d_model
    return q + kv + o


def _ffn_params(cfg: ArchConfig, d_ff: int) -> int:
    mult = 3 if cfg.ffn_kind == "swiglu" else 2
    return mult * cfg.d_model * d_ff


def _block_params(cfg: ArchConfig, kind: str, active_only: bool) -> int:
    d = cfg.d_model
    if kind == "attn":
        p = _attn_params(cfg)
        if cfg.is_moe:
            e_act = cfg.experts_per_token if active_only else cfg.n_experts
            p += e_act * _ffn_params(cfg, cfg.moe_d_ff)
            p += cfg.n_shared_experts * _ffn_params(cfg, cfg.moe_d_ff)
            p += d * cfg.n_experts                     # router
        else:
            p += _ffn_params(cfg, cfg.d_ff)
        return p
    if kind == "rglru":
        w = cfg.lru_width or d
        # in/out projections + gates + temporal conv (recurrentgemma block)
        p = 2 * d * w + 2 * w * w // 1 + cfg.conv1d_width * w + 2 * w
        p += _ffn_params(cfg, cfg.d_ff)
        return p
    if kind in ("mlstm", "slstm"):
        hd = cfg.resolved_head_dim
        nh = cfg.n_heads
        qkv = 3 * d * nh * hd
        gates = 3 * d * nh if kind == "mlstm" else 4 * d * nh * hd
        out = nh * hd * d
        up = 2 * d * (2 * d)                           # proj up/down block
        return qkv + gates + out + up
    raise ValueError(kind)


def _params(cfg: ArchConfig, active_only: bool) -> int:
    total = cfg.vocab_size * cfg.d_model              # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model
    layers = list(range(cfg.n_layers))
    for i in layers:
        total += _block_params(cfg, cfg.block_kind(i), active_only)
    if cfg.is_encoder_decoder:
        for i in range(cfg.n_encoder_layers):
            total += _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        total += cfg.n_layers * _attn_params(cfg)     # cross-attention
    return int(total)


# ---------------------------------------------------------------------------
# Shape cells (assigned input shapes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token per sequence
        return self.seq_len * self.global_batch


SHAPE_CELLS: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


ARCH_IDS = (
    "whisper_large_v3", "recurrentgemma_2b", "qwen1_5_0_5b", "phi3_medium_14b",
    "gemma3_27b", "mistral_large_123b", "internvl2_76b", "qwen2_moe_a2_7b",
    "qwen3_moe_30b_a3b", "xlstm_125m",
)
# external ids (--arch accepts either form)
_ALIASES = {
    "whisper-large-v3": "whisper_large_v3",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "phi3-medium-14b": "phi3_medium_14b",
    "gemma3-27b": "gemma3_27b",
    "mistral-large-123b": "mistral_large_123b",
    "internvl2-76b": "internvl2_76b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "xlstm-125m": "xlstm_125m",
    "paper-lm": "paper_lm",
}


def get_config(arch: str) -> ArchConfig:
    mod_name = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def applicable_cells(cfg: ArchConfig):
    """The shape cells this arch runs (DESIGN.md §Arch-applicability)."""
    for cell in SHAPE_CELLS.values():
        if cell.name == "long_500k" and not cfg.supports_long_context:
            continue                # pure full-attention: documented skip
        yield cell


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Shrink to a CPU-smoke size preserving the family structure."""
    scale_layers = max(len(cfg.block_pattern),
                       2 if not cfg.is_encoder_decoder else 2)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, max(scale_layers, 2)),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        lru_width=128 if cfg.lru_width else None,
        local_window=32,
        n_experts=min(cfg.n_experts, 8),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        decoder_len=16,
        n_patch_tokens=min(cfg.n_patch_tokens, 8),
    )
