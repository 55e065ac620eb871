"""Scenario constants and memory accounting (the part of
``repro.core.scenarios`` the runtime needs so far: `DTYPE_BYTES` and
`kv_cache_bytes`, for the decode measurement's ``bytes``).  The scenario
registry and its folds come with ROADMAP queue 1 item 5.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig

DTYPE_BYTES = 2                     # bf16 weights / KV cache


def kv_cache_bytes(cfg: ArchConfig, kv_len: int, batch: int,
                   dtype_bytes: int = DTYPE_BYTES) -> float:
    """Total KV-cache (+ recurrent-state) bytes for `batch` live sequences.

    Attention layers hold K+V per token: global layers over the full
    context, local layers over min(context, window).  Recurrent blocks
    (RG-LRU, m/sLSTM) hold O(1)-per-sequence state instead.
    """
    hd = cfg.resolved_head_dim
    if cfg.is_encoder_decoder:
        # the decoder holds self-KV over the trained decoder length plus
        # cross-KV over the encoded source sequence; its layers must NOT
        # also be charged the decoder-only full-context KV below
        dec = min(cfg.decoder_len, kv_len)
        per_seq = cfg.n_layers * 2.0 * cfg.n_kv_heads * hd * \
            (dec + kv_len) * dtype_bytes
        return per_seq * batch
    per_seq = 0.0
    for i in range(cfg.n_layers):
        bk = cfg.block_kind(i)
        if bk == "attn":
            ctx = kv_len
            if cfg.attn_kind(i) == "local":
                ctx = min(kv_len, cfg.local_window)
            per_seq += 2.0 * cfg.n_kv_heads * hd * ctx * dtype_bytes
        elif bk == "rglru":
            w = cfg.lru_width or cfg.d_model
            per_seq += (w + cfg.conv1d_width * w) * 4  # f32 carry state
        else:                                          # mlstm / slstm
            per_seq += cfg.n_heads * hd * hd * 4
    return per_seq * batch
