"""Whisper-style encoder-decoder backbone, as ``repro.models.encdec``.

The conv / mel audio front end is a stub, as in the reference: the
encoder takes precomputed (batch, frames, d_model) frame embeddings.
Sinusoidal positions on both sides (`common.sinusoidal_positions`, the
reference's table bit for bit).  A decoder layer is causal
self-attention, cross-attention over the encoder states and an FFN; the
cross K/V are computed once by `prefill` and cached.  Every attention call
(the encoder's non-causal self-attention, the decoder's causal one and the
cross-attention, sq != skv) is the hand-written flash-attention kernel.

Layer stacks are the reference's stacked trees, applied by a Python loop
over the leading layers axis.  Caches are written in place, as in
`repro_torch.models.transformer`.  Quirks kept from the reference:

  * the decoder's self cache is a ring of ``decoder_len`` slots whatever
    the serving length, and `decode_step` clamps its position embedding
    to row ``decoder_len - 1`` (``dynamic_slice_in_dim`` clamps);
  * `init_cache(batch, enc_len)` takes the *encoder* length: a serving
    loop that steps tokens from `init_cache` attends over a zero cross
    cache, and the encoder runs in `prefill`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common
from repro_torch.models.common import ParamDef
from repro_torch.models.transformer import (_adtype, _rematted, _tied,
                                            attention_apply, attention_defs,
                                            ffn_apply, ffn_defs, stack_defs)


def _enc_block_defs(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    return {"ln1": common.norm_defs(cfg.norm_kind, d),
            "attn": attention_defs(cfg),
            "ln2": common.norm_defs(cfg.norm_kind, d),
            "ffn": ffn_defs(cfg)}


def _dec_block_defs(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    return {"ln1": common.norm_defs(cfg.norm_kind, d),
            "self": attention_defs(cfg),
            "lnx": common.norm_defs(cfg.norm_kind, d),
            "cross": attention_defs(cfg),
            "ln2": common.norm_defs(cfg.norm_kind, d),
            "ffn": ffn_defs(cfg)}


def encdec_defs(cfg: ArchConfig) -> Dict:
    return {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "fsdp"),
                          scale=0.02),
        "enc": stack_defs(_enc_block_defs(cfg), cfg.n_encoder_layers),
        "enc_norm": common.norm_defs(cfg.norm_kind, cfg.d_model),
        "dec": stack_defs(_dec_block_defs(cfg), cfg.n_layers),
        "dec_norm": common.norm_defs(cfg.norm_kind, cfg.d_model),
    }


def _enc_block(p, x, cfg, rules, mesh):
    h = common.norm(cfg.norm_kind, x, p["ln1"])
    a, _ = attention_apply(p["attn"], h, cfg, causal=False, rules=rules,
                           mesh=mesh)
    x = common.residual(x, a, rules, mesh)
    h = common.norm(cfg.norm_kind, x, p["ln2"])
    return common.residual(x, ffn_apply(p["ffn"], h, cfg, rules, mesh), rules,
                           mesh)


def encode(params: Dict, frames: torch.Tensor, cfg: ArchConfig, *,
           rules=None, mesh=None) -> torch.Tensor:
    """(batch, frames, d_model) frame embeddings -> encoder states."""
    x = frames.to(_adtype(cfg))
    x = x + common.sinusoidal_positions(x.shape[1], cfg.d_model,
                                        x.device).to(x.dtype)[None]
    x = common.logical(x, ("batch", "act_seq", "act_embed"), rules, mesh)
    for i in range(cfg.n_encoder_layers):
        x = _enc_block(common.layer_params(params["enc"], i), x, cfg, rules,
                       mesh)
    return common.norm(cfg.norm_kind, x, params["enc_norm"])


def _dec_block(p, x, cfg, enc_out, self_cache=None, cross_cache=None,
               pos=None, rules=None, mesh=None):
    h = common.norm(cfg.norm_kind, x, p["ln1"])
    a, _ = attention_apply(p["self"], h, cfg, causal=True, cache=self_cache,
                           pos=pos, rules=rules, mesh=mesh)
    x = common.residual(x, a, rules, mesh)
    h = common.norm(cfg.norm_kind, x, p["lnx"])
    a, _ = attention_apply(p["cross"], h, cfg, causal=False,
                           kv_source=enc_out, cache=cross_cache,
                           cross_cache_only=enc_out is None, rules=rules,
                           mesh=mesh)
    x = common.residual(x, a, rules, mesh)
    h = common.norm(cfg.norm_kind, x, p["ln2"])
    return common.residual(x, ffn_apply(p["ffn"], h, cfg, rules, mesh), rules,
                           mesh)


def _embed_tokens(params, cfg, tokens):
    x = common.lookup(params["embed"], tokens, _adtype(cfg))
    pe = common.sinusoidal_positions(tokens.shape[1], cfg.d_model, x.device)
    return x + pe.to(x.dtype)[None]


def _logits(params, cfg, x):
    x = common.norm(cfg.norm_kind, x, params["dec_norm"])
    return common.mask_padded_vocab(
        common.head_logits(x, params["embed"].t()).float(),
        cfg.vocab_size)


def forward(params: Dict, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: ArchConfig, *, remat=False, rules=None, mesh=None
            ) -> torch.Tensor:
    """Training forward: (frame embeddings, decoder tokens) -> logits.
    ``remat`` (any true value) checkpoints each decoder layer, as the
    reference's ``jax.checkpoint(body)``."""
    enc_out = encode(params, frames, cfg, rules=rules, mesh=mesh)
    params = _tied(params, cfg)
    x = _embed_tokens(params, cfg, tokens)
    x = common.logical(x, ("batch", "act_seq", "act_embed"), rules, mesh)
    body = _rematted(lambda x, lp: _dec_block(lp, x, cfg, enc_out,
                                              rules=rules, mesh=mesh),
                     bool(remat))
    for i in range(cfg.n_layers):
        x = body(x, common.layer_params(params["dec"], i))
    return common.logical(_logits(params, cfg, x),
                          ("batch", "act_seq", "vocab"), rules, mesh)


def init_cache(cfg: ArchConfig, batch: int, enc_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Dict:
    """Self caches of ``decoder_len`` slots, cross caches of ``enc_len``,
    stacked over the decoder layers (zeros)."""
    nkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    L = cfg.n_layers

    def zeros(s):
        return torch.zeros((L, batch, nkv, s, hd), dtype=dtype,
                           device=device)
    return {"self": {"k": zeros(cfg.decoder_len),
                     "v": zeros(cfg.decoder_len)},
            "cross": {"k": zeros(enc_len), "v": zeros(enc_len)}}


def prefill(params: Dict, frames: torch.Tensor, cfg: ArchConfig, *,
            dtype: torch.dtype = torch.bfloat16, rules=None, mesh=None,
            caches: Dict = None) -> Dict:
    """Encode, then each decoder layer's cross K/V (with their biases)
    into the cache; empty self caches.  ``caches`` (default
    `init_cache`'s zeros) are written in place.  On a mesh (``rules``,
    ``mesh``; DTensor parameters and frames) the encoder runs on the mesh
    and the caller gives ``caches`` laid out by `sharding.cache_shardings`
    (`repro_torch.launch.serve`, `repro_torch.launch.dryrun`): each rank
    writes its own shards."""
    enc_out = encode(params, frames, cfg, rules=rules, mesh=mesh)
    b, s = frames.shape[:2]
    nkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if caches is None:
        caches = init_cache(cfg, b, s, dtype, frames.device)
    for i in range(cfg.n_layers):
        cp = common.layer_params(params["dec"], i)["cross"]
        for name in ("k", "v"):
            kv = enc_out @ cp[f"w{name}"].to(enc_out.dtype)
            if f"b{name}" in cp:
                kv = kv + cp[f"b{name}"].to(enc_out.dtype)
            kv = common.split_last(kv, nkv, hd).transpose(1, 2)
            common.write_(caches["cross"][name], (slice(i, i + 1),),
                          kv[None])
    return caches


def decode_step(params: Dict, caches: Dict, tokens: torch.Tensor, pos: int,
                cfg: ArchConfig, rules=None, mesh=None
                ) -> Tuple[torch.Tensor, Dict]:
    """One decoder token against the self cache (a ring of ``decoder_len``)
    and the cross cache; both updated in place (the cross cache is only
    read).  ``pos`` is a host int."""
    params = _tied(params, cfg)
    x = common.lookup(params["embed"], tokens, _adtype(cfg))
    pe = common.sinusoidal_positions(cfg.decoder_len, cfg.d_model, x.device)
    row = min(max(int(pos), 0), cfg.decoder_len - 1)
    x = x + pe[row:row + 1].to(x.dtype)[None]
    for i in range(cfg.n_layers):
        lp = common.layer_params(params["dec"], i)
        sc = common.tree_index(caches["self"], i)
        cc = common.tree_index(caches["cross"], i)
        x = _dec_block(lp, x, cfg, None, sc, cc, int(pos), rules, mesh)
    return _logits(params, cfg, x), caches


def loss_fn(params: Dict, batch: Dict, cfg: ArchConfig, *, remat=False,
            rules=None, mesh=None) -> Tuple[torch.Tensor, Dict]:
    logits = forward(params, batch["frames"], batch["tokens"], cfg,
                     remat=remat, rules=rules, mesh=mesh)
    ce = common.cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}
