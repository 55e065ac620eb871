"""Decoder-only LM: the attention families (dense, GQA, local/global with a
ring-buffer cache, QKV bias, RoPE, logit softcap, the vision-stub
``embeds``), MoE, hybrid and xLSTM of ``repro.models.transformer``.

Layers come in *pattern groups*: the per-layer kind sequence has period
lcm(|block_pattern|, |attn_pattern|); per-group params are stacked along a
leading ``layers`` axis (the reference's tree layout, so weights cross 1:1)
and applied by a Python loop over that axis where the reference scans; a
partial remainder group (gemma3: 62 = 6*10 + 2) is applied explicitly.

Blocks are attention (dense, GQA, local/global) followed by an FFN or,
for MoE archs, the routed experts (`repro_torch.models.moe`), RG-LRU
(recurrentgemma, `repro_torch.models.rglru`) and mLSTM / sLSTM (xLSTM,
`repro_torch.models.xlstm`).  Every attention call goes through
`common.chunked_attention`, that is the hand-written flash-attention
kernel; the RG-LRU scan and the mLSTM parallel form over a prompt launch
their own hand-written kernels.  `attention_apply` also serves the
encoder-decoder's cross-attention (`repro_torch.models.encdec`).

Caches are written in place: `forward` with caches (prefill) and
`decode_step` update the cache tensors they are given (KV caches and
recurrent states alike) and return the same dict, where the reference
returns new arrays of equal value.

Each model exposes:
    lm_defs(cfg)                    ParamDef tree (single source of truth)
    forward(params, tokens, ...)    logits (train / prefill; optional caches;
                                    ``remat`` per pattern group)
    init_cache(cfg, batch, len)     decode caches
    decode_step(params, cache, tokens, pos)
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.common import ParamDef

# ---------------------------------------------------------------------------
# pattern machinery
# ---------------------------------------------------------------------------


def effective_pattern(cfg: ArchConfig) -> List[Tuple[str, str]]:
    """Per-layer (block_kind, attn_kind) with the combined period."""
    period = len(cfg.block_pattern)
    if "attn" in cfg.block_pattern:
        period = math.lcm(period, len(cfg.attn_pattern))
    period = min(period, cfg.n_layers)
    return [(cfg.block_kind(i),
             cfg.attn_kind(i) if cfg.block_kind(i) == "attn" else "-")
            for i in range(period)]


def group_layout(cfg: ArchConfig) -> Tuple[List[Tuple[str, str]], int, int]:
    """(pattern, n_full_groups, n_remainder_layers)."""
    if cfg.n_layers == 0:
        return [], 0, 0
    pat = effective_pattern(cfg)
    return pat, cfg.n_layers // len(pat), cfg.n_layers % len(pat)


def stack_defs(defs, n: int):
    return common.tree_map(
        lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes,
                           init=d.init, scale=d.scale), defs)


# ---------------------------------------------------------------------------
# attention / ffn blocks
# ---------------------------------------------------------------------------


def attention_defs(cfg: ArchConfig) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    defs = {
        "wq": ParamDef((d, nh * hd), ("fsdp", "heads")),
        "wk": ParamDef((d, nkv * hd), ("fsdp", "heads")),
        "wv": ParamDef((d, nkv * hd), ("fsdp", "heads")),
        "wo": ParamDef((nh * hd, d), ("heads", "fsdp")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((nh * hd,), ("heads",), init="zeros")
        defs["bk"] = ParamDef((nkv * hd,), ("heads",), init="zeros")
        defs["bv"] = ParamDef((nkv * hd,), ("heads",), init="zeros")
    return defs


def _proj(x, w, b=None):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def attention_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                    causal: bool = True, window: Optional[int] = None,
                    cache: Optional[Dict] = None, pos: Optional[int] = None,
                    kv_source: Optional[torch.Tensor] = None,
                    cross_cache_only: bool = False, rules=None, mesh=None
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (b, s, d). Modes:
      train:    cache=None                          -> (out, None)
      prefill:  cache={k,v empty (b,nkv,S,hd)}      -> (out, filled cache)
      decode:   cache filled, pos = current length  -> (out, updated cache)
      cross:    kv_source = encoder states (keys and values projected from
                them, no mask); cross_cache_only reads the precomputed
                cross K/V in ``cache`` without reprojecting (decode)
    ``pos`` is a host int; the cache is updated in place.  On a mesh
    (``rules`` and ``mesh``, DTensor inputs) q is constrained to its
    batch and head shards, and the kernel runs on each rank's own.
    """
    b, s, d = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = _proj(x, p["wq"], p.get("bq")).reshape(b, s, nh, hd)
    if cross_cache_only:
        out = common.chunked_attention(
            q.transpose(1, 2), cache["k"].to(x.dtype),
            cache["v"].to(x.dtype), causal=False)
        out = out.transpose(1, 2).reshape(b, s, nh * hd)
        return _proj(out, p["wo"]), cache
    src = kv_source if kv_source is not None else x
    skv = src.shape[1]
    k = _proj(src, p["wk"], p.get("bk")).reshape(b, skv, nkv, hd)
    v = _proj(src, p["wv"], p.get("bv")).reshape(b, skv, nkv, hd)

    if cfg.rope_theta:
        qpos = torch.arange(s, device=x.device) + (pos or 0)
        kpos = torch.arange(skv, device=x.device) if pos is None else qpos
        q = common.rope(q, qpos.expand(b, s), cfg.rope_theta)
        k = common.rope(k, kpos.expand(b, skv), cfg.rope_theta)

    q = q.transpose(1, 2)                             # (b, nh, s, hd)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    q = common.logical(q, ("batch", "act_heads", "act_seq", None), rules,
                       mesh)

    kv_len = None
    q_off = 0
    if kv_source is not None:
        causal = False
    elif cache is not None:
        W = cache["k"].shape[2]
        if pos is None:                                # prefill: write [0:s]
            kk, vv = k, v
            if W < s:                                  # local ring: tail only
                kk, vv = kk[:, :, -W:], vv[:, :, -W:]
                # slot of absolute position p is p % W: place the tail so
                # decode's `pos % W` indexing continues consistently
                shift = (s - W) % W
                kk = torch.roll(kk, shift, dims=2)
                vv = torch.roll(vv, shift, dims=2)
            n = kk.shape[2]
            common.write_(cache["k"], (slice(None), slice(None),
                                       slice(0, n)), kk)
            common.write_(cache["v"], (slice(None), slice(None),
                                       slice(0, n)), vv)
            # attention over just the fresh kv (standard causal prefill)
        else:                                          # decode: write at pos
            # Ring-buffer write: local-attention layers keep only a
            # window-sized cache (W < max_len) and wrap; softmax is
            # permutation-invariant so slot order inside the ring is
            # irrelevant, only validity (kv_len) matters.  Full caches
            # (W == max_len) reduce to the ordinary absolute write.  The
            # start is clamped as dynamic_update_slice clamps it.
            wpos = min(pos % W, W - s)
            at = (slice(None), slice(None), slice(wpos, wpos + s))
            common.write_(cache["k"], at, k)
            common.write_(cache["v"], at, v)
            k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
            kv_len = min(pos + 1, W)
            q_off = pos
            causal = False                 # ring entries are all <= pos
            window = None                  # the ring IS the window

    out = common.chunked_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_off, kv_len=kv_len)
    out = out.transpose(1, 2).reshape(b, s, nh * hd)
    return _proj(out, p["wo"]), cache


def ffn_defs(cfg: ArchConfig, d_ff: Optional[int] = None) -> Dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    mult = 2 if cfg.ffn_kind == "swiglu" else 1
    return {"wi": ParamDef((d, mult * f), ("fsdp", "mlp")),
            "wo": ParamDef((f, d), ("mlp", "fsdp"))}


def ffn_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig, rules=None,
              mesh=None) -> torch.Tensor:
    h = x @ p["wi"].to(x.dtype)
    h = common.logical(h, ("batch", "act_seq", "mlp"), rules, mesh)
    if cfg.ffn_kind == "swiglu":
        u, g = torch.chunk(h, 2, dim=-1)
        h = common.activation("swiglu", g) * u
    else:
        h = common.activation(cfg.ffn_kind, h)
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# block dispatch
# ---------------------------------------------------------------------------


def block_defs(cfg: ArchConfig, kind: str, attn_kind: str) -> Dict:
    d = cfg.d_model
    if kind == "attn":
        defs = {"ln1": common.norm_defs(cfg.norm_kind, d),
                "attn": attention_defs(cfg),
                "ln2": common.norm_defs(cfg.norm_kind, d)}
        defs["moe" if cfg.is_moe else "ffn"] = (
            moe_lib.moe_defs(cfg) if cfg.is_moe else ffn_defs(cfg))
        return defs
    if kind == "rglru":
        return {"ln1": common.norm_defs(cfg.norm_kind, d),
                "rec": rglru_lib.rglru_defs(cfg),
                "ln2": common.norm_defs(cfg.norm_kind, d),
                "ffn": ffn_defs(cfg)}
    if kind == "mlstm":
        return {"ln1": common.norm_defs(cfg.norm_kind, d),
                "mlstm": xlstm_lib.mlstm_defs(cfg)}
    if kind == "slstm":
        return {"ln1": common.norm_defs(cfg.norm_kind, d),
                "slstm": xlstm_lib.slstm_defs(cfg)}
    raise ValueError(kind)


def block_cache(cfg: ArchConfig, kind: str, attn_kind: str, batch: int,
                max_len: int, dtype: torch.dtype, device) -> Dict:
    """A block's decode cache: K/V in ``dtype`` for attention, the fp32
    recurrent state for the others (as the reference's)."""
    if kind == "attn":
        # local-attention layers keep a ring buffer of exactly the window
        # (attention_apply wraps the write position)
        s = min(max_len, cfg.local_window) if attn_kind == "local" \
            else max_len
        shape = (batch, cfg.n_kv_heads, s, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "rglru":
        return rglru_lib.rglru_init_state(cfg, batch, device)
    if kind == "mlstm":
        return xlstm_lib.mlstm_init_state(cfg, batch, device)
    if kind == "slstm":
        return xlstm_lib.slstm_init_state(cfg, batch, device)
    raise ValueError(kind)


def _store(cache: Dict, state: Dict) -> Dict:
    """Write a recurrent state into the cache's tensors in place (they may
    be views of a stacked group).  A conv tail shorter than the cache's
    (a prompt of fewer than ``kw - 1`` tokens) fills its last rows, the
    rows before it zero."""
    for key, val in state.items():
        dst = cache[key]
        at = (slice(None),)
        if dst.shape != val.shape:
            dst.zero_()
            at = (slice(None), slice(dst.shape[1] - val.shape[1], None))
        common.write_(dst, at, val)
    return cache


def block_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig, kind: str,
                attn_kind: str, *, cache=None, pos: Optional[int] = None,
                rules=None, mesh=None
                ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Returns (x_out, new_cache, aux_loss).  Modes: train (no cache),
    prefill (cache given, no pos), decode (pos given); the cache is
    updated in place."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = common.norm(cfg.norm_kind, x, p["ln1"])
    if kind == "attn":
        window = cfg.local_window if attn_kind == "local" else None
        a, new_cache = attention_apply(p["attn"], h, cfg, causal=True,
                                       window=window, cache=cache, pos=pos,
                                       rules=rules, mesh=mesh)
        x = x + a
        h = common.norm(cfg.norm_kind, x, p["ln2"])
        if cfg.is_moe:
            f, aux = moe_lib.moe_apply(p["moe"], h, cfg, rules, mesh)
        else:
            f = ffn_apply(p["ffn"], h, cfg, rules, mesh)
        x = x + f
        x = common.logical(x, ("batch", "act_seq", "act_embed"), rules,
                           mesh)
        return x, new_cache, aux
    if kind == "rglru":
        if cache is None:                                  # train
            r = rglru_lib.rglru_apply(p["rec"], h, cfg)
        elif pos is None:                                  # prefill
            r, state = rglru_lib.rglru_apply(p["rec"], h, cfg,
                                             return_state=True)
            _store(cache, state)
        else:                                              # decode
            r, state = rglru_lib.rglru_decode(p["rec"], h, cache, cfg)
            _store(cache, state)
        x = x + r
        h = common.norm(cfg.norm_kind, x, p["ln2"])
        return x + ffn_apply(p["ffn"], h, cfg, rules, mesh), cache, aux
    if kind == "mlstm":
        if pos is None:
            r = xlstm_lib.mlstm_apply(p["mlstm"], h, cfg)
            if cache is not None:                          # prefill
                _store(cache, xlstm_lib.mlstm_prefill_state(p["mlstm"], h,
                                                            cfg))
        else:                                              # decode
            r, state = xlstm_lib.mlstm_decode(p["mlstm"], h, cache, cfg)
            _store(cache, state)
        return x + r, cache, aux
    if kind == "slstm":
        if cache is None:                                  # train
            r = xlstm_lib.slstm_apply(p["slstm"], h, cfg)
        elif pos is None:                                  # prefill
            r, state = xlstm_lib.slstm_apply(p["slstm"], h, cfg,
                                             return_state=True)
            _store(cache, state)
        else:                                              # decode
            r, state = xlstm_lib.slstm_decode(p["slstm"], h, cache, cfg)
            _store(cache, state)
        return x + r, cache, aux
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# full LM
# ---------------------------------------------------------------------------


def lm_defs(cfg: ArchConfig) -> Dict:
    pat, n_groups, rem = group_layout(cfg)
    group = {f"b{j}": block_defs(cfg, bk, ak)
             for j, (bk, ak) in enumerate(pat)}
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "fsdp"),
                          scale=0.02),
        "final_norm": common.norm_defs(cfg.norm_kind, cfg.d_model),
    }
    if n_groups:
        defs["groups"] = stack_defs(group, n_groups)
    if rem:
        defs["rem"] = {f"b{j}": block_defs(cfg, *pat[j]) for j in range(rem)}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.padded_vocab),
                                ("fsdp", "vocab"))
    return defs


def _adtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _embed(params, cfg, tokens, embeds=None, rules=None, mesh=None):
    x = common.lookup(params["embed"], tokens).to(_adtype(cfg))
    if cfg.family in ("dense", "moe", "hybrid"):
        # the constant rounded to the activation dtype first, as
        # jnp.asarray(sqrt(d), x.dtype) is (on the host: no device sync)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    if embeds is not None:                    # vlm/audio stub front-end
        n = embeds.shape[1]
        x = torch.cat([embeds.to(x.dtype), x[:, n:]], dim=1)
    return common.logical(x, ("batch", "act_seq", "act_embed"), rules, mesh)


def _head(params, cfg, x):
    w = common.gather_dp(params["embed"].t() if cfg.tie_embeddings
                         else params["head"])
    logits = x @ w.to(x.dtype)
    logits = common.softcap(logits.float(), cfg.logits_softcap)
    return common.mask_padded_vocab(logits, cfg.vocab_size)


def _units(params, caches, cfg):
    """The layers in order, as (stacked, layers): each stacked pattern
    group, then each remainder layer alone; a layer is (block params,
    block cache or None, block kind, attn kind)."""
    pat, n_groups, rem = group_layout(cfg)
    for g in range(n_groups):
        gp = common.layer_params(params["groups"], g)
        gc = common.tree_index(caches["groups"], g) if caches else None
        yield True, [(gp[f"b{j}"], gc[f"b{j}"] if gc else None, bk, ak)
                     for j, (bk, ak) in enumerate(pat)]
    for j in range(rem):
        c = caches["rem"][f"b{j}"] if caches else None
        yield False, [(common.gather_dp(params["rem"][f"b{j}"]), c,
                       *pat[j])]


def _layers(params, caches, cfg):
    """`_units`' layers, one by one."""
    for _, layers in _units(params, caches, cfg):
        yield from layers


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                  torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_saveable``: keep the matrix
    products' outputs, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _rematted(fn: Callable, remat) -> Callable:
    """``fn`` under the reference's ``remat``: False as it is, True
    recomputed in the backward (non-reentrant `torch.utils.checkpoint`),
    ``"dots"`` recomputed but for its matrix products' outputs."""
    if not remat:
        return fn
    from torch.utils import checkpoint
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            checkpoint.create_selective_checkpoint_contexts, _dots_saveable)
    elif remat is not True:
        raise ValueError(f"remat must be False, True or 'dots', got "
                         f"{remat!r}")
    return lambda *args: checkpoint.checkpoint(fn, *args,
                                               use_reentrant=False, **kw)


def forward(params: Dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            embeds: Optional[torch.Tensor] = None,
            caches: Optional[Dict] = None, remat=False, rules=None, mesh=None
            ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Train (caches=None) / prefill (caches=init, filled in place).
    Returns (logits, caches, aux).  ``remat`` (False, True or ``"dots"``,
    the reference's) checkpoints each stacked pattern group, as the
    reference checkpoints its scanned group body; the remainder layers are
    not checkpointed, as there."""
    x = _embed(params, cfg, tokens, embeds, rules, mesh)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(x, layers):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for bp, bc, bk, ak in layers:
            x, _, a = block_apply(bp, x, cfg, bk, ak, cache=bc, rules=rules,
                                  mesh=mesh)
            aux = aux + a
        return x, aux

    grouped = _rematted(run, remat)
    for stacked, layers in _units(params, caches, cfg):
        x, a = (grouped if stacked else run)(x, layers)
        aux_total = aux_total + a
    x = common.norm(cfg.norm_kind, x, params["final_norm"])
    logits = common.logical(_head(params, cfg, x),
                            ("batch", "act_seq", "vocab"), rules, mesh)
    return logits, caches, aux_total


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Dict:
    pat, n_groups, rem = group_layout(cfg)
    out: Dict[str, Any] = {}
    if n_groups:
        out["groups"] = {
            f"b{j}": common.tree_map(
                lambda a: a.unsqueeze(0).repeat(
                    (n_groups,) + (1,) * a.dim()),
                block_cache(cfg, bk, ak, batch, max_len, dtype, device))
            for j, (bk, ak) in enumerate(pat)}
    if rem:
        out["rem"] = {f"b{j}": block_cache(cfg, *pat[j], batch, max_len,
                                           dtype, device)
                      for j in range(rem)}
    return out


def decode_step(params: Dict, caches: Dict, tokens: torch.Tensor, pos: int,
                cfg: ArchConfig, rules=None, mesh=None
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token step. tokens: (b, 1) int; pos: host int (current cache
    length).  Returns (logits (b, 1, vocab), caches updated in place)."""
    x = _embed(params, cfg, tokens, None, rules, mesh)
    for bp, bc, bk, ak in _layers(params, caches, cfg):
        x, _, _ = block_apply(bp, x, cfg, bk, ak, cache=bc, pos=int(pos),
                              rules=rules, mesh=mesh)
    x = common.norm(cfg.norm_kind, x, params["final_norm"])
    return _head(params, cfg, x), caches


def loss_fn(params: Dict, batch: Dict, cfg: ArchConfig, *, remat=False,
            rules=None, mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy (+ 0.01 aux) and its parts, as the
    reference's; differentiable on the card through the kernels' autograd
    Functions (``remat`` as in `forward`)."""
    logits, _, aux = forward(params, batch["tokens"], cfg,
                             embeds=batch.get("embeds"), remat=remat,
                             rules=rules, mesh=mesh)
    ce = common.cross_entropy(logits, batch["labels"])
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}
