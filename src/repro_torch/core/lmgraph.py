"""Compute-graph builders: arch config -> CrossFlow graph (paper input (5)).

Builders produce *training* (fwd + bwd: dgrad + wgrad) or *serving* graphs.
GEMM nodes carry meta flags consumed by repro_torch.core.transform:

  weight=True    participates in the DP gradient all-reduce;
  shard_k=False  contraction dim not shardable (stateful recurrences);
  moe=True       routed-expert GEMM (EP dispatch);
  no_kp=True     not kernel-parallelizable at all.

The per-layer subgraph is built once per distinct layer kind and replicated
`count` times via `repeat` (homogeneous layers — the same observation the
paper uses for DP/KP replicas, §6.5, keeps graphs small at 88 layers).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.core.graph import ComputeGraph

DTYPE_BYTES = 2                     # bf16 activations/weights in the model


def _linear(g: ComputeGraph, name: str, tokens: int, d_in: int, d_out: int,
            deps, train: bool, **meta):
    """y = x W  (+ bwd: dgrad y W^T, wgrad x^T y)."""
    last = g.gemm(f"{name}.fwd", m=tokens, n=d_out, k=d_in, deps=deps,
                  weight=True, **meta).name
    if train:
        dg = g.gemm(f"{name}.dgrad", m=tokens, n=d_in, k=d_out, deps=[last],
                    **meta).name
        g.gemm(f"{name}.wgrad", m=d_in, n=d_out, k=tokens, deps=[last],
               batch_dim="k", **meta)     # grad bytes counted on .fwd only
        last = dg
    return last


def _attention(g: ComputeGraph, name: str, cfg: ArchConfig, batch: int,
               q_len: int, kv_len: int, deps, train: bool,
               local: bool) -> str:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    tokens, kv_tokens = batch * q_len, batch * kv_len
    last = _linear(g, f"{name}.q", tokens, d, nh * hd, deps, train)
    last_k = _linear(g, f"{name}.kv", kv_tokens, d, 2 * nkv * hd, deps, train)
    ctx = min(kv_len, cfg.local_window) if local else kv_len
    # per-sequence score/value GEMMs batched over (batch, heads);
    # causality halves the scored area during train/prefill
    causal = 0.5 if q_len == kv_len else 1.0
    ctx_eff = max(int(ctx * causal), 1)
    qk = g.gemm(f"{name}.qk", b=batch * nh, m=q_len, n=ctx_eff, k=hd,
                deps=[last, last_k], shard_m=False, shard_n=False,
                batch_dim="b", kp_b=True, gather_act=False)
    sm = g.elementwise(f"{name}.softmax",
                       n_elems=batch * nh * q_len * ctx_eff,
                       flops_per_elem=6.0, deps=[qk.name])
    av = g.gemm(f"{name}.av", b=batch * nh, m=q_len, n=hd, k=ctx_eff,
                deps=[sm.name], shard_m=False, shard_n=False, batch_dim="b",
                kp_b=True, gather_act=False)
    if train:
        # attention backward ~ 2x the fwd score/value GEMM work
        g.gemm(f"{name}.qk.bwd", b=batch * nh, m=q_len, n=ctx_eff, k=hd,
               deps=[av.name], shard_m=False, shard_n=False,
               batch_dim="b", kp_b=True, gather_act=False)
        av2 = g.gemm(f"{name}.av.bwd", b=batch * nh, m=q_len, n=hd,
                     k=ctx_eff, deps=[f"{name}.qk.bwd"],
                     shard_m=False, shard_n=False, batch_dim="b",
                     kp_b=True, gather_act=False)
        last = av2.name
    else:
        last = av.name
    return _linear(g, f"{name}.o", tokens, nh * hd, d, [last], train)


def _ffn(g: ComputeGraph, name: str, cfg: ArchConfig, tokens: int, deps,
         train: bool, d_ff: Optional[int] = None, moe: bool = False) -> str:
    d_ff = d_ff or cfg.d_ff
    mult = 2 if cfg.ffn_kind == "swiglu" else 1
    up = _linear(g, f"{name}.up", tokens, cfg.d_model, mult * d_ff, deps,
                 train, moe=moe)
    act = g.elementwise(f"{name}.act", n_elems=tokens * d_ff,
                        flops_per_elem=4.0, deps=[up])
    return _linear(g, f"{name}.down", tokens, d_ff, cfg.d_model, [act.name],
                   train, moe=moe)


def _moe(g: ComputeGraph, name: str, cfg: ArchConfig, tokens: int, deps,
         train: bool) -> str:
    # router
    r = _linear(g, f"{name}.router", tokens, cfg.d_model, cfg.n_experts,
                deps, train)
    # routed experts: per-token compute = top-k experts' FFW
    routed_tokens = tokens * cfg.experts_per_token
    last = _ffn(g, f"{name}.experts", cfg, routed_tokens, [r], train,
                d_ff=cfg.moe_d_ff, moe=True)
    if cfg.n_shared_experts:
        last_s = _ffn(g, f"{name}.shared", cfg, tokens, deps, train,
                      d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
        cmb = g.elementwise(f"{name}.combine", n_elems=tokens * cfg.d_model,
                            flops_per_elem=2.0, deps=[last, last_s])
        last = cmb.name
    return last


def _rglru(g: ComputeGraph, name: str, cfg: ArchConfig, tokens: int, deps,
           train: bool) -> str:
    w = cfg.lru_width or cfg.d_model
    xin = _linear(g, f"{name}.in", tokens, cfg.d_model, 2 * w, deps, train)
    conv = g.elementwise(f"{name}.conv", n_elems=tokens * w,
                         flops_per_elem=2.0 * cfg.conv1d_width, deps=[xin])
    gates = _linear(g, f"{name}.gates", tokens, w, 2 * w, [conv.name], train,
                    shard_k=False)     # recurrence state: k not shardable
    scan = g.elementwise(f"{name}.scan", n_elems=tokens * w,
                         flops_per_elem=8.0, deps=[gates])
    return _linear(g, f"{name}.out", tokens, w, cfg.d_model, [scan.name],
                   train)


def _xlstm_block(g: ComputeGraph, name: str, cfg: ArchConfig, kind: str,
                 tokens: int, deps, train: bool) -> str:
    hd, nh, d = cfg.resolved_head_dim, cfg.n_heads, cfg.d_model
    qkv = _linear(g, f"{name}.qkv", tokens, d, 3 * nh * hd, deps, train)
    # recurrence: mLSTM matrix memory (hd x hd per head) or sLSTM scalar.
    per_tok_flops = nh * hd * hd * 4.0 if kind == "mlstm" else nh * hd * 8.0
    rec = g.elementwise(f"{name}.rec", n_elems=tokens,
                        flops_per_elem=per_tok_flops, deps=[qkv])
    out = _linear(g, f"{name}.o", tokens, nh * hd, d, [rec.name], train)
    up = _linear(g, f"{name}.up", tokens, d, 2 * d, [out], train)
    return _linear(g, f"{name}.down", tokens, 2 * d, d, [up], train)


def _lstm_layer(g: ComputeGraph, name: str, hidden: int, batch: int,
                seq: int, deps, train: bool) -> str:
    """The paper's LSTM: per step a (batch, 4h, h) GEMM; seq-serialized,
    contraction not shardable across time (shard_k=False on the recurrence).
    DP still shards the batch rows (m)."""
    last = deps
    # input projection for the whole sequence (parallel over time)
    xw = _linear(g, f"{name}.xw", batch * seq, hidden, 4 * hidden, last, train)
    # recurrent matmul: seq sequential steps of (batch, 4h, h)
    hw = g.gemm(f"{name}.hw", b=seq, m=batch, n=4 * hidden, k=hidden,
                deps=[xw], weight=True, batch_dim="m", shard_k=False)
    ew = g.elementwise(f"{name}.gates", n_elems=batch * seq * 4 * hidden,
                       flops_per_elem=3.0, deps=[hw.name])
    if train:
        g.gemm(f"{name}.hw.bwd", b=seq, m=batch, n=hidden, k=4 * hidden,
               deps=[ew.name], batch_dim="m", shard_k=False)
        wg = g.gemm(f"{name}.hw.wgrad", m=hidden, n=4 * hidden,
                    k=batch * seq, deps=[ew.name], batch_dim="k")
        return wg.name
    return ew.name


# ---------------------------------------------------------------------------
# Public builders
# ---------------------------------------------------------------------------


def gemm_graph(m: int, n: int, k: int, train: bool = False) -> ComputeGraph:
    """A single (possibly distributed) GEMM — paper §8 GEMM validation."""
    g = ComputeGraph(f"gemm_{m}x{n}x{k}")
    g.gemm("gemm", m=m, n=n, k=k, weight=True)
    if train:
        g.gemm("gemm.dgrad", m=m, n=k, k=n, deps=["gemm"])
        g.gemm("gemm.wgrad", m=k, n=n, k=m, deps=["gemm"], weight=True,
               batch_dim="k")
    g.validate()
    return g


def build_graph(cfg: ArchConfig, cell: ShapeCell,
                layer_multiplier: bool = True) -> ComputeGraph:
    """Arch config x shape cell -> CrossFlow compute graph.

    With `layer_multiplier` the distinct layer kinds are built once and a
    `repeat` meta records multiplicity; predict_model_time expands timing.
    """
    train = cell.kind == "train"
    batch = cell.global_batch
    if cell.kind == "decode":
        q_len, kv_len = 1, cell.seq_len
    else:
        q_len = kv_len = cell.seq_len
    tokens = batch * q_len

    g = ComputeGraph(f"{cfg.name}|{cell.name}")

    if cfg.family == "lstm":
        last = g.gather("embed", rows=tokens, width=cfg.d_model).name
        for i in range(cfg.n_layers):
            last = _lstm_layer(g, f"layer{i}", cfg.d_model,
                               cell.global_batch, cell.seq_len, [last], train)
        h = _linear(g, "lm_head", tokens, cfg.d_model, cfg.vocab_size,
                    [last], train)
        g.elementwise("ce", n_elems=tokens * cfg.vocab_size,
                      flops_per_elem=4.0, deps=[h], dtype_bytes=4)
        g.validate()
        return g

    last = g.gather("embed", rows=tokens, width=cfg.d_model).name
    if cfg.is_encoder_decoder and cell.kind == "prefill":
        # serving prefill for enc-dec = encode + per-layer cross-KV project
        before = set(g.nodes)
        e = _attention(g, "enc.attn", cfg, batch, cell.seq_len,
                       cell.seq_len, [last], False, local=False)
        e = _ffn(g, "enc.ffn", cfg, cell.seq_len * batch, [e], False)
        for name in set(g.nodes) - before:
            g.nodes[name].meta["repeat"] = cfg.n_encoder_layers
        kvp = _linear(g, "cross.kv", cell.seq_len * batch, cfg.d_model,
                      2 * cfg.n_kv_heads * cfg.resolved_head_dim, [e],
                      False)
        g.nodes[kvp].meta["repeat"] = cfg.n_layers
        g.validate()
        return g
    if cfg.is_encoder_decoder:
        # encoder over seq_len frames; decoder over decoder_len tokens
        enc_tokens = (cell.seq_len * cell.global_batch
                      if cell.kind != "decode" else 0)
        dec_tokens = (min(cfg.decoder_len, cell.seq_len) * cell.global_batch
                      if cell.kind != "decode" else cell.global_batch)
        if enc_tokens:
            before = set(g.nodes)
            e = _attention(g, "enc.attn", cfg, batch, cell.seq_len,
                           cell.seq_len, [last], train, local=False)
            e = _ffn(g, "enc.ffn", cfg, enc_tokens, [e], train)
            for name in set(g.nodes) - before:
                g.nodes[name].meta["repeat"] = cfg.n_encoder_layers
            last = e
        dec_q = (1 if cell.kind == "decode"
                 else min(cfg.decoder_len, cell.seq_len))
        before = set(g.nodes)
        dec = _attention(g, "dec.self", cfg, batch, dec_q,
                         min(cfg.decoder_len, cell.seq_len), [last], train,
                         local=False)
        dec = _attention(g, "dec.cross", cfg, batch, dec_q, cell.seq_len,
                         [dec], train, local=False)
        dec = _ffn(g, "dec.ffn", cfg, dec_tokens, [dec], train)
        for name in set(g.nodes) - before:
            g.nodes[name].meta["repeat"] = cfg.n_layers
        _linear(g, "lm_head", dec_tokens, cfg.d_model, cfg.vocab_size, [dec],
                train)
        g.validate()
        return g

    # decoder-only families: build each distinct (block kind, attn kind) once
    kinds: Dict[Tuple[str, str], int] = {}
    for i in range(cfg.n_layers):
        bk = cfg.block_kind(i)
        ak = cfg.attn_kind(i) if bk == "attn" else "-"
        kinds[(bk, ak)] = kinds.get((bk, ak), 0) + 1
    for (bk, ak), count in kinds.items():
        nm = f"{bk}.{ak}" if ak != "-" else bk
        before = set(g.nodes)
        if bk == "attn":
            a = _attention(g, f"{nm}.attn", cfg, batch, q_len, kv_len,
                           [last], train, local=(ak == "local"))
            if cfg.is_moe:
                e = _moe(g, f"{nm}.moe", cfg, tokens, [a], train)
            else:
                e = _ffn(g, f"{nm}.ffn", cfg, tokens, [a], train)
        elif bk == "rglru":
            r = _rglru(g, f"{nm}.rec", cfg, tokens, [last], train)
            e = _ffn(g, f"{nm}.ffn", cfg, tokens, [r], train)
        elif bk in ("mlstm", "slstm"):
            e = _xlstm_block(g, nm, cfg, bk, tokens, [last], train)
        else:
            raise ValueError(bk)
        for name in set(g.nodes) - before:       # whole group stands for
            g.nodes[name].meta["repeat"] = count  # `count` identical layers
        last = e
    h = _linear(g, "lm_head", tokens, cfg.d_model, cfg.vocab_size, [last],
                train)
    if train or cell.kind == "prefill":
        g.elementwise("ce", n_elems=tokens * cfg.vocab_size,
                      flops_per_elem=4.0, deps=[h])
    g.validate()
    return g


def expand_repeats(g: ComputeGraph) -> float:
    """Sum of per-kind multipliers: Σ repeat over tagged sinks (timing is
    linear in layer count for homogeneous stacks)."""
    return sum(n.meta.get("repeat", 1) for n in g.nodes.values()
               if "repeat" in n.meta) or 1.0
