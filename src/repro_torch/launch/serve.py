"""Batched serving: prefill + decode loop with a KV cache.

CLI:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu]

`serve` mirrors ``repro.launch.serve.serve``: the planner picks the
strategy for the mesh, weights come from a seed, prompts from
``np.random.default_rng(seed)``, and the prompt is prefilled by stepping it
through ``decode_step`` token by token (as the reference does, robust
across families), then ``gen`` tokens are decoded greedily.  Every
attention call of every step launches the hand-written flash-attention
kernel.  The port runs on one card: a mesh of more than one device raises
(sharding is ROADMAP queue 1 item 9).  The LSTM baseline has no decode
path and raises, as the reference does.  The encoder-decoder steps its
prompt against the zero cross cache `init_cache` gives it (the
reference's loop; its encoder runs in `Model.prefill`).
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ShapeCell, get_config, reduced
from repro_torch.core import planner as planner_lib
from repro_torch.models import Model, build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, params: Dict, prompts: np.ndarray,
             gen: int) -> Dict:
    """Prefill ``prompts`` (batch, prompt_len) by stepping them through
    ``decode_step``, then decode ``gen`` tokens greedily.

    Returns {"tokens" (batch, gen) int32 numpy, "prefill_s", "decode_s"};
    the times are host-clock seconds, each phase ended by a device
    synchronise.  Tokens stay on the device until the loop ends."""
    batch, prompt_len = prompts.shape
    dev = model.device
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    with torch.no_grad():
        caches = model.init_cache(batch, prompt_len + gen)
        t0 = time.perf_counter()
        logits = None
        for t in range(prompt_len):
            logits, caches = model.decode_step(params, caches,
                                               toks[:, t:t + 1], t)
        _sync(dev)
        prefill_s = time.perf_counter() - t0

        out_tokens = []
        cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        t0 = time.perf_counter()
        for t in range(gen):
            out_tokens.append(cur)
            logits, caches = model.decode_step(params, caches, cur,
                                               prompt_len + t)
            cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        _sync(dev)
        decode_s = time.perf_counter() - t0
    return {"tokens": torch.cat(out_tokens, dim=1).cpu().numpy(),
            "prefill_s": prefill_s, "decode_s": decode_s}


def serve(arch: str, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          mesh_shape: Tuple[int, ...] = (1, 1), use_reduced: bool = True,
          seed: int = 0, greedy: bool = True, device=None) -> Dict:
    """Serve ``batch`` random prompts of ``arch``; the reference's return
    dict: tokens, prefill_s, decode_s, tok_per_s, plan."""
    if not greedy:
        raise NotImplementedError("serve decodes greedily only, as the "
                                  "reference does")
    if math.prod(mesh_shape) != 1:
        raise NotImplementedError(
            f"mesh {mesh_shape}: the port serves on one card; sharding "
            f"across devices is ROADMAP queue 1 item 9")
    dev = resolve_device(device)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    model = build_model(cfg, dev)
    if not model.has_decode:
        raise ValueError(f"{arch} has no decode path")
    cell = ShapeCell("serve", prompt_len + gen, batch, "decode")
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    plan = planner_lib.plan(cfg, cell, mesh_shape, axes, device=dev)

    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (batch, prompt_len)).astype(np.int32)
    params = model.init(seed)
    out = generate(model, params, prompts, gen)
    return {**out,
            "tok_per_s": batch * gen / max(out["decode_s"], 1e-9),
            "plan": plan.strategy.name}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = serve(args.arch, args.batch, args.prompt_len, args.gen,
                tuple(int(x) for x in args.mesh.split("x")),
                use_reduced=args.reduced, seed=args.seed, device=args.device)
    print(f"[serve] strategy {out['plan']}: prefill {out['prefill_s']:.2f}s, "
          f"decode {out['decode_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s)")
    print("[serve] sample tokens:", out["tokens"][0][:12])


if __name__ == "__main__":
    main()
