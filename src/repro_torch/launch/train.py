"""End-to-end training entry point, as ``repro.launch.train``.

Wires the stack: the DeepFlow planner (the CrossFlow-predicted plan for
the ``train`` cell) -> the mesh and the plan's placements
(`repro_torch.parallel.sharding`) -> the train step (loss + gradient
through the hand-written kernels' autograd Functions, the gradients
pinned to the parameters' placements, optional bf16 or int8
error-feedback gradient compression, remat, AdamW with ZeRO-1 moments)
-> the synthetic data pipeline with prefetch (each rank keeps its DP
shard of the global batch) -> async atomic checkpointing (restorable onto
another mesh shape) -> preemption handler + straggler watchdog.

A mesh (``--mesh 2x2``) needs one process per device: run it under
``torchrun --nproc-per-node N`` (NCCL on the card, gloo with ``--device
cpu``); its device count must be the world size, or it raises.  At 1x1
without a process group the step runs on plain tensors, as before the
mesh path existed; inside a process group even 1x1 takes the mesh path.
Losses are printed by rank 0.

CLI:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 100 --batch 8 --seq 128 --mesh 1x1 --ckpt-dir /tmp/ckpt \\
        [--reduced] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --reduced --mesh 2x2 --steps 3
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import optim, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig, ShapeCell, get_config, \
    reduced
from repro_torch.core import planner as planner_lib
from repro_torch.data import DataConfig, PrefetchIterator
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import Model, build_model
from repro_torch.parallel import replicating, sharding
from repro_torch.runtime import PreemptionHandler, StragglerWatchdog, \
    compress, decompress, init_error_state
from repro_torch.tree import is_dtensor, tree_leaves, tree_map, \
    tree_unflatten


@dataclasses.dataclass
class TrainConfig:
    arch: str = "qwen1.5-0.5b"
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    mesh_shape: Tuple[int, ...] = (1, 1)
    lr: float = 3e-4
    warmup: int = 20
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    remat: Any = False                  # False | True | "dots"
    grad_compression: str = "none"      # none | bf16 | int8
    use_reduced_config: bool = False
    seed: int = 0
    device: Optional[str] = None        # None -> the card; "cpu" asks


class TrainState:
    def __init__(self, params, opt_state, err_state=None):
        self.params = params
        self.opt_state = opt_state
        self.err_state = err_state

    def as_tree(self):
        t = {"params": self.params, "opt": self.opt_state._asdict()}
        if self.err_state is not None:
            t["err"] = self.err_state
        return t

    @staticmethod
    def from_tree(t):
        return TrainState(t["params"], optim.AdamWState(**t["opt"]),
                          t.get("err"))


def item(x) -> float:
    """A scalar metric as a host float (a DTensor's full value)."""
    return float(x.full_tensor() if is_dtensor(x) else x)


def make_train_step(model: Model, cfg: ArchConfig,
                    opt_cfg: optim.AdamWConfig, remat, compression: str,
                    rules=None, mesh=None):
    """The step: (params, opt_state, err_state, batch) -> the same, updated
    (params and moments in place, see `optim.apply`), and metrics
    (``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr``, device tensors).
    ``batch`` lies on the parameters' device.

    On a mesh (``rules`` and ``mesh``; parameters, moments and batch are
    DTensors) the forward and the backward run under DTensor's implicit
    replication, and each gradient is pinned to its parameter's
    placements (the reference's ``grad_shardings``): a ``Partial``
    gradient is reduced (reduce-scatter over the data axis, the DP
    mean's all-reduce), so the optimizer updates each rank's shards."""
    if compression not in ("none", "bf16", "int8"):
        raise ValueError(f"grad compression {compression!r}: none, bf16 or "
                         f"int8")

    def step_fn(params, opt_state, err_state, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with replicating(mesh is not None):
            loss, metrics = model.loss_fn(live, batch, remat=remat,
                                          rules=rules, mesh=mesh)
            leaves = tree_leaves(live)
            grads = tree_unflatten(live, torch.autograd.grad(loss, leaves))
            if mesh is not None:
                grads = tree_map(lambda g, p: g.redistribute(
                    p.device_mesh, p.placements), grads, params)
        del live, leaves
        if compression == "bf16":
            # halve the DP all-reduce volume; optimizer math stays fp32
            grads = tree_map(lambda g: g.to(torch.bfloat16).float(), grads)
        if compression == "int8":
            comp, err_state = compress(grads, err_state)
            grads = decompress(comp, grads)
        params, opt_state, om = optim.apply(opt_cfg, opt_state, params,
                                            grads)
        metrics = {k: v.detach() for k, v in
                   dict(metrics, loss=loss, **om).items()}
        return params, opt_state, err_state, metrics

    return step_fn


def setup(tc: TrainConfig):
    """(cfg, model, plan, device, mesh): the arch, the model on the device,
    the planner's plan for the ``train`` cell of this batch and length,
    and the mesh (None on the one-device path)."""
    dev = resolve_device(tc.device)
    mesh = mesh_lib.runtime_mesh(tc.mesh_shape, dev)
    cfg = get_config(tc.arch)
    if tc.use_reduced_config:
        cfg = reduced(cfg)
    model = build_model(cfg, dev)
    cell = ShapeCell("train", tc.seq_len, tc.global_batch, "train")
    axes = mesh_lib.default_axes(tuple(tc.mesh_shape))
    plan = planner_lib.plan(cfg, cell, tuple(tc.mesh_shape), axes,
                            device=dev)
    return cfg, model, plan, dev, mesh


def train(tc: TrainConfig) -> Dict[str, Any]:
    """The loop: resume from ``ckpt_dir``'s latest checkpoint if it has
    one, then steps from there to ``tc.steps``.  Returns the reference's
    dict: history (losses), final_loss, stragglers, state, plan."""
    cfg, model, plan, dev, mesh = setup(tc)
    opt_cfg = optim.AdamWConfig(lr=tc.lr, warmup_steps=tc.warmup,
                                total_steps=max(tc.steps, 1))
    rules = bsh = None
    main = mesh is None or dist.get_rank() == 0
    if mesh is None:
        params = model.init(tc.seed)
    else:
        cell = ShapeCell("train", tc.seq_len, tc.global_batch, "train")
        rules = sharding.resolve_rules(plan, mesh)
        bsh = sharding.batch_shardings(cfg, cell, plan, mesh)
        params = model.init(tc.seed, shardings=sharding.param_shardings(
            model, plan, mesh), mesh=mesh)
    state = TrainState(params, optim.init(params),
                       init_error_state(params)
                       if tc.grad_compression == "int8" else None)

    ckpt = CheckpointManager(tc.ckpt_dir) if tc.ckpt_dir else None
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        state = TrainState.from_tree(ckpt.restore(like=state.as_tree()))
        start_step = int(state.opt_state.step)
        if main:
            print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(model, cfg, opt_cfg, tc.remat,
                              tc.grad_compression, rules, mesh)
    data_cfg = DataConfig(global_batch=tc.global_batch, seq_len=tc.seq_len,
                          seed=tc.seed)
    it = PrefetchIterator(data_cfg, cfg, start_step=start_step)
    preempt = PreemptionHandler()
    watchdog = StragglerWatchdog()
    history = []
    t_prev = time.time()
    try:
        for step, batch in it:
            if step >= tc.steps:
                break
            batch = {k: v.to(dev, non_blocking=True)
                     for k, v in batch.items()}
            if mesh is not None:        # each rank keeps its DP shard
                batch = sharding.distribute(
                    batch, mesh, {k: bsh[k] for k in batch})
            state.params, state.opt_state, state.err_state, metrics = \
                step_fn(state.params, state.opt_state, state.err_state,
                        batch)
            loss = item(metrics["loss"])
            now = time.time()
            watchdog.observe(step, now - t_prev)
            t_prev = now
            history.append(loss)
            if step % tc.log_every == 0 and main:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"lr {item(metrics['lr']):.2e} "
                      f"gnorm {item(metrics['grad_norm']):.3f}")
            if ckpt and step and step % tc.ckpt_every == 0:
                ckpt.save(step, state.as_tree())
            if preempt.preempted:
                if main:
                    print("[train] preemption: saving and exiting")
                if ckpt:
                    ckpt.save(step, state.as_tree(), block=True)
                break
    finally:
        it.close()
        if ckpt:
            ckpt.wait()
    if ckpt and not preempt.preempted:
        ckpt.save(tc.steps, state.as_tree(), block=True)
    return {"history": history, "final_loss": history[-1] if history else
            float("nan"), "stragglers": watchdog.events, "state": state,
            "plan": plan}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1",
                    help="e.g. 2x2 (data x model); one process per device "
                         "(torchrun --nproc-per-node 4)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config of the arch family")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    tc = TrainConfig(arch=args.arch, steps=args.steps,
                     global_batch=args.batch, seq_len=args.seq,
                     mesh_shape=tuple(int(x) for x in args.mesh.split("x")),
                     lr=args.lr, ckpt_dir=args.ckpt_dir, remat=args.remat,
                     grad_compression=args.compression,
                     use_reduced_config=args.reduced, device=args.device)
    if math.prod(tc.mesh_shape) > 1 or "WORLD_SIZE" in os.environ:
        mesh_lib.init_distributed(tc.device)     # torchrun's process group
    out = train(tc)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"[train] done: final loss {out['final_loss']:.4f} "
              f"({len(out['history'])} steps, "
              f"{len(out['stragglers'])} straggler events)")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
