"""Process groups for the mesh tests: gloo over spawned host processes.

`spawn(fn, world, tmp)` runs ``fn(rank, tmp, *args)`` in ``world``
processes joined through a ``FileStore`` under ``tmp`` (no port, so xdist
workers never meet), one thread each.  The functions here run in those
processes: they import torch, numpy and the port only (no JAX), read
their inputs from ``tmp`` and rank 0 pickles what the tests compare
(numpy values and floats).
"""

import contextlib
import dataclasses
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCH = "qwen1.5-0.5b"
BATCH, SEQ, STEPS, LR = 4, 16, 3, 1e-3


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, f"store_{fn.__name__}_{world}"),
                           world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        fn(rank, tmp, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world, tmp, *args, join=True):
    """Run the group; with ``join=False`` return at once a context whose
    `wait` joins it (the caller works meanwhile)."""
    ctx = mp.spawn(_entry, args=(fn, world, str(tmp), args), nprocs=world,
                   join=False)
    if join:
        wait(ctx)
    return ctx


def wait(ctx, timeout=600):
    """Join the group; kill it and fail after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"process group still running after "
                               f"{timeout} s")


def save(tmp, name, value):
    with open(os.path.join(tmp, name), "wb") as f:
        pickle.dump(value, f)


def load(tmp, name):
    with open(os.path.join(tmp, name), "rb") as f:
        return pickle.load(f)


def f32(arch):
    from repro_torch.configs.base import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32")


def step_batches(cfg):
    """The data pipeline's first ``STEPS`` global batches."""
    from repro_torch.data.pipeline import DataConfig, synth_batch
    dc = DataConfig(global_batch=BATCH, seq_len=SEQ)
    return [synth_batch(dc, cfg, i) for i in range(STEPS)]


def one_device_steps(cfg, weights, compression="none"):
    """``STEPS`` of the port's one-device ``make_train_step`` -> (losses,
    final parameters as numpy)."""
    from repro_torch import optim
    from repro_torch.launch.train import item, make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_numpy, \
        params_to_numpy
    from repro_torch.runtime import init_error_state
    params = params_from_numpy(weights, "cpu")
    step = make_train_step(build_model(cfg, "cpu"), cfg, optim.AdamWConfig(
        lr=LR, warmup_steps=1, total_steps=STEPS), False, compression)
    opt = optim.init(params)
    err = init_error_state(params) if compression == "int8" else None
    losses = []
    for b in step_batches(cfg):
        params, opt, err, m = step(params, opt, err, b)
        losses.append(item(m["loss"]))
    return losses, params_to_numpy(params)


_SETUPS = {}


def _setup(cfg, shape):
    """(model, mesh, plan, rules, param placements, batch placements) of
    the planner's plan on a mesh of ``shape`` (one per config and shape
    in a process)."""
    key = (repr(cfg), tuple(shape))
    if key not in _SETUPS:
        _SETUPS[key] = _make_setup(cfg, shape)
    return _SETUPS[key]


def _make_setup(cfg, shape):
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core import planner
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding
    mesh = mesh_lib.make_mesh(shape, device="cpu")
    cell = ShapeCell("train", SEQ, BATCH, "train")
    plan = planner.plan(cfg, cell, tuple(shape), mesh.mesh_dim_names,
                        device="cpu")
    model = build_model(cfg, "cpu")
    return (model, mesh, plan, sharding.resolve_rules(plan, mesh),
            sharding.param_shardings(model, plan, mesh),
            sharding.batch_shardings(cfg, cell, plan, mesh))


def _full(t):
    return t.full_tensor().detach().numpy()


@contextlib.contextmanager
def local_shapes(wrapper):
    """The shapes of the first input of every call of the kernel wrapper
    ``repro_torch.kernels.ops.<wrapper>`` meanwhile (on the mesh path:
    the rank's local shard)."""
    from repro_torch.kernels import ops
    shapes, real = [], getattr(ops, wrapper)

    def seen(x, *a, **kw):
        shapes.append(tuple(x.shape))
        return real(x, *a, **kw)

    setattr(ops, wrapper, seen)
    try:
        yield shapes
    finally:
        setattr(ops, wrapper, real)


def mesh_loss(rank, tmp, arch, shape, name, cfg_kw=None, grads=False,
              wrapper=None):
    """The f32 loss (and every gradient, full) of ``arch`` on a mesh of
    ``shape``, on the weights and batch in ``tmp/<name>_in``; with a
    kernel ``wrapper``, the local shapes of its calls (`local_shapes`)."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import replicating, sharding
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(f32(arch), **(cfg_kw or {}))
    inp = load(tmp, f"{name}_in")
    model, mesh, plan, rules, psh, bsh = _setup(cfg, shape)
    params = sharding.distribute(params_from_numpy(inp["weights"], "cpu"),
                                 mesh, psh)
    batch = sharding.distribute(
        {k: torch.from_numpy(np.asarray(v)) for k, v in inp["batch"].items()},
        mesh, {k: bsh[k] for k in inp["batch"]})
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    record = local_shapes(wrapper) if wrapper else contextlib.nullcontext()
    with replicating(), record as shapes:
        loss, _ = model.loss_fn(live, batch, rules=rules, mesh=mesh)
        out = {"loss": float(loss.full_tensor())}
        if grads:
            gs = torch.autograd.grad(loss, tree_leaves(live))
            out["grads"] = [_full(g) for g in gs]
    if wrapper:
        out["local"] = shapes
    if rank == 0:
        save(tmp, f"{name}_out", out)


def mesh_steps(tmp, shape, name, compression="none"):
    """``STEPS`` of the port's ``make_train_step`` on a mesh of ``shape``
    from the weights in ``tmp/<name>_in`` -> (losses, final parameters,
    full, as numpy; per leaf the rank's parameter bytes, the full bytes,
    the rank's moment bytes and the spec's shard factor, before the
    steps)."""
    from repro_torch import optim
    from repro_torch.launch.train import item, make_train_step
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import sharding
    from repro_torch.runtime import init_error_state
    from repro_torch.tree import tree_leaves
    cfg = f32(ARCH)
    model, mesh, plan, rules, psh, bsh = _setup(cfg, shape)
    params = sharding.distribute(params_from_numpy(
        load(tmp, f"{name}_in")["weights"], "cpu"), mesh, psh)
    opt = optim.init(params)
    err = init_error_state(params) if compression == "int8" else None
    specs = tree_leaves(sharding.param_specs(model, plan, mesh))
    held = [(p.to_local().nbytes, p.numel() * p.element_size(),
             m.to_local().nbytes, v.to_local().nbytes,
             sharding.shard_factor(mesh, s))
            for p, m, v, s in zip(tree_leaves(params), tree_leaves(opt.mu),
                                  tree_leaves(opt.nu), specs)]
    step = make_train_step(model, cfg, optim.AdamWConfig(
        lr=LR, warmup_steps=1, total_steps=STEPS), False, compression,
        rules, mesh)
    losses = []
    for b in step_batches(cfg):
        b = sharding.distribute(b, mesh, {k: bsh[k] for k in b})
        params, opt, err, m = step(params, opt, err, b)
        losses.append(item(m["loss"]))
    return losses, [_full(p) for p in tree_leaves(params)], held


def dense(rank, tmp, shape):
    """qwen1.5-0.5b (f32) on a mesh: loss and gradients, the attention
    wrapper's local heads, each rank's parameter and moment bytes, then
    ``STEPS`` of ``make_train_step``."""
    name = "dense%dx%d" % shape
    mesh_loss(rank, tmp, ARCH, shape, name, grads=True,
              wrapper="flash_attention")
    losses, final, held = mesh_steps(tmp, shape, name)
    if rank == 0:
        out = load(tmp, f"{name}_out")
        out.update(held=held, step_losses=losses, final=final)
        save(tmp, f"{name}_out", out)


def _gpipe(rank, tmp):
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel import pipeline
    inp = load(tmp, "gpipe_in")
    mesh = mesh_lib.make_mesh((4,), ("stage",), device="cpu")

    def fn_stage(params, x):
        for p in params:
            x = torch.tanh(x @ p)
        return x

    staged = pipeline.stage_params_split(torch.from_numpy(inp["ws"]), 4)
    got = pipeline.gpipe(fn_stage, mesh, n_microbatches=3)(
        staged, torch.from_numpy(inp["x"]))
    if rank == 0:
        save(tmp, "gpipe_out", got.numpy())


def _buckets(rank, tmp):
    from repro_torch.parallel import collectives

    def tree(r):
        return {"a": torch.arange(15, dtype=torch.float32).reshape(3, 5) + r,
                "b": torch.full((4,), 0.5 * (r + 1), dtype=torch.bfloat16),
                "c": {"d": torch.ones(7, dtype=torch.float32) * r,
                      "e": torch.arange(6, dtype=torch.bfloat16)}}

    world = dist.get_world_size()
    got = collectives.bucketed_all_reduce(tree(rank), bucket_bytes=16)
    mean = collectives.mean_all_reduce(tree(rank))
    want = tree(0)
    for r in range(1, world):
        want = {"a": want["a"] + tree(r)["a"], "b": want["b"] + tree(r)["b"],
                "c": {k: want["c"][k] + tree(r)["c"][k] for k in "de"}}
    ok = all(torch.equal(x, y) and x.dtype == y.dtype
             for x, y in zip(_leaves(got), _leaves(want)))
    ok_mean = all(torch.allclose(x.float(), y.float() / world)
                  for x, y in zip(_leaves(mean), _leaves(want)))
    if rank == 0:
        save(tmp, "buckets_out", {"sum": ok, "mean": ok_mean})


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def group_2x2(rank, tmp):
    """Every 2x2 check of tests/test_torch_parallel.py in one group."""
    dense(rank, tmp, (2, 2))
    mesh_loss(rank, tmp, "qwen3-moe-30b-a3b", (2, 2), "moe_grouped",
              dict(moe_impl="grouped_tp", moe_groups=2, capacity_factor=8.0))
    mesh_loss(rank, tmp, "qwen3-moe-30b-a3b", (2, 2), "moe_ep")
    mesh_loss(rank, tmp, "recurrentgemma-2b", (2, 2), "rg",
              wrapper="rglru_kernel")
    mesh_loss(rank, tmp, "xlstm-125m", (2, 2), "xl",
              wrapper="mlstm_parallel")
    _gpipe(rank, tmp)
    _buckets(rank, tmp)


def group_4x2(rank, tmp):
    dense(rank, tmp, (4, 2))


@contextlib.contextmanager
def expert_layouts(force=None):
    """Each expert layout `moe._mesh_apply` takes inside the block, in the
    list yielded (`moe.gathers_weights`: True gathers the weights over the
    DP axes, False keeps them in place); with ``force`` that layout is
    taken instead of the rule's."""
    from repro_torch.models import moe
    rule, took = moe.gathers_weights, []

    def recorded(*args):
        took.append(rule(*args) if force is None else force)
        return took[-1]

    moe.gathers_weights = recorded
    try:
        yield took
    finally:
        moe.gathers_weights = rule


def moe_cases(rank, tmp, arch, shape, cases):
    """`mesh_loss` with every gradient of ``arch`` on a mesh of ``shape``
    for each (name, config overrides) of ``cases``; inputs and outputs
    under ``<name><rows>x<cols>``, the expert layouts each case took
    (`expert_layouts`) with its output."""
    for name, kw in cases:
        tag = "%s%dx%d" % ((name,) + shape)
        with expert_layouts() as took:
            mesh_loss(rank, tmp, arch, shape, tag, kw, grads=True)
        if rank == 0:
            out = load(tmp, f"{tag}_out")
            save(tmp, f"{tag}_out", dict(out, layouts=took))


@contextlib.contextmanager
def swiglu_layouts(force=None):
    """Each choice of how swiglu's halves meet on the ``model`` shards
    (`common.swiglu`, the MoE's experts), in the list yielded
    (`common.pairs_weights`: True moves the weight's columns, False the
    product's); with ``force`` that one is taken instead of the rule's."""
    from repro_torch.models import common
    rule, took = common.pairs_weights, []

    def recorded(*args):
        took.append(rule(*args) if force is None else force)
        return took[-1]

    common.pairs_weights = recorded
    try:
        yield took
    finally:
        common.pairs_weights = rule


# (name, forced `pairs_weights`, config overrides): each layout, then an
# mlp width the 2-way model axis does not divide (swiglu replicated)
LAYOUTS = (("weights", True, {}), ("products", False, {}),
           ("uneven", None, {"d_ff": 255}))


def ffn_layout_cases(rank, tmp, shape):
    """tests/test_torch_dryrun_ffn_layout.py's runs on a mesh of
    ``shape``: `mesh_loss` with every gradient of reduced qwen1.5-0.5b
    with swiglu's halves paired through each of `LAYOUTS`
    (`swiglu_layouts`), the choices its layers made saved with each
    output, then of reduced whisper-large-v3; inputs and outputs under
    ``dense_<layout><rows>x<cols>`` and ``whisper<rows>x<cols>``."""
    for layout, force, kw in LAYOUTS:
        tag = "dense_%s%dx%d" % ((layout,) + shape)
        with swiglu_layouts(force) as took:
            mesh_loss(rank, tmp, ARCH, shape, tag, kw, grads=True)
        if rank == 0:
            save(tmp, f"{tag}_out", dict(load(tmp, f"{tag}_out"),
                                         layouts=took))
    mesh_loss(rank, tmp, "whisper-large-v3", shape, "whisper%dx%d" % shape,
              grads=True)


def params_leaves(tree):
    """A numpy tree's leaves in `tree_leaves` order."""
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


RUN = dict(arch=ARCH, global_batch=BATCH, seq_len=SEQ,
           use_reduced_config=True, log_every=100, device="cpu", lr=LR)


def float32_runs():
    """``train()`` and ``serve()`` on the float32 reduced configs (a
    context: the launchers' ``reduced`` patched)."""
    import contextlib
    from repro_torch.launch import serve as port_serve
    from repro_torch.launch import train as port_train

    @contextlib.contextmanager
    def patched():
        saved = port_train.reduced, port_serve.reduced
        port_train.reduced = port_serve.reduced = \
            lambda c: f32(c.name)
        try:
            yield
        finally:
            port_train.reduced, port_serve.reduced = saved
    return patched()


def mesh_generate(tmp, shape):
    """Greedy tokens of ``serve``'s loop (`launch.serve.generate`) on a
    mesh of ``shape``, the planner's serve plan, from the weights and
    prompts in ``tmp/serve_in``."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core import planner
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import sharding
    inp = load(tmp, "serve_in")
    batch, prompt_len = inp["prompts"].shape
    cfg = f32(ARCH)
    model = build_model(cfg, "cpu")
    mesh = mesh_lib.make_mesh(shape, device="cpu")
    cell = ShapeCell("serve", prompt_len + inp["gen"], batch, "decode")
    plan = planner.plan(cfg, cell, tuple(shape), mesh.mesh_dim_names,
                        device="cpu")
    params = sharding.distribute(params_from_numpy(inp["weights"], "cpu"),
                                 mesh, sharding.param_shardings(model, plan,
                                                                mesh))
    return generate(model, params, inp["prompts"], inp["gen"], plan,
                    mesh)["tokens"]


def group_runtime(rank, tmp):
    """Every check of tests/test_torch_parallel_runtime.py but the CLI's,
    in one group of 4: ``train()`` at 2x2 with checkpoints, the same run
    cut at step 2 and continued on 1x4, int8 compression at 2x2 (through
    ``train()``, and through ``make_train_step`` on the weights in
    ``tmp/int8_in``), ``serve()`` at 2x2 and its loop on the weights in
    ``tmp/serve_in``, and the ``collective`` microbenchmark at 4 devices
    (this group)."""
    from repro_torch.calibrate import microbench
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import TrainConfig, train
    out = {}
    with float32_runs():
        a = train(TrainConfig(mesh_shape=(2, 2), steps=4, ckpt_every=2,
                              ckpt_dir=os.path.join(tmp, "a"), **RUN))
        out["a"] = a["history"]
        out["a_state"] = [(path, _full(leaf) if leaf.__class__.__name__ ==
                           "DTensor" else leaf.numpy()) for path, leaf in
                          _flatten(a["state"].as_tree())]
        b = os.path.join(tmp, "b")
        out["b"] = train(TrainConfig(mesh_shape=(2, 2), steps=2,
                                     ckpt_dir=b, **RUN))["history"]
        out["c"] = train(TrainConfig(mesh_shape=(1, 4), steps=4,
                                     ckpt_dir=b, **RUN))["history"]
        out["int8"] = train(TrainConfig(mesh_shape=(2, 2), steps=3,
                                        grad_compression="int8",
                                        **RUN))["history"]
        out["tokens"] = serve(ARCH, batch=2, prompt_len=6, gen=4,
                              mesh_shape=(2, 2), device="cpu")["tokens"]
    out["int8_steps"] = mesh_steps(tmp, (2, 2), "int8", "int8")[0]
    out["ref_tokens"] = mesh_generate(tmp, (2, 2))
    spec = microbench.MeasureSpec(suite="full", collective_bytes=(1 << 10,
                                                                  1 << 16),
                                  collective_devices=4, reps=2)
    recs = []
    microbench.run_points(microbench.enumerate_points(spec), spec,
                          recs.append, device="cpu")
    out["collective"] = recs
    if rank == 0:
        save(tmp, "runtime_out", out)
