"""Multi-pod dry-run: every (arch x shape x mesh) step run once on fake
tensors over a fake 256- or 512-rank process group, as
``repro.launch.dryrun``.

For each cell this builds the REAL step function (``make_train_step``
with the AdamW update, the prefill, or the decode step) under the
planner's sharding on the production mesh (16x16 single-pod, 2x16x16
multi-pod), runs it once on rank 0's local shards as fake tensors (shapes,
dtypes and placements, no data), and records:

  * memory       rank 0's argument, output, temporary and peak bytes:
                 whether the cell fits a device,
  * FLOPs, bytes rank 0's dot FLOPs and bytes (`repro_torch.launch.
                 counters`: an unfused eager count, each loop iteration
                 counted, where the reference's XLA ``cost_analysis``
                 counts a loop body once and corrects only the layer
                 groups),
  * collectives  the bytes rank 0 receives per collective kind (the
                 DTensor collectives and ``torch.distributed`` calls),
  * the DeepFlow planner's CrossFlow prediction for the same cell (the
    prediction against the counted terms is the validation axis).

The reference lowers and compiles under 512 fake XLA host devices; here
the group is ``init_process_group("fake", ...)`` at 256 or 512 ranks, set
up by `run_cell` and destroyed after it (it refuses to run inside an
existing group), and the step runs in a ``FakeTensorMode``.  No device is
touched, so the dry-run needs no card.  ``device`` picks the path that is
counted: ``cuda`` (the default) the card's, where the hand-written
kernels' fake-tensor rules stand for their launches; ``cpu`` the host's,
where the kernels' plain versions run.  The card's path runs on fake
``meta`` tensors, which the kernels' rules take as they take fake
``cuda`` ones: autograd over a ``cuda`` tensor needs the card's device
guard (a build without CUDA aborts the process, a CUDA build with no card
visible raises, and with one it opens a context on it), so a ``cuda``
fake would touch a device or fail.  A failing rule is an error: nothing
falls back to the plain versions.

Artifacts land in ``artifacts/dryrun_torch/<arch>__<cell>__<mesh>.json``
(``__cpu`` after the host path's), never in the reference's
``artifacts/dryrun/``; runs are resumable (existing artifacts are skipped
unless --force).  A record has the reference's keys, plus ``device`` (the
path counted) and ``kernels`` (each hand-written kernel's calls).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --cell train_4k --mesh single [--device cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.configs.base import ARCH_IDS, SHAPE_CELLS, ShapeCell, \
    applicable_cells, get_config, reduced
from repro_torch.core import planner as planner_lib
from repro_torch.launch import counters, mesh as mesh_lib
from repro_torch.launch.train import make_train_step
from repro_torch.models import build_model
from repro_torch.models.model import input_specs
from repro_torch.parallel import sharding as shard_lib
from repro_torch.tree import tree_map

ART_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "artifacts", "dryrun_torch")
MESHES = {"single": (16, 16), "multi": (2, 16, 16)}


def path_device(device=None) -> torch.device:
    """The device of the fake tensors for the path ``device`` names:
    ``cpu`` the host's; ``cuda`` (None) the card's, on ``meta``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"dryrun: device {dev}: cuda (the card's path) or "
                         f"cpu (the host's)")
    return torch.device("meta")


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks in this process (this
    process is rank 0), destroyed on exit; refuses to stand in for a group
    that exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            f"dryrun: a process group of {dist.get_world_size()} ranks "
            f"({dist.get_backend()}) already exists; the dry-run sets up "
            f"its own fake group and runs outside any other")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tensor(shape, dtype, dev, mesh=None, placements=None,
            fill=torch.empty):
    """A tensor of ``shape`` (``fill``'s values) on ``dev``; on a mesh
    rank 0's shard of it under ``placements``, as a DTensor."""
    if mesh is None:
        return fill(tuple(shape), dtype=dtype, device=dev)
    from torch.distributed.tensor import DTensor
    box = shard_lib.local_box(tuple(shape), mesh, placements)
    local = fill(tuple(s.stop - s.start for s in box), dtype=dtype,
                 device=dev)
    stride, n = [], 1
    for size in reversed(tuple(shape)):     # contiguous, computed on the host
        stride.insert(0, n)
        n *= size
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _tree(abstract, dev, mesh, shardings, fill=torch.empty):
    if mesh is None:
        return tree_map(lambda a: _tensor(a.shape, a.dtype, dev, fill=fill),
                        abstract)
    return tree_map(lambda a, pl: _tensor(a.shape, a.dtype, dev, mesh, pl,
                                          fill), abstract, shardings)


def build_cell(arch: str, cell: Union[str, ShapeCell], mesh, mesh_shape,
               fsdp: bool = True, remat="auto", cfg_override=None,
               opts: Optional[Dict] = None, device=None, fake_mode=None):
    """Returns (fn, args, in_shardings tuple, plan, cfg): ``args`` are
    rank 0's inputs as fake tensors made in ``fake_mode`` (DTensors of the
    plan's placements on ``mesh``; plain tensors where ``mesh`` is None,
    the one-device path, whose ``in_shardings`` are None).

    ``cell`` is a shape cell or its name.  ``opts`` (hillclimb variants):
    cfg=dict of ArchConfig overrides, rules=dict of logical-axis rule
    overrides, serve_bf16=bool (bf16 params for prefill/decode),
    bf16_grads=bool (bf16 gradient all-reduce), remat=bool or "dots",
    grad_constraint=bool (the port always pins each gradient to its
    parameter's placements, `launch.train.make_train_step`).
    """
    from torch._subclasses.fake_tensor import FakeTensorMode
    opts = opts or {}
    cfg = cfg_override or get_config(arch)
    if opts.get("cfg"):
        cfg = dataclasses.replace(cfg, **opts["cfg"])
    if "remat" in opts:
        remat = opts["remat"]
    cell = SHAPE_CELLS[cell] if isinstance(cell, str) else cell
    dev = path_device(device)
    fake_mode = fake_mode or FakeTensorMode(allow_non_fake_inputs=True)
    # the model's own device serves the shapes of its caches only
    model = dataclasses.replace(build_model(cfg, "cpu"),
                                device=torch.device("meta"))
    axes = (shard_lib.mesh_axes(mesh) if mesh is not None
            else mesh_lib.default_axes(tuple(mesh_shape)))
    plan = planner_lib.plan(cfg, cell, tuple(mesh_shape), axes,
                            device="cpu")
    rules = p_shard = b_shard = None
    if mesh is not None:
        rules = shard_lib.resolve_rules(plan, mesh, fsdp=fsdp)
        if opts.get("rules"):
            rules = dict(rules, **opts["rules"])
        p_shard = shard_lib.param_shardings(model, plan, mesh, fsdp=fsdp)
    p_dtype = (torch.bfloat16 if (opts.get("serve_bf16")
                                  and cell.kind != "train")
               else torch.float32)
    specs = input_specs(cfg, cell)
    if mesh is not None:
        b_shard = shard_lib.batch_shardings(cfg, cell, plan, mesh)
        b_shard = {k: b_shard[k] for k in specs}

    with fake_mode:
        params = _tree(model.abstract_params(p_dtype), dev, mesh, p_shard)
        batch = _tree(specs, dev, mesh, b_shard)

    if cell.kind == "train":
        use_remat = (cell.seq_len * cell.global_batch >= 2 ** 20
                     if remat == "auto" else remat)
        opt_cfg = optim.AdamWConfig(total_steps=1000)
        compression = "bf16" if opts.get("bf16_grads") else "none"
        step = make_train_step(model, cfg, opt_cfg, use_remat, compression,
                               rules, mesh)

        def fn(params, opt_state, batch):
            p, o, _, metrics = step(params, opt_state, None, batch)
            return p, o, metrics["loss"]

        with fake_mode:
            opt_state = optim.init(params)
        in_sh = None if mesh is None else (
            p_shard, optim.AdamWState(step=shard_lib.scalar_sharding(mesh),
                                      mu=p_shard, nu=p_shard), b_shard)
        return fn, (params, opt_state, batch), in_sh, plan, cfg

    if cell.kind == "prefill":
        with fake_mode:
            cache_abs = model.init_cache(cell.global_batch, cell.seq_len)
        c_shard = None if mesh is None else shard_lib.cache_shardings(
            cfg, plan, mesh, cache_abs)
        if cfg.is_encoder_decoder:
            # whisper prefill = encode + cross-KV precompute
            def fn(params, batch):
                caches = _tree(cache_abs, dev, mesh, c_shard, torch.zeros)
                with torch.no_grad():
                    return model.prefill(params, batch, caches=caches,
                                         rules=rules, mesh=mesh)
        else:
            def fn(params, batch):
                # realistic serving prefill: fill caches AND return the
                # next-token logits (keeps the head/last layer live)
                caches = _tree(cache_abs, dev, mesh, c_shard, torch.zeros)
                with torch.no_grad():
                    logits, caches, _ = model.forward(
                        params, batch, caches=caches, rules=rules,
                        mesh=mesh)
                return logits[:, -1], caches

        in_sh = None if mesh is None else (p_shard, b_shard)
        return fn, (params, batch), in_sh, plan, cfg

    # decode
    max_len = cell.seq_len
    with fake_mode:
        cache_abs = model.init_cache(cell.global_batch, max_len)
        c_shard = None if mesh is None else shard_lib.cache_shardings(
            cfg, plan, mesh, cache_abs)
        caches = _tree(cache_abs, dev, mesh, c_shard)

    def fn(params, caches, batch):
        with torch.no_grad():
            return model.decode_step(params, caches, batch["tokens"],
                                     max_len - 1, rules=rules, mesh=mesh)

    in_sh = None if mesh is None else (p_shard, c_shard, b_shard)
    return fn, (params, caches, batch), in_sh, plan, cfg


def _step_metrics(arch, cell, mesh, mesh_shape, fsdp, cfg_override,
                  remat="auto", opts=None, device=None) -> Dict:
    """One build + one fake step under the counters; every loop iteration
    and every layer is counted (no correction needed).  ``lower_s`` is the
    seconds spent building the cell, ``compile_s`` the fake step's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    t0 = time.time()
    fn, args, _, plan, cfg = build_cell(
        arch, cell, mesh, mesh_shape, fsdp=fsdp, remat=remat, opts=opts,
        cfg_override=cfg_override, device=device, fake_mode=fake)
    t_build = time.time() - t0
    with fake:
        counter = counters.StepCounter(args)
        with counter:
            out = fn(*args)
        memory = counter.finish(out)
    t_step = time.time() - t0 - t_build
    return {
        "plan": plan, "cfg": cfg,
        "flops": counter.flops, "bytes": counter.bytes,
        "coll": dict(counter.collectives),
        "memory": memory, "kernels": dict(counter.kernels),
        "lower_s": round(t_build, 2), "compile_s": round(t_step, 2),
    }


def cut_config(cfg, layers: Optional[int] = None,
               use_reduced: bool = False):
    """``cfg`` at `reduced` size with ``use_reduced``, and cut to
    ``layers`` layers (its widths kept)."""
    if use_reduced:
        cfg = reduced(cfg)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def port_collectives(arch: str, cell_name: str, mesh_shape,
                     layers: Optional[int] = None,
                     use_reduced: bool = False) -> Dict:
    """The bytes rank 0 receives per collective kind (and their
    ``count``) in one step of the cell on a fake group of the mesh's
    ranks, the card's path, in this process; the arch cut as
    `cut_config` cuts it."""
    shape = tuple(mesh_shape)
    cfg = cut_config(get_config(arch), layers, use_reduced)
    with fake_group(math.prod(shape)):
        mesh = mesh_lib.make_mesh(shape, device="cuda")
        return _step_metrics(arch, cell_name, mesh, shape, True, cfg)["coll"]


def _probe_configs(cfg):
    """Variant configs for the reference's scan-trip-count correction.

    Returns (probes, combine) where `combine(full, probe_metrics)` produces
    corrected totals:  m = m_rem + n_groups * (m_full - m_rem)  (decoder)
    or the two-scan version for enc-dec.  The port counts every layer, so
    `run_cell` needs no correction; fed a one-group config's counts as
    ``full``, `combine` gives the full config's direct count, which is how
    the tests show that the counters see every layer.
    """
    from repro_torch.models.transformer import group_layout
    if cfg.is_encoder_decoder:
        n_enc, n_dec = cfg.n_encoder_layers, cfg.n_layers
        probes = {"zero": dataclasses.replace(cfg, n_layers=0,
                                              n_encoder_layers=0),
                  "enc0": dataclasses.replace(cfg, n_encoder_layers=0),
                  "dec0": dataclasses.replace(cfg, n_layers=0)}

        def combine(full, pm, key):
            z = pm["zero"][key]
            b_enc = pm["dec0"][key] - z        # dec0 keeps only the encoder
            b_dec = pm["enc0"][key] - z
            return z + n_enc * b_enc + n_dec * b_dec

        return probes, combine
    pat, n_groups, rem = group_layout(cfg)
    probes = {"rem": dataclasses.replace(cfg, n_layers=rem)}

    def combine(full, pm, key):
        m_rem = pm["rem"][key]
        return m_rem + n_groups * (full[key] - m_rem)

    return probes, combine


def _corrected(full, probe_metrics, combine):
    out = {}
    out["flops"] = combine(full, probe_metrics, "flops")
    out["bytes"] = combine(full, probe_metrics, "bytes")
    coll = {}
    for k in list(full["coll"].keys()):
        f = {"k": full["coll"][k]}
        pm = {name: {"k": m["coll"][k]} for name, m in
              probe_metrics.items()}
        coll[k] = combine(f, pm, "k")
    out["coll"] = coll
    return out


def run_cell(arch: str, cell_name: str, mesh_kind: str,
             force: bool = False, device=None,
             art_dir: Optional[str] = None) -> Dict:
    """One cell on the production mesh ``mesh_kind`` (``single`` or
    ``multi``) in a fake group of its devices -> the record (also written
    to ``art_dir``, default `ART_DIR`, and read back from there unless
    ``force``).  A failure is recorded (``ok`` False, the error and the
    traceback), not raised.  The step is the reference's default: FSDP,
    its remat rule, no ``opts``; ``variant`` stays empty (the key is the
    reference's record's)."""
    art_dir = art_dir or ART_DIR
    os.makedirs(art_dir, exist_ok=True)
    path_kind = torch.device("cuda" if device is None else device).type
    tag = f"{arch}__{cell_name}__{mesh_kind}"
    if path_kind == "cpu":
        tag += "__cpu"
    path = os.path.join(art_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    mesh_shape = MESHES[mesh_kind]
    n_dev = 512 if mesh_kind == "multi" else 256
    with fake_group(n_dev):
        try:
            mesh = mesh_lib.make_production_mesh(multi_pod=mesh_kind
                                                 == "multi",
                                                 device=path_kind)
            full = _step_metrics(arch, cell_name, mesh, mesh_shape, True,
                                 None, device=device)
            plan, cfg = full["plan"], full["cfg"]
            result = {
                "arch": arch, "cell": cell_name, "mesh": mesh_kind,
                "variant": "",
                "mesh_shape": list(mesh_shape), "devices": n_dev,
                "ok": True,
                "strategy": plan.strategy.name,
                "predicted_step_s": plan.predicted_step_s,
                "predicted_breakdown": plan.predicted_breakdown,
                "flops_per_device_raw": full["flops"],
                "bytes_per_device_raw": full["bytes"],
                "flops_per_device": full["flops"],
                "bytes_per_device": full["bytes"],
                "memory": full["memory"],
                "collectives_raw": full["coll"],
                "collectives": full["coll"],
                "params": cfg.param_count(),
                "active_params": cfg.active_param_count(),
                "lower_s": full["lower_s"],
                "compile_s": full["compile_s"],
                "scan_corrected": False,
                "device": path_kind,
                "kernels": full["kernels"],
            }
        except Exception as e:          # noqa: BLE001 — record the failure
            result = {"arch": arch, "cell": cell_name, "mesh": mesh_kind,
                      "variant": "", "ok": False, "error": str(e),
                      "traceback": traceback.format_exc()[-4000:]}
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the path counted: cuda (default, the card's; "
                         "needs no card) or cpu (the host's)")
    ap.add_argument("--out", default=None,
                    help=f"the artifacts' directory (default {ART_DIR})")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    n_ok = n_fail = 0
    for arch in archs:
        cfg = get_config(arch)
        cells = [c.name for c in applicable_cells(cfg)]
        if args.cell != "all":
            cells = [c for c in cells if c == args.cell]
        for cell in cells:
            for mk in meshes:
                r = run_cell(arch, cell, mk, force=args.force,
                             device=args.device, art_dir=args.out)
                status = "OK " if r["ok"] else "FAIL"
                if r["ok"]:
                    mem = r["memory"]
                    kern = ",".join(f"{k}:{n}" for k, n in
                                    sorted(r["kernels"].items())) or "-"
                    extra = (f"flops/dev={r['flops_per_device']:.3e} "
                             f"peak={mem['peak_bytes'] / 2 ** 30:.2f}GiB "
                             f"coll={r['collectives']['count']} "
                             f"kernels={kern} "
                             f"compile={r['compile_s']:.0f}s")
                    n_ok += 1
                else:
                    extra = r["error"][:140]
                    n_fail += 1
                print(f"[dryrun] {status} {arch:22s} {cell:12s} {mk:6s} "
                      f"{extra}", flush=True)
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
