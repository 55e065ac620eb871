"""The reference's dry-run measured in a process of its own.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, which every later process of the importer would inherit, so the
tests never import it: they run this file as a script,

    python tests/dryrunhelpers.py ARCH CELL MESH [--reduced] [--layers N]
        [--walk] [--memory] [--collectives] [--keys]

(`reference` runs it and returns its output) which prints one JSON
object: ``plan`` (the planner's strategy, predicted step and breakdown,
params, active params, for ``MESH`` such as 16x16 or 2x16x16), and on
request ``dot_flops`` (a walk of the step's jaxpr: 2 m n k for each
``dot_general``, each loop body counted its trip count times: XLA's
``cost_analysis`` counts a loop body once), ``memory`` (the compiled
step's ``memory_analysis``), ``collectives`` (the reference's record's
``collectives``: its ``collective_bytes``, the layer groups corrected by
its probes as its `run_cell` corrects them) and ``record_keys`` (the keys
of the reference's `run_cell` record).  ``--reduced`` cuts the arch to
`reduced` size, ``--layers N`` to N layers at its widths.

    python tests/dryrunhelpers.py --compare-collectives ARCH CELL MESH
        [--reduced] [--layers N]

prints, per collective kind, the MiB rank 0 receives in one step of the
port's dry-run (`port_collectives`) beside the reference's.  The mesh's axes are ``Auto`` (``launch/mesh.make_mesh``
builds ``Explicit`` ones on this JAX, which ``with_sharding_constraint``
refuses) and the reference's bucketing is off (its bucketed evaluator
reads ``jax.core.Literal``, which this JAX lacks).
"""

from __future__ import annotations

import json
import math
import sys


def dot_flops(jaxpr) -> float:
    """2 m n k for every ``dot_general`` of ``jaxpr`` and the jaxprs it
    calls; a ``scan`` body counts ``length`` times, a ``cond`` its
    costliest branch."""
    from jax._src import core
    total = 0.0
    for eqn in jaxpr.eqns:
        prim, params = eqn.primitive.name, eqn.params
        if prim == "dot_general":
            (lc, rc), (lb, _) = params["dimension_numbers"]
            lhs, rhs = (v.aval.shape for v in eqn.invars)
            k = math.prod(lhs[d] for d in lc)
            batch = math.prod(lhs[d] for d in lb)
            m = math.prod(s for d, s in enumerate(lhs)
                          if d not in lc and d not in lb)
            n = math.prod(s for d, s in enumerate(rhs)
                          if d not in rc and d not in params[
                              "dimension_numbers"][1][1])
            total += 2.0 * batch * m * n * k
            continue
        if prim == "while":
            raise ValueError("a while loop: its trip count is unknown")
        subs = []
        for val in params.values():
            for v in (val if isinstance(val, (tuple, list)) else (val,)):
                if isinstance(v, core.ClosedJaxpr):
                    subs.append(v.jaxpr)
                elif isinstance(v, core.Jaxpr):
                    subs.append(v)
        if prim == "cond":
            total += max(dot_flops(s) for s in subs)
        else:
            mult = params["length"] if prim == "scan" else 1
            total += mult * sum(dot_flops(s) for s in subs)
    return total


def record_keys(dryrun, arch: str, cell_name: str, mesh_kind: str):
    """The keys of the reference's `run_cell` record, its lowering
    stubbed out (the metrics of a real lowering have the same keys)."""
    import tempfile

    def stub(arch, cell_name, mesh, mesh_shape, fsdp, cfg_override,
             remat="auto", opts=None):
        from repro.configs.base import SHAPE_CELLS, get_config
        from repro.core import planner
        cfg = cfg_override or get_config(arch)
        plan = planner.plan(cfg, SHAPE_CELLS[cell_name], mesh_shape,
                            mesh.axis_names)
        coll = {k: 0.0 for k in dryrun._COLLECTIVES}
        coll["count"] = 0
        return {"plan": plan, "cfg": cfg, "flops": 0.0, "bytes": 0.0,
                "coll": coll, "memory": {}, "lower_s": 0.0,
                "compile_s": 0.0}

    dryrun._compile_metrics = stub
    with tempfile.TemporaryDirectory() as art_dir:
        dryrun.ART_DIR = art_dir
        rec = dryrun.run_cell(arch, cell_name, mesh_kind, save=False)
    assert rec["ok"], rec
    return sorted(rec)


def _cut(cfg, argv, reduced):
    """``cfg`` at `reduced` size under ``--reduced``, and cut to N layers
    (its widths kept) under ``--layers N``."""
    import dataclasses
    if "--reduced" in argv:
        cfg = reduced(cfg)
    if "--layers" in argv:
        cfg = dataclasses.replace(
            cfg, n_layers=int(argv[argv.index("--layers") + 1]))
    return cfg


def main(argv) -> None:
    arch, cell_name, mesh_txt = argv[:3]
    shape = tuple(int(x) for x in mesh_txt.split("x"))
    import jax
    from jax.sharding import AxisType
    from repro.configs.base import SHAPE_CELLS, get_config, reduced
    from repro.core import compileahead, planner
    from repro.launch import dryrun
    compileahead.set_bucketing_default(False)
    cfg = _cut(get_config(arch), argv, reduced)
    axes = ("pod", "data", "model")[-len(shape):]
    plan = planner.plan(cfg, SHAPE_CELLS[cell_name], shape, axes)
    out = {"plan": {"strategy": plan.strategy.name,
                    "predicted_step_s": plan.predicted_step_s,
                    "predicted_breakdown": plan.predicted_breakdown,
                    "params": cfg.param_count(),
                    "active_params": cfg.active_param_count()}}
    if "--walk" in argv or "--memory" in argv:
        mesh = jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(shape))
        fn, args, in_sh, plan, cfg = dryrun.build_cell(
            arch, cell_name, mesh, shape, cfg_override=cfg)
        if "--walk" in argv:
            with mesh:
                out["dot_flops"] = dot_flops(
                    jax.make_jaxpr(fn)(*args).jaxpr)
        if "--memory" in argv:
            m = dryrun._compile_metrics(arch, cell_name, mesh, shape, True,
                                        cfg)
            out["memory"] = m["memory"]
    if "--collectives" in argv:
        mesh = jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(shape))
        full = dryrun._compile_metrics(arch, cell_name, mesh, shape, True,
                                       cfg)
        probes, combine = dryrun._probe_configs(full["cfg"])
        pm = {name: dryrun._compile_metrics(arch, cell_name, mesh, shape,
                                            True, pcfg)
              for name, pcfg in probes.items()}
        out["collectives"] = dryrun._corrected(full, pm, combine)["coll"]
    if "--keys" in argv:
        kind = {2: "single", 3: "multi"}[len(shape)]
        out["record_keys"] = record_keys(dryrun, arch, cell_name, kind)
    print(json.dumps(out))


def reference(arch: str, cell_name: str, mesh_txt: str, *flags) -> dict:
    """This script's JSON for these arguments, from a process of its own
    (CPU JAX, the repo's ``src`` on the path)."""
    import os
    import subprocess
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__, arch, cell_name,
                           mesh_txt, *flags], env=env, capture_output=True,
                          text=True, timeout=600, cwd=repo)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def port_collectives(arch: str, cell_name: str, mesh_txt: str,
                     flags) -> dict:
    """The port's ``collectives`` for one step of the cell on a fake group
    of the mesh's ranks (the card's path), in this process; ``flags`` as
    `main`'s ``--reduced`` and ``--layers N``."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import dryrun, mesh as mesh_lib
    shape = tuple(int(x) for x in mesh_txt.split("x"))
    cfg = _cut(get_config(arch), flags, reduced)
    with dryrun.fake_group(math.prod(shape)):
        mesh = mesh_lib.make_mesh(shape, device="cuda")
        return dryrun._step_metrics(arch, cell_name, mesh, shape, True,
                                    cfg)["coll"]


def compare_collectives(argv) -> None:
    arch, cell_name, mesh_txt = argv[:3]
    flags = argv[3:]
    ref = reference(arch, cell_name, mesh_txt, "--collectives",
                    *flags)["collectives"]
    port = port_collectives(arch, cell_name, mesh_txt, flags)
    print(f"{arch} {cell_name} {mesh_txt} {' '.join(flags)}: MiB rank 0 "
          f"receives in a step")
    print(f"  {'kind':20s} {'port':>14s} {'reference':>14s}")
    for kind in port:
        if kind == "count":
            print(f"  {kind:20s} {port[kind]:14d} {int(ref[kind]):14d}")
        else:
            print(f"  {kind:20s} {port[kind] / 2 ** 20:14.3f} "
                  f"{ref[kind] / 2 ** 20:14.3f}")


if __name__ == "__main__":
    if sys.argv[1] == "--compare-collectives":
        compare_collectives(sys.argv[2:])
    else:
        main(sys.argv[1:])
