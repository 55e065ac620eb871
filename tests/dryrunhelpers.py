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
its probes as its `run_cell` corrects them, with ``flops``, its XLA
FLOPs a device corrected alike) and ``record_keys`` (the keys
of the reference's `run_cell` record).  ``--reduced`` cuts the arch to
`reduced` size, ``--layers N`` to N layers at its widths.

    python tests/dryrunhelpers.py --compare-collectives ARCH CELL MESH
        [--reduced] [--layers N] [--moe-layout in-place|gathered]

prints, per collective kind, the MiB rank 0 receives in one step of the
port's dry-run (``repro_torch.launch.dryrun.port_collectives``) beside
the reference's, and the expert layouts the port's MoE layers took
(``--moe-layout`` forces one: `meshhelpers.expert_layouts`);

    python tests/dryrunhelpers.py --port-ops ARCH CELL MESH [--reduced]
        [--layers N]

prints the port's dot FLOPs of one step by op and local operand shapes
(`port_ops`: which products a mesh runs whole on every rank);

    python tests/dryrunhelpers.py --survey [--layers N] [--timeout S]
        [--jobs J] [--arch A]... [--out FILE]

runs every architecture of ``ARCH_IDS`` and paper-lm on each of its
``applicable_cells`` on 16x16 at N and 2N layers (default 2) and prints,
per cell and depth, the MiB rank 0 receives by kind in the port's step
and the reference's, the port's dot FLOPs a rank beside the reference's
jaxpr walk over the ranks, and then the slope (2N less N layers); each
side of each cell is a process of its own, ended after S seconds
(default 240), and a side that fails or runs out of time prints one line
that says so (`survey`).  ``--out`` also writes one JSON line per cell
and depth.  The
reference's mesh axes are ``Auto`` (``launch/mesh.make_mesh`` builds
``Explicit`` ones on this JAX, which ``with_sharding_constraint``
refuses) and the reference's bucketing is off (its bucketed evaluator
reads ``jax.core.Literal``, which this JAX lacks).
"""

from __future__ import annotations

import json
import math
import re
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
                    "predicted_breakdown": plan.predicted_breakdown}}
    try:
        out["plan"].update(params=cfg.param_count(),
                           active_params=cfg.active_param_count())
    except ValueError:
        pass            # the reference counts no LSTM block (paper-lm)
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
        corrected = dryrun._corrected(full, pm, combine)
        out["collectives"] = corrected["coll"]
        out["flops"] = corrected["flops"]
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


def _port_cut(flags) -> dict:
    """`dryrun.cut_config`'s arguments from ``--reduced`` and
    ``--layers N``."""
    layers = int(flags[flags.index("--layers") + 1]) \
        if "--layers" in flags else None
    return dict(layers=layers, use_reduced="--reduced" in flags)


def port_ops(arch: str, cell_name: str, mesh_txt: str, flags) -> dict:
    """The port's dot FLOPs for one step of the cell on a fake group of
    the mesh's ranks (the card's path), by op and rank 0's local operand
    shapes, with the step's total under ``"total"``; ``flags`` as
    `main`'s ``--reduced`` and ``--layers N``."""
    import collections
    from repro_torch.configs.base import get_config
    from repro_torch.launch import counters, dryrun, mesh as mesh_lib
    shape = tuple(int(x) for x in mesh_txt.split("x"))
    cfg = dryrun.cut_config(get_config(arch), **_port_cut(flags))
    by_op = collections.Counter()
    count = counters.StepCounter._count

    def counted(self, func, args, kwargs, out):
        before = self.flops
        count(self, func, args, kwargs, out)
        if self.flops != before:
            key = (func._overloadpacket.__name__,) + tuple(
                tuple(a.shape) for a in args if hasattr(a, "shape"))
            by_op[str(key)] += self.flops - before

    counters.StepCounter._count = counted
    try:
        with dryrun.fake_group(math.prod(shape)):
            mesh = mesh_lib.make_mesh(shape, device="cuda")
            m = dryrun._step_metrics(arch, cell_name, mesh, shape, True, cfg)
    finally:
        counters.StepCounter._count = count
    return dict(by_op.most_common(), total=m["flops"])


def compare_collectives(argv) -> None:
    from meshhelpers import expert_layouts
    from repro_torch.launch import dryrun
    arch, cell_name, mesh_txt = argv[:3]
    flags = argv[3:]
    force = None
    if "--moe-layout" in flags:
        i = flags.index("--moe-layout")
        force = {"in-place": False, "gathered": True}[flags[i + 1]]
        flags = flags[:i] + flags[i + 2:]
    ref = reference(arch, cell_name, mesh_txt, "--collectives",
                    *flags)["collectives"]
    with expert_layouts(force) as took:
        port = dryrun.port_collectives(
            arch, cell_name, [int(x) for x in mesh_txt.split("x")],
            **_port_cut(flags))
    print(f"{arch} {cell_name} {mesh_txt} {' '.join(flags)}: MiB rank 0 "
          f"receives in a step")
    print(f"  {'kind':20s} {'port':>14s} {'reference':>14s}")
    for kind in port:
        if kind == "count":
            print(f"  {kind:20s} {port[kind]:14d} {int(ref[kind]):14d}")
        else:
            print(f"  {kind:20s} {port[kind] / 2 ** 20:14.3f} "
                  f"{ref[kind] / 2 ** 20:14.3f}")
    print(f"  {'total':20s} "
          f"{sum(v for k, v in port.items() if k != 'count') / 2 ** 20:14.3f}"
          f" {sum(ref[k] for k in port if k != 'count') / 2 ** 20:14.3f}")
    if took:
        layouts = sorted({"gathered" if t else "in-place" for t in took})
        print(f"  the port's MoE layers' expert weights: {', '.join(layouts)}"
              + (" (forced)" if force is not None else ""))


SURVEY_MESH = "16x16"


def _json_of(cmd, timeout: float):
    """(the last line of ``cmd``'s output as JSON, None) or (None, why it
    gave none: its time limit or its error's last line)."""
    import os
    import subprocess
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=timeout, cwd=repo)
    except subprocess.TimeoutExpired:
        return None, f"past its {timeout:.0f} s limit"
    if proc.returncode != 0:
        lines = [ln.strip() for ln in proc.stderr.splitlines() if ln.strip()]
        errors = [ln for ln in lines if re.match(r"(\[rank\d+\]: )?[\w.]*"
                                                 r"(Error|Exception)\b", ln)]
        return None, ((errors or lines or [f"exit {proc.returncode}"])[-1])
    return json.loads(proc.stdout.strip().splitlines()[-1]), None


def port_cell(arch: str, cell_name: str, mesh_txt: str, flags) -> dict:
    """The port's step of the cell on a fake group of the mesh's ranks
    (the card's path): rank 0's received bytes by kind, its dot FLOPs
    and its peak bytes."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun, mesh as mesh_lib
    shape = tuple(int(x) for x in mesh_txt.split("x"))
    cfg = dryrun.cut_config(get_config(arch), **_port_cut(flags))
    with dryrun.fake_group(math.prod(shape)):
        mesh = mesh_lib.make_mesh(shape, device="cuda")
        m = dryrun._step_metrics(arch, cell_name, mesh, shape, True, cfg)
    return {"collectives": m["coll"], "flops": m["flops"],
            "peak_bytes": m["memory"]["peak_bytes"]}


def _survey_one(arch, cell_name, layers, timeout):
    """One cell at one depth: both sides, each in a process of its own."""
    flags = ["--layers", str(layers)]
    port, port_err = _json_of([sys.executable, __file__, "--port-cell",
                               arch, cell_name, SURVEY_MESH, *flags],
                              timeout)
    ref, ref_err = _json_of([sys.executable, __file__, arch, cell_name,
                             SURVEY_MESH, "--collectives", "--walk",
                             *flags], timeout)
    return {"arch": arch, "cell": cell_name, "layers": layers,
            "port": port, "port_error": port_err,
            "reference": ref and {"collectives": ref["collectives"],
                                  "dot_flops": ref["dot_flops"]},
            "reference_error": ref_err}


_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")


def _mib(coll) -> list:
    return [coll[k] / 2 ** 20 for k in _KINDS]


def _survey_line(rec, ranks: int) -> str:
    """One cell at one depth: each side's MiB by kind and total, or why it
    has none; where both have them, port / reference in bytes and FLOPs."""
    sides = []
    for side in ("port", "reference"):
        got = rec[side]
        if got is None:
            sides.append(f"{side[:4]}: {rec[side + '_error']}")
            continue
        mib = _mib(got["collectives"])
        sides.append(f"{side[:4]} " + " ".join(f"{v:10.1f}" for v in mib)
                     + f" = {sum(mib):10.1f}")
    line = (f"{rec['arch']:18s} {rec['cell']:11s} {rec['layers']:2d}  "
            + "  ".join(sides))
    if rec["port"] is None or rec["reference"] is None:
        return line
    port = sum(_mib(rec["port"]["collectives"]))
    ref = sum(_mib(rec["reference"]["collectives"]))
    pf, rf = rec["port"]["flops"], rec["reference"]["dot_flops"] / ranks
    return (f"{line}  {port / ref:6.3f}x bytes; FLOPs {pf:.4e} / "
            f"{rf:.4e} = {pf / rf:.3f}x")


def survey(argv) -> None:
    """`--survey`: see the module docstring."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.configs.base import _ALIASES, applicable_cells, \
        get_config

    def opt(name, default, cast=int):
        return cast(argv[argv.index(name) + 1]) if name in argv else default

    n = opt("--layers", 2)
    timeout = opt("--timeout", 240.0, float)
    jobs = opt("--jobs", 2)
    out = opt("--out", None, str)
    # every external id: ARCH_IDS' ten and paper-lm
    archs = [argv[i + 1] for i, a in enumerate(argv) if a == "--arch"] or \
        list(_ALIASES)
    work = [(a, c.name, layers) for a in archs
            for c in applicable_cells(get_config(a)) for layers in (n, 2 * n)]
    ranks = math.prod(int(x) for x in SURVEY_MESH.split("x"))
    print(f"# survey on {SURVEY_MESH}: MiB rank 0 receives in a step, "
          f"{' / '.join(_KINDS)} = total, port then reference; dot FLOPs a "
          f"rank, port / the reference's jaxpr walk over {ranks}")
    with ThreadPoolExecutor(jobs) as pool:
        recs = list(pool.map(lambda w: _survey_one(*w, timeout), work))
    for rec in recs:
        print(_survey_line(rec, ranks), flush=True)
    print(f"# slope: {2 * n} layers less {n}, MiB a step and FLOPs a rank")
    by = {(r["arch"], r["cell"], r["layers"]): r for r in recs}
    for arch, cell_name, layers in work[::2]:
        lo, hi = by[(arch, cell_name, n)], by[(arch, cell_name, 2 * n)]
        if not all(r["port"] and r["reference"] for r in (lo, hi)):
            print(f"{arch:18s} {cell_name:11s}  no slope: a side failed")
            continue
        dp = sum(_mib(hi["port"]["collectives"])) - \
            sum(_mib(lo["port"]["collectives"]))
        dr = sum(_mib(hi["reference"]["collectives"])) - \
            sum(_mib(lo["reference"]["collectives"]))
        fp = hi["port"]["flops"] - lo["port"]["flops"]
        fr = (hi["reference"]["dot_flops"] - lo["reference"]["dot_flops"]) \
            / ranks
        print(f"{arch:18s} {cell_name:11s}  port {dp:10.1f} ref {dr:10.1f} "
              f"MiB; FLOPs {fp:.4e} / {fr:.4e}")
    if out:
        with open(out, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    # the repo's packages importable however the script is started
    sys.path.insert(1, str(__import__("pathlib").Path(__file__).resolve()
                           .parents[1] / "src"))
    if sys.argv[1] == "--compare-collectives":
        compare_collectives(sys.argv[2:])
    elif sys.argv[1] == "--port-ops":
        print(json.dumps(port_ops(*sys.argv[2:5], sys.argv[5:])))
    elif sys.argv[1] == "--port-cell":
        print(json.dumps(port_cell(*sys.argv[2:5], sys.argv[5:])))
    elif sys.argv[1] == "--survey":
        survey(sys.argv[2:])
    else:
        main(sys.argv[1:])
