"""DeepFlow pathfinding CLI, PyTorch port.

Subcommands (the reference's flags, plus ``--device``; default ``cuda``,
and a missing card is an error, never a silent fall-back to the host):

  sweep   cross-product (arch x cell x mesh x logic x hbm x net) scored by
          the batched evaluator (repro_torch.core.pathfinder); prints CSV
          (optionally only the Pareto frontier) and can write it to a
          file; the best point goes to stderr:

              PYTHONPATH=src python -m repro_torch.pathfind sweep \\
                  --arch qwen1.5-0.5b --cell train_4k \\
                  --mesh 8x8 --mesh 16x16 \\
                  --logic N7,N5,N3 --hbm HBM2E,HBM3 --csv sweep.csv

          This is the reference's in-memory sweep.  The flags of the
          reference's chunked, resumable runner (--out, --resume,
          --scenario, --scale, --profile, --arch all, ...) are not flags
          here and exit 2: the runner comes later (ROADMAP queue 1 item 6).

  plan    the CrossFlow -> runtime bridge: best runtime-realizable strategy
          for one (arch, cell, mesh) on the TPU-v5e micro-arch:

              PYTHONPATH=src python -m repro_torch.pathfind plan \\
                  --arch qwen1.5-0.5b --cell train_4k --mesh 16x16

  calibrate  measurement-driven calibration (repro_torch.calibrate): run the
          microbenchmark suite on the card (cuBLAS GEMMs, the hand-written
          Hopper GEMM, bandwidth probes), fit the techlib/PPE
          efficiency+overhead vector to the measurements by multi-start GD
          with autograd through the performance model, and write
          DIR/profile.json + DIR/report.json (the drift baseline).
          Resumable (--resume skips measured points):

              PYTHONPATH=src python -m repro_torch.pathfind calibrate \\
                  --out calib --suite slice --tech tpu_v5e

  validate  re-measure (or reuse) the suite and diff the validation
          report against the stored baseline — non-zero exit on drift:

              PYTHONPATH=src python -m repro_torch.pathfind validate \\
                  --out calib

Every file written here is in the reference's format, so the reference's
``python -m repro.pathfind sweep --profile DIR/profile.json`` consumes a
profile fitted on the card.  The other subcommands (soe, cooptimize,
explore, size, sweep-worker) come with later slices of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict, List, Optional, Tuple


def _mesh(text: str) -> Tuple[int, ...]:
    try:
        dims = tuple(int(x) for x in text.lower().split("x"))
    except ValueError:
        dims = ()
    if not dims or any(d <= 0 for d in dims):
        raise argparse.ArgumentTypeError(
            f"bad mesh {text!r}; expected e.g. 16x16 or 2x16x16")
    return dims


def _csv_list(text: str) -> List[str]:
    return [x.strip() for x in text.split(",") if x.strip()]


def _add_sweep_flags(sw) -> None:
    sw.add_argument("--arch", action="append", default=None,
                    help="model arch id (repeatable)")
    sw.add_argument("--cell", action="append", default=None,
                    help="shape cell name (repeatable; default train_4k)")
    sw.add_argument("--mesh", action="append", type=_mesh, default=None,
                    help="mesh shape like 16x16 (repeatable)")
    sw.add_argument("--logic", type=_csv_list, default=["N7"],
                    help="comma-separated logic nodes (default N7)")
    sw.add_argument("--hbm", type=_csv_list, default=["HBM2E"],
                    help="comma-separated HBM generations")
    sw.add_argument("--net", type=_csv_list, default=["IB-NDR-X8"],
                    help="comma-separated inter-node networks")
    sw.add_argument("--area", type=float, default=None,
                    help="proc chip area budget (mm^2)")
    sw.add_argument("--power", type=float, default=None,
                    help="node power budget (W)")
    sw.add_argument("--tilings", type=int, default=8,
                    help="PPE tiling samples per level")
    sw.add_argument("--pareto", type=_csv_list, default=None, metavar="OBJS",
                    help="print only the Pareto frontier over these "
                         "objectives (e.g. time_s,devices)")
    sw.add_argument("--csv", default=None, help="also write CSV here")
    sw.add_argument("--device", default="cuda",
                    help="where the evaluation runs (default cuda; cpu "
                         "only when asked)")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="repro_torch.pathfind",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sw = sub.add_parser("sweep", help="batched design-space sweep")
    _add_sweep_flags(sw)

    pl = sub.add_parser("plan", help="runtime sharding plan for one point")
    pl.add_argument("--arch", required=True)
    pl.add_argument("--cell", required=True)
    pl.add_argument("--mesh", type=_mesh, required=True)
    pl.add_argument("--device", default="cuda",
                    help="where the prediction runs (default cuda)")

    ca = sub.add_parser("calibrate",
                        help="measure the card and fit a calibration "
                             "profile")
    ca.add_argument("--out", required=True, metavar="DIR",
                    help="measurement + profile output directory")
    ca.add_argument("--suite", default="quick",
                    choices=["quick", "full", "slice"],
                    help="microbenchmark suite (quick = GEMM-only; slice = "
                         "the port's main path: + the hand-written GEMM at "
                         "full qwen1.5-0.5b width + bandwidth probes)")
    ca.add_argument("--reps", type=int, default=3,
                    help="timing repetitions per point (best-of)")
    ca.add_argument("--resume", action="store_true",
                    help="skip points already in DIR/measurements.jsonl")
    ca.add_argument("--tech", default="cpu_host", choices=["cpu_host",
                                                           "tpu_v5e"],
                    help="techlib entry the profile anchors")
    ca.add_argument("--steps", type=int, default=80,
                    help="fit GD steps (default 80)")
    ca.add_argument("--starts", type=int, default=6,
                    help="fit multi-start batch (default 6)")
    ca.add_argument("--tilings", type=int, default=8,
                    help="PPE tiling samples during fit/validation")
    ca.add_argument("--seed", type=int, default=0)
    ca.add_argument("--device", default="cuda",
                    help="where measurements and the fit run (default "
                         "cuda; cpu only when asked)")

    va = sub.add_parser("validate",
                        help="validation report + drift vs stored baseline")
    va.add_argument("--out", required=True, metavar="DIR",
                    help="calibration directory (measurements + profile)")
    va.add_argument("--profile", default=None, metavar="FILE",
                    help="profile JSON (default DIR/profile.json)")
    va.add_argument("--baseline", default=None, metavar="FILE",
                    help="stored baseline report (default DIR/report.json)")
    va.add_argument("--remeasure", action="store_true",
                    help="re-run the microbenchmark suite instead of "
                         "reusing DIR/measurements.jsonl")
    va.add_argument("--update-baseline", action="store_true",
                    help="overwrite the baseline with this report")
    va.add_argument("--drift-tol", type=float, default=0.25,
                    help="allowed absolute MRE worsening per group "
                         "(default 0.25 = 25 points)")
    va.add_argument("--tilings", type=int, default=None,
                    help="PPE tiling samples (default: the profile's "
                         "fit-time value, so the drift gate compares "
                         "like with like)")
    va.add_argument("--device", default="cuda",
                    help="where the prediction runs (default cuda)")
    return p


def template_arch(tech: str, device=None):
    from repro_torch.core import age
    return age.cpu_host_microarch(device=device) if tech == "cpu_host" \
        else age.tpu_v5e_microarch(device=device)


@dataclasses.dataclass
class CalibrateResult:
    profile: object                 # calibrate.profiles.CalibrationProfile
    fit: object                     # calibrate.fitting.FitResult
    report: Dict                    # calibrated validation report
    baseline_report: Dict           # uncalibrated (identity) report
    stats: object                   # calibrate.microbench.MeasureStats
    profile_path: str


def calibrate(spec, out_dir: str, *, tech: str = "cpu_host", steps: int = 80,
              starts: int = 6, tilings: int = 8, seed: int = 0,
              resume: bool = False, device=None,
              verbose: bool = True) -> Optional[CalibrateResult]:
    """Measure -> fit -> profile.json + report.json for one MeasureSpec.

    The body of ``pathfind calibrate``; returns None when nothing was
    measured."""
    from repro_torch.calibrate import fitting, microbench, profiles, report
    from repro_torch.core.roofline import PPEConfig

    runner = microbench.MicrobenchRunner(spec, out_dir=out_dir, device=device)
    stats = runner.run(resume=resume, verbose=verbose)
    print(f"# measured {stats.n_measured} points "
          f"(skipped {stats.n_skipped} existing) in {stats.elapsed_s:.1f}s",
          file=sys.stderr)
    if not stats.records:
        return None

    template = template_arch(tech, device)
    ppe = PPEConfig(n_tilings=tilings)
    res = fitting.fit(stats.records, template, ppe=ppe,
                      cfg=fitting.FitConfig(steps=steps, starts=starts,
                                            seed=seed))
    base_rep = report.validation_report(stats.records, template, ppe=ppe)
    cal_rep = report.validation_report(stats.records, template,
                                       params=res.params, ppe=ppe)
    profile = profiles.CalibrationProfile(
        tech=tech, params=res.params,
        measure_fingerprint=spec.fingerprint(),
        fit={"mre": res.mre, "mre_uncalibrated": res.mre_identity,
             "loss": res.loss, "loss_uncalibrated": res.loss_identity,
             "selected": res.selected, "n_evals": res.n_evals,
             "n_measurements": len(stats.records),
             "n_tilings": tilings},
        validation={"uncalibrated": base_rep["overall"],
                    "calibrated": cal_rep["overall"]})
    ppath = os.path.join(out_dir, "profile.json")
    profiles.save_profile(profile, ppath)
    report.save_baseline(cal_rep, os.path.join(out_dir, "report.json"))
    return CalibrateResult(profile=profile, fit=res, report=cal_rep,
                           baseline_report=base_rep, stats=stats,
                           profile_path=ppath)


def _cmd_calibrate(args) -> int:
    """Measure -> fit -> profile.json + report.json (repro_torch.calibrate)."""
    from repro_torch.calibrate import microbench, report

    spec = microbench.default_spec(args.suite, reps=args.reps)
    out = calibrate(spec, args.out, tech=args.tech, steps=args.steps,
                    starts=args.starts, tilings=args.tilings, seed=args.seed,
                    resume=args.resume, device=args.device)
    if out is None:
        print("error: no measurements", file=sys.stderr)
        return 2
    res = out.fit
    print(report.format_report(out.report, baseline=out.baseline_report))
    print(f"# fit[{res.selected}]: MRE {res.mre_identity * 100:.1f}% -> "
          f"{res.mre * 100:.1f}% over {res.n_evals} objective evals",
          file=sys.stderr)
    print(f"# profile -> {out.profile_path}; baseline report -> "
          f"{os.path.join(args.out, 'report.json')}", file=sys.stderr)
    if not res.improved:
        print("# warning: calibration did not improve on the "
              "uncalibrated techlib entry", file=sys.stderr)
    return 0


def _cmd_validate(args) -> int:
    """Fresh validation report + drift detection vs the stored baseline."""
    from repro_torch.calibrate import microbench, profiles, report
    from repro_torch.core.roofline import PPEConfig

    ppath = args.profile or os.path.join(args.out, "profile.json")
    bpath = args.baseline or os.path.join(args.out, "report.json")
    profile = profiles.load_profile(ppath)
    if args.remeasure:
        spec = microbench.MicrobenchRunner.from_dir(args.out).spec
        records = microbench.MicrobenchRunner(
            spec, device=args.device).run().records
    else:
        records = microbench.load_measurements(args.out)
    if not records:
        print(f"error: no measurements in {args.out}", file=sys.stderr)
        return 2
    template = template_arch(profile.tech, args.device)
    # tilings must match the fit-time sampling or every group's MRE
    # shifts and the drift gate fires with nothing actually changed
    tilings = args.tilings if args.tilings is not None \
        else int(profile.fit.get("n_tilings", 8))
    ppe = PPEConfig(n_tilings=tilings)
    cal_rep = report.validation_report(records, template,
                                       params=profile.params, ppe=ppe)
    base_rep = report.validation_report(records, template, ppe=ppe)
    print(report.format_report(cal_rep, baseline=base_rep))
    stored = report.load_baseline(bpath) if os.path.exists(bpath) else None
    if args.update_baseline or stored is None:
        report.save_baseline(cal_rep, bpath)
        print(f"# baseline written -> {bpath}", file=sys.stderr)
        return 0
    drift = report.check_drift(cal_rep, stored, tol=args.drift_tol)
    if drift:
        for msg in drift:
            print(f"# DRIFT: {msg}", file=sys.stderr)
        return 1
    print(f"# no drift vs {bpath} (tol "
          f"{args.drift_tol * 100:.0f} points)", file=sys.stderr)
    return 0


def _cmd_sweep(args) -> int:
    """The reference's in-memory sweep (``repro/pathfind.py:_cmd_sweep``)."""
    from repro_torch.core import pathfinder
    from repro_torch.core.age import Budgets
    from repro_torch.core.roofline import PPEConfig

    runner = args.extra + (["--arch all"] if args.arch and "all" in args.arch
                           else [])
    if runner:
        print(f"error: {' '.join(runner)}: not taken by the in-memory "
              f"sweep; the chunked sweep runner (--out, --resume, "
              f"--scenario, --profile, --arch all, ...) is not ported yet "
              f"(ROADMAP queue 1 item 6)", file=sys.stderr)
        return 2
    if not (args.arch and args.mesh):
        print("error: sweep needs --arch and --mesh", file=sys.stderr)
        return 2
    cells = args.cell or ["train_4k"]
    budgets = Budgets.default()
    if args.area is not None:
        budgets = dataclasses.replace(budgets, proc_chip_area_mm2=args.area)
    if args.power is not None:
        budgets = dataclasses.replace(budgets, power_w=args.power)
    result = pathfinder.sweep(
        args.arch, cells, args.mesh, logic_nodes=args.logic,
        hbms=args.hbm, nets=args.net, budgets=budgets,
        ppe=PPEConfig(n_tilings=args.tilings), device=args.device)
    points = result.points
    if args.pareto:
        points = result.pareto(objectives=args.pareto)
    lines = [pathfinder.CSV_HEADER] + [p.as_csv_row() for p in points]
    print("\n".join(lines))
    if args.csv:
        with open(args.csv, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        print(f"# wrote {len(points)} points to {args.csv}", file=sys.stderr)
    best = result.best()
    print(f"# best: {best.arch}/{best.cell} mesh="
          f"{'x'.join(map(str, best.mesh))} {best.logic}/{best.hbm}/"
          f"{best.net} {best.strategy.name} -> {best.time_s*1e3:.2f} ms",
          file=sys.stderr)
    return 0


def _cmd_plan(args) -> int:
    from repro_torch.configs.base import SHAPE_CELLS, get_config
    from repro_torch.core import planner

    axes = ("pod", "data", "model")[-len(args.mesh):]
    plan = planner.plan(get_config(args.arch), SHAPE_CELLS[args.cell],
                        args.mesh, axes, device=args.device)
    print(f"strategy       {plan.strategy.name}")
    print(f"predicted_step {plan.predicted_step_s*1e3:.3f} ms")
    for k, v in plan.predicted_breakdown.items():
        print(f"  {k:15s} {v*1e3:.3f} ms")
    for axis, rule in plan.rules:
        print(f"rule {axis:10s} -> {rule}")
    if plan.notes:
        print(f"notes: {plan.notes}")
    return 0


def main(argv=None) -> int:
    parser = _parser()
    # the reference's runner flags are left over here, for `_cmd_sweep`
    # to refuse by name
    args, extra = parser.parse_known_args(argv)
    args.extra = extra
    if args.extra and args.cmd != "sweep":
        parser.error(f"unrecognized arguments: {' '.join(args.extra)}")
    try:
        return {"sweep": _cmd_sweep, "plan": _cmd_plan,
                "calibrate": _cmd_calibrate,
                "validate": _cmd_validate}[args.cmd](args)
    except ModuleNotFoundError as e:
        print(f"error: unknown arch (no config module): {e.name}",
              file=sys.stderr)
    except KeyError as e:
        print(f"error: unknown name: {e}", file=sys.stderr)
    except (ValueError, AttributeError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
