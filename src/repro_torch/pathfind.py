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

          With --out DIR (or any other flag of the chunked engine:
          --resume, --scenario, --scale, --slo, --scenario-param,
          --objectives, --profile, --chunk-size, --max-chunks,
          --backend, --workers, --superbatch, --frontier-only,
          --frontier-cap, --arch all) the sweep runs on the chunked,
          resumable runner (repro_torch.core.sweeprunner; by default its
          pipelined executor, repro_torch.core.sweeppipeline): results
          stream to DIR/results.jsonl, finished chunks are checkpointed,
          and an interrupted sweep continues with ZERO re-evaluation:

              PYTHONPATH=src python -m repro_torch.pathfind sweep \\
                  --scenario serving-traffic --arch all --mesh 8x8 \\
                  --logic N7,N5 --scenario-param qps=2,8 \\
                  --objectives energy,cost,goodput --out sweeps/traffic
              PYTHONPATH=src python -m repro_torch.pathfind sweep \\
                  --out sweeps/traffic --resume

          The directory is the reference's: the same spec fingerprint,
          chunk hashes and checkpoint protocol, so either package resumes
          a sweep the other started.  --scenario picks the workload
          (repro_torch.core.scenarios): train, serving, serving-long,
          serving-traffic.  --backend pipeline (auto), serial, device
          (serial, each chunk spread over every local device), thread or
          process (--workers N is the pool size of the last two);
          --frontier-only keeps only the Pareto frontier, carried on the
          card (DIR/frontier.jsonl, resumable from
          DIR/frontier_state.npz).  --bucketing scores designs through
          their canonical buckets (repro_torch.core.compileahead; off by
          default here, as a fresh process pays a host trace per design;
          --no-bucketing is the default, as the reference's flag);
          --compile-ahead N packs N superbatches ahead and, with
          --bucketing, traces their designs off the critical path
          (default 2); --no-compile-cache is accepted as in the
          reference (nothing is compiled to disk here).  The reference's flags whose machinery
          is not ported yet exit 2 naming their ROADMAP queue 1 item:
          --workers on the pipeline backend (the sweep fabric) and
          --lease-ttl (item 11).

  size    inverse fleet sizing over a swept serving-traffic design space:
          the minimum device count serving --qps under percentile SLO
          walls, on the closed-form traffic model — swept points are never
          re-evaluated (--from DIR needs no device):

              PYTHONPATH=src python -m repro_torch.pathfind size \\
                  --from sweeps/traffic --qps 24 --slo-ttft-p99 2.0

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

  soe     DeepFlow's search and optimization engine (repro_torch.core.soe):
          rank every parallelism strategy on the template budgets, then
          run the eq.-6 multi-start descent over the budget vector through
          the differentiable CrossFlow for the best few:

              PYTHONPATH=src python -m repro_torch.pathfind soe \\
                  --arch qwen1.5-0.5b --cell train_4k --devices 64

  cooptimize  sweep -> refine (repro_torch.core.cooptimize): descend
          jointly over budgets and technology knobs (DVFS voltage, HBM
          bandwidth / capacity) around the Pareto frontier of a
          checkpointed sweep, written by either package, and stream the
          refined records in the sweep's schema to DIR/refined.jsonl:

              PYTHONPATH=src python -m repro_torch.pathfind cooptimize \\
                  --from sweeps/train --top-k 2 --steps 10

Every file written here is in the reference's format, so the reference's
``python -m repro.pathfind sweep --profile DIR/profile.json`` consumes a
profile fitted on the card, and each package's cooptimize refines the
other's sweep directory.  The reference's other subcommands exit 2 naming
the ROADMAP queue 1 item that ports them: explore and sweep-worker (item
11).
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


def _scenario_param(text: str) -> Tuple[str, object]:
    """KEY=V or KEY=V1,V2,... (a comma list declares a sweep axis)."""
    key, sep, val = text.partition("=")
    vals = [v for v in val.split(",") if v]
    if not sep or not key or not vals:
        raise argparse.ArgumentTypeError(
            f"bad scenario param {text!r}; expected KEY=V or KEY=V1,V2,...")
    try:
        out = [float(v) for v in vals]
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"bad scenario param {text!r}: values must be numbers")
    return key.strip(), out[0] if len(out) == 1 else out


def _scenario_params_dict(pairs) -> dict:
    return dict(pairs or ())


def _add_device_flag(p, what: str) -> None:
    p.add_argument("--device", default="cuda",
                   help=f"where {what} runs (default cuda; cpu only when "
                        f"asked)")


# -- shared flag groups (sweep / size) ---------------------------------------
# one scenario/profile/out-dir vocabulary across subcommands: a flag means
# the same thing everywhere, and commands that read their spec from a
# directory refuse contradicting flags instead of silently ignoring them


def _add_axis_flags(p) -> None:
    g = p.add_argument_group("design-space axes")
    g.add_argument("--arch", action="append", default=None,
                   help="model arch id (repeatable; 'all' = every config)")
    g.add_argument("--cell", action="append", default=None,
                   help="shape cell name (repeatable; default from the "
                        "scenario, e.g. train_4k / prefill_32k+decode_32k)")
    g.add_argument("--mesh", action="append", type=_mesh, default=None,
                   help="mesh shape like 16x16 (repeatable)")
    g.add_argument("--logic", type=_csv_list, default=["N7"],
                   help="comma-separated logic nodes (default N7)")
    g.add_argument("--hbm", type=_csv_list, default=["HBM2E"],
                   help="comma-separated HBM generations")
    g.add_argument("--net", type=_csv_list, default=["IB-NDR-X8"],
                   help="comma-separated inter-node networks")
    g.add_argument("--area", type=float, default=None,
                   help="proc chip area budget (mm^2)")
    g.add_argument("--power", type=float, default=None,
                   help="node power budget (W)")
    g.add_argument("--scale", type=_csv_list, default=None,
                   metavar="S1,S2,...",
                   help="budget-scale variants (e.g. 0.8,1.0,1.2) "
                        "multiplying area+power per hardware point")
    g.add_argument("--tilings", type=int, default=8,
                   help="PPE tiling samples per level")


def _add_scenario_flags(p, default_scenario: str = "train") -> None:
    g = p.add_argument_group("scenario")
    g.add_argument("--scenario", default=default_scenario,
                   help="workload scenario: train | serving | serving-long "
                        "| serving-traffic (continuous batching + "
                        "percentile SLO walls)")
    g.add_argument("--slo", type=float, default=None,
                   help="serving TTFT SLO in seconds (tags slo_ok; for "
                        "serving-traffic this is the p99 TTFT wall)")
    g.add_argument("--scenario-param", action="append",
                   type=_scenario_param, default=None,
                   metavar="KEY=V[,V2,...]",
                   help="typed scenario parameter (repeatable); for "
                        "serving-traffic: qps, prompt_mean, prompt_cv, "
                        "output_mean, output_cv, prefill_chunk, "
                        "slo_ttft_p50/p99, slo_tpot_p50/p99.  A comma "
                        "list declares a sweep axis (variants ride in "
                        "the cell id)")
    g.add_argument("--objectives", type=_csv_list, default=None,
                   metavar="OBJ1,OBJ2,...",
                   help="Pareto objectives from the objective registry "
                        "(core/objectives.py): 'energy', 'cost', "
                        "'goodput' (kind-matched aliases), canonical "
                        "names like energy_j_per_token, or the "
                        "scenario's own record fields.  Replaces the "
                        "scenario's default objective set")
    g.add_argument("--profile", default=None, metavar="FILE",
                   help="calibration profile JSON (pathfind calibrate); "
                        "every hardware point is evaluated on the "
                        "measurement-anchored MicroArch")


# flags of the reference's `sweep` whose machinery is not ported yet: each
# exits 2 naming its ROADMAP queue 1 item (dest, flag, what, item)
LATER_SWEEP_FLAGS = (
    ("lease_ttl", "--lease-ttl", "the sweep fabric's chunk leases", 11),
)
# subcommands of the reference CLI that later slices port
LATER_COMMANDS = {"explore": 11, "sweep-worker": 11}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="repro_torch.pathfind",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sw = sub.add_parser("sweep", help="batched design-space sweep")
    _add_axis_flags(sw)
    _add_scenario_flags(sw)
    sw.add_argument("--pareto", type=_csv_list, default=None, metavar="OBJS",
                    help="print only the Pareto frontier over these "
                         "objectives (default: the scenario's, e.g. "
                         "time_s,devices)")
    sw.add_argument("--csv", default=None, help="also write CSV here")
    # chunked resumable engine (repro_torch.core.sweeprunner)
    sw.add_argument("--out", default=None,
                    help="stream results + checkpoints into this directory "
                         "(enables --resume)")
    sw.add_argument("--resume", action="store_true",
                    help="continue an interrupted sweep from --out "
                         "(spec loaded from DIR/spec.json; zero "
                         "re-evaluation of finished chunks)")
    sw.add_argument("--chunk-size", type=int, default=32,
                    help="design points per chunk (checkpoint granularity)")
    sw.add_argument("--workers", type=int, default=None,
                    help="parallel chunk workers: on thread/process "
                         "backends the pool size (on the pipeline/auto "
                         "backend the reference's distributed sweep "
                         "fabric, not ported yet: exits 2)")
    sw.add_argument("--lease-ttl", type=float, default=None,
                    help="not ported yet (exits 2)")
    sw.add_argument("--backend", default="auto",
                    choices=["auto", "pipeline", "serial", "thread",
                             "process", "device"],
                    help="chunk fan-out: auto = the pipelined executor "
                         "(async double-buffered producer/device/writer "
                         "pipeline on the card's own stream); device = "
                         "serial, each chunk spread over every card")
    sw.add_argument("--max-chunks", type=int, default=None,
                    help="stop after N chunks (testing/benchmarks; "
                         "combine with --resume to continue)")
    sw.add_argument("--superbatch", type=int, default=None,
                    help="design points per device dispatch on the "
                         "pipeline backend (default 256; commit "
                         "granularity stays --chunk-size)")
    sw.add_argument("--frontier-only", action="store_true",
                    help="device-resident streaming-Pareto mode: only "
                         "the frontier over the scenario's objectives is "
                         "materialized/printed (DIR/frontier.jsonl with "
                         "--out); per-point rows never reach the host; "
                         "the carried state checkpoints to "
                         "DIR/frontier_state.npz per committed superbatch "
                         "(--resume continues with zero re-evaluation)")
    sw.add_argument("--frontier-cap", type=int, default=None,
                    help="carried device frontier capacity (default 512; "
                         "overflow is reported, never silent)")
    sw.add_argument("--no-compile-cache", action="store_true",
                    help="the reference's switch for its on-disk XLA "
                         "cache; nothing is compiled to disk here, so "
                         "it changes nothing")
    sw.add_argument("--compile-ahead", type=int, default=None, metavar="N",
                    help="superbatches to pack ahead of the device stage "
                         "on the pipeline backend, their designs traced "
                         "by the compile service off the critical path "
                         "(default 2)")
    bk = sw.add_mutually_exclusive_group()
    bk.add_argument("--bucketing", action="store_true",
                    help="cross-design bucketed dispatch: each design "
                         "traced once on the host, one canonical graph "
                         "per bucket, records bit for bit equal across "
                         "backends (execution-only; off by default)")
    bk.add_argument("--no-bucketing", action="store_true",
                    help="one vmapped function per design group (the "
                         "default; records equal to --bucketing's at "
                         "float32 rounding)")
    _add_device_flag(sw, "the evaluation")

    pl = sub.add_parser("plan", help="runtime sharding plan for one point")
    pl.add_argument("--arch", required=True)
    pl.add_argument("--cell", required=True)
    pl.add_argument("--mesh", type=_mesh, required=True)
    _add_device_flag(pl, "the prediction")

    sz = sub.add_parser("size",
                        help="inverse fleet sizing: minimum device count "
                             "serving --qps under percentile SLO walls")
    sz.add_argument("--from", dest="from_dir", default=None, metavar="DIR",
                    help="checkpointed serving-traffic sweep directory; "
                         "swept points are read, never re-scored.  "
                         "Without --from, the design-space axes below "
                         "run a fresh sweep first")
    _add_axis_flags(sz)
    _add_scenario_flags(sz, default_scenario="serving-traffic")
    sz.add_argument("--qps", type=float, required=True,
                    help="offered load (requests/s) to serve")
    sz.add_argument("--slo-ttft-p50", type=float, default=None,
                    help="median TTFT wall in seconds")
    sz.add_argument("--slo-ttft-p99", type=float, default=None,
                    help="p99 TTFT wall in seconds")
    sz.add_argument("--slo-tpot-p50", type=float, default=None,
                    help="median TPOT wall in seconds")
    sz.add_argument("--slo-tpot-p99", type=float, default=None,
                    help="p99 TPOT wall in seconds")
    sz.add_argument("--top-k", type=int, default=5,
                    help="feasible designs to report (default 5)")
    sz.add_argument("--rank-by", default="devices",
                    choices=["devices", "cost_per_token",
                             "energy_per_token"],
                    help="fleet-plan ranking: devices (default) or an "
                         "objective column already in the swept records "
                         "($/token, J/token) — zero re-evaluation")
    sz.add_argument("--out", default=None,
                    help="stream the fresh sweep's results + checkpoints "
                         "into this directory (axes mode only)")
    sz.add_argument("--chunk-size", type=int, default=32,
                    help="design points per chunk (axes mode)")
    sz.add_argument("--backend", default="auto",
                    choices=["auto", "pipeline", "serial", "thread",
                             "process", "device"],
                    help="sweep backend (axes mode; auto = the "
                         "pipelined executor)")
    _add_device_flag(sz, "the fresh sweep (axes mode)")

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

    co = sub.add_parser("cooptimize",
                        help="sweep -> refine cross-stack co-optimization")
    co.add_argument("--from", dest="from_dir", required=True, metavar="DIR",
                    help="checkpointed sweep directory (spec.json + "
                         "results.jsonl) written by either package; seeds "
                         "are read, never re-scored")
    co.add_argument("--scenario", default=None,
                    help="must match the sweep's scenario if given "
                         "(the spec in DIR is authoritative)")
    co.add_argument("--top-k", type=int, default=4,
                    help="frontier points to refine (default 4)")
    co.add_argument("--candidates", type=int, default=2,
                    help="discrete (mesh, strategy) candidates per seed, "
                         "ranked from the sweep's own records (default 2)")
    co.add_argument("--steps", type=int, default=24,
                    help="refinement GD steps (default 24)")
    co.add_argument("--starts", type=int, default=4,
                    help="multi-start batch size (default 4)")
    co.add_argument("--lr", type=float, default=0.05)
    co.add_argument("--seed", type=int, default=0)
    co.add_argument("--scenario-param", action="append",
                    type=_scenario_param, default=None,
                    metavar="KEY=V[,V2,...]",
                    help="must match the sweep's scenario params if given "
                         "(the spec in DIR is authoritative)")
    co.add_argument("--objectives", type=_csv_list, default=None,
                    metavar="OBJ1,OBJ2,...",
                    help="must match the sweep's objectives if given "
                         "(the spec in DIR is authoritative)")
    co.add_argument("--out", default=None, metavar="FILE",
                    help="refined-records JSONL path "
                         "(default DIR/refined.jsonl)")
    co.add_argument("--csv", default=None, help="also write CSV here")
    _add_device_flag(co, "the refinement")

    so = sub.add_parser("soe", help="strategy x budget co-optimization")
    so.add_argument("--arch", required=True)
    so.add_argument("--cell", required=True)
    so.add_argument("--devices", type=int, default=64)
    so.add_argument("--logic", default="N7")
    so.add_argument("--hbm", default="HBM2E")
    so.add_argument("--net", default="IB-NDR-X8")
    so.add_argument("--steps", type=int, default=20)
    so.add_argument("--starts", type=int, default=4)
    so.add_argument("--tilings", type=int, default=8)
    so.add_argument("--no-search-arch", action="store_true",
                    help="rank strategies only (skip the budget GD)")
    _add_device_flag(so, "the search")

    for cmd, item in LATER_COMMANDS.items():
        sub.add_parser(cmd, help=f"not ported yet (ROADMAP queue 1 item "
                                 f"{item}; exits 2)", add_help=False)
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


def _later_flag(args) -> Optional[str]:
    """The ``error:`` text for the first flag of a later item, or None."""
    for dest, flag, what, item in LATER_SWEEP_FLAGS:
        val = getattr(args, dest, None)
        if val is not None and val is not False:
            return (f"{flag}: {what} is not ported yet (ROADMAP queue 1 "
                    f"item {item})")
    return None


def _cmd_sweep(args) -> int:
    """``pathfind sweep``: the in-memory sweep, or the chunked runner when
    any of its flags is given (the reference's routing)."""
    later = _later_flag(args)
    if later:
        print(f"error: {later}", file=sys.stderr)
        return 2
    # every flag the chunked engine owns must route there — a runner-only
    # flag silently dropped by the in-memory path is a footgun
    use_runner = bool(args.out or args.resume or args.scenario != "train"
                      or args.scale or args.max_chunks is not None
                      or args.backend != "auto" or args.slo is not None
                      or args.chunk_size != 32
                      or args.profile is not None
                      or args.scenario_param or args.objectives
                      or args.workers is not None
                      or args.frontier_only or args.superbatch is not None
                      or args.frontier_cap is not None
                      or args.compile_ahead is not None
                      or args.no_bucketing or args.bucketing
                      or (args.arch and "all" in args.arch))
    if use_runner:
        return _cmd_sweep_runner(args)

    from repro_torch.core import pathfinder
    from repro_torch.core.age import Budgets
    from repro_torch.core.roofline import PPEConfig

    if not (args.arch and args.mesh):
        print("error: sweep needs --arch and --mesh (or --resume with "
              "--out)", file=sys.stderr)
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


def _spec_from_args(args):
    """The `sweeprunner.SweepSpec` of a command line's axes and scenario
    flags (``sweep`` and ``size``)."""
    from repro_torch.core import sweeprunner
    profile_dict = None
    if args.profile is not None:
        from repro_torch.calibrate import profiles as profiles_lib
        profile_dict = profiles_lib.load_profile(args.profile).to_dict()
    return sweeprunner.SweepSpec(
        arches=tuple(args.arch),
        mesh_shapes=tuple(tuple(m) for m in args.mesh),
        scenario=args.scenario, cells=tuple(args.cell or ()),
        logic_nodes=tuple(args.logic), hbms=tuple(args.hbm),
        nets=tuple(args.net),
        budget_scales=tuple(float(s) for s in args.scale) if args.scale
        else (1.0,),
        area_mm2=args.area, power_w=args.power, slo_s=args.slo,
        n_tilings=args.tilings, chunk_size=args.chunk_size,
        profile=profile_dict,
        scenario_params=_scenario_params_dict(args.scenario_param) or None,
        objectives=tuple(args.objectives) if args.objectives else None)


def _spec_flags_given(args, defaults: Dict[str, object]) -> List[str]:
    """The axis / scenario flags set away from their defaults: a command
    that loads its spec from a directory refuses them."""
    return [name for name, dest in (
        ("--arch", "arch"), ("--cell", "cell"), ("--mesh", "mesh"),
        ("--logic", "logic"), ("--hbm", "hbm"), ("--net", "net"),
        ("--scale", "scale"), ("--area", "area"), ("--power", "power"),
        ("--slo", "slo"), ("--scenario", "scenario"),
        ("--chunk-size", "chunk_size"), ("--tilings", "tilings"),
        ("--profile", "profile"), ("--scenario-param", "scenario_param"),
        ("--objectives", "objectives"), ("--out", "out"))
        if dest in defaults and getattr(args, dest) != defaults[dest]]


_AXIS_DEFAULTS = {"arch": None, "cell": None, "mesh": None,
                  "logic": ["N7"], "hbm": ["HBM2E"], "net": ["IB-NDR-X8"],
                  "scale": None, "area": None, "power": None, "slo": None,
                  "tilings": 8, "profile": None, "scenario_param": None,
                  "objectives": None}


def _validate_dispatch_args(args) -> int:
    """Reject nonsensical dispatch sizing up front (rc 2) instead of
    letting a ``--superbatch 0`` surface mid-sweep."""
    superbatch = getattr(args, "superbatch", None)
    if superbatch is not None and superbatch <= 0:
        print(f"error: --superbatch must be a positive number of design "
              f"points (got {superbatch}); drop the flag for the default "
              f"(256)", file=sys.stderr)
        return 2
    compile_ahead = getattr(args, "compile_ahead", None)
    if compile_ahead is not None and compile_ahead <= 0:
        print(f"error: --compile-ahead must be a positive number of "
              f"superbatches to pre-compile (got {compile_ahead}); drop "
              f"the flag for the default (2), or use --no-bucketing to "
              f"fall back to per-group lazy compilation", file=sys.stderr)
        return 2
    return 0


def _cmd_sweep_runner(args) -> int:
    """Chunked / resumable path (repro_torch.core.sweeprunner)."""
    from repro_torch.core import sweeprunner

    rc = _validate_dispatch_args(args)
    if rc:
        return rc
    if args.frontier_only and args.pareto:
        print("error: --frontier-only already reduces to the "
              "scenario's Pareto objectives on device; drop --pareto",
              file=sys.stderr)
        return 2
    kwargs = dict(backend=args.backend, workers=args.workers,
                  superbatch=args.superbatch, device=args.device,
                  compile_ahead=args.compile_ahead,
                  bucketing=True if args.bucketing
                  else False if args.no_bucketing else None)
    if args.resume:
        if not args.out:
            print("error: --resume requires --out DIR", file=sys.stderr)
            return 2
        # the spec comes from DIR/spec.json; axis/scenario flags on the
        # command line would be silently contradicted, so refuse them
        ignored = _spec_flags_given(args, dict(
            _AXIS_DEFAULTS, scenario="train", chunk_size=32))
        if ignored:
            print(f"error: --resume loads the sweep spec from "
                  f"{args.out}/spec.json; drop these flags (they would "
                  f"be ignored): {', '.join(ignored)}", file=sys.stderr)
            return 2
        runner = sweeprunner.SweepRunner.from_dir(args.out, **kwargs)
    else:
        if not (args.arch and args.mesh):
            print("error: sweep needs --arch and --mesh (or --resume with "
                  "--out)", file=sys.stderr)
            return 2
        spec = _spec_from_args(args)
        if spec.profile is not None:
            print(f"# profile: {args.profile} "
                  f"(tech={spec.profile.get('tech')})", file=sys.stderr)
        runner = sweeprunner.SweepRunner(spec, out_dir=args.out, **kwargs)
    # --workers on the pipeline backend is the reference's distributed
    # sweep fabric (N sweep-worker processes over --out)
    if args.workers is not None and runner.backend == "pipeline":
        print("error: --workers: parallel chunk workers on the "
              "pipeline/auto backend (the distributed sweep fabric) is "
              "not ported yet (ROADMAP queue 1 item 11); --backend thread "
              "or process runs a pool of N workers", file=sys.stderr)
        return 2

    run_kwargs = dict(resume=args.resume, max_chunks=args.max_chunks,
                      frontier_only=args.frontier_only)
    if args.frontier_cap is not None:
        run_kwargs["frontier_capacity"] = args.frontier_cap
    stats = runner.run(**run_kwargs)
    # any variant resolves the same fields/objectives for CSV + frontier
    scn = runner.spec.scenario_spec.variants()[0].resolve()
    records = stats.records or []
    shown = records
    objectives = args.pareto or list(scn.objectives)
    if args.pareto:
        shown = sweeprunner.pareto_records(records, objectives)
    csv_text = sweeprunner.to_csv(shown, scn)
    print(csv_text)
    if args.csv:
        with open(args.csv, "w") as fh:
            fh.write(csv_text + "\n")
        print(f"# wrote {len(shown)} points to {args.csv}", file=sys.stderr)
    mode = " frontier-only" if stats.frontier_only else ""
    print(f"# sweep[{scn.name}]{mode} backend={stats.backend}: "
          f"{stats.n_points_total} points in {stats.n_chunks_total} chunks; "
          f"skipped {stats.n_chunks_skipped} checkpointed, evaluated "
          f"{stats.n_chunks_evaluated} "
          f"({stats.n_points_evaluated} points) in {stats.elapsed_s:.1f}s",
          file=sys.stderr)
    print(f"# cache: prediction {stats.cache_hits} hits / "
          f"{stats.cache_misses} misses; compiled fns "
          f"{stats.compile_misses} built / {stats.compile_hits} reused",
          file=sys.stderr)
    print(f"# compile: {stats.compile_seconds:.1f}s tracing designs into "
          f"their buckets, {stats.stall_seconds:.1f}s stalling the eval "
          f"path (compile-ahead hides the rest)", file=sys.stderr)
    if stats.frontier_only:
        print(f"# frontier: {len(records)} non-dominated points over "
              f"{'/'.join(scn.objectives)}", file=sys.stderr)
        if stats.n_frontier_overflowed:
            print(f"# warning: device frontier capacity overflowed "
                  f"({stats.n_frontier_overflowed} candidates dropped); "
                  f"raise --frontier-cap", file=sys.stderr)
    if not stats.complete:
        device = "" if runner.device.type == "cuda" \
            else f" --device {runner.device.type}"
        if stats.frontier_only and stats.out_dir:
            print(f"# incomplete: resume with `python -m "
                  f"repro_torch.pathfind sweep --out {stats.out_dir} "
                  f"--resume --frontier-only{device}` (carried state in "
                  f"frontier_state.npz)", file=sys.stderr)
        elif stats.frontier_only:
            print("# incomplete (no --out directory: the carried frontier "
                  "state was not checkpointed)", file=sys.stderr)
        elif stats.out_dir:
            print(f"# incomplete: resume with `python -m "
                  f"repro_torch.pathfind sweep --out {stats.out_dir} "
                  f"--resume{device}`", file=sys.stderr)
        else:
            print("# incomplete (no --out directory: nothing was "
                  "checkpointed)", file=sys.stderr)
    feasible = [r for r in records
                if r.get("feasible", True)
                and r.get(objectives[0]) is not None
                and float(r[objectives[0]]) > 0.0]
    if feasible:
        best = min(feasible, key=lambda r: float(r[objectives[0]]))
        print(f"# best[{objectives[0]}]: {best['key']} -> "
              f"{float(best[objectives[0]]):.4g}", file=sys.stderr)
    return 0


def _cmd_size(args) -> int:
    """Inverse fleet-sizing query (repro_torch.core.traffic.size_fleet)."""
    import json

    from repro_torch.core import objectives as objectives_lib
    from repro_torch.core import sweeprunner, traffic

    if args.from_dir:
        # the swept records are authoritative: refuse contradicting flags
        # exactly as `sweep --resume` does
        ignored = _spec_flags_given(args, dict(
            _AXIS_DEFAULTS, scenario="serving-traffic", out=None))
        if ignored:
            print(f"error: --from loads the sweep spec from "
                  f"{args.from_dir}/spec.json; drop these flags (they "
                  f"would be ignored): {', '.join(ignored)}",
                  file=sys.stderr)
            return 2
        spec, records = sweeprunner.load_sweep(args.from_dir)
        if not records:
            # frontier-only sweep: size over the materialized frontier
            fp = os.path.join(args.from_dir, "frontier.jsonl")
            if os.path.exists(fp):
                with open(fp) as fh:
                    records = [json.loads(ln) for ln in fh if ln.strip()]
    else:
        if not (args.arch and args.mesh):
            print("error: size needs --arch and --mesh (or --from DIR)",
                  file=sys.stderr)
            return 2
        spec = _spec_from_args(args)
        runner = sweeprunner.SweepRunner(spec, out_dir=args.out,
                                         backend=args.backend,
                                         device=args.device)
        records = runner.run().records
    if spec.scenario != "serving-traffic":
        print(f"error: fleet sizing needs the serving-traffic scenario "
              f"(the sweep used {spec.scenario!r})", file=sys.stderr)
        return 2
    # model defaults = the spec's single-valued params; swept
    # (multi-valued) params override per record via the cell-id suffix
    base = dict(traffic.PARAM_DEFAULTS)
    base.update({k: v for k, v in spec.scenario_spec.params
                 if not isinstance(v, tuple)})
    if spec.slo_s is not None:
        base["slo_ttft_p99"] = spec.slo_s
    # objective-model params (energy price, MTBF, ...) are not traffic
    # params; split them out before the strict traffic parser
    _, base = objectives_lib.split_objective_params(base)
    tm, pol, spec_slo = traffic.split_params(base)
    slo = {name: float(v) for name in
           ("ttft_p50", "ttft_p99", "tpot_p50", "tpot_p99")
           if (v := getattr(args, "slo_" + name)) is not None}
    if not slo:         # fall back to the walls the sweep itself carried
        slo = {k[len("slo_"):]: float(v) for k, v in spec_slo.items()
               if v is not None}
    if not slo:
        print("error: size needs at least one SLO wall (--slo-ttft-p99 "
              "0.5, --slo-tpot-p50 0.05, ...)", file=sys.stderr)
        return 2
    plan = traffic.size_fleet(records, args.qps, slo=slo, traffic=tm,
                              policy=pol, top_k=args.top_k,
                              rank_by=args.rank_by)
    walls = " ".join(f"{k}<={v:g}s" for k, v in sorted(slo.items()))
    print(f"# size: {plan.n_records} serving-traffic records, "
          f"{plan.n_sized} sizeable under {walls} at {plan.qps:g} qps "
          f"({plan.n_unsizeable} unsizeable; {plan.n_evals} closed-form "
          f"evals, zero sweep re-evaluations)", file=sys.stderr)
    if plan.best is None:
        print("# no swept design meets the SLO walls at any replica "
              "count", file=sys.stderr)
        return 1
    rank_col = traffic.RANK_COLUMNS[args.rank_by]
    header = ("devices,replicas,devices_per_replica,per_replica_qps,"
              "ttft_p99_s,tpot_p50_s,util,key")
    if rank_col is not None:       # default devices output stays identical
        header += f",{rank_col}"
    print(header)
    for c in plan.candidates:
        m = c.metrics
        row = (f"{c.devices},{c.replicas},{c.devices_per_replica},"
               f"{c.per_replica_qps:.4g},{m['ttft_p99_s']:.4g},"
               f"{m['tpot_p50_s']:.4g},{m['util']:.3f},{c.key}")
        if rank_col is not None:
            row += f",{c.rank_value:.6g}" if c.rank_value is not None \
                else ","
        print(row)
    b = plan.best
    print(f"# best: {b.devices} devices = {b.replicas} replicas x "
          f"{b.devices_per_replica} ({b.key}) -> ttft_p99 "
          f"{b.metrics['ttft_p99_s']:.4g}s, tpot_p50 "
          f"{b.metrics['tpot_p50_s']:.4g}s at {b.per_replica_qps:.4g} "
          f"qps/replica", file=sys.stderr)
    return 0


def _cmd_cooptimize(args) -> int:
    """Sweep -> refine pipeline (repro_torch.core.cooptimize)."""
    import json

    from repro_torch.core import cooptimize, sweeprunner

    spec, records = sweeprunner.load_sweep(args.from_dir)
    if not records:
        # frontier-only sweep: seed refinement from the materialized
        # frontier (exactly the points worth refining anyway)
        fp = os.path.join(args.from_dir, "frontier.jsonl")
        if os.path.exists(fp):
            with open(fp) as fh:
                records = [json.loads(ln) for ln in fh if ln.strip()]
    if args.scenario is not None and args.scenario != spec.scenario:
        print(f"error: --scenario {args.scenario} contradicts the sweep "
              f"spec in {args.from_dir} (scenario={spec.scenario}); the "
              f"spec is authoritative — drop the flag", file=sys.stderr)
        return 2
    if args.scenario_param:
        want = _scenario_params_dict(args.scenario_param)
        have = dict(spec.scenario_params or {})
        if any(have.get(k) != v for k, v in want.items()):
            print(f"error: --scenario-param contradicts the sweep spec in "
                  f"{args.from_dir} (params={have}); the spec is "
                  f"authoritative — drop the flag", file=sys.stderr)
            return 2
    if args.objectives is not None \
            and tuple(args.objectives) != (spec.objectives or ()):
        print(f"error: --objectives {','.join(args.objectives)} "
              f"contradicts the sweep spec in {args.from_dir} "
              f"(objectives="
              f"{','.join(spec.objectives) if spec.objectives else '<default>'}"
              f"); the spec is authoritative — drop the flag",
              file=sys.stderr)
        return 2
    cfg = cooptimize.RefineConfig(
        top_k=args.top_k, candidates_per_seed=args.candidates,
        steps=args.steps, starts=args.starts, lr=args.lr, seed=args.seed)
    out_path = args.out or os.path.join(args.from_dir, "refined.jsonl")
    stats = cooptimize.refine_sweep((spec, records), cfg=cfg,
                                    out_path=out_path, verbose=False,
                                    device=args.device)
    scn = spec.scenario_spec.variants()[0].resolve()
    csv_text = sweeprunner.to_csv(stats.records, scn)
    print(csv_text)
    if args.csv:
        with open(args.csv, "w") as fh:
            fh.write(csv_text + "\n")
        print(f"# wrote {len(stats.records)} refined points to {args.csv}",
              file=sys.stderr)
    print(f"# cooptimize[{stats.scenario}]: {stats.n_records} sweep "
          f"records -> frontier {stats.n_frontier}; refined "
          f"{stats.n_candidates} candidates around {stats.n_seeds} seeds "
          f"({stats.n_objective_evals} objective evals, "
          f"{stats.n_unimproved} unimproved) in {stats.elapsed_s:.1f}s",
          file=sys.stderr)
    print(f"# {stats.n_dominating}/{stats.n_refined} refined points "
          f"dominate >=1 sweep frontier point; refined records -> "
          f"{stats.out_path}", file=sys.stderr)
    if stats.n_refined and not stats.n_dominating:
        print("# warning: no refined point dominates the sweep frontier "
              "(try more --steps/--starts)", file=sys.stderr)
    return 0


def _cmd_soe(args) -> int:
    """Strategy x budget co-optimization (repro_torch.core.soe)."""
    from repro_torch.configs.base import SHAPE_CELLS, get_config
    from repro_torch.core import lmgraph, soe, techlib
    from repro_torch.core.roofline import PPEConfig

    tech = techlib.make_tech_config(args.logic, args.hbm, args.net)
    g = lmgraph.build_graph(get_config(args.arch), SHAPE_CELLS[args.cell])
    res = soe.co_optimize(
        tech, g, n_devices=args.devices,
        cfg=soe.SOEConfig(steps=args.steps, starts=args.starts),
        search_arch=not args.no_search_arch,
        ppe=PPEConfig(n_tilings=args.tilings), device=args.device)
    print(f"strategy  {res.strategy.name}")
    print(f"time      {res.time_s*1e3:.3f} ms/iter")
    print(f"queries   {res.n_queries}")
    for comp, frac in res.budgets.area_frac.items():
        print(f"area[{comp:9s}] {float(frac):.3f}")
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
    # a subcommand of a later slice takes the reference's flags, which are
    # not declared here: its arguments are left over, and it is refused by
    # name below
    args, extra = parser.parse_known_args(argv)
    if args.cmd in LATER_COMMANDS:
        print(f"error: pathfind {args.cmd} is not ported yet (ROADMAP "
              f"queue 1 item {LATER_COMMANDS[args.cmd]})", file=sys.stderr)
        return 2
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    try:
        return {"sweep": _cmd_sweep, "plan": _cmd_plan, "size": _cmd_size,
                "calibrate": _cmd_calibrate, "validate": _cmd_validate,
                "soe": _cmd_soe,
                "cooptimize": _cmd_cooptimize}[args.cmd](args)
    except ModuleNotFoundError as e:
        print(f"error: unknown arch (no config module): {e.name}",
              file=sys.stderr)
    except KeyError as e:
        print(f"error: unknown name: {e}", file=sys.stderr)
    except (ValueError, AttributeError, OSError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
    return 2

if __name__ == "__main__":
    sys.exit(main())
