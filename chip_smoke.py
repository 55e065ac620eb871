#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

drives the port's main path — measure -> fit -> profile -> report ->
validate, then a full-size CrossFlow prediction — on the card, through the
same functions ``python -m repro_torch.pathfind calibrate|validate`` calls:

  1. setup     prints the card's name and power limit and builds every
               CUDA kernel of the path from ``src/repro_torch/kernels/csrc``
               (nvcc for sm_90a, one process per source, all at once),
               printing ptxas' register / shared-memory / spill lines;
  2. kernels   runs each kernel against its plain PyTorch version at the
               unit-test shapes and every shape the main path gives it,
               the full-width qwen1.5-0.5b layer GEMMs included (f32 and
               bf16, two block shapes), then times kernel, plain
               version and the library call (torch.matmul) with CUDA events
               at the four full-width shapes, beside the card's bound;
  3. calibrate the ``slice`` measurement suite on the tpu_v5e template: the
               quick cuBLAS GEMMs, the hand-written GEMM at the same shapes
               plus the full-width ones, bandwidth probes; fit, profile,
               report (into ``build/chip_smoke/``, gitignored), then
               ``pathfind validate`` (rc 0 required);
  4. predict   full-size qwen1.5-0.5b x train_4k on the tpu_v5e template,
               uncalibrated and with the phase-3 profile applied, checked
               against the same prediction on the host.

Every kernel's launch count is zeroed just before phases 3-4 and read just
after; a kernel of the path that was not launched there fails the run.
Any failure exits non-zero.  The last two lines of standard output are a
JSON line per kernel set and the device line
``{"ok": true, "device": {"platform": "gpu", ...}}``; the line before them
is the card's name and power limit as nvidia-smi gives them.  Without a
CUDA device, or without ``src/repro_torch`` beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# peak rates of one H100 SXM (NVIDIA data sheet, dense) at 700 W
H100_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

UNIT_SHAPES = ((128, 128, 128), (256, 512, 128), (64, 384, 256),
               (8, 128, 128), (256, 256, 1024), (40, 120, 72))
BLOCK_SHAPES = (None, (64, 64, 64))
TOLS = {"float32": (1e-4, 8e-4), "bfloat16": (2e-2, 1.6e-1)}  # rtol, atol
KERNELS = {     # name -> what the JSON line says about it
    "gemm": {"route": "cuda",
             "source": "src/repro_torch/kernels/csrc/gemm.cu",
             "replaces": "src/repro/kernels/gemm.py:71"},
}


def _port():
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke: {src}/repro_torch not found; run "
                         f"from a checkout of the repository")
    sys.path.insert(0, str(src))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_setup() -> None:
    from repro_torch.kernels import build
    print("== phase 1: setup")
    print(card_line())
    t0 = time.perf_counter()
    logs = build.build(list(KERNELS))
    print(f"# built {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")


def _events_ms(fn, device, warmup: int = 3, iters: int = 20) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def phase_kernels(device, cmp_shapes, timed_shapes) -> dict:
    """Kernel vs plain on the same inputs; timings at ``timed_shapes``."""
    import torch
    from repro_torch.kernels import gemm as gemm_mod
    print("== phase 2: kernels against their plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    max_abs = {"float32": 0.0, "bfloat16": 0.0}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        rtol, atol = TOLS[dname]
        for (m, n, k) in cmp_shapes:
            x = torch.randn((m, k), generator=gen, device=device).to(dtype)
            w = torch.randn((k, n), generator=gen, device=device).to(dtype)
            want = gemm_mod.gemm_plain(x, w).float()
            for block in BLOCK_SHAPES:
                got = gemm_mod.gemm(x, w, block_shape=block)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                assert got.dtype == dtype and got.shape == (m, n), \
                    (got.dtype, got.shape)
                err = (got.float() - want).abs().max().item()
                rel = err / max(want.abs().max().item(), 1e-30)
                print(f"  gemm {dname:8s} ({m},{n},{k}) block={block}: "
                      f"max abs err {err:.3e}, rel {rel:.3e}")
                torch.testing.assert_close(got.float(), want, rtol=rtol,
                                           atol=atol)
                max_abs[dname] = max(max_abs[dname], err)
    timing = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "flops": 0.0, "bytes": 0.0}
    if device.type != "cuda":
        return {"max_abs_err": max_abs["float32"], "timing": None}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for (m, n, k) in timed_shapes:
            x = torch.randn((m, k), generator=gen, device=device).to(dtype)
            w = torch.randn((k, n), generator=gen, device=device).to(dtype)
            ms = _events_ms(lambda: gemm_mod.gemm(x, w), device)
            plain = _events_ms(lambda: gemm_mod.gemm_plain(x, w), device)
            lib = _events_ms(lambda: torch.matmul(x, w), device)
            flops = 2.0 * m * n * k
            nbytes = float((m * k + k * n + m * n) * x.element_size())
            t_ops = flops / H100_PEAK_FLOPS[dname] * 1e3
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            by = "operations" if t_ops >= t_bytes else "bytes"
            print(f"  time gemm {dname:8s} ({m},{n},{k}): kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, "
                  f"torch.matmul {lib:.4f} ms, bound {bound:.4f} ms "
                  f"({by}), kernel/bound {ms / bound:.2f}x")
            if dname == "float32":      # the main path's dtype
                timing["ms"] += ms
                timing["plain_ms"] += plain
                timing["library_ms"] += lib
                timing["flops"] += flops
                timing["bytes"] += nbytes
    return {"max_abs_err": max_abs["float32"], "timing": timing}


def phase_calibrate(device, spec, workdir: Path, steps: int, starts: int):
    import numpy as np
    from repro_torch import pathfind
    from repro_torch.calibrate import report
    print("== phase 3: measure -> fit -> profile -> report -> validate")
    shutil.rmtree(workdir, ignore_errors=True)
    out = pathfind.calibrate(spec, str(workdir), tech="tpu_v5e", steps=steps,
                             starts=starts, tilings=8, device=device,
                             verbose=False)
    assert out is not None, "calibrate measured nothing"
    print(report.format_report(out.report, baseline=out.baseline_report))
    groups = out.report["groups"]
    want_kinds = {"gemm": len(spec.gemm_shapes),
                  "gemm_pallas": len(spec.pallas_shapes),
                  "elementwise": len(spec.elementwise_sizes)}
    for kind, n in want_kinds.items():
        if n:
            assert groups[kind]["n"] == n, (kind, groups.get(kind))
    for g, s in groups.items():
        assert math.isfinite(s["mre"]) and math.isfinite(s["bias_log"]), g
    times = [r["t_s"] for r in out.stats.records]
    assert len(times) == out.stats.n_points_total and \
        all(np.isfinite(times)) and min(times) > 0, times
    print(f"# fit[{out.fit.selected}]: MRE {out.fit.mre_identity * 100:.1f}%"
          f" -> {out.fit.mre * 100:.1f}% over {out.fit.n_evals} evals")
    rc = pathfind.main(["validate", "--out", str(workdir), "--device",
                        str(device)])
    assert rc == 0, f"pathfind validate exited {rc}"
    return out


def phase_predict(device, profile_path: str) -> None:
    import torch
    from repro_torch.calibrate import profiles
    from repro_torch.configs.base import SHAPE_CELLS, get_config
    from repro_torch.core import age, lmgraph, roofline, simulate
    from repro_torch.core.parallelism import Strategy
    print("== phase 4: predict qwen1.5-0.5b x train_4k (tpu_v5e template)")
    cfg = get_config("qwen1.5-0.5b")
    graph = lmgraph.build_graph(cfg, SHAPE_CELLS["train_4k"])
    prof = profiles.load_profile(profile_path)
    ppe = roofline.PPEConfig(n_tilings=int(prof.fit.get("n_tilings", 8)))
    results = {}
    for dev in (device, torch.device("cpu")):
        t0 = time.perf_counter()
        base = age.tpu_v5e_microarch(device=dev)
        for label, arch, cfg_ppe in (
                ("uncalibrated", base, ppe),
                ("calibrated", profiles.apply_profile(base, prof),
                 profiles.ppe_with_profile(ppe, prof))):
            for strat in ("RC-1-1-d64-p1", "RC-2-2-d4-p4"):
                bd = simulate.predict(arch, graph, Strategy.parse(strat),
                                      cfg=cfg_ppe)
                results[(dev.type, label, strat)] = (
                    float(bd.total_s), float(bd.compute_s), float(bd.comm_s))
        print(f"# 4 predictions on {dev.type}: "
              f"{time.perf_counter() - t0:.2f}s")
    for (where, label, strat), (tot, comp, comm) in results.items():
        if where != device.type:
            continue
        host = results[("cpu", label, strat)]
        print(f"  {label:12s} {strat}: total_s {tot:.6g}  compute_s "
              f"{comp:.6g}  comm_s {comm:.6g}")
        for a, b in zip((tot, comp, comm), host):
            assert math.isfinite(a) and a >= 0, (label, strat, a)
            assert abs(a - b) <= 1e-4 * abs(b), \
                f"{label} {strat}: device {a} vs host {b}"
    assert results[(device.type, "uncalibrated", "RC-1-1-d64-p1")][0] > 0
    arch = age.tpu_v5e_microarch(device=device)
    d, f, kv = cfg.d_model, cfg.d_ff, 2 * cfg.n_kv_heads * cfg.resolved_head_dim
    for name, (n, k) in (("q", (d, d)), ("kv", (kv, d)), ("o", (d, d)),
                         ("up", (2 * f, d)), ("down", (d, f))):
        tiling = roofline.best_gemm_tiling(arch, 4096, n, k, cfg=ppe)
        print(f"  best_gemm_tiling {name:4s} (4096,{n},{k}): L2 {tiling[0]} "
              f"L1 {tiling[1]} L0 {tiling[2]}")


def run(device, spec, workdir: Path, cmp_shapes, timed_shapes,
        steps: int = 80, starts: int = 6) -> list:
    """Phases 2-4; returns the per-kernel result objects."""
    from repro_torch.kernels import gemm as gemm_mod
    t0 = time.perf_counter()
    ker = phase_kernels(device, cmp_shapes, timed_shapes)
    t1 = time.perf_counter()
    print(f"# phase 2: {t1 - t0:.2f}s")
    # the main path: launch counts from zero, read right after
    gemm_mod.reset_launches()
    out = phase_calibrate(device, spec, workdir, steps, starts)
    t2 = time.perf_counter()
    print(f"# phase 3: {t2 - t1:.2f}s (measuring {out.stats.elapsed_s:.2f}s, "
          f"the rest fit, reports and validate)")
    phase_predict(device, out.profile_path)
    print(f"# phase 4: {time.perf_counter() - t2:.2f}s")
    launches = gemm_mod.LAUNCHES
    per_point = max(spec.warmup, 1) + max(spec.reps, 1)
    expected = len(spec.pallas_shapes) * per_point \
        if device.type == "cuda" else 0
    print(f"# gemm kernel launches on the main path: {launches} "
          f"(expected {expected})")
    assert launches == expected, (launches, expected)
    t = ker["timing"]
    row = {"name": "gemm", **KERNELS["gemm"], "launches": launches,
           "max_abs_err": ker["max_abs_err"]}
    if t is None:
        row.update(ms=None, plain_ms=None, bound_ms=None, bound_by=None,
                   library_ms=None)
    else:
        t_ops = t["flops"] / H100_PEAK_FLOPS["float32"] * 1e3
        t_bytes = t["bytes"] / H100_BYTES_PER_S * 1e3
        row.update(ms=t["ms"], plain_ms=t["plain_ms"],
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   library_ms=t["library_ms"])
    return [row]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the card", file=sys.stderr)
        return 1
    _port()
    from repro_torch.calibrate import microbench
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_setup()
    print(f"# phase 1: {time.perf_counter() - t0:.2f}s")
    spec = microbench.default_spec("slice", reps=3)
    # the unit-test shapes and every shape the main path gives the kernel
    cmp_shapes = tuple(dict.fromkeys(UNIT_SHAPES + spec.pallas_shapes))
    kernels = run(device, spec, ROOT / "build" / "chip_smoke",
                  cmp_shapes, microbench.QWEN_LAYER_SHAPES)
    print(f"# chip_smoke phases done in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
