#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

drives the port's main paths on the card, through the functions a user
calls: measure -> fit -> profile -> report -> validate
(``python -m repro_torch.pathfind calibrate|validate``), a full-size
CrossFlow prediction, and serving full-width qwen1.5-0.5b
(``python -m repro_torch.launch.serve``):

  1. setup     prints the card's name and power limit and builds every
               CUDA kernel of the paths from ``src/repro_torch/kernels/csrc``
               (nvcc for sm_90a, one process per source, all at once),
               printing ptxas' register / shared-memory / spill lines;
  2. kernels   runs each kernel against its plain PyTorch version at the
               unit-test shapes and every shape the main paths give it
               (f32 and bf16, two block shapes each): the GEMM at the
               full-width qwen1.5-0.5b layer GEMMs, flash attention at the
               full-width prefill (2, 16, 2048, 2048, 64) and decode
               (8, 16, 1, 160, 64) shapes and the calibration suite's
               reduced ones; then times kernel, plain version and the
               library call (torch.matmul, F.scaled_dot_product_attention)
               at the full-width shapes, each from a CUDA-graph replay
               timed with CUDA events, beside the card's bound;
  3. calibrate the ``slice`` measurement suite on the tpu_v5e template: the
               quick cuBLAS GEMMs, the hand-written GEMM at the same shapes
               plus the full-width ones, bandwidth probes, the reduced
               qwen1.5-0.5b prefill and decode steps; fit, profile, report
               (into ``build/chip_smoke/``, gitignored), then
               ``pathfind validate`` (rc 0 required);
  4. predict   full-size qwen1.5-0.5b x train_4k on the tpu_v5e template,
               uncalibrated and with the phase-3 profile applied, checked
               against the same prediction on the host;
  5. serve     full-width qwen1.5-0.5b (24 layers, random weights from a
               seed): ``serve(batch=8, prompt_len=128, gen=32)``, then a
               2048-token prompt forwarded 2047 tokens into a cache and
               stepped once, whose logits must match the last position of
               a 2048-token forward.

Every kernel's launch count is zeroed just before phases 3-5 and read just
after; each must have risen by exactly the count the paths imply.  Any
failure exits non-zero.  The last two lines of standard output are a JSON
line of kernel results and the device line
``{"ok": true, "device": {"platform": "gpu", ...}}``; the line before them
is the card's name and power limit as nvidia-smi gives them.  Without a
CUDA device, or without ``src/repro_torch`` beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import collections
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
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:100"},
}


def _decode(b, h, skv, d, kv_len):
    """A decode call: one query at position kv_len - 1 over a cache."""
    return ((b, h, h, 1, skv, d),
            dict(causal=False, q_offset=kv_len - 1, kv_len=kv_len))


# flash attention: (b, h, h_kv, sq, skv, d), mask arguments
ATTN_UNIT = (   # tests/test_torch_attention.py and test_torch_card.py
    ((1, 4, 4, 128, 128, 64), dict(causal=True)),
    ((2, 8, 2, 128, 128, 64), dict(causal=True)),
    ((1, 4, 1, 256, 256, 32), dict(causal=True)),
    ((1, 2, 2, 128, 384, 64), dict(causal=False)),
    ((1, 2, 2, 256, 256, 32), dict(causal=True, window=32)),
    ((1, 2, 2, 256, 256, 32), dict(causal=True, window=128)),
    ((1, 2, 1, 100, 77, 128), dict(causal=False)),
    ((1, 4, 2, 200, 200, 128), dict(causal=True, window=64)),
    ((1, 4, 2, 16, 64, 64), dict(causal=True, q_offset=48)),
    *(((2, 4, 2, 1, 64, 32), dict(causal=False, q_offset=n - 1, kv_len=n))
      for n in (1, 17, 64)),
)
ATTN_PATH = (   # the shapes the main paths give the kernel
    ((2, 16, 16, 2048, 2048, 64), dict(causal=True)),   # full-width prefill
    *(_decode(8, 16, 160, 64, n) for n in (1, 80, 160)),  # phase-5 serve
    ((2, 16, 16, 2047, 2047, 64), dict(causal=True)),   # phase-5 check
    _decode(2, 16, 2048, 64, 2048),
    ((2, 4, 4, 128, 128, 32), dict(causal=True)),       # phase-3 prefill
    _decode(2, 4, 128, 32, 128),                        # phase-3 decode
)
ATTN_TIMED = (ATTN_PATH[0], ATTN_PATH[3])   # full-width prefill, decode
ATTN_BLOCKS = ((128, 128), (32, 64))
ATTN_TOLS = {"float32": 2e-3, "bfloat16": 3e-2}    # rtol = atol
SERVE = dict(batch=8, prompt_len=128, gen=32, use_reduced=False)
CHECK_LEN = 2048        # phase 5's prefill-vs-decode consistency prompt


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


def _graph_ms(fn, device, iters: int = 20, reps: int = 5) -> float:
    """Mean ms of one ``fn()`` replayed from a CUDA graph of ``iters``
    calls, timed with CUDA events: the device's time without the host's
    launch overhead, which at decode's microsecond kernels is larger than
    the kernel itself."""
    import torch
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):       # warm up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / (iters * reps)


def _bound(flops: float, nbytes: float, dname: str):
    """(least ms on the card, what bounds it): the larger of the
    operations over the peak rate for the type and the bytes over the
    memory rate."""
    t_ops = flops / H100_PEAK_FLOPS[dname] * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase_gemm(device, cmp_shapes, timed_shapes) -> dict:
    """GEMM kernel vs plain on the same inputs; timings at
    ``timed_shapes`` in f32, the calibration path's dtype."""
    import torch
    from repro_torch.kernels import gemm as gemm_mod
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
    if device.type != "cuda":
        return {"max_abs_err": max_abs["float32"], "timing": None}
    timing = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "flops": 0.0, "bytes": 0.0, "dtype": "float32"}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for (m, n, k) in timed_shapes:
            x = torch.randn((m, k), generator=gen, device=device).to(dtype)
            w = torch.randn((k, n), generator=gen, device=device).to(dtype)
            ms = _graph_ms(lambda: gemm_mod.gemm(x, w), device)
            plain = _graph_ms(lambda: gemm_mod.gemm_plain(x, w), device)
            lib = _graph_ms(lambda: torch.matmul(x, w), device)
            flops = 2.0 * m * n * k
            nbytes = float((m * k + k * n + m * n) * x.element_size())
            bound, by = _bound(flops, nbytes, dname)
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


def _visible_pairs(sq: int, skv: int, causal: bool = True, window=None,
                   q_offset: int = 0, kv_len=None) -> int:
    """(query, key) pairs the masks leave visible: the work these inputs
    need (the kernel skips fully masked tiles)."""
    import numpy as np
    q = q_offset + np.arange(sq)[:, None]
    k = np.arange(skv)[None, :]
    vis = k < (skv if kv_len is None else kv_len)
    if causal:
        vis = vis & (k <= q)
    if window is not None:
        vis = vis & (k > q - window)
    return int(vis.sum())


def _attn_inputs(shape, dtype, gen, device):
    import torch
    b, h, hkv, sq, skv, d = shape
    return tuple(torch.randn(s, generator=gen, device=device).to(dtype)
                 for s in ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


def phase_attention(device, cmp_cases, timed_cases) -> dict:
    """Flash-attention kernel vs `attention_ref` on the same inputs;
    timings at ``timed_cases`` in bf16, the serving path's dtype."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref
    gen = torch.Generator(device=device).manual_seed(1)
    max_abs = {"float32": 0.0, "bfloat16": 0.0}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        tol = ATTN_TOLS[dname]
        for shape, kw in cmp_cases:
            q, k, v = _attn_inputs(shape, dtype, gen, device)
            want = attention_ref(q, k, v, **kw).float()
            for bq, bkv in ATTN_BLOCKS:
                got = fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv,
                                         **kw)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                assert got.dtype == dtype and got.shape == q.shape, \
                    (got.dtype, got.shape)
                err = (got.float() - want).abs().max().item()
                rel = err / max(want.abs().max().item(), 1e-30)
                print(f"  flash_attention {dname:8s} {shape} {kw} "
                      f"blocks=({bq},{bkv}): max abs err {err:.3e}, "
                      f"rel {rel:.3e}")
                torch.testing.assert_close(got.float(), want, rtol=tol,
                                           atol=tol)
                max_abs[dname] = max(max_abs[dname], err)
    if device.type != "cuda":
        return {"max_abs_err": max_abs["bfloat16"], "timing": None}
    timing = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "flops": 0.0, "bytes": 0.0, "dtype": "bfloat16"}
    for shape, kw in timed_cases:
        b, h, hkv, sq, skv, d = shape
        q, k, v = _attn_inputs(shape, torch.bfloat16, gen, device)
        kvl = kw.get("kv_len") or skv
        kc, vc = k[:, :, :kvl], v[:, :, :kvl]
        ms = _graph_ms(lambda: fa.flash_attention(q, k, v, **kw), device)
        plain = _graph_ms(lambda: attention_ref(q, k, v, **kw), device)
        lib = _graph_ms(lambda: F.scaled_dot_product_attention(
            q, kc, vc, is_causal=kw["causal"]), device)
        flops = 4.0 * b * h * d * _visible_pairs(sq, skv, **kw)
        nbytes = float(2 * (2 * b * h * sq * d + 2 * b * hkv * kvl * d))
        bound, by = _bound(flops, nbytes, "bfloat16")
        print(f"  time flash_attention bfloat16 {shape} {kw}: kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s, "
              f"{nbytes / ms / 1e6:.1f} GB/s), plain {plain:.4f} ms, "
              f"F.scaled_dot_product_attention {lib:.4f} ms, bound "
              f"{bound:.5f} ms ({by}), kernel/bound {ms / bound:.1f}x")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("flops", flops), ("bytes", nbytes)):
            timing[key] += val
    return {"max_abs_err": max_abs["bfloat16"], "timing": timing}


def phase_calibrate(device, spec, workdir: Path, steps: int, starts: int):
    import numpy as np
    from repro_torch import pathfind
    from repro_torch.calibrate import microbench, report
    from repro_torch.calibrate.report import _group_key
    print("== phase 3: measure -> fit -> profile -> report -> validate")
    shutil.rmtree(workdir, ignore_errors=True)
    out = pathfind.calibrate(spec, str(workdir), tech="tpu_v5e", steps=steps,
                             starts=starts, tilings=8, device=device,
                             verbose=False)
    assert out is not None, "calibrate measured nothing"
    print(report.format_report(out.report, baseline=out.baseline_report))
    groups = out.report["groups"]
    want_kinds = collections.Counter(
        _group_key({"kind": p.kind, **dict(p.params)})
        for p in microbench.enumerate_points(spec))
    for kind, n in want_kinds.items():
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


def phase_serve(device, serve_kw: dict, check_len: int) -> int:
    """Serve qwen1.5-0.5b through the port's ``launch.serve``, then check
    prefill (a forward into the cache) against decode (one step).  Returns
    the flash-attention launches this phase must have made."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import build_model
    cfg = get_config("qwen1.5-0.5b")
    if serve_kw["use_reduced"]:
        cfg = reduced(cfg)
    print(f"== phase 5: serve {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}x{cfg.resolved_head_dim} heads, "
          f"vocab {cfg.padded_vocab}) {serve_kw}")
    out = serve_mod.serve("qwen1.5-0.5b", device=device, **serve_kw)
    toks = out["tokens"]
    assert toks.shape == (serve_kw["batch"], serve_kw["gen"]), toks.shape
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size
    print(f"  plan {out['plan']}: prefill_s {out['prefill_s']:.4f} "
          f"(stepping {serve_kw['prompt_len']} prompt tokens), decode_s "
          f"{out['decode_s']:.4f}, tok_per_s {out['tok_per_s']:.1f}")
    print(f"  first tokens: {toks[0, :8].tolist()} {toks[-1, :8].tolist()}")

    model = build_model(cfg, device)
    params = model.init(1)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                            (2, check_len))
    ids = torch.as_tensor(ids, dtype=torch.int32, device=device)
    with torch.no_grad():
        caches = model.init_cache(2, check_len)
        model.forward(params, {"tokens": ids[:, :-1]}, caches=caches)
        step, _ = model.decode_step(params, caches, ids[:, -1:],
                                    check_len - 1)
        full = model.forward(params, {"tokens": ids})[0][:, -1]
    step, full = step[:, 0, :cfg.vocab_size], full[:, :cfg.vocab_size]
    err = (step - full).abs().max().item()
    scale = full.abs().max().item()
    same = (step.argmax(-1) == full.argmax(-1)).float().mean().item()
    print(f"  prefill {check_len - 1} + 1 decode step vs a {check_len}-token "
          f"forward: max abs logit diff {err:.4e} of max |logit| "
          f"{scale:.4e} ({err / scale:.2e}); argmax agrees on "
          f"{same * 100:.0f}% of rows")
    assert math.isfinite(err) and bool(torch.isfinite(full).all())
    assert err <= ATTN_TOLS["bfloat16"] * scale, (err, scale)
    prof_steps = _profile_decode(model, params, serve_kw, device)
    steps = serve_kw["prompt_len"] + serve_kw["gen"]
    # serve, then forward + step + forward, then the profiled steps
    return cfg.n_layers * (steps + 3 + prof_steps)


def _profile_decode(model, params, serve_kw: dict, device) -> int:
    """Where a serving step's time goes: ``generate`` at the serve batch
    over a short prompt under torch.profiler (CPU + CUDA); prints wall
    time and device-busy time per step and the kernels by device time.
    Returns the decode steps it ran."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import generate
    prompt_len, gen = 4, 8
    prompts = np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (serve_kw["batch"], prompt_len))
    if device.type != "cuda":
        generate(model, params, prompts, gen)
        return prompt_len + gen
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(model, params, prompts, gen)
        wall = time.perf_counter() - t0
    n = prompt_len + gen
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and "CUDA" in str(e.device_type)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        print("  profiled decode steps: the profiler recorded no device "
              "time (device busy share not measured)")
        return n
    launches = sum(e.count for e in kernels)
    print(f"  profiled {n} decode steps at batch {serve_kw['batch']}: wall "
          f"{wall / n * 1e3:.3f} ms/step (profiler on), device busy "
          f"{busy_us / n / 1e3:.3f} ms/step, idle share "
          f"{1 - busy_us * 1e-6 / wall:.3f}, {launches / n:.1f} kernel "
          f"launches/step under {len(kernels)} names")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / n / 1e3:8.4f} ms/step "
              f"{e.count / n:6.1f} launches/step  {e.key[:90]}")
    return n


def _row(name: str, launches: int, res: dict) -> dict:
    row = {"name": name, **KERNELS[name], "launches": launches,
           "max_abs_err": res["max_abs_err"]}
    t = res["timing"]
    if t is None:
        row.update(ms=None, plain_ms=None, bound_ms=None, bound_by=None,
                   library_ms=None)
    else:
        bound, by = _bound(t["flops"], t["bytes"], t["dtype"])
        row.update(ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=bound,
                   bound_by=by, library_ms=t["library_ms"])
    return row


def run(device, spec, workdir: Path, gemm_cmp, gemm_timed, attn_cmp,
        attn_timed, serve_kw: dict, check_len: int, steps: int = 80,
        starts: int = 6) -> list:
    """Phases 2-5; returns the per-kernel result objects."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import gemm as gemm_mod
    print("== phase 2: kernels against their plain versions")
    t0 = time.perf_counter()
    results = {"gemm": phase_gemm(device, gemm_cmp, gemm_timed),
               "flash_attention": phase_attention(device, attn_cmp,
                                                  attn_timed)}
    t1 = time.perf_counter()
    print(f"# phase 2: {t1 - t0:.2f}s")
    # the main paths: launch counts from zero, read right after
    gemm_mod.reset_launches()
    fa_mod.reset_launches()
    out = phase_calibrate(device, spec, workdir, steps, starts)
    t2 = time.perf_counter()
    print(f"# phase 3: {t2 - t1:.2f}s (measuring {out.stats.elapsed_s:.2f}s, "
          f"the rest fit, reports and validate)")
    phase_predict(device, out.profile_path)
    t3 = time.perf_counter()
    print(f"# phase 4: {t3 - t2:.2f}s")
    serve_launches = phase_serve(device, serve_kw, check_len)
    print(f"# phase 5: {time.perf_counter() - t3:.2f}s")
    launches = {"gemm": gemm_mod.LAUNCHES,
                "flash_attention": fa_mod.LAUNCHES}
    per_point = max(spec.warmup, 1) + max(spec.reps, 1)
    model_layers = sum(reduced(get_config(a)).n_layers
                       for a in spec.model_archs)
    expected = {
        "gemm": len(spec.pallas_shapes) * per_point,
        "flash_attention": model_layers * len(spec.model_phases) * per_point
        + serve_launches}
    if device.type != "cuda":
        expected = dict.fromkeys(expected, 0)
    for name, n in launches.items():
        print(f"# {name} kernel launches on the main paths: {n} "
              f"(expected {expected[name]})")
        assert n == expected[name], (name, n, expected[name])
    return [_row(name, launches[name], results[name]) for name in KERNELS]


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
    # the unit-test shapes and every shape the main paths give the kernels
    cmp_shapes = tuple(dict.fromkeys(UNIT_SHAPES + spec.pallas_shapes))
    kernels = run(device, spec, ROOT / "build" / "chip_smoke",
                  cmp_shapes, microbench.QWEN_LAYER_SHAPES,
                  ATTN_UNIT + ATTN_PATH, ATTN_TIMED, SERVE, CHECK_LEN)
    print(f"# chip_smoke phases done in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
