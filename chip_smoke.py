#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

drives the port's main paths on the card, through the functions a user
calls: measure -> fit -> profile -> report -> validate
(``python -m repro_torch.pathfind calibrate|validate``), a full-size
CrossFlow prediction, the search layer and the chunked sweep runner
(``pathfind plan|sweep|size``), DeepFlow's search (``pathfind
soe|cooptimize``), serving full-width qwen1.5-0.5b
(``python -m repro_torch.launch.serve``), the recurrent families at
full width (``Model.prefill`` and ``serve`` of recurrentgemma-2b and
xlstm-125m), training (``launch.train.train``), the MoE,
encoder-decoder and LSTM families (qwen2-moe-a2.7b and whisper-large-v3
at full width), and parallelism (the mesh path over a ``DeviceMesh``):

  1. setup     prints the card's name and power limit and builds every
               CUDA kernel of the paths from ``src/repro_torch/kernels/csrc``
               (nvcc for sm_90a, one process per source, all at once),
               printing ptxas' register / shared-memory / spill lines and,
               from ``cuobjdump --dump-sass``, each GEMM entry's HMMA and
               FFMA counts (every entry must multiply on the tensor cores
               and none with FFMA), each mLSTM entry's registers,
               stack, local memory and HMMA count (``cuobjdump
               --dump-resource-usage``; every bf16 entry must hold
               ``HMMA.16816.F32.BF16`` and spill nothing) and each RG-LRU
               scan entry's registers, shared memory, spills and LDGSTS /
               FMUL / FADD / FFMA counts (every ring entry must copy with
               LDGSTS, no entry may hold an FFMA, none may spill);
  2. kernels   runs each kernel against its plain PyTorch version at the
               unit-test shapes and every shape the main paths give it
               (f32 and bf16, two block shapes each): the GEMM also at
               ragged and unaligned shapes, into the other output dtype
               and on NaN and Inf inputs, and at the full-width
               qwen1.5-0.5b layer GEMMs, where its f32 error from the
               float64 product must stay within 4x ``torch.matmul``'s; flash attention at the
               full-width qwen1.5-0.5b (d 64) and recurrentgemma-2b (d 256)
               prefill and decode shapes and the calibration suite's
               reduced ones; the RG-LRU scan bit for bit, on both of its
               variants (printing which each shape took), at
               recurrentgemma-2b's (2, 2048, 2560); the mLSTM parallel
               form at ragged lengths at every head dim and xlstm-125m's
               (2, 4, 2048, 192); then
               times kernel, plain version and the
               library call where one PyTorch call computes the same
               function (torch.matmul, F.scaled_dot_product_attention with
               enable_gqa where the head counts differ, printing which of
               its fused backends take the shape; none for the scan and
               the mLSTM) at the full-width shapes, each from a CUDA-graph
               replay timed with CUDA events, beside the card's bound
               (the bf16 mLSTM kernel at (2, 4, 2048, d) for every head
               dim; the JSON row keeps d = 192);
  3. calibrate the ``slice`` measurement suite on the tpu_v5e template: the
               quick cuBLAS GEMMs, the hand-written GEMM at the same shapes
               plus the full-width ones, bandwidth probes, the reduced
               qwen1.5-0.5b prefill and decode steps; fit, profile, report
               (into ``build/chip_smoke/``, gitignored), then
               ``pathfind validate`` (rc 0 required);
  4. predict   full-size qwen1.5-0.5b x train_4k on the tpu_v5e template,
               uncalibrated and with the phase-3 profile applied, checked
               against the same prediction on the host; then the search
               layer (``core/pathfinder.py``): (a) ``pathfind plan`` for
               qwen1.5-0.5b x train_4k at 16x16, (b) the in-memory
               ``sweep`` of every arch x train_4k x meshes 8x8 and 16x16
               x every logic node, HBM generation and network of the
               techlib, (c) one matrix-mode call of 16,384 rows for one
               skeleton (the AGE points of (b) scaled by seeded factors in
               [0.8, 1.2]); each on the card and on the host, the card's
               rows held to the host's (1e-4 relative) and (b)'s to the
               reference's rows in ``tests/test_torch_golden_sweep.npz``,
               printing points/s on both and the card's per-row eager
               rate; (d) the chunked runner through ``pathfind sweep
               --out DIR [--resume]`` and ``pathfind size --from DIR``:
               the serving-traffic scenario on the phase-3 profile (every
               arch x 8x8, 16x16 x N7, N5 x HBM2E, HBM3, objectives
               energy, cost, goodput, two qps values), stopped after half
               its chunks on the card and resumed (no chunk evaluated
               twice), held to an uninterrupted host run (the same spec
               fingerprint and chunk hashes, records within 1e-4); the
               train, serving and serving-traffic scenarios of the same
               axes uncalibrated on card and host, the card's records
               held to the host's and, for two archs, to the
               reference's own in ``tests/test_torch_golden_runner.jsonl``
               (1e-4), each through the default pipelined executor
               (``--backend auto``); the executors against those
               pipeline directories: every scenario on ``--backend
               serial`` on card and host (``spec.json`` and
               ``checkpoint.jsonl`` the same bytes, records within 1e-4),
               a serial run stopped half way and resumed on the pipeline,
               ``--frontier-only`` of every scenario (exactly the keys of
               ``pareto_records`` over the full directory) and one stopped
               and resumed from ``frontier_state.npz``, ``--backend
               thread`` and ``process`` on the train scenario of the
               golden archs; fleet
               sizing over the card's directory printing the host's
               text; points/s of every sweep and backend on both; (e)
               DeepFlow's search: ``pathfind soe`` for qwen1.5-0.5b x
               train_4k on 64 devices at the reference's defaults on
               card and host (the same strategy and queries, the batched
               path, the best time within TIME_RTOL, the reference's
               printed lines from ``tests/test_torch_golden_soe.json``),
               the reference's SOE and refine objectives, gradients and
               a three-step descent from that file (SOE_TOLS), ``pathfind
               cooptimize --from`` (d)'s card-written train and
               calibrated serving-traffic directories on card and host
               (the same counts, records within 1e-4), each command's
               wall seconds and eq.-6 steps/s, and one profiled step of
               each engine; (f) the bucketed search (the sweeps above
               run unbucketed, the default): (d)'s scenarios with
               ``--bucketing`` on the serial backend and the pipeline,
               each from an empty store and design registry, their
               points/s and compile and stall seconds beside (d)'s
               unbucketed ones, the serial records held to (d)'s
               unbucketed serial ones (1e-5) and the golden ones, the
               pipeline's the serial's bit for bit, the bucket and
               compile counters, one vmapped call and one profiled
               superbatch bucketed and not (launches, host-to-device
               copies, idle share), ``pathfind sweep`` with
               ``--bucketing --compile-ahead 2 --no-compile-cache``,
               ``--no-bucketing`` and ``--backend device``, and a matrix
               call over every card (a 2-card split against one card
               where the host has two); every ``pathfind`` call of
               phase 4 starts from empty caches, as a new process does;
  5. serve     full-width qwen1.5-0.5b (24 layers, random weights from a
               seed): ``serve(batch=8, prompt_len=128, gen=32)``, then a
               2048-token prompt forwarded 2047 tokens into a cache and
               stepped once, whose logits must match the last position of
               a 2048-token forward, and a profiled decode window;
  6. recurrent recurrentgemma-2b and xlstm-125m at full width (random
               weights from seed 0), each: ``Model.prefill`` of a batch-2,
               2048-token prompt (timed, and once profiled: the scan's and
               the mLSTM kernels' shares of its device-busy time),
               ``serve(batch=8,
               prompt_len=128, gen=32)``, the same 2047 + 1 against 2048
               consistency check, and a profiled decode window;
  7. train     the kernels' autograd Functions against autograd through
               their plain versions, then ``launch.train.train`` at full
               width (qwen1.5-0.5b with a checkpoint round trip,
               recurrentgemma-2b, xlstm-125m), the reduced archs against
               ``tests/test_torch_golden_train.npz``, and remat;
  8. families  MoE, the encoder-decoder and the LSTM: (a) the reduced
               qwen2-moe-a2.7b, qwen3-moe-30b-a3b (both dispatches),
               whisper-large-v3 and paper-lm in f32 and bf16 against the
               reference's outputs in ``tests/test_torch_golden_families.
               npz`` (FAMILY_GOLDEN); (b) full-width qwen2-moe-a2.7b:
               ``serve``, ``Model.prefill`` of (2, 2048), the 2047 + 1
               check at capacity 8.0 (no drops), its first MoE layer
               against a dense computation; (c) full-width
               whisper-large-v3: ``Model.prefill`` of (2, 1500) frame
               embeddings, 16 decode steps from it against a forward,
               ``serve``, and 3 steps
               of ``launch.train.train`` at 1500 frames and 448 tokens,
               one more timed and one profiled.  Phase 2 holds the
               attention kernel to its plain version at every shape
               these paths give it (ATTN_PATH);
  9. parallel  the process group at world size 1 (NCCL), then (a) three
               steps of ``make_train_step`` on full-width qwen1.5-0.5b at
               (4, 2048) through the mesh path (DTensor parameters, AdamW
               moments and batches on a 1x1 ``DeviceMesh``; the kernels
               reached on each rank's shards), from phase 7 (b)'s seed,
               batches and schedule, its losses held to phase 7 (b)'s
               first three at rtol 1e-5 and its step ms printed beside
               phase 7 (b)'s; (b) ``bucketed_all_reduce`` of a mixed bf16
               / f32 tree; (c) the ``collective`` microbenchmark at 1
               device; (d) where the host has more than one card, three
               steps of ``torchrun`` training on a 2-rank mesh, else a
               line saying it has one.

Every kernel's launch count is zeroed just before phases 3-5, 6, 7 (b)-(e),
8 and 9 (a), and read just after each; each must have risen by exactly
the count the paths imply.  Any failure exits non-zero.  The last
two lines of standard output are a JSON line of kernel results and the
device line ``{"ok": true, "device": {"platform": "gpu", ...}}``; the line
before them is the card's name and power limit as nvidia-smi gives them.
Without a CUDA device, or without ``src/repro_torch`` beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# peak rates of one H100 SXM (NVIDIA data sheet, dense) at 700 W
H100_BYTES_PER_S = 3.35e12
# float32 is the FFMA units' rate; tf32 the tensor cores' (the GEMM's f32
# path does three TF32 products, so its bound is 3 x 2mnk at this rate)
H100_PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}

UNIT_SHAPES = ((128, 128, 128), (256, 512, 128), (64, 384, 256),
               (8, 128, 128), (256, 256, 1024), (40, 120, 72))
# ragged and unaligned edges of the GEMM's 128 x 128 tile and its 16-byte
# copies: k % 4 != 0 (f32 and bf16), n % 8 != 0 (bf16), m < 16
GEMM_EDGES = ((33, 65, 31), (1, 1, 1), (17, 9, 129), (96, 64, 70),
              (48, 100, 64), (130, 260, 36))
BLOCK_SHAPES = (None, (64, 64, 64))
TOLS = {"float32": (1e-4, 8e-4), "bfloat16": (2e-2, 1.6e-1)}  # rtol, atol
KERNELS = {     # name -> what the JSON line says about it
    "gemm": {"route": "cuda",
             "source": "src/repro_torch/kernels/csrc/gemm.cu",
             "replaces": "src/repro/kernels/gemm.py:71",
             "backward": "none (refuses)"},
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:100",
        "backward": "plain recompute"},
    "rglru_scan": {"route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "replaces": "src/repro/kernels/rglru.py:50",
                   "backward": "rglru_scan kernel, reversed"},
    "mlstm_parallel": {"route": "cuda",
                       "source": "src/repro_torch/kernels/csrc/mlstm.cu",
                       "replaces": "src/repro/kernels/mlstm.py:93",
                       "backward": "plain recompute"},
}


# the __global__ names of csrc/*.cu, as the profiler shows them
PORT_KERNEL_NAMES = ("gemm_kernel", "attn_kernel", "attn_mma_kernel",
                     "rglru_kernel", "rglru_ring_kernel", "mlstm_kernel",
                     "mlstm_mma_kernel")


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
    ((1, 10, 1, 300, 300, 256), dict(causal=True)),     # head dim 256
    ((2, 4, 1, 256, 256, 256), dict(causal=True, window=64)),
    ((1, 4, 2, 16, 64, 256), dict(causal=True, q_offset=100, window=32)),
    # ragged edges of the bf16 tensor-core kernel's 16-row warp tiles and
    # 32- / 64-key tiles, a window edge inside a tile, GQA group 10
    ((2, 4, 2, 17, 17, 32), dict(causal=True)),
    ((1, 2, 1, 15, 15, 256), dict(causal=True)),
    ((2, 20, 2, 77, 77, 256), dict(causal=True)),
    ((1, 2, 2, 200, 200, 64), dict(causal=True, window=24)),
)
RG_WINDOW = 2048        # recurrentgemma-2b's local window
ATTN_PATH = (   # the shapes the main paths give the kernel
    ((2, 16, 16, 2048, 2048, 64), dict(causal=True)),   # full-width prefill
    *(_decode(8, 16, 160, 64, n) for n in (1, 80, 160)),  # phase-5 serve
    ((2, 16, 16, 2047, 2047, 64), dict(causal=True)),   # phase-5 check
    _decode(2, 16, 2048, 64, 2048),
    ((2, 4, 4, 128, 128, 32), dict(causal=True)),       # phase-3 prefill
    _decode(2, 4, 128, 32, 128),                        # phase-3 decode
    # phase 6, recurrentgemma-2b: prefill 2048 / 2047 (local, window 2048),
    # serve's decode over a 160-slot ring, the check's decode at 2048
    ((2, 10, 1, 2048, 2048, 256), dict(causal=True, window=RG_WINDOW)),
    ((2, 10, 1, 2047, 2047, 256), dict(causal=True, window=RG_WINDOW)),
    *(((8, 10, 1, 1, 160, 256), dict(causal=False, q_offset=n - 1, kv_len=n))
      for n in (1, 80, 160)),
    ((2, 10, 1, 1, 2048, 256), dict(causal=False, q_offset=2047,
                                    kv_len=2048)),
    # phase 8, whisper-large-v3 (d 64): the encoder over 1500 frames
    # (non-causal), the decoder's self- and cross-attention in training
    # (448 tokens) and over 16 tokens, decode steps over the 448-slot self
    # ring and the 1500-row cross cache, serve's over its 160-row zero cross
    # cache
    ((2, 20, 20, 1500, 1500, 64), dict(causal=False)),
    ((2, 20, 20, 448, 1500, 64), dict(causal=False)),
    ((2, 20, 20, 448, 448, 64), dict(causal=True)),
    ((2, 20, 20, 16, 16, 64), dict(causal=True)),
    ((2, 20, 20, 16, 1500, 64), dict(causal=False)),
    *(((b, 20, 20, 1, 448, 64), dict(causal=False, q_offset=n - 1, kv_len=n))
      for b, n in ((2, 1), (2, 16), (8, 80), (8, 160))),
    ((2, 20, 20, 1, 1500, 64), dict(causal=False)),
    ((8, 20, 20, 1, 160, 64), dict(causal=False)),
    # phase 8, qwen2-moe-a2.7b (d 128): prefill 2048 / 2047, serve's decode
    # and the check's step at 2048
    ((2, 16, 16, 2048, 2048, 128), dict(causal=True)),
    ((2, 16, 16, 2047, 2047, 128), dict(causal=True)),
    *(_decode(8, 16, 160, 128, n) for n in (1, 80, 160)),
    _decode(2, 16, 2048, 128, 2048),
)
# full-width prefill and decode: qwen1.5-0.5b (d 64), recurrentgemma (d 256)
ATTN_TIMED = (ATTN_PATH[0], ATTN_PATH[3], ATTN_PATH[8], ATTN_PATH[12])
# timed beside SDPA and printed, outside the JSON row's sum (which keeps
# the four shapes above): whisper's encoder, qwen2-moe's prefill (d 128)
ATTN_TIMED_FAMILIES = (ATTN_PATH[14], ATTN_PATH[25])
ATTN_BLOCKS = ((128, 128), (32, 64))
ATTN_TOLS = {"float32": 2e-3, "bfloat16": 3e-2}    # rtol = atol
# the RG-LRU scan: (batch, seq, width); the tests' shapes (widths 37, and
# 100 and 36 in bf16, take the element-wise variant; 36 and 40 leave a
# partial channel block on the ring), then recurrentgemma-2b's prefill
# (2048) and phase 6's check (2047) at width 2560.  Both variants take the
# plain version's product then sum at every step: bit for bit.
RGLRU_UNIT = ((1, 128, 64), (2, 256, 128), (3, 96, 32), (2, 7, 37),
              (1, 1, 64), (2, 200, 36), (3, 130, 100), (1, 100, 40))
RGLRU_PATH = ((2, 2048, 2560), (2, 2047, 2560))
RGLRU_BLOCKS = (128, 16)
# the mLSTM parallel form: (b, h, s, d); the tests' shapes, lengths that
# are no multiple of the bf16 kernel's 16-row warp tile, 64-row q tile or
# 64-key kv tile at every head dim, then xlstm-125m's prefill (2048)
# and phase 6's check (2047), 4 heads of 192
MLSTM_HEAD_DIMS = (32, 64, 128, 192)
MLSTM_UNIT = ((1, 2, 128, 64), (2, 4, 256, 32), (1, 2, 1, 32),
              (2, 4, 100, 192), (1, 1, 77, 128),
              *((2, 3, s, d) for d in MLSTM_HEAD_DIMS for s in (15, 65, 200)))
MLSTM_PATH = ((2, 4, 2048, 192), (2, 4, 2047, 192))
# timed in bf16: the path's shape (the JSON row), then the other head dims
MLSTM_TIMED = (MLSTM_PATH[0], *((2, 4, 2048, d) for d in (32, 64, 128)))
MLSTM_BLOCKS = ((128, 128), (32, 64))
MLSTM_TOLS = {"float32": 3e-3, "bfloat16": 3e-2}   # rtol = atol
# phase 4's search work: None takes every arch lmgraph builds, every
# technology of the techlib
SEARCH = dict(arches=None, meshes=((8, 8), (16, 16)), logic=None, hbm=None,
              net=None, matrix_rows=16384, eager_rows=8)
SEARCH_RTOL = 1e-4      # the card's rows against the host's and the golden
# phase 4 (f): bucketed records against unbucketed ones; the rows of a
# matrix split over several devices against one device's
BUCKET_RTOL = 1e-5
SPLIT_RTOL = 1e-6
# phase 4 (f)'s matrix call over every card, (c)'s skeleton
SPLIT_ROWS = 4096
GOLDEN_SWEEP = ROOT / "tests" / "test_torch_golden_sweep.npz"
# phase 4 (d), the chunked runner: one set of axes for every scenario (every
# registered arch, 2 meshes, 2 logic nodes, 2 HBM generations, the composed
# objectives, chunks of 8 designs), each scenario's own flags, the sizing
# query, and the archs of the axes whose records the reference wrote into
# GOLDEN_RUNNER
RUNNER = dict(
    arches=("all",),
    axes=("--mesh", "8x8", "--mesh", "16x16", "--logic", "N7,N5", "--hbm",
          "HBM2E,HBM3", "--objectives", "energy,cost,goodput",
          "--chunk-size", "8"),
    scenarios={"train": (), "serving": ("--slo", "10"),
               "serving-traffic": ("--scenario-param", "qps=0.25,1",
                                   "--slo", "30")},
    size=("--qps", "4", "--slo-ttft-p99", "30"),
    golden_arches=("qwen1_5_0_5b", "recurrentgemma_2b"))
GOLDEN_RUNNER = ROOT / "tests" / "test_torch_golden_runner.jsonl"
# phase 4 (e), DeepFlow: ``pathfind soe`` at the reference's defaults (20
# steps, 4 starts, 8 tilings), whose printed lines the golden file holds;
# ``pathfind cooptimize --from`` phase 4 (d)'s card-written train and
# calibrated serving-traffic directories with these flags; the card's
# best time against the host's (TIME_RTOL) and each refined record
# against the host's (SEARCH_RTOL)
DEEPFLOW = dict(
    soe=("--arch", "qwen1.5-0.5b", "--cell", "train_4k", "--devices", "64"),
    cooptimize=("--top-k", "2", "--candidates", "1", "--steps", "8",
                "--starts", "4"),
    dirs=("train", "traffic"))
TIME_RTOL = 1e-4
# the reference's objectives, gradients and first descent steps at fixed
# points (tests/test_torch_golden_soe.py writes it), held on the card at
# value rtol / gradient tolerance (of the gradient's norm) / iterate atol
GOLDEN_SOE = ROOT / "tests" / "test_torch_golden_soe.json"
SOE_TOLS = dict(value=1e-4, grad=1e-3, w=1e-4)
# what the golden file holds: `soe.make_objective` on tests/test_core_soe.py's
# GEMM and on phase 4 (e)'s soe point (its strategy), each at the template
# and seeded starts; each scenario's refine objective, built in and with
# composed objectives, on the first design of a one-design sweep, at the
# seed operating point and a seeded start (norms: the design's record); a
# three-step batched descent on the GEMM objective; and the printed lines
# of ``pathfind soe`` at DEEPFLOW's flags and at a short run's
_TECH = ["N7", "HBM2E", "IB-NDR-X8"]
SOE_CASES = dict(
    objective=[
        dict(graph=["gemm", 4096, 4096, 4096], strategy="RC-2-2-d2-p1",
             tech=_TECH, n_tilings=24, starts=3, seed=1),
        dict(graph=["lm", "qwen1.5-0.5b", "train_4k"],
             strategy="RC-4-1-d16-p1", tech=_TECH, n_tilings=8, starts=2,
             seed=1)],
    refine=[dict(arches=["qwen1.5-0.5b"], mesh_shapes=[[4, 4]],
                 scenario=scenario, logic_nodes=["N7"], n_tilings=4,
                 scenario_params=params, objectives=objectives, starts=2,
                 seed=0)
            for scenario, params in (("train", None), ("serving", None),
                                     ("serving-traffic", {"qps": 0.1}))
            for objectives in (None, ["energy", "cost", "goodput"])],
    descent=dict(objective=0, steps=3, starts=3, seed=0),
    soe_cli=[["soe", *DEEPFLOW["soe"]],
             ["soe", *DEEPFLOW["soe"], "--steps", "3", "--starts", "2"]])
SERVE = dict(batch=8, prompt_len=128, gen=32, use_reduced=False)
CHECK_LEN = 2048        # phase 5's prefill-vs-decode consistency prompt
# ``profiled``: the archs whose prefill is also profiled on the card
# (xlstm-125m's, 94,975 launches of its sLSTM loop, is left out to keep
# the phases inside their time limit; PERF.md keeps its numbers)
RECURRENT = dict(archs=("recurrentgemma-2b", "xlstm-125m"), prefill=(2, 2048),
                 serve=dict(batch=8, prompt_len=128, gen=32),
                 check_len=2048, use_reduced=False,
                 profiled=("recurrentgemma-2b",))
# phase 7, training.  (a) each autograd Function (attention, scan, mLSTM)
# against autograd through its plain version: phase 2's unit cases and the
# shapes the training runs give it, both dtypes; forwards at phase 2's
# tolerances (the scan bit for bit), gradients within GRAD_TOLS of their
# max |value|; the launches per forward + backward.
GRAD_TOLS = {"float32": 1e-5, "bfloat16": 1e-2}
GRAD_LAUNCHES = {"flash_attention": 1, "rglru_scan": 2, "mlstm_parallel": 1}
GRAD_CASES = {
    "flash_attention": ATTN_UNIT + (
        ((4, 16, 16, 2048, 2048, 64), dict(causal=True)),      # qwen (b)
        ((2, 10, 1, 1024, 1024, 256), dict(causal=True,        # rg (c)
                                           window=RG_WINDOW))),
    "rglru_scan": RGLRU_UNIT + ((2, 1024, 2560),),
    "mlstm_parallel": MLSTM_UNIT + ((2, 4, 512, 192),),
}
# (b) ``launch.train.train`` of full-width qwen1.5-0.5b at (4, 2048), seed
# 0, lr 1e-3, warmup 5, a checkpoint after step ``resume_at`` (its state
# after resume_at + 1 updates), which a second ``train`` resumes for the
# last 2 steps: losses within RESUME_TOLS["loss"] (rtol) of the
# uninterrupted run's, parameters within 2 lr of them element by element
# (AdamW normalises each element's step, so noise in a gradient that
# should be zero, and the embedding gradient's atomic adds, can move an
# element by up to lr per step) and within RESUME_TOLS["mean"] of them on
# average (mean |difference| over mean |parameter|); then ``timed`` steps
# timed and one profiled.  (c) recurrentgemma-2b and xlstm-125m at full
# width: ``other_steps`` steps of ``train`` each, one more profiled for
# the archs in ``profiled`` (xlstm-125m's profile, ~94,000 launches whose
# events took the profiler 60-80 s, cut for phase 9's time).  (d) the
# reduced models held to tests/test_torch_golden_train.npz.
# (e) remat through the kernels' Functions: one step of each reduced arch
# below (attention, the scan, the mLSTM: every block kind with a kernel)
# in float32 with remat True and "dots", its loss within
# REMAT_TOLS["loss"] (rtol) and every gradient within REMAT_TOLS["grad"]
# of its max |value| of the same step without remat (the card's backward
# adds some gradients atomically, so not bit for bit), and its kernel
# launches `_train_launches(cfg, 1, remat)`: the recomputation launches
# each stacked group's forward kernels again.
REMAT = dict(archs=("qwen1.5-0.5b", "recurrentgemma-2b", "xlstm-125m"),
             batch=2, seq=64)
REMAT_TOLS = dict(loss=1e-6, grad=1e-5)
TRAIN = dict(arch="qwen1.5-0.5b", batch=4, seq=2048, steps=20, lr=1e-3,
             warmup=5, resume_at=17, timed=3,
             others=(("recurrentgemma-2b", 2, 1024), ("xlstm-125m", 2, 512)),
             other_steps=3, profiled=("recurrentgemma-2b",), use_reduced=False,
             grads=GRAD_CASES, remat=REMAT)
RESUME_TOLS = dict(loss=1e-5, mean=1e-5)
GOLDEN_TRAIN = ROOT / "tests" / "test_torch_golden_train.npz"
# what the golden file holds: the reduced archs in float32, numpy weights
# (`golden_weights`), the data pipeline's batches, AdamW
# (lr, warmup, total = steps): the loss of every step and the first step's
# per-leaf gradient norms, held at TRAIN_GOLDEN_TOLS (rtol).  The reduced
# xlstm-125m's training is chaotic (the mLSTM denominator): half an ulp on
# every weight moves the reference's own fifth loss by up to 2.3e-3
# (tests/test_torch_golden_train.py), so its losses after the first
# update are held to CHAOTIC_LOSS_TOL, its first loss and its gradient
# norms as the others'.
TRAIN_GOLDEN = dict(archs=("qwen1.5-0.5b", "recurrentgemma-2b", "xlstm-125m"),
                    batch=2, seq=32, steps=5, lr=1e-3, warmup=2)
TRAIN_GOLDEN_TOLS = dict(losses=1e-4, grad_norms=1e-3)
CHAOTIC_TRAIN = ("xlstm-125m",)
CHAOTIC_LOSS_TOL = 1e-2
# Archs whose bf16 stack is chaotic: an mLSTM output divides by a
# denominator that can come near zero, so one bf16 rounding in a layer's
# input moves the logits by tens of percent (the reference's own bf16
# logits of the reduced xlstm-125m lie 47 % of max |logit| from its f32
# ones: tests/test_torch_models.py).  There the stack's check runs in f32
# activations, and each mLSTM layer's kernel is held to its decode
# recurrence in bf16 on that layer's input.
CHAOTIC_BF16 = ("xlstm-125m",)
# phase 8 (a), the model families against the reference's own outputs
# (tests/test_torch_golden_families.npz, written on the host by
# tests/test_torch_golden_families.py): each case is a reduced arch,
# "+grouped_tp" its MoE dispatch grouped_tp over 2 groups; weights
# `golden_weights`, inputs the file's (``tokens`` (batch, prompt + steps +
# 1), ``frames`` (batch, frames, 128)), in float32 and bfloat16.  Each case
# holds: the logits of a forward over the prompt (decoder-only: into fresh
# caches, then ``steps`` decode steps; encoder-decoder: the forward of frames
# and prompt, the prefill's cross caches, then ``steps`` decode steps from
# them; the LSTM: the forward), the loss of the prompt (labels the next
# tokens) and the global norm of its gradient, and for MoE each router
# call's experts.  FAMILY_TOLS: logits and caches of max |value|, loss and
# gradient norm relative.  MoE routing: identical in float32; in bfloat16
# the router product is rounded to bfloat16, so a token whose k-th and
# (k+1)-th experts lie within NEAR_TIE (in logit units: 4 bfloat16 ulps of
# a logit in [2, 4)) may take either; there the case runs twice, once
# with the reference's experts forced (every value held at FAMILY_TOLS)
# and once with its own (every expert it takes that the reference did not
# within NEAR_TIE of the one it left, the margins printed; the forward's
# logits held at the tokens, in (batch, position) order, before the first
# that took other experts: causal attention and the experts' capacity
# carry a flip to later tokens).  Only the first router call where the
# runs part must be a near tie (`first_divergence`): from there a token
# that took other experts feeds later layers other inputs.
FAMILY_GOLDEN = dict(cases=("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
                            "qwen3-moe-30b-a3b+grouped_tp",
                            "whisper-large-v3", "paper-lm"),
                     batch=2, prompt=16, steps=6, frames=24, groups=2)
GOLDEN_FAMILIES = ROOT / "tests" / "test_torch_golden_families.npz"
FAMILY_TOLS = {"float32": dict(logits=1e-4, cache=1e-2, loss=1e-4,
                               grad=1e-3),
               "bfloat16": dict(logits=3e-2, cache=3e-2, loss=1e-2,
                                grad=3e-2)}
NEAR_TIE = 1 / 16
# phase 8 (b), (c): the families at full width, random f32 weights from
# seed 0.  qwen2-moe-a2.7b (56 GB of f32 weights; serve builds its own,
# so it runs first and frees them): serve, one prefill, the 2047 + 1
# against 2048 check at capacity ``check_capacity`` (nothing dropped),
# the first MoE layer against a dense computation.  whisper-large-v3: the
# prefill of ``frames`` frame embeddings, ``steps`` decode steps from it
# against a forward, serve (its prompt stepped against init_cache's zero
# cross cache, as the reference's serve does), and ``train_steps`` steps
# of ``launch.train.train`` at ``train`` (batch, frames) with decoder_len
# tokens, one more timed and one profiled.  Their profiled decode windows
# (last read: qwen2-moe idle 0.674-0.766 at ~3,570 launches a step,
# whisper 0.908-0.938; PERF.md) were cut for phase 4 (f)'s time; phases 5
# and 6 keep theirs.
FAMILIES = dict(
    moe=dict(arch="qwen2-moe-a2.7b", prefill=(2, 2048), check_len=2048,
             check_capacity=8.0),
    whisper=dict(arch="whisper-large-v3", frames=(2, 1500), steps=16,
                 train=(2, 1500), train_steps=3, lr=1e-4, warmup=1),
    serve=dict(batch=8, prompt_len=128, gen=32), use_reduced=False)


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
    sources = [Path(k["source"]).stem for k in KERNELS.values()]
    logs = build.build(sources)
    print(f"# built {', '.join(sources)} in {time.perf_counter() - t0:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")
    gemm_sass(build._target("gemm"))
    mlstm_sass(build._target("mlstm"), logs["mlstm"])
    rglru_sass(build._target("rglru_scan"), logs["rglru_scan"])


def _cuobjdump() -> str:
    """The toolkit's cuobjdump, or the copy in Triton's package."""
    import importlib.util
    cands = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        cands.append(str(Path(spec.origin).parent / "backends" / "nvidia"
                         / "bin" / "cuobjdump"))
    tool = next((c for c in cands if c and Path(c).is_file()), None)
    if tool is None:
        raise RuntimeError("cuobjdump not found (PATH, /usr/local/cuda/bin "
                           "or Triton's package): the GEMM's SASS is "
                           "checked on a machine with the CUDA toolkit")
    return tool


SASS_OPS = ("HMMA", "FFMA", "FMUL", "FADD", "LDGSTS")


def _sass_ops(lib: str, kernel: str) -> dict:
    """Per entry function of ``lib`` whose name holds ``kernel``, its
    tensor-core (HMMA, by shape and type), FFMA, FMUL, FADD and LDGSTS
    (``cp.async``) instruction counts from ``cuobjdump --dump-sass``."""
    sass = subprocess.run([_cuobjdump(), "--dump-sass", lib],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    funcs = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if kernel in name:
                funcs[name] = collections.Counter()
        elif name in funcs:
            for word in line.replace(";", " ").split():
                op = word.split(".")[0]
                if op in SASS_OPS:
                    funcs[name][word if op == "HMMA" else op] += 1
    return funcs


def gemm_sass(lib: str) -> None:
    """Every GEMM entry must multiply on the tensor cores, TF32 for f32
    inputs and BF16 for bf16 inputs, and none with FFMA."""
    funcs = _sass_ops(lib, "gemm_kernel")
    # 2 input x 2 output dtypes x 2 copy variants
    assert len(funcs) == 8, sorted(funcs)
    for name, ops in sorted(funcs.items()):
        print(f"  [gemm] SASS {name}: {dict(sorted(ops.items()))}")
        want = "TF32" if "gemm_kernelIf" in name else "BF16"
        assert any(op.startswith("HMMA") and want in op for op in ops), \
            (name, want)
        assert not ops["FFMA"], (name, ops["FFMA"])


def _resources(lib: str, log: str):
    """Per entry function of ``lib``: its resource fields (``cuobjdump
    --dump-resource-usage``: REG, SHARED, STACK, LOCAL, ...) and, where
    this run's ptxas log has them, its bytes of spill stores."""
    usage = subprocess.run([_cuobjdump(), "--dump-resource-usage", lib],
                           capture_output=True, text=True, check=True,
                           timeout=120).stdout
    res = {name: dict(re.findall(r"(\w+):(\d+)", fields)) for name, fields
           in re.findall(r"Function (\S+):\s*\n\s*(REG:.*)", usage)}
    spills = dict(re.findall(r"Function properties for (\S+)\s*\n\s*\d+ "
                             r"bytes stack frame, (\d+) bytes spill stores",
                             log))
    return res, spills, usage


def mlstm_sass(lib: str, log: str) -> None:
    """Per mLSTM entry function, its registers, stack frame and local
    memory (``cuobjdump --dump-resource-usage``), its spill stores where
    this run's ptxas log has them, and its HMMA count: every bf16 entry
    (``mlstm_mma_kernel``, one per head dim) must hold
    ``HMMA.16816.F32.BF16`` and spill nothing (no stack, no local
    memory, 0 bytes of spill stores)."""
    res, spills, usage = _resources(lib, log)
    ops = _sass_ops(lib, "mlstm")
    mma = [name for name in ops if "mlstm_mma_kernel" in name]
    assert len(ops) == 8 and len(mma) == 4, sorted(ops)
    for name in sorted(ops):
        fields = res.get(name, {})
        assert "REG" in fields, (name, usage[:2000])
        hmma = {op: n for op, n in ops[name].items() if op.startswith("HMMA")}
        print(f"  [mlstm] {name}: {fields['REG']} registers, stack "
              f"{fields['STACK']} B, local {fields['LOCAL']} B, spill "
              f"stores {spills.get(name, 'not in this log')}, {hmma}")
        if name in mma:
            assert ops[name]["HMMA.16816.F32.BF16"] > 0, (name, hmma)
            assert fields["STACK"] == fields["LOCAL"] == "0", (name, fields)
            assert spills.get(name, "0") == "0", (name, spills[name])


def rglru_sass(lib: str, log: str) -> None:
    """Per RG-LRU scan entry (the ring and the element-wise variant, f32
    and bf16), its registers, static shared memory (the ring's tiles are
    dynamic, sized at launch), stack, local memory and spills, and its
    LDGSTS / FMUL / FADD / FFMA counts: every ring entry
    must copy with LDGSTS (``cp.async``); no entry may hold an FFMA (the
    output is the plain version's bit for bit only because each step is
    a rounded product, then a rounded sum); none may spill."""
    res, spills, usage = _resources(lib, log)
    ops = _sass_ops(lib, "rglru")
    ring = [name for name in ops if "rglru_ring_kernel" in name]
    assert len(ops) == 4 and len(ring) == 2, sorted(ops)
    for name in sorted(ops):
        fields = res.get(name, {})
        assert "REG" in fields, (name, usage[:2000])
        print(f"  [rglru_scan] {name}: {fields['REG']} registers, static "
              f"shared {fields.get('SHARED', '?')} B, stack "
              f"{fields['STACK']} B, local {fields['LOCAL']} B, spill "
              f"stores {spills.get(name, 'not in this log')}, "
              f"{ {op: ops[name][op] for op in SASS_OPS[1:]} }")
        assert ops[name]["FMUL"] and ops[name]["FADD"], (name, ops[name])
        assert not ops[name]["FFMA"], (name, ops[name]["FFMA"])
        if name in ring:
            assert ops[name]["LDGSTS"], (name, ops[name])
        assert fields["STACK"] == fields["LOCAL"] == "0", (name, fields)
        assert spills.get(name, "0") == "0", (name, spills[name])


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


def _gemm_f64_err(got, x, w) -> float:
    """Max abs distance of ``got`` from the float64 product of x and w."""
    return (got.double() - x.double() @ w.double()).abs().max().item()


def _gemm_nonfinite(gemm_mod, device, dtype) -> None:
    """A and B with NaN and +-Inf made by CUDA ops (sqrt of -1, 1 / 0),
    also where an Inf meets a TF32 value, a zero or another Inf: the
    kernel's NaN and +-Inf must be plain's, at the same places."""
    import torch
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((33, 31), generator=gen, device=device)
    w = torch.randn((31, 65), generator=gen, device=device)
    nan = torch.sqrt(torch.full((), -1.0, device=device))
    inf = torch.reciprocal(torch.zeros((), device=device))
    x[1, 3], x[2, 5], x[3, 7], x[5, 10] = inf, -inf, nan, 0.0
    w[3, 0], w[3, 1], w[3, 2], w[3, 5] = 1.0, 0.0, -2.0, inf
    w[5, 4], w[10, 6], w[11, 8] = -inf, -inf, nan
    x, w = x.to(dtype), w.to(dtype)
    got = gemm_mod.gemm(x, w).float()
    want = gemm_mod.gemm_plain(x, w).float()
    odd = ~want.isfinite()
    assert torch.equal(~got.isfinite(), odd), "non-finite places differ"
    assert torch.equal(got[odd].nan_to_num(), want[odd].nan_to_num())
    print(f"  gemm {str(dtype)[6:]:8s} NaN / Inf inputs: "
          f"{int(want.isnan().sum())} NaN, {int(want.isinf().sum())} Inf "
          f"outputs, as plain gives them")


def phase_gemm(device, cmp_shapes, timed_shapes) -> dict:
    """GEMM kernel vs plain on the same inputs, in both input dtypes, both
    block shapes and the other output dtype, and on NaN and Inf; timings at ``timed_shapes``
    in both input dtypes.  The row's dtype is f32, the calibration path's:
    3xTF32, so its bound is three TF32 products at the TF32 peak.  At each
    timed f32 shape the kernel's error from the float64 product must be at
    most 4x that of ``torch.matmul`` (TF32 off)."""
    import torch
    from repro_torch.kernels import gemm as gemm_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    max_abs = {"float32": 0.0, "bfloat16": 0.0}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        other = torch.bfloat16 if dtype == torch.float32 else torch.float32
        for (m, n, k) in cmp_shapes:
            x = torch.randn((m, k), generator=gen, device=device).to(dtype)
            w = torch.randn((k, n), generator=gen, device=device).to(dtype)
            for block, out_dtype in ((None, dtype), ((64, 64, 64), dtype),
                                     (None, other)):
                want = gemm_mod.gemm_plain(x, w, out_dtype).float()
                got = gemm_mod.gemm(x, w, block_shape=block,
                                    out_dtype=out_dtype)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                assert got.dtype == out_dtype and got.shape == (m, n), \
                    (got.dtype, got.shape)
                err = (got.float() - want).abs().max().item()
                rel = err / max(want.abs().max().item(), 1e-30)
                oname = str(out_dtype).replace("torch.", "")
                print(f"  gemm {dname:8s} -> {oname:8s} ({m},{n},{k}) "
                      f"block={block}: max abs err {err:.3e}, rel {rel:.3e}")
                rtol, atol = TOLS[oname if oname == "bfloat16" else dname]
                torch.testing.assert_close(got.float(), want, rtol=rtol,
                                           atol=atol)
                if out_dtype == dtype:
                    max_abs[dname] = max(max_abs[dname], err)
        _gemm_nonfinite(gemm_mod, device, dtype)
    if device.type != "cuda":
        return {"max_abs_err": max_abs["float32"], "timing": None}
    sums = {}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        tot = sums[dname] = collections.Counter()
        for (m, n, k) in timed_shapes:
            x = torch.randn((m, k), generator=gen, device=device).to(dtype)
            w = torch.randn((k, n), generator=gen, device=device).to(dtype)
            ms = _graph_ms(lambda: gemm_mod.gemm(x, w), device)
            plain = _graph_ms(lambda: gemm_mod.gemm_plain(x, w), device)
            lib = _graph_ms(lambda: torch.matmul(x, w), device)
            flops = 2.0 * m * n * k
            nbytes = float((m * k + k * n + m * n) * x.element_size())
            # the tensor cores' bound: 3 TF32 products for f32 inputs
            ops, kind = ((3 * flops, "tf32") if dname == "float32"
                         else (flops, "bfloat16"))
            bound, by = _bound(ops, nbytes, kind)
            line = (f"  time gemm {dname:8s} ({m},{n},{k}): kernel {ms:.4f} "
                    f"ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
                    f"{plain:.4f} ms, torch.matmul {lib:.4f} ms, "
                    f"tensor-core bound {bound:.4f} ms ({by}"
                    f"{', 3xTF32' if dname == 'float32' else ''}), "
                    f"kernel/bound {ms / bound:.2f}x, kernel/matmul "
                    f"{ms / lib:.2f}x")
            if dname == "float32":
                ffma, _ = _bound(flops, nbytes, "float32")
                err = _gemm_f64_err(gemm_mod.gemm(x, w), x, w)
                lib_err = _gemm_f64_err(torch.matmul(x, w), x, w)
                line += (f", FFMA bound {ffma:.4f} ms; max abs err from "
                         f"the float64 product: kernel {err:.3e}, "
                         f"torch.matmul {lib_err:.3e}")
                assert err <= 4 * lib_err, (m, n, k, err, lib_err)
                tot["ffma"] += ffma
            print(line)
            for key, val in (("ms", ms), ("plain_ms", plain),
                             ("library_ms", lib), ("bound", bound),
                             ("flops", ops), ("bytes", nbytes)):
                tot[key] += val
        print(f"  time gemm {dname:8s} sum of {len(timed_shapes)} shapes: "
              f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
              f"torch.matmul {tot['library_ms']:.4f} ms, tensor-core bound "
              f"{tot['bound']:.4f} ms"
              + (f", FFMA bound {tot['ffma']:.4f} ms" if tot["ffma"] else ""))
    timing = {key: sums["float32"][key]
              for key in ("ms", "plain_ms", "library_ms", "flops", "bytes")}
    return {"max_abs_err": max_abs["float32"],
            "timing": dict(timing, dtype="tf32")}


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


def _sdpa_backends(q, k, v, causal: bool, gqa: bool) -> str:
    """Which of SDPA's fused backends take these inputs (each tried once
    under `sdpa_kernel`); where none does, SDPA runs its math backend,
    which writes the whole score matrix to memory."""
    import warnings
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    took = []
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        try:    # a refusal raises, after a warning that says why
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                               enable_gqa=gqa)
            took.append(backend.name.lower())
        except RuntimeError:
            pass
    return ", ".join(took) or "none (math)"


def phase_attention(device, cmp_cases, timed_cases, more_timed=()) -> dict:
    """Flash-attention kernel vs `attention_ref` on the same inputs;
    timings at ``timed_cases`` in bf16, the serving path's dtype, summed
    into the JSON row, and at ``more_timed``, printed only.  The library
    call is SDPA with ``enable_gqa`` where the head counts differ, so that
    its fused backends take the grouped shapes."""
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
    for i, (shape, kw) in enumerate(timed_cases + tuple(more_timed)):
        b, h, hkv, sq, skv, d = shape
        q, k, v = _attn_inputs(shape, torch.bfloat16, gen, device)
        kvl = kw.get("kv_len") or skv
        kc, vc = k[:, :, :kvl], v[:, :, :kvl]
        gqa = h != hkv
        ms = _graph_ms(lambda: fa.flash_attention(q, k, v, **kw), device)
        plain = _graph_ms(lambda: attention_ref(q, k, v, **kw), device)
        lib = _graph_ms(lambda: F.scaled_dot_product_attention(
            q, kc, vc, is_causal=kw["causal"], enable_gqa=gqa), device)
        backends = _sdpa_backends(q, kc, vc, kw["causal"], gqa)
        if gqa:     # the yardstick before enable_gqa, for comparison
            backends += ("; without enable_gqa %.4f ms" % _graph_ms(
                lambda: F.scaled_dot_product_attention(
                    q, kc, vc, is_causal=kw["causal"]), device))
        flops = 4.0 * b * h * d * _visible_pairs(sq, skv, **kw)
        nbytes = float(2 * (2 * b * h * sq * d + 2 * b * hkv * kvl * d))
        bound, by = _bound(flops, nbytes, "bfloat16")
        print(f"  time flash_attention bfloat16 {shape} {kw}: kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s, "
              f"{nbytes / ms / 1e6:.1f} GB/s), plain {plain:.4f} ms, "
              f"F.scaled_dot_product_attention {lib:.4f} ms (enable_gqa="
              f"{gqa}; fused backends that take it: {backends}), bound "
              f"{bound:.5f} ms ({by}), kernel/bound {ms / bound:.1f}x, "
              f"kernel/SDPA {ms / lib:.2f}x"
              + ("" if i < len(timed_cases) else " (not in the JSON row)"))
        if i >= len(timed_cases):
            continue
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("flops", flops), ("bytes", nbytes)):
            timing[key] += val
    return {"max_abs_err": max_abs["bfloat16"], "timing": timing}


def _timing() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "flops": 0.0,
            "bytes": 0.0}


def _rglru_inputs(shape, dtype, gen, device):
    import torch
    batch, seq, width = shape
    a = torch.sigmoid(torch.randn(shape, generator=gen, device=device))
    b = torch.randn(shape, generator=gen, device=device)
    h0 = torch.randn((batch, width), generator=gen, device=device)
    return a.to(dtype), b.to(dtype), h0


def phase_rglru(device, cmp_shapes, timed_shapes) -> dict:
    """RG-LRU scan kernel vs `rglru_scan_ref` on the same inputs (a nonzero
    h0); timings at ``timed_shapes`` in f32, the model path's dtype (the
    gates are computed in f32).  No one PyTorch call computes a linear
    recurrence, so the library time is None."""
    import torch
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels.ref import rglru_scan_ref
    gen = torch.Generator(device=device).manual_seed(2)
    max_abs = 0.0
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for shape in cmp_shapes:
            a, b, h0 = _rglru_inputs(shape, dtype, gen, device)
            want = rglru_scan_ref(a, b, h0)
            for block_t in RGLRU_BLOCKS:
                got = rg.rglru_scan(a, b, h0, block_t=block_t)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                assert got.dtype == torch.float32 and got.shape == a.shape, \
                    (got.dtype, got.shape)
                err = (got - want).abs().max().item()
                print(f"  rglru_scan {dname:8s} {shape} block_t={block_t}: "
                      f"{rg.LAST_VARIANT or 'plain'}, max abs err {err:.3e}")
                # bit for bit (the inputs are finite)
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)), (shape, err)
                max_abs = max(max_abs, err)
    if device.type != "cuda":
        return {"max_abs_err": max_abs, "timing": None}
    timing = dict(_timing(), dtype="float32")
    for shape in timed_shapes:
        a, b, h0 = _rglru_inputs(shape, torch.float32, gen, device)
        batch, seq, width = shape
        ms = _graph_ms(lambda: rg.rglru_scan(a, b, h0), device)
        variant = rg.LAST_VARIANT
        # the plain version is a loop of 3 launches per step: few replays
        plain = _graph_ms(lambda: rglru_scan_ref(a, b, h0), device,
                          iters=2, reps=2)
        flops = 2.0 * batch * seq * width
        nbytes = float(4 * (3 * batch * seq * width + batch * width))
        bound, by = _bound(flops, nbytes, "float32")
        print(f"  time rglru_scan float32 {shape}: {variant} kernel "
              f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), plain "
              f"{plain:.4f} ms, "
              f"library none (no one PyTorch call computes a linear "
              f"recurrence), bound {bound:.5f} ms ({by}), kernel/bound "
              f"{ms / bound:.1f}x")
        for key, val in (("ms", ms), ("plain_ms", plain), ("flops", flops),
                         ("bytes", nbytes)):
            timing[key] += val
    return {"max_abs_err": max_abs, "timing": timing}


def _mlstm_inputs(shape, dtype, gen, device):
    import torch
    import torch.nn.functional as F
    b, h, s, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
               for _ in range(3))
    log_f = F.logsigmoid(torch.randn((b, h, s), generator=gen,
                                     device=device) + 1.0)
    log_i = 0.3 * torch.randn((b, h, s), generator=gen, device=device)
    return q, k, v, torch.cumsum(log_f, -1), log_i


def phase_mlstm(device, cmp_shapes, timed_shapes) -> dict:
    """mLSTM kernel vs `mlstm_parallel_ref` on the same inputs; timings at
    ``timed_shapes`` in bf16, the model path's dtype (the tensor-core
    kernel), each beside its bound; the first is the JSON row's.  No one
    PyTorch call computes the stabilised decay-weighted form, so the
    library time is None (the plain version, a naive einsum / matmul form,
    is timed as plain)."""
    import torch
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels.ref import mlstm_parallel_ref
    gen = torch.Generator(device=device).manual_seed(3)
    max_abs = {"float32": 0.0, "bfloat16": 0.0}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        tol = MLSTM_TOLS[dname]
        for shape in cmp_shapes:
            ins = _mlstm_inputs(shape, dtype, gen, device)
            want = mlstm_parallel_ref(*ins).float()
            for bq, bkv in MLSTM_BLOCKS:
                got = ml.mlstm_parallel(*ins, block_q=bq, block_kv=bkv)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                assert got.dtype == dtype and got.shape == ins[0].shape, \
                    (got.dtype, got.shape)
                err = (got.float() - want).abs().max().item()
                rel = err / max(want.abs().max().item(), 1e-30)
                print(f"  mlstm_parallel {dname:8s} {shape} blocks=({bq},"
                      f"{bkv}): max abs err {err:.3e}, rel {rel:.3e}")
                torch.testing.assert_close(got.float(), want, rtol=tol,
                                           atol=tol)
                max_abs[dname] = max(max_abs[dname], err)
    if device.type != "cuda":
        return {"max_abs_err": max_abs["bfloat16"], "timing": None}
    timing = dict(_timing(), dtype="bfloat16")
    for i, shape in enumerate(timed_shapes):
        b, h, s, d = shape
        ins = _mlstm_inputs(shape, torch.bfloat16, gen, device)
        ms = _graph_ms(lambda: ml.mlstm_parallel(*ins), device)
        plain = _graph_ms(lambda: mlstm_parallel_ref(*ins), device,
                          iters=4, reps=2)
        flops = 4.0 * b * h * d * _visible_pairs(s, s)
        nbytes = float(2 * 4 * b * h * s * d + 4 * 2 * b * h * s)
        bound, by = _bound(flops, nbytes, "bfloat16")
        print(f"  time mlstm_parallel bfloat16 {shape}: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms, "
              f"library none (no one PyTorch call computes it), bound "
              f"{bound:.5f} ms ({by}), kernel/bound {ms / bound:.1f}x"
              + ("  [the JSON row]" if i == 0 else ""))
        if i == 0:
            timing.update(ms=ms, plain_ms=plain, flops=flops, bytes=nbytes)
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


def _held(got, want, what: str) -> None:
    """``got`` within SEARCH_RTOL of ``want``, value by value."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    bad = np.abs(got - want) > SEARCH_RTOL * np.abs(want)
    assert not bad.any(), (f"{what}: {int(bad.sum())} values off, first "
                           f"{got[bad][:4]} vs {want[bad][:4]}")


def phase_search(device, search: dict) -> None:
    """Phase 4's search layer: (a) plan, (b) sweep, (c) a matrix call, each
    on the card and on the host (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch import pathfind
    from repro_torch.configs.base import ARCH_IDS, SHAPE_CELLS, get_config
    from repro_torch.core import age, lmgraph, pathfinder, planner, techlib
    from repro_torch.core.placement import mesh_system
    from repro_torch.core.roofline import PPEConfig
    devices = (device, torch.device("cpu"))
    card = card_line() if device.type == "cuda" else "host rehearsal"

    print("-- (a) pathfind plan qwen1.5-0.5b x train_4k at 16x16")
    assert pathfind.main(["plan", "--arch", "qwen1.5-0.5b", "--cell",
                          "train_4k", "--mesh", "16x16", "--device",
                          str(device)]) == 0
    plans = [planner.plan(get_config("qwen1.5-0.5b"),
                          SHAPE_CELLS["train_4k"], (16, 16),
                          ("data", "model"), device=dev) for dev in devices]
    assert plans[0].strategy == plans[1].strategy
    _held(*([p.predicted_step_s, *p.predicted_breakdown.values()]
            for p in plans), "plan")

    # every config module: the registered archs and the paper's LSTM
    arches = search["arches"] or tuple(
        get_config(a).name for a in (*ARCH_IDS, "paper-lm"))
    grid = dict(arches=arches, cells=("train_4k",),
                mesh_shapes=search["meshes"],
                logic_nodes=search["logic"] or techlib.LOGIC_NODES,
                hbms=search["hbm"] or techlib.HBM_GENERATIONS,
                nets=search["net"] or techlib.NETWORK_GENERATIONS)
    print(f"-- (b) sweep: {len(grid['arches'])} archs x train_4k x "
          f"{len(grid['mesh_shapes'])} meshes x {len(grid['logic_nodes'])} "
          f"logic x {len(grid['hbms'])} HBM x {len(grid['nets'])} nets")
    sweeps = []
    for dev in devices:
        t0 = time.perf_counter()
        res = pathfinder.sweep(**grid, cache=None, device=dev)
        dt = time.perf_counter() - t0
        sweeps.append(res)
        print(f"  sweep on {dev.type}: {len(res.points)} points in "
              f"{dt:.3f}s = {len(res.points) / dt:.1f} points/s  [{card}]")
    metrics = ("time_s", "compute_s", "comm_s", "exposed_comm_s")
    labels, rows = [], []
    for res in sweeps:
        labels.append(["|".join((p.arch, p.cell, "x".join(map(str, p.mesh)),
                                 p.logic, p.hbm, p.net, p.strategy.name))
                       for p in res.points])
        rows.append([[getattr(p, m) for m in metrics] for p in res.points])
    assert labels[0] == labels[1]
    _held(rows[0], rows[1], "sweep, card against host")
    best = [res.points.index(res.best()) for res in sweeps]
    assert labels[0][best[0]] == labels[1][best[1]]
    print(f"  best: {labels[0][best[0]]} -> "
          f"{sweeps[0].points[best[0]].time_s * 1e3:.2f} ms")
    with np.load(GOLDEN_SWEEP) as golden:
        assert list(golden["metrics"]) == list(metrics)
        where = {label: i for i, label in enumerate(labels[0])}
        idx = [where[label] for label in golden["labels"]]
        _held(np.asarray(rows[0])[idx], golden["rows"],
              "sweep, card against the reference's golden rows")
        print(f"  {len(idx)} rows held to {GOLDEN_SWEEP.name}")

    n = search["matrix_rows"]
    print(f"-- (c) one matrix call of {n} rows: qwen1.5-0.5b x train_4k x "
          f"16x16")
    cfg, cell = get_config("qwen1.5-0.5b"), SHAPE_CELLS["train_4k"]
    graph = lmgraph.build_graph(cfg, cell)
    strategy = planner.candidate_strategies(cfg, cell, (16, 16))[0]
    system = mesh_system((16, 16))
    ppe = PPEConfig(n_tilings=8)
    hw = {dev.type: [age.generate(techlib.make_tech_config(*t),
                                  age.Budgets.default(), device=dev)
                     for t in itertools.product(grid["logic_nodes"],
                                                grid["hbms"], grid["nets"])]
          for dev in devices}
    base = pathfinder.pack_hw_many(hw["cpu"])
    matrix = base[np.arange(n) % len(base)].copy()
    matrix[:, :13] *= (0.8 + 0.4 * torch.rand(
        (n, 13), generator=torch.Generator().manual_seed(0))).numpy()
    out = {}
    for dev in devices:
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            out[dev.type] = pathfinder.evaluate(
                template=hw[dev.type][0], matrix=matrix, graph=graph,
                strategy=strategy, system=system, ppe=ppe, cache=None)
            times.append(time.perf_counter() - t0)
        print(f"  matrix on {dev.type}: {n} rows in {times[0]:.4f}s, then "
              f"{times[1]:.4f}s = {n / min(times):.1f} points/s  [{card}]")
    _held(out[device.type], out["cpu"], "matrix, card against host")
    print(f"  all {n} rows held to the host's")
    if device.type == "cuda":       # one group of (b)'s size, then (c)
        for rows in (len(base), n):
            _device_profile(lambda: pathfinder.evaluate(
                template=hw[device.type][0], matrix=matrix[:rows],
                graph=graph, strategy=strategy, system=system, ppe=ppe,
                cache=None), 1, f"matrix call of {rows} rows")

    k = search["eager_rows"]
    for dev in devices:
        ev = pathfinder.BatchedEvaluator(graph, strategy, system=system,
                                         ppe=ppe, cache=None, device=dev)
        t0 = time.perf_counter()
        eager = [ev.evaluate([a], min_batch_jit=2) for a in hw[dev.type][:k]]
        dt = time.perf_counter() - t0
        print(f"  eager rows on {dev.type}: {k} in {dt:.3f}s = "
              f"{k / dt:.2f} points/s  [{card}]")
        assert np.isfinite(np.concatenate(eager)).all()


def runner_argv(scenario: str, runner: dict = RUNNER) -> list:
    """``pathfind sweep`` arguments of one scenario of phase 4 (d)."""
    return ["sweep", "--scenario", scenario,
            *(x for a in runner["arches"] for x in ("--arch", a)),
            *runner["axes"], *runner["scenarios"][scenario]]


_SWEEP_LINE = re.compile(r"# sweep\[[^\]]+\](?: frontier-only)? backend=\w+: "
                         r"(\d+) points in (\d+) chunks; skipped (\d+) "
                         r"checkpointed, evaluated (\d+) \((\d+) points\)")


def _cli(argv, ok=(0,)):
    """``pathfind.main(argv)`` with its output captured: (exit code,
    stdout, stderr, seconds); an exit code not in ``ok`` fails the phase.
    Each call starts as a new process would: from an empty prediction
    cache (the serving and serving-traffic scenarios score the same
    points), compiled store, design registry and hardware-row caches, so
    that each sweep's rate and compile seconds are its own."""
    import contextlib
    import io
    from repro_torch import pathfind
    from repro_torch.core import pathfinder, sweeppipeline, sweeprunner
    pathfinder.clear_prediction_cache()
    pathfinder.clear_compiled_caches()
    sweeprunner._HW_CACHE.clear()
    with sweeppipeline._ROW_LOCK:
        sweeppipeline._ROW_CACHE.clear()
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = pathfind.main([str(a) for a in argv])
    dt = time.perf_counter() - t0
    assert rc in ok, (f"pathfind {' '.join(map(str, argv))} exited {rc}: "
                      f"{err.getvalue()[-2000:]}")
    return rc, out.getvalue(), err.getvalue(), dt


def _sweep_counts(err: str) -> tuple:
    """(points, chunks, skipped, evaluated chunks, evaluated points) from
    a ``# sweep[...]`` line."""
    m = _SWEEP_LINE.search(err)
    assert m, err
    return tuple(int(x) for x in m.groups())


def _jsonl(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def _held_records(got: list, want: list, what: str,
                  rtol: float = SEARCH_RTOL) -> int:
    """``got`` records equal to ``want`` key by key: labels, flags and the
    non-finite (None) pattern exactly, numbers within ``rtol``
    (SEARCH_RTOL); the numbers of a nested dict (a refined record's knobs
    and budget fractions) within that plus 1e-5, the unit of the budgets'
    5-decimal rounding.  Returns the numbers compared."""
    def held(g, v, key, atol=0.0):
        if isinstance(v, dict):
            assert isinstance(g, dict) and list(g) == list(v), (what, key)
            return sum(held(g[k], x, (*key, k), 1e-5) for k, x in v.items())
        if isinstance(v, float):
            assert isinstance(g, float) and \
                abs(g - v) <= rtol * abs(v) + atol, (what, key, g, v)
            return 1
        assert g == v, (what, key, g, v)
        return 0

    assert [r["key"] for r in got] == [r["key"] for r in want], what
    n = 0
    for g, w in zip(got, want):
        assert list(g) == list(w), (what, w["key"], list(g), list(w))
        n += sum(held(g[k], v, (w["key"], k)) for k, v in w.items())
    return n


def _printed_close(got: str, want: str) -> bool:
    """Text equal apart from numbers within SEARCH_RTOL plus one unit in
    the last printed digit; True when the text is identical."""
    num = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]\d+)?")
    assert num.split(got) == num.split(want), (got, want)
    for a, b in zip(num.findall(got), num.findall(want)):
        mant, _, exp = b.partition("e")
        unit = 10.0 ** (int(exp or 0) - len(mant.partition(".")[2]))
        assert abs(float(a) - float(b)) <= \
            SEARCH_RTOL * abs(float(b)) + unit, (a, b)
    return got == want


def phase_runner(device, runner: dict, workdir: Path,
                 profile_path: str) -> dict:
    """Phase 4 (d): ``pathfind sweep --out DIR [--resume]`` and ``pathfind
    size --from DIR`` on the card and on the host (see the module
    docstring); returns the points/s of every sweep, per place."""
    import torch
    from repro_torch.core import pathfinder, sweeprunner
    card = card_line() if device.type == "cuda" else "host rehearsal"
    where = {"card": str(device), "host": "cpu"}
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    print("-- (d) the chunked runner: pathfind sweep --out DIR [--resume], "
          "pathfind size --from DIR")

    # 1. serving-traffic on the phase-3 profile: uninterrupted on the host,
    #    on the card stopped after half its chunks and resumed
    argv = runner_argv("serving-traffic", runner) + ["--profile",
                                                     profile_path]
    dirs = {k: workdir / f"traffic-{k}" for k in where}
    _, _, err, dt = _cli(argv + ["--out", dirs["host"], "--device", "cpu"])
    n_points, n_chunks = _sweep_counts(err)[:2]
    half = n_chunks // 2
    print(f"  serving-traffic, calibrated, on the host: {n_points} points "
          f"in {n_chunks} chunks, {dt:.3f}s = {n_points / dt:.1f} points/s")
    _, _, err1, dt1 = _cli(argv + ["--out", dirs["card"], "--device",
                                where["card"], "--max-chunks", half])
    ckpt = dirs["card"] / "checkpoint.jsonl"
    first = ckpt.read_text()
    assert _sweep_counts(err1)[2:4] == (0, half) and "# incomplete" in err1
    _, _, err2, dt2 = _cli(["sweep", "--out", dirs["card"], "--resume",
                         "--device", where["card"]])
    counts = _sweep_counts(err2)
    assert counts[2:4] == (half, n_chunks - half), counts
    lines = ckpt.read_text().splitlines()
    assert ckpt.read_text().startswith(first)
    assert sorted(json.loads(x)["chunk"] for x in lines) == \
        list(range(n_chunks)), "a chunk evaluated twice or never"
    print(f"  serving-traffic, calibrated, on {device.type}: {half} chunks, "
          f"then --resume: skipped {half}, evaluated {n_chunks - half} "
          f"(zero re-evaluated); {dt1 + dt2:.3f}s = "
          f"{n_points / (dt1 + dt2):.1f} points/s  [{card}]")
    for name in ("spec.json", "checkpoint.jsonl"):
        assert (dirs["card"] / name).read_bytes() == \
            (dirs["host"] / name).read_bytes(), name
    n = _held_records(_jsonl(dirs["card"] / "results.jsonl"),
                      _jsonl(dirs["host"] / "results.jsonl"),
                      "resumed card sweep against the host's")
    print(f"  spec fingerprint and {n_chunks} chunk hashes identical; "
          f"{n} numbers of {n_points} records held to the host's")
    if device.type == "cuda":       # one chunk of the card's sweep
        spec, _ = sweeprunner.load_sweep(str(dirs["card"]))
        chunk = sweeprunner.make_chunks(sweeprunner.enumerate_labels(spec),
                                        spec.chunk_size)[0]
        pathfinder.evaluate(spec=spec, labels=chunk.labels, cache=None,
                            device=device)
        _device_profile(lambda: pathfinder.evaluate(
            spec=spec, labels=chunk.labels, cache=None, device=device), 1,
            f"runner chunk of {len(chunk.labels)} designs")

    # 2. every scenario, uncalibrated: card against host, and the records
    #    of the golden archs against the reference's own
    golden = {}
    rates = {k: {} for k in where}      # points/s per place and run
    for rec in _jsonl(GOLDEN_RUNNER):
        golden.setdefault(rec.pop("scenario"), []).append(rec)
    for scenario in runner["scenarios"]:
        recs = {}
        for k, dev in where.items():
            d = workdir / f"{scenario}-{k}"
            _, _, err, dt = _cli(runner_argv(scenario, runner) + [
                "--out", d, "--device", dev])
            n_points = _sweep_counts(err)[0]
            rates[k][scenario] = n_points / dt
            print(f"  {scenario} on {torch.device(dev).type}: {n_points} "
                  f"points in {dt:.3f}s = {n_points / dt:.1f} points/s"
                  + (f"  [{card}]" if k == "card" else ""))
            recs[k] = [{f: v for f, v in r.items() if f != "chunk"}
                       for r in _jsonl(d / "results.jsonl")]
        _held_records(recs["card"], recs["host"],
                      f"{scenario}: card against host")
        want = golden[scenario]
        by_key = {r["key"]: r for r in recs["card"]}
        _held_records([by_key[r["key"]] for r in want], want,
                      f"{scenario}: card against the reference's golden")
        print(f"  {scenario}: {len(recs['card'])} records held to the "
              f"host's, {len(want)} to {GOLDEN_RUNNER.name}")

    # 3. the other backends and the streaming frontier against (2)'s
    #    pipeline directories
    phase_backends(device, runner, workdir, rates)

    # 4. fleet sizing over the card-written directory and the host's
    # (exit 1: no design meets the walls); the same exit code and plan
    outs = {k: _cli(["size", "--from", dirs[k], *runner["size"]],
                    ok=(0, 1))[:2] for k in where}
    rc, text = outs["card"]
    assert rc == outs["host"][0], (rc, outs["host"][0])
    exact = _printed_close(text, outs["host"][1])
    print(f"  pathfind size --from DIR {' '.join(runner['size'])}: exit "
          f"{rc}, {max(len(text.splitlines()) - 1, 0)} fleet plans; the "
          f"card's directory prints the host's text"
          + ("" if exact else " within the last printed digit"))
    return rates


def _by_chunk(path: Path) -> list:
    """A results.jsonl's records in chunk order without their chunk tags
    (the thread and process backends commit chunks as they complete)."""
    recs = _jsonl(path)
    order = sorted(range(len(recs)), key=lambda i: (recs[i]["chunk"], i))
    return [{k: v for k, v in recs[i].items() if k != "chunk"}
            for i in order]


def phase_backends(device, runner: dict, workdir: Path,
                   rates: dict) -> None:
    """Phase 4 (d), the executors: (i) every scenario on ``--backend
    serial`` on card and host, its ``spec.json`` and ``checkpoint.jsonl``
    the pipeline's bytes and its records the pipeline's, with the points/s
    of both backends; (ii) a serial run stopped half way, resumed on the
    pipeline; (iii) ``--frontier-only`` of every scenario against the
    pipeline directory's ``pareto_records``, and one stopped and resumed
    from ``frontier_state.npz``; (iv) the thread and process pools on the
    train scenario over the golden archs (phase 4 (f) profiles one
    superbatch, bucketed and not).  ``rates`` holds (2)'s pipeline points/s
    per place and scenario; this phase adds the rest."""
    import torch
    from repro_torch.core import sweeprunner
    card = card_line() if device.type == "cuda" else "host rehearsal"
    where = {"card": str(device), "host": "cpu"}
    print("-- (d) the executors: --backend serial|thread|process, "
          "--frontier-only")
    t0 = time.perf_counter()

    def sweep(scenario, out, dev, *flags):
        _, _, err, dt = _cli(runner_argv(scenario, runner) + [
            "--out", out, "--device", dev, *flags])
        return _sweep_counts(err), dt

    # (i) serial against the pipeline, every scenario, card and host
    for scenario in runner["scenarios"]:
        for k, dev in where.items():
            pipe = workdir / f"{scenario}-{k}"
            d = workdir / f"{scenario}-{k}-serial"
            counts, dt = sweep(scenario, d, dev, "--backend", "serial")
            rates[k][f"{scenario} serial"] = counts[0] / dt
            for name in ("spec.json", "checkpoint.jsonl"):
                assert (d / name).read_bytes() == \
                    (pipe / name).read_bytes(), (scenario, k, name)
            _held_records(_by_chunk(d / "results.jsonl"),
                          _by_chunk(pipe / "results.jsonl"),
                          f"{scenario} on {k}: serial against pipeline")
            print(f"  {scenario} --backend serial on "
                  f"{torch.device(dev).type}: {counts[0]} points in "
                  f"{dt:.3f}s = {counts[0] / dt:.1f} points/s; spec.json "
                  f"and checkpoint.jsonl the pipeline's bytes, records "
                  f"held to its own" + (f"  [{card}]" if k == "card" else ""))
    pipe = workdir / "train-card"

    # (ii) serial stopped half way, resumed on the pipeline
    d = workdir / "train-serial-resumed"
    n_chunks = len((pipe / "checkpoint.jsonl").read_text().splitlines())
    half = n_chunks // 2
    counts, _ = sweep("train", d, where["card"], "--backend", "serial",
                      "--max-chunks", half)
    assert counts[2:4] == (0, half), counts
    _, _, err, dt2 = _cli(["sweep", "--out", d, "--resume", "--device",
                           where["card"]])
    counts = _sweep_counts(err)
    assert "backend=pipeline" in err and \
        counts[2:4] == (half, n_chunks - half), (counts, err)
    for name in ("spec.json", "checkpoint.jsonl"):
        assert (d / name).read_bytes() == (pipe / name).read_bytes(), name
    _held_records(_by_chunk(d / "results.jsonl"),
                  _by_chunk(pipe / "results.jsonl"),
                  "train: serial then pipeline against pipeline")
    print(f"  train: --backend serial for {half} chunks, then --resume on "
          f"the pipeline: skipped {half}, evaluated {n_chunks - half} (zero "
          f"re-evaluated), directory the pipeline's  [{card}]")

    # (iii) the streaming frontier: each scenario against pareto_records
    # over (2)'s card directory, one stopped and resumed
    for scenario in runner["scenarios"]:
        d = workdir / f"{scenario}-frontier"
        counts, dt = sweep(scenario, d, where["card"], "--frontier-only")
        spec, recs = sweeprunner.load_sweep(str(workdir /
                                                f"{scenario}-card"))
        objectives = spec.scenario_spec.variants()[0].resolve().objectives
        want = sweeprunner.pareto_records(recs, objectives)
        got = _jsonl(d / "frontier.jsonl")
        assert want and sorted(r["key"] for r in got) == \
            sorted(r["key"] for r in want), scenario
        by_key = {r["key"]: r for r in got}
        _held_records([by_key[r["key"]] for r in want], want,
                      f"{scenario}: frontier against pareto_records")
        rates["card"][f"{scenario} frontier-only"] = counts[0] / dt
        print(f"  {scenario} --frontier-only on {device.type}: {counts[0]} "
              f"points in {dt:.3f}s = {counts[0] / dt:.1f} points/s; "
              f"{len(got)} frontier records, the full sweep's "
              f"pareto_records over {'/'.join(objectives)}  [{card}]")
    d = workdir / "traffic-frontier-resumed"
    full = workdir / "serving-traffic-frontier"
    counts, _ = sweep("serving-traffic", d, where["card"], "--frontier-only",
                      "--max-chunks", half)
    assert (d / "frontier_state.npz").is_file() and counts[3] == half
    _, _, err, _ = _cli(["sweep", "--out", d, "--resume", "--frontier-only",
                         "--device", where["card"]])
    counts = _sweep_counts(err)
    assert counts[2] == half and counts[2] + counts[3] == counts[1], counts
    assert _jsonl(d / "frontier.jsonl") == _jsonl(full / "frontier.jsonl")
    print(f"  serving-traffic --frontier-only stopped after {half} chunks, "
          f"resumed from frontier_state.npz: skipped {half}, evaluated "
          f"{counts[3]}, the uninterrupted frontier  [{card}]")

    # (iv) the pools on the train scenario over the golden archs (their
    # start-up, not the sweep, is what they add), each record the
    # pipeline's of the same key
    pools = dict(runner, arches=runner["golden_arches"])
    by_key = {r["key"]: r for r in _by_chunk(pipe / "results.jsonl")}
    for backend, workers in (("thread", 2), ("process", 2)):
        d = workdir / f"train-{backend}"
        _, _, err, dt = _cli(runner_argv("train", pools) + [
            "--out", d, "--device", where["card"], "--backend", backend,
            "--workers", workers])
        counts = _sweep_counts(err)
        assert counts[3] == counts[1] and f"backend={backend}:" in err
        rates["card"][f"train {backend}"] = counts[0] / dt
        got = _by_chunk(d / "results.jsonl")
        assert sorted(json.loads(x)["chunk"] for x in (
            d / "checkpoint.jsonl").read_text().splitlines()) == \
            list(range(counts[1]))
        _held_records(got, [by_key[r["key"]] for r in got],
                      f"train: {backend} against pipeline")
        print(f"  train (golden archs) --backend {backend} --workers "
              f"{workers} on {device.type}: {counts[0]} points in "
              f"{dt:.3f}s = {counts[0] / dt:.1f} points/s; every chunk "
              f"once, the pipeline's records  [{card}]")

    print(f"# phase 4 (d), the executors: {time.perf_counter() - t0:.2f}s")
    for k in where:
        print(f"  points/s on {k}: " + ", ".join(
            f"{name} {rate:.1f}" for name, rate in rates[k].items())
            + (f"  [{card}]" if k == "card" else ""))


def _compile_line(err: str) -> str:
    """The ``# compile: ...`` summary line of a sweep's standard error."""
    m = re.search(r"# compile: ([\d.]+)s tracing designs into their "
                  r"buckets, ([\d.]+)s stalling", err)
    assert m, err
    return f"compile {m.group(1)} s, stall {m.group(2)} s"


def _launch_profile(fn, what: str) -> dict:
    """``fn()`` once under torch.profiler: prints and returns its device
    launches, host-to-device copies, device-busy ms and idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if "CUDA" in str(getattr(e, "device_type", ""))]
    busy = sum(e.self_device_time_total for e in dev) * 1e-6
    out = dict(launches=sum(e.count for e in dev),
               h2d=sum(e.count for e in dev if "HtoD" in e.key),
               busy_ms=busy * 1e3, wall_ms=wall * 1e3,
               idle=1 - busy / wall if busy else None)
    print(f"  profiled {what}: wall {out['wall_ms']:.3f} ms (profiler on), "
          f"device busy {out['busy_ms']:.3f} ms, idle share "
          + (f"{out['idle']:.3f}" if busy else "not measured")
          + f", {out['launches']} launches, {out['h2d']} host-to-device "
          f"copies")
    return out


def _skeleton_rows(device, n: int):
    """(c)'s skeleton (qwen1.5-0.5b x train_4k x 16x16, its first
    strategy) as an evaluator on ``device``, the template, and ``n``
    seeded rows around it."""
    import numpy as np
    import torch
    from repro_torch.configs.base import SHAPE_CELLS, get_config
    from repro_torch.core import age, lmgraph, pathfinder, planner, techlib
    from repro_torch.core.placement import mesh_system
    from repro_torch.core.roofline import PPEConfig
    cfg, cell = get_config("qwen1.5-0.5b"), SHAPE_CELLS["train_4k"]
    ev = pathfinder.BatchedEvaluator(
        lmgraph.build_graph(cfg, cell),
        planner.candidate_strategies(cfg, cell, (16, 16))[0],
        system=mesh_system((16, 16)), ppe=PPEConfig(n_tilings=8),
        cache=None, device=device)
    template = age.generate(techlib.make_tech_config("N7", "HBM2E"),
                            age.Budgets.default(), device=device)
    base = pathfinder.pack_hw(template)
    rows = base[None, :] * (0.8 + 0.4 * torch.rand(
        (n, base.shape[0]), generator=torch.Generator().manual_seed(1))
        .numpy())
    return ev, template, rows.astype(np.float32)


def phase_bucketed(device, runner: dict, workdir: Path,
                   rates: dict) -> None:
    """Phase 4 (f): the bucketed search on ``device`` (see the module
    docstring), over (d)'s directories in ``workdir``; ``rates`` are (d)'s
    unbucketed points/s, per place."""
    from repro_torch.core import compileahead, sweeppipeline, sweeprunner
    card = card_line() if device.type == "cuda" else "host rehearsal"
    dev = str(device)
    t0 = time.perf_counter()
    print("-- (f) the bucketed search: serial and pipeline with "
          "--bucketing from empty caches, the backends bit for bit, "
          "compile-ahead, --backend device, devices")
    golden = {}
    for rec in _jsonl(GOLDEN_RUNNER):
        golden.setdefault(rec.pop("scenario"), []).append(rec)

    # (i) every scenario with --bucketing on the serial backend and on the
    # pipeline, each from empty caches (as a new process): the serial
    # records against (d)'s unbucketed serial ones and the golden ones,
    # the pipeline's against the serial's bit for bit; the rates beside
    # (d)'s unbucketed ones, also from empty caches
    for scenario in runner["scenarios"]:
        got, parts = {}, []
        for backend, base in (("serial", f"{scenario} serial"),
                              ("pipeline", scenario)):
            d = workdir / f"{scenario}-card-bucketed-{backend}"
            _, _, err, dt = _cli(runner_argv(scenario, runner) + [
                "--out", d, "--device", dev, "--backend", backend,
                "--bucketing"])
            got[backend] = _by_chunk(d / "results.jsonl")
            stats = compileahead.bucket_stats()
            parts.append(
                f"{backend} {len(got[backend]) / dt:.1f} points/s in "
                f"{dt:.3f}s ({_compile_line(err)}, "
                f"{stats['designs_traced']} designs traced into "
                f"{stats['buckets']} buckets; unbucketed "
                f"{rates['card'][base]:.1f} points/s)")
        off = _by_chunk(workdir / f"{scenario}-card-serial"
                        / "results.jsonl")
        n = _held_records(got["serial"], off, f"{scenario}: bucketed "
                          f"against not", rtol=BUCKET_RTOL)
        by_key = {r["key"]: r for r in got["serial"]}
        _held_records([by_key[r["key"]] for r in golden[scenario]],
                      golden[scenario], f"{scenario}: bucketed against the "
                      f"reference's golden")
        assert got["pipeline"] == got["serial"], \
            f"{scenario}: bucketed pipeline and serial differ in bits"
        print(f"  {scenario} --bucketing on {device.type}, from empty "
              f"caches: {'; '.join(parts)}; {n} numbers of the serial "
              f"records within {BUCKET_RTOL:g} of the unbucketed serial's, "
              f"{len(golden[scenario])} golden records within "
              f"{SEARCH_RTOL:g}; the bucketed pipeline's records are the "
              f"bucketed serial's bit for bit  [{card}]")
    t1 = time.perf_counter()
    print(f"  # (i) {t1 - t0:.2f}s")

    # (ii) one vmapped call of (c)'s skeleton over 84 rows (one design's
    # techlib points), and one superbatch of two chunks, each bucketed and
    # not, profiled
    ev, template, rows = _skeleton_rows(device, 84)
    for bucketing in (True, False):
        fn = ev._compiled(template, bucketed=bucketing)
        ev._rows(fn, rows)
        if device.type == "cuda":
            _launch_profile(lambda: ev._rows(fn, rows), "vmapped call of "
                            "84 rows of (c)'s skeleton, " + (
                                "bucketed" if bucketing else "unbucketed"))
    spec, _ = sweeprunner.load_sweep(str(workdir / "train-card"))
    chunks = sweeprunner.make_chunks(sweeprunner.enumerate_labels(spec),
                                     spec.chunk_size)
    for bucketing in (True, False):
        ex = sweeppipeline.PipelineExecutor(
            spec, cache=None, superbatch=2 * spec.chunk_size,
            bucketing=bucketing, device=device)
        pack = ex.pack(ex._pack_slices(chunks)[0])

        def superbatch():
            ex.dispatch(pack)
            return ex.finalize(pack)
        superbatch()
        n = sum(len(c.labels) for c in pack.chunks)
        what = f"pipeline superbatch of {n} designs, " + (
            f"{len(ex._bucket_plan(pack))} buckets" if bucketing
            else f"{len(pack.groups)} groups, unbucketed")
        if device.type == "cuda":
            _launch_profile(superbatch, what)
        else:
            superbatch()
            print(f"  {what} on the host (no profile)")

    t2 = time.perf_counter()
    print(f"  # (ii) {t2 - t1:.2f}s")

    # (iii) the execution flags through the CLI, on the train scenario of
    # the golden archs: with --bucketing against (i)'s bucketed pipeline
    # records of the same keys, bit for bit, the others against (d)'s
    # unbucketed pipeline records
    flagged = dict(runner, arches=runner["golden_arches"])
    pipes = {bucketed: {r["key"]: r for r in _by_chunk(workdir / (
        "train-card-bucketed-pipeline" if bucketed else "train-card")
        / "results.jsonl")} for bucketed in (True, False)}
    for flags in (("--bucketing", "--compile-ahead", "2",
                   "--no-compile-cache"), ("--no-bucketing",),
                  ("--backend", "device")):
        bucketed = "--bucketing" in flags
        d = workdir / ("train-flags" + "".join(flags).replace("--", "-"))
        _, _, err, dt = _cli(runner_argv("train", flagged) + [
            "--out", d, "--device", dev, *flags])
        counts = _sweep_counts(err)
        got = _by_chunk(d / "results.jsonl")
        want = [pipes[bucketed][r["key"]] for r in got]
        assert counts[3] == counts[1] and len(got) == counts[0]
        if bucketed:
            assert got == want, f"{' '.join(flags)}: not the pipeline's bits"
        else:
            _held_records(got, want, " ".join(flags), rtol=BUCKET_RTOL)
        print(f"  train (golden archs) {' '.join(flags)} on {device.type}: "
              f"{counts[0]} points in {dt:.3f}s ({_compile_line(err)}); the "
              + ("bucketed pipeline's records bit for bit" if bucketed else
                 "pipeline's records " + ("bit for bit" if got == want else
                                          f"within {BUCKET_RTOL:g}"))
              + f"  [{card}]")

    t3 = time.perf_counter()
    print(f"  # (iii) {t3 - t2:.2f}s")

    # (iv) the rows split over devices
    phase_devices(device)
    print(f"# phase 4 (f): {time.perf_counter() - t0:.2f}s")


def phase_devices(device) -> None:
    """Phase 4 (f) (iv): a matrix call of (c)'s skeleton over every card
    (the host: every host shard) against one device's rows; where the
    host has two cards or more, a 2-card split of it and the pipeline's
    megabatches split over every card (bucketed and not, the train
    scenario of phase 4 (d)'s golden archs, every dispatch large enough
    to split), each against one card.  Runs alone too (``python3 -c
    'import chip_smoke as c, torch; c._port();
    c.phase_devices(torch.device("cuda", 0))'``)."""
    import numpy as np
    import torch
    from repro_torch.core import pathfinder, sweeppipeline, sweeprunner
    card = card_line() if device.type == "cuda" else "host rehearsal"
    ev, template, rows = _skeleton_rows(device, SPLIT_ROWS)
    one = ev.evaluate_matrix(template, rows, devices=1)
    n_dev = pathfinder.local_device_count(device)
    t0 = time.perf_counter()
    every = ev.evaluate_matrix(template, rows, devices=n_dev, block=8)
    dt = time.perf_counter() - t0
    _held(every, one, "matrix over every device against one device")
    print(f"  evaluate_matrix(devices={n_dev}, block=8) of {SPLIT_ROWS} "
          f"rows on {device.type}: {dt:.4f}s, the one-device rows  [{card}]")
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if n_cards < 2:
        print(f"  the host has {n_cards} card(s): the 2-device split was "
              f"not run")
        return

    def split_held(got, what):
        bad = np.abs(got - one) > SPLIT_RTOL * np.abs(one)
        assert not bad.any(), f"{what}: {int(bad.sum())} values off"
        return "bit for bit" if np.array_equal(got, one) else \
            f"within {SPLIT_RTOL:g}"

    for n in sorted({2, n_cards}):
        t0 = time.perf_counter()
        got = ev.evaluate_matrix(template, rows, devices=n, block=8)
        dt = time.perf_counter() - t0
        print(f"  {n}-card split of {SPLIT_ROWS} rows in {dt:.4f}s: "
              f"{split_held(got, f'{n}-card split')} the one-card rows  "
              f"[{card}]")
    spec = sweeprunner.SweepSpec(
        arches=("qwen1.5-0.5b", "recurrentgemma-2b"),
        mesh_shapes=((8, 8), (16, 16)), logic_nodes=("N7", "N5"),
        hbms=("HBM2E", "HBM3"), chunk_size=8)
    chunks = sweeprunner.make_chunks(sweeprunner.enumerate_labels(spec),
                                     spec.chunk_size)
    for bucketing in (True, False):
        recs = {}
        for n in (1, n_cards):
            ex = sweeppipeline.PipelineExecutor(
                spec, cache=None, devices=n, bucketing=bucketing,
                shard_min_rows=1, device=device)
            out = []
            ex.run(chunks, lambda c, r: out.extend(r))
            recs[n] = out
        exact = recs[n_cards] == recs[1]
        if not exact:
            _held_records(recs[n_cards], recs[1],
                          f"pipeline over {n_cards} cards", rtol=SPLIT_RTOL)
        print(f"  the pipeline's {'bucketed' if bucketing else 'unbucketed'}"
              f" dispatches split over {n_cards} cards: "
              f"{len(recs[1])} records, "
              + ("bit for bit" if exact else f"within {SPLIT_RTOL:g}")
              + f" the one-card records  [{card}]")


class _Spy:
    """Records every call of ``module.name`` (its arguments and result)
    while in a ``with`` block; the function itself still runs."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.calls = []

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def spy(*args, **kwargs):
            out = real(*args, **kwargs)
            self.calls.append((args, kwargs, out))
            return out
        setattr(self.module, self.name, spy)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def soe_objective(case: dict):
    """The port's `soe.make_objective` of one golden case."""
    from repro_torch.configs.base import SHAPE_CELLS, get_config
    from repro_torch.core import lmgraph, soe, techlib
    from repro_torch.core.age import Budgets
    from repro_torch.core.parallelism import Strategy
    from repro_torch.core.roofline import PPEConfig
    kind, *args = case["graph"]
    graph = lmgraph.gemm_graph(*args) if kind == "gemm" else \
        lmgraph.build_graph(get_config(args[0]), SHAPE_CELLS[args[1]])
    return soe.make_objective(techlib.make_tech_config(*case["tech"]), graph,
                              Strategy.parse(case["strategy"]),
                              template=Budgets.default(),
                              ppe=PPEConfig(n_tilings=case["n_tilings"]))


def refine_objective(case: dict, device):
    """The port's `cooptimize.make_refine_objective` of one golden case:
    the first design of the case's sweep spec, on ``device``."""
    from repro_torch.core import cooptimize, sweeprunner, techlib
    spec = sweeprunner.SweepSpec.from_dict(case["spec"])
    lb = sweeprunner.enumerate_labels(spec)[0]
    return cooptimize.make_refine_objective(
        techlib.make_tech_config(lb.logic, lb.hbm, lb.net),
        spec.budgets(lb.scale), sweeprunner.scenario_for(spec, lb.cell),
        sweeprunner.resolve_label(spec, lb, device),
        sweeprunner.spec_ppe(spec), case["norms"],
        cooptimize.RefineConfig(), profile=spec.profile)


def soe_golden_port(golden: dict, device) -> dict:
    """The port's numbers at every point of the golden file, on
    ``device``: each objective's values and gradients (one vmapped
    ``grad_and_value`` over the points) and the batched descent's iterates
    and values."""
    import torch
    from repro_torch.core import soe
    out = {}
    for kind in ("objective", "refine"):
        out[kind] = []
        for entry in golden[kind]:
            f = soe_objective(entry["case"]) if kind == "objective" \
                else refine_objective(entry["case"], device)
            x = torch.tensor(entry["points"], dtype=torch.float32,
                             device=device)
            g, v = torch.func.vmap(torch.func.grad_and_value(f))(x)
            out[kind].append({"values": v.double().cpu().tolist(),
                              "grads": g.double().cpu().tolist()})
    d = golden["descent"]
    steps = []
    res = soe.optimize(
        soe_objective(golden["objective"][d["objective"]]["case"]),
        soe.SOEConfig(steps=d["steps"], starts=d["starts"], seed=d["seed"]),
        on_step=lambda t, W: steps.append(W.tolist()), device=device)
    out["descent"] = {"W": steps, "history": res.history,
                      "n_queries": res.n_queries}
    return out


def hold_to_soe_golden(got: dict, golden: dict, tols: dict) -> int:
    """``got`` (`soe_golden_port`) against the golden file: values within
    ``tols["value"]`` relative, each gradient within ``tols["grad"]`` of
    its norm, the descent's values within ``tols["value"]`` and iterates
    within ``tols["w"]``, its query count exact.  Returns the numbers
    compared."""
    import numpy as np
    n = 0
    for kind in ("objective", "refine"):
        assert len(got[kind]) == len(golden[kind]), kind
        for i, (g, w) in enumerate(zip(got[kind], golden[kind])):
            gv, wv = np.asarray(g["values"]), np.asarray(w["values"])
            assert np.isfinite(gv).all() and np.allclose(
                gv, wv, rtol=tols["value"], atol=0), (kind, i, gv, wv)
            for gg, wg in zip(np.asarray(g["grads"]),
                              np.asarray(w["grads"])):
                err = np.linalg.norm(gg - wg) / np.linalg.norm(wg)
                assert err <= tols["grad"], (kind, i, err)
            n += gv.size + np.asarray(w["grads"]).size
    g, w = got["descent"], golden["descent"]
    assert g["n_queries"] == w["n_queries"], (g["n_queries"], w["n_queries"])
    assert np.allclose(g["history"], w["history"], rtol=tols["value"],
                       atol=0), (g["history"], w["history"])
    assert np.allclose(g["W"], w["W"], rtol=0, atol=tols["w"]), "iterates"
    return n + len(w["history"]) + np.asarray(w["W"]).size


def _soe_fields(text: str) -> dict:
    lines = dict(line.split(None, 1) for line in text.splitlines()
                 if line.startswith(("strategy", "time", "queries")))
    return {"strategy": lines["strategy"].strip(),
            "time_ms": float(lines["time"].split()[0]),
            "queries": int(lines["queries"])}


def phase_deepflow(device, deepflow: dict, runner_dir: Path) -> None:
    """Phase 4 (e): ``pathfind soe``, the golden objectives and ``pathfind
    cooptimize --from DIR`` on the card and on the host (see the module
    docstring)."""
    import functools
    import torch
    from repro_torch.core import cooptimize, scenarios, soe, sweeprunner
    card = card_line() if device.type == "cuda" else "host rehearsal"
    where = {"card": str(device), "host": "cpu"}
    golden = json.loads(GOLDEN_SOE.read_text())
    t_start = time.perf_counter()
    print("-- (e) DeepFlow: pathfind soe, the reference's objectives, "
          "pathfind cooptimize --from DIR")

    # (i) pathfind soe: the batched path on both, the same strategy and
    # queries, and the reference's printed lines where the golden file
    # holds them for these flags
    argv = ["soe", *deepflow["soe"]]
    runs = {}
    for k, dev in where.items():
        with _Spy(soe, "optimize") as calls, \
                _Spy(soe, "_optimize_sequential") as fd:
            _, out, _, dt = _cli(argv + ["--device", dev])
        assert not fd, "pathfind soe fell back to the FD loop"
        steps = 0
        for _, kw, res in calls:
            # the batched path: one query per start and step, one history
            # entry each (FD costs 17 queries per history entry)
            assert res.n_queries == len(res.history) > 0, res.n_queries
            steps += res.n_queries // kw["cfg"].starts
        runs[k] = dict(_soe_fields(out), out=out, dt=dt, steps=steps)
        print(f"  pathfind soe on {torch.device(dev).type}: "
              f"{runs[k]['strategy']} {runs[k]['time_ms']} ms/iter, "
              f"{runs[k]['queries']} queries; {len(calls)} descents, "
              f"{steps} eq.-6 steps in {dt:.3f}s = {steps / dt:.2f} "
              f"steps/s" + (f"  [{card}]" if k == "card" else ""))
    c, h = runs["card"], runs["host"]
    assert c["strategy"] == h["strategy"] and c["queries"] == h["queries"]
    assert abs(c["time_ms"] - h["time_ms"]) <= TIME_RTOL * h["time_ms"], \
        (c["time_ms"], h["time_ms"])
    for entry in golden["soe_cli"]:
        if entry["argv"] == argv:
            exact = _printed_close(c["out"], entry["stdout"])
            print(f"  the card's pathfind soe prints the reference's lines"
                  + ("" if exact else " within the last printed digit"))

    # (ii) the reference's objectives, gradients and descent
    t0 = time.perf_counter()
    n = hold_to_soe_golden(soe_golden_port(golden, device), golden,
                           SOE_TOLS)
    print(f"  {n} numbers held to {GOLDEN_SOE.name} (values {SOE_TOLS}) "
          f"in {time.perf_counter() - t0:.3f}s")

    # (iii) pathfind cooptimize --from phase 4 (d)'s card-written dirs
    for name in deepflow["dirs"]:
        src = runner_dir / f"{name}-card"
        spec, _ = sweeprunner.load_sweep(str(src))
        scn = spec.scenario_spec.variants()[0].resolve()
        base = set(sweeprunner.LABEL_FIELDS) | set(scn.fields) | {"key"}
        got = {}
        for k, dev in where.items():
            out_path = runner_dir / f"{name}-refined-{k}.jsonl"
            with _Spy(cooptimize, "refine_sweep") as calls:
                _, _, err, dt = _cli(["cooptimize", "--from", src,
                                      *deepflow["cooptimize"], "--out",
                                      out_path, "--device", dev])
            stats = calls[0][2]
            starts = int(deepflow["cooptimize"][
                deepflow["cooptimize"].index("--starts") + 1])
            steps = stats.n_objective_evals // starts
            recs = _jsonl(out_path)
            assert [r["key"] for r in recs] == \
                [r["key"] for r in stats.records]
            for r in recs:
                assert base <= set(r) and r["refined"] is True, r["key"]
                assert set(r["knobs"]) == set(cooptimize.KNOBS), r["key"]
            got[k] = (stats, recs)
            print(f"  cooptimize --from {name} ({stats.scenario}"
                  f"{', profile' if spec.profile else ''}) on "
                  f"{torch.device(dev).type}: {stats.n_candidates} "
                  f"candidates, {stats.n_refined} refined, "
                  f"{stats.n_unimproved} unimproved, {stats.n_dominating} "
                  f"dominating; {steps} eq.-6 steps in {dt:.3f}s = "
                  f"{steps / dt:.2f} steps/s"
                  + (f"  [{card}]" if k == "card" else ""))
        (cs, crecs), (hs, hrecs) = got["card"], got["host"]
        for f in ("n_candidates", "n_refined", "n_unimproved",
                  "n_dominating", "n_objective_evals"):
            assert getattr(cs, f) == getattr(hs, f), \
                (name, f, getattr(cs, f), getattr(hs, f))
        n = _held_records(crecs, hrecs, f"cooptimize --from {name}")
        print(f"  {name}: {len(crecs)} refined records held to the "
              f"host's ({n} numbers)")

    # (iv) one profiled step of each engine (4 starts: the vmapped value
    # and gradient, then the eq.-6 update of the budget block), card only
    if device.type == "cuda":
        from repro_torch.core.age import Budgets
        refine = golden["refine"][-1]
        cases = (
            ("pathfind soe", soe_objective(golden["objective"][1]["case"]),
             torch.stack(soe._initial_starts(soe.SOEConfig(starts=4),
                                             Budgets.default(), device))),
            (f"cooptimize ({refine['case']['spec']['scenario']}, composed "
             f"objectives)", refine_objective(refine["case"], device),
             torch.tensor(refine["points"] * 2, dtype=torch.float32,
                          device=device)))
        proj = functools.partial(soe._project_simplexes, min_frac=1e-3)
        for what, f, W in cases:
            vg = torch.func.vmap(torch.func.grad_and_value(f))

            def step():
                G, _ = vg(W)
                soe.eq6_update(W[:, :17], W[:, :17], G[:, :17], 0.05, 0.7,
                               proj)
            step()
            _device_profile(step, 1, f"eq.-6 step of {what}, "
                            f"{W.shape[0]} starts")
    print(f"# phase 4 (e): {time.perf_counter() - t_start:.2f}s")


def _consistency(model, params, device, check_len: int) -> None:
    """Forward ``check_len - 1`` tokens into a cache, step the last one, and
    hold its logits to the last position of a ``check_len``-token forward
    (bf16 tolerance, 3e-2 of max |logit|)."""
    import numpy as np
    import torch
    cfg = model.cfg
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


def _moe_consistency(model, params, device, check_len: int) -> list:
    """`_consistency` for an MoE arch, with the routing rule of
    FAMILY_GOLDEN: the step's own experts for the last token may part
    from the ``check_len``-token forward's only at a near tie (the first
    layer where they part within NEAR_TIE; margins printed, the router
    products of 2 and of 4096 rows round differently in bf16); where they
    differ, the step is taken again with the
    forward's experts (it rewrites its cache slot with the same token)
    and that step is held to the forward at the bf16 tolerance.  Returns
    the two forwards' router calls (probabilities, experts) and the decode
    steps taken (1 or 2)."""
    import numpy as np
    import torch
    cfg = model.cfg
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                            (2, check_len))
    ids = torch.as_tensor(ids, dtype=torch.int32, device=device)
    with torch.no_grad():
        caches = model.init_cache(2, check_len)
        with moe_routing() as pre:
            model.forward(params, {"tokens": ids[:, :-1]}, caches=caches)
        with moe_routing() as whole:
            full = model.forward(params, {"tokens": ids})[0][:, -1]
        want = [i.reshape(2, check_len, -1)[:, -1] for _, i in whole.calls]
        with moe_routing() as own:
            step, _ = model.decode_step(params, caches, ids[:, -1:],
                                        check_len - 1)
        flips = routing_flips(own.calls, want)
        print(f"  the step's own routing: {len(flips)} of "
              f"{2 * len(want)} router rows (layer by layer) take other "
              f"experts than the {check_len}-token forward's last token; "
              f"margins (ln P) {[(c, round(m, 5)) for c, _, m in flips]} "
              f"(layer, margin), the first layer's at most NEAR_TIE "
              f"{NEAR_TIE:.4f}")
        assert all(m <= NEAR_TIE for _, _, m in first_divergence(flips)), \
            flips
        if flips:
            with moe_routing(want):
                step, _ = model.decode_step(params, caches, ids[:, -1:],
                                            check_len - 1)
    step, full = step[:, 0, :cfg.vocab_size], full[:, :cfg.vocab_size]
    err = (step - full).abs().max().item()
    scale = full.abs().max().item()
    print(f"  prefill {check_len - 1} + 1 decode step"
          + (" (the forward's experts)" if flips else "")
          + f" vs a {check_len}-token forward: max abs logit diff "
          f"{err:.4e} of max |logit| {scale:.4e} ({err / scale:.2e})")
    assert math.isfinite(err) and bool(torch.isfinite(full).all())
    assert err <= ATTN_TOLS["bfloat16"] * scale, (err, scale)
    return pre.calls + whole.calls, 1 + bool(flips)


def _mlstm_layers_check(model, params, device, check_len: int) -> int:
    """Each mLSTM layer on its own input from a ``check_len``-token forward:
    the parallel form (the kernel) at the last position against the
    prefill state of the first ``check_len - 1`` positions stepped once by
    the decode recurrence, at the bf16 tolerance (3e-2 of max |output|).
    Returns the mLSTM layers checked."""
    import numpy as np
    import torch
    from repro_torch.models import common, transformer, xlstm
    cfg = model.cfg
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                            (2, check_len))
    ids = torch.as_tensor(ids, dtype=torch.int32, device=device)
    worst, n = 0.0, 0
    with torch.no_grad():
        x = transformer._embed(params, cfg, ids)
        for bp, _, kind, akind in transformer._layers(params, None, cfg):
            if kind == "mlstm":
                h = common.norm(cfg.norm_kind, x, bp["ln1"])
                full = xlstm.mlstm_apply(bp["mlstm"], h, cfg)[:, -1]
                state = xlstm.mlstm_prefill_state(bp["mlstm"], h[:, :-1],
                                                  cfg)
                step = xlstm.mlstm_decode(bp["mlstm"], h[:, -1:], state,
                                          cfg)[0][:, 0]
                err = (step.float() - full.float()).abs().max().item()
                scale = full.float().abs().max().item()
                assert math.isfinite(err) and \
                    err <= ATTN_TOLS["bfloat16"] * scale, (n, err, scale)
                worst = max(worst, err / scale)
                n += 1
            x = transformer.block_apply(bp, x, cfg, kind, akind)[0]
    print(f"  {n} mLSTM layers, kernel at position {check_len - 1} vs the "
          f"prefill state + 1 decode step, bf16: worst max abs diff "
          f"{worst:.2e} of max |output|")
    return n


def _serve(arch: str, device, serve_kw: dict):
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve as serve_mod
    t0 = time.perf_counter()
    out = serve_mod.serve(arch, device=device, **serve_kw)
    wall = time.perf_counter() - t0
    toks = out["tokens"]
    assert toks.shape == (serve_kw["batch"], serve_kw["gen"]), toks.shape
    assert toks.min() >= 0 and toks.max() < get_config(arch).vocab_size
    print(f"  plan {out['plan']}: prefill_s {out['prefill_s']:.4f} "
          f"(stepping {serve_kw['prompt_len']} prompt tokens), decode_s "
          f"{out['decode_s']:.4f}, tok_per_s {out['tok_per_s']:.1f}; "
          f"serve() {wall:.2f}s in all (the planner and the weights' "
          f"init included)")
    print(f"  first tokens: {toks[0, :8].tolist()} {toks[-1, :8].tolist()}")


def phase_serve(device, serve_kw: dict, check_len: int) -> int:
    """Serve qwen1.5-0.5b through the port's ``launch.serve``, then check
    prefill (a forward into the cache) against decode (one step).  Returns
    the flash-attention launches this phase must have made."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import build_model
    cfg = get_config("qwen1.5-0.5b")
    if serve_kw["use_reduced"]:
        cfg = reduced(cfg)
    print(f"== phase 5: serve {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}x{cfg.resolved_head_dim} heads, "
          f"vocab {cfg.padded_vocab}) {serve_kw}")
    _serve("qwen1.5-0.5b", device, serve_kw)
    model = build_model(cfg, device)
    params = model.init(1)
    _consistency(model, params, device, check_len)
    prof_steps = _profile_decode(model, params, serve_kw, device)
    steps = serve_kw["prompt_len"] + serve_kw["gen"]
    # serve, then forward + step + forward, then the profiled steps
    return cfg.n_layers * (steps + 3 + prof_steps)


def phase_recurrent(device, rec: dict) -> dict:
    """recurrentgemma-2b and xlstm-125m (``rec["archs"]``) through
    ``Model.prefill`` (timed), ``serve``, the prefill/decode consistency
    check and a profiled decode window.  Returns the launches per kernel
    this phase must have made."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import build_model
    expected = collections.Counter()
    serve_kw = dict(rec["serve"], use_reduced=rec["use_reduced"])
    batch, plen = rec["prefill"]
    for arch in rec["archs"]:
        cfg = get_config(arch)
        if rec["use_reduced"]:
            cfg = reduced(cfg)
        kinds = collections.Counter(cfg.block_kind(i)
                                    for i in range(cfg.n_layers))
        print(f"== phase 6: {cfg.name} ({cfg.n_layers} layers: "
              f"{dict(kinds)}, d_model {cfg.d_model}, {cfg.n_heads}x"
              f"{cfg.resolved_head_dim} heads, vocab {cfg.padded_vocab})")
        t0 = time.perf_counter()
        model = build_model(cfg, device)
        params = model.init(0)
        ids = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (batch, plen)), dtype=torch.int32,
            device=device)
        times = []
        with torch.no_grad():
            for _ in range(2):              # the first call warms up
                t1 = time.perf_counter()
                caches = model.prefill(params, {"tokens": ids})
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                times.append(time.perf_counter() - t1)
            profiled = device.type == "cuda" and arch in rec["profiled"]
            if profiled:                    # a third, profiled
                prof = _device_profile(
                    lambda: model.prefill(params, {"tokens": ids}), 1,
                    f"Model.prefill ({batch}, {plen})")
                for kind, what in (("rglru", "RG-LRU scan kernels"),
                                   ("mlstm", "mLSTM kernels")):
                    if prof and kinds[kind]:
                        busy, by_name, _ = prof
                        ms = sum(t for key, t in by_name.items()
                                 if kind in key) / 1e3
                        print(f"  {what}: {ms:.4f} ms of the profiled "
                              f"prefill's {busy / 1e3:.3f} ms device busy "
                              f"({ms * 1e3 / busy * 100:.2f} %)")
        leaves = [t for c in caches.values() for b in c.values()
                  for t in b.values()]
        assert all(bool(torch.isfinite(t).all()) for t in leaves)
        print(f"  Model.prefill ({batch}, {plen}): {times[1] * 1e3:.2f} ms "
              f"(first call {times[0] * 1e3:.2f} ms), {len(leaves)} cache "
              f"tensors, all finite")
        # the prefills (one profiled on the card), the check's forwards
        forwards = (3 if profiled else 2) + 2
        layer_checks = 0
        if arch in CHAOTIC_BF16 and cfg.dtype == "bfloat16":
            # a pass through the stack, plus a parallel form per layer
            forwards += 1
            layer_checks = _mlstm_layers_check(model, params, device,
                                               rec["check_len"])
            print("  the stack's check in f32 activations (bf16 is chaotic "
                  "here):")
            _consistency(build_model(dataclasses.replace(cfg, dtype="float32"),
                                     device), params, device,
                         rec["check_len"])
        else:
            _consistency(model, params, device, rec["check_len"])
        prof_steps = _profile_decode(model, params, serve_kw, device)
        del params, caches
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(f"  serve {serve_kw}")
        _serve(arch, device, serve_kw)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(f"# phase 6 {cfg.name}: {time.perf_counter() - t0:.2f}s")
        # decode steps: serve's, the check's one and the profiled ones
        steps = (serve_kw["prompt_len"] + serve_kw["gen"] + 1 + prof_steps)
        expected["rglru_scan"] += forwards * kinds["rglru"]
        expected["mlstm_parallel"] += forwards * kinds["mlstm"] + layer_checks
        expected["flash_attention"] += (forwards + steps) * kinds["attn"]
    return expected


def function_grads(name: str, args, kwargs=None, seed: int = 0):
    """A kernel wrapper's forward and gradients (every input) against
    autograd through its plain version on the same inputs and the same
    upstream gradient: the forward at phase 2's tolerance (the scan bit
    for bit), each gradient within GRAD_TOLS of its max |value|, each in
    its input's dtype.  Returns (the wrapper's kernel launches over its
    forward and backward, the worst gradient error as a share of its max
    |value|)."""
    import torch
    from repro_torch.kernels import flash_attention, mlstm, ref, rglru
    mod, fn, plain, ftols = {
        "flash_attention": (flash_attention, flash_attention.flash_attention,
                            ref.attention_ref, ATTN_TOLS),
        "rglru_scan": (rglru, rglru.rglru_scan, ref.rglru_scan_ref, None),
        "mlstm_parallel": (mlstm, mlstm.mlstm_parallel,
                           ref.mlstm_parallel_ref, MLSTM_TOLS)}[name]
    kwargs = kwargs or {}
    ins = [a.detach().clone().requires_grad_(True) for a in args]
    ref_ins = [a.detach().clone().requires_grad_(True) for a in args]
    before = mod.LAUNCHES
    out = fn(*ins, **kwargs)
    want = plain(*ref_ins, **kwargs)
    gen = torch.Generator(device=want.device).manual_seed(seed)
    up = torch.randn(want.shape, generator=gen, device=want.device)
    got_g = torch.autograd.grad((out.float() * up).sum(), ins)
    want_g = torch.autograd.grad((want.float() * up).sum(), ref_ins)
    if want.device.type == "cuda":
        torch.cuda.synchronize(want.device)
    launches = mod.LAUNCHES - before
    dname = str(args[0].dtype).split(".")[-1]
    if ftols is None:
        assert torch.equal(out, want), name
    else:
        torch.testing.assert_close(out.float(), want.float(),
                                   rtol=ftols[dname], atol=ftols[dname])
    worst = 0.0
    for g, w, a in zip(got_g, want_g, args):
        assert g.dtype == a.dtype and g.shape == a.shape, (name, g.dtype)
        assert bool(torch.isfinite(g.float()).all()), name
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        tol = GRAD_TOLS[str(a.dtype).split(".")[-1]]
        assert err <= tol * scale, (name, tuple(a.shape), err, scale)
        worst = max(worst, err / max(scale, 1e-30))
    return launches, worst


def phase_grads(device, cases: dict) -> None:
    """Phase 7 (a): every case of every Function, in both dtypes."""
    import torch
    print("== phase 7 (a): the kernels' autograd Functions against "
          "autograd through their plain versions")
    gen = torch.Generator(device=device).manual_seed(7)
    inputs = {"flash_attention": lambda c, dt: (
        _attn_inputs(c[0], dt, gen, device), c[1]),
        "rglru_scan": lambda c, dt: (_rglru_inputs(c, dt, gen, device), {}),
        "mlstm_parallel": lambda c, dt: (_mlstm_inputs(c, dt, gen, device),
                                         {})}
    for name, name_cases in cases.items():
        for dname in ("float32", "bfloat16"):
            worst, n = 0.0, 0
            want = GRAD_LAUNCHES[name] if device.type == "cuda" else 0
            for i, case in enumerate(name_cases):
                args, kw = inputs[name](case, getattr(torch, dname))
                launches, err = function_grads(name, args, kw, seed=i)
                assert launches == want, (name, case, launches, want)
                worst, n = max(worst, err), n + 1
            print(f"  {name} {dname}: {n} cases, gradients within "
                  f"{worst:.2e} of max |grad| (tolerance "
                  f"{GRAD_TOLS[dname]:g}), {want} kernel launches per "
                  f"forward + backward")


def _train_launches(cfg, steps: int, remat=False) -> collections.Counter:
    """Kernel launches of ``steps`` forward + backward passes: one per
    attention and mLSTM layer, two per scan layer (the reversed scan);
    remat re-launches the forward kernels of the stacked groups."""
    kinds = collections.Counter(cfg.block_kind(i)
                                for i in range(cfg.n_layers))
    per = collections.Counter({"flash_attention": kinds["attn"],
                               "rglru_scan": 2 * kinds["rglru"],
                               "mlstm_parallel": kinds["mlstm"]})
    if remat:
        from repro_torch.models.transformer import group_layout
        pat, n_groups, _ = group_layout(cfg)
        grouped = collections.Counter(bk for bk, _ in pat * n_groups)
        per.update({"flash_attention": grouped["attn"],
                    "rglru_scan": grouped["rglru"],
                    "mlstm_parallel": grouped["mlstm"]})
    return collections.Counter({k: v * steps for k, v in per.items()})


def _batch(cfg, batch: int, seq: int, step: int, device, seed: int = 0):
    from repro_torch.data import DataConfig, synth_batch
    return {k: v.to(device) for k, v in synth_batch(
        DataConfig(global_batch=batch, seq_len=seq, seed=seed), cfg,
        step).items()}


def _profile_train_step(step_fn, out, cfg, batch: int, seq: int, device,
                        at: int) -> None:
    """One train step after the run, profiled: busy, idle, launches, the
    three kernels' device time (the scan's holds its reversed launches)
    and each Function's backward range (the plain recompute, or the
    reversed scan), as shares of the busy time."""
    st = out["state"]
    b = _batch(cfg, batch, seq, at, device)
    prof = _device_profile(lambda: step_fn(st.params, st.opt_state,
                                           st.err_state, b), 1,
                           f"train step of {cfg.name} ({batch}, {seq})")
    if not prof:
        return
    busy, by_name, spans = prof
    for kname, keys in (("flash_attention", ("attn_kernel",
                                             "attn_mma_kernel")),
                        ("rglru_scan", ("rglru_kernel",
                                        "rglru_ring_kernel")),
                        ("mlstm_parallel", ("mlstm_kernel",
                                            "mlstm_mma_kernel"))):
        fwd = sum(t for key, t in by_name.items()
                  if any(k in key for k in keys))
        bwd, ranges = spans.get(f"repro_torch::{kname}_backward",
                                (None, 0))
        if not fwd and bwd is None:
            continue
        bwd_text = ("not measured (no range recorded)" if bwd is None else
                    f"{bwd / 1e3:.4f} ms over {ranges} ranges "
                    f"({bwd / busy * 100:.2f} %)")
        what = ("forward and reversed backward launches"
                if kname == "rglru_scan" else "forward launches")
        print(f"  {kname}: kernels ({what}) {fwd / 1e3:.4f} ms "
              f"({fwd / busy * 100:.2f} %), backward range {bwd_text} of "
              f"{busy / 1e3:.3f} ms busy")


def phase_train(device, train: dict, workdir: Path,
                record: dict = None) -> collections.Counter:
    """Phase 7 (b) and (c): ``launch.train.train`` at full width, the
    checkpoint round trip, timed and profiled steps.  Returns the kernel
    launches these runs must have made; ``record`` gets (b)'s losses and
    median step ms (phase 9 holds the mesh path to them)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build_model
    from repro_torch import optim
    from repro_torch.tree import tree_leaves
    cuda = device.type == "cuda"
    expected = collections.Counter()

    def cfg_of(arch):
        cfg = get_config(arch)
        return reduced(cfg) if train["use_reduced"] else cfg

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    t_b = time.perf_counter()
    cfg = cfg_of(train["arch"])
    b, s, steps = train["batch"], train["seq"], train["steps"]
    print(f"== phase 7 (b): train {cfg.name} ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.param_count() / 1e9:.3f} B "
          f"parameters) at "
          f"({b}, {s}), {steps} steps, lr {train['lr']}, warmup "
          f"{train['warmup']}, seed 0")
    ckpt = workdir / "uninterrupted"
    resumed = workdir / "resumed"
    shutil.rmtree(workdir, ignore_errors=True)
    tc = train_mod.TrainConfig(
        arch=train["arch"], steps=steps, global_batch=b, seq_len=s,
        lr=train["lr"], warmup=train["warmup"], ckpt_dir=str(ckpt),
        ckpt_every=train["resume_at"], log_every=5,
        use_reduced_config=train["use_reduced"], seed=0, device=str(device))
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = train_mod.train(tc)
    sync()
    wall = time.perf_counter() - t0
    hist = out["history"]
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda \
        else None
    print(f"  train(): {len(hist)} steps in {wall:.2f}s (set-up, planner, "
          f"init and two checkpoint saves included); losses "
          f"{hist[0]:.4f} -> {hist[-1]:.4f}, min of the last 5 "
          f"{min(hist[-5:]):.4f}; peak device memory "
          + (f"{peak:.2f} GiB" if peak is not None else "not measured"))
    assert len(hist) == steps and all(np.isfinite(hist)), hist
    assert min(hist[-5:]) < hist[0], hist
    expected += _train_launches(cfg, steps)
    # the checkpoint after step resume_at alone in a directory: resume it
    k = train["resume_at"]
    shutil.copytree(ckpt / f"step_{k:09d}", resumed / f"step_{k:09d}")
    (resumed / "LATEST").write_text(f"step_{k:09d}")
    shutil.rmtree(ckpt)
    t0 = time.perf_counter()
    out2 = train_mod.train(dataclasses.replace(tc,
                                               ckpt_dir=str(resumed)))
    sync()
    h2 = out2["history"]
    assert len(h2) == steps - k - 1, h2
    expected += _train_launches(cfg, len(h2))
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(h2, hist[k + 1:]))
    diffs = [(p2 - p1).abs() for p1, p2 in zip(
        tree_leaves(out["state"].params), tree_leaves(out2["state"].params))]
    worst = max(d.max().item() for d in diffs)
    mean = sum(d.sum().item() for d in diffs) / sum(
        p.abs().sum().item() for p in tree_leaves(out["state"].params))
    print(f"  resumed from the step-{k} checkpoint ({k + 1} updates) for "
          f"{len(h2)} steps in {time.perf_counter() - t0:.2f}s: losses "
          f"{h2} against {hist[k + 1:]} (max rel diff {loss_err:.2e}); "
          f"parameters max abs diff "
          f"{worst:.3e}, mean |diff| / mean |param| {mean:.3e}")
    assert loss_err <= RESUME_TOLS["loss"], (h2, hist[k + 1:])
    assert worst <= 2 * train["lr"] and mean <= RESUME_TOLS["mean"], \
        (worst, mean)
    assert int(out2["state"].opt_state.step) == steps
    del out2, diffs
    shutil.rmtree(workdir, ignore_errors=True)
    # timed steps on the run's state, then one profiled
    model = build_model(cfg, device)
    opt_cfg = optim.AdamWConfig(lr=train["lr"],
                                warmup_steps=train["warmup"],
                                total_steps=steps)
    step_fn = train_mod.make_train_step(model, cfg, opt_cfg, False,
                                        "none")
    st = out["state"]
    times = []
    for i in range(train["timed"]):
        batch = _batch(cfg, b, s, steps + i, device)
        sync()
        t1 = time.perf_counter()
        st.params, st.opt_state, st.err_state, m = step_fn(
            st.params, st.opt_state, st.err_state, batch)
        float(m["loss"])
        sync()
        times.append(time.perf_counter() - t1)
    step_s = sorted(times)[len(times) // 2]
    if record is not None:
        record.update(losses=list(hist), step_ms=step_s * 1e3)
    plan = out["plan"]
    print(f"  step time (median of {len(times)}, host clock after a "
          f"synchronise): {step_s * 1e3:.2f} ms, {b * s / step_s:.1f} "
          f"tokens/s; the planner's predicted step ({plan.strategy.name}, "
          f"tpu_v5e template): {plan.predicted_step_s * 1e3:.2f} ms "
          f"(measured / predicted {step_s / plan.predicted_step_s:.2f}, "
          f"no limit)")
    expected += _train_launches(cfg, len(times))
    if cuda:
        _profile_train_step(step_fn, out, cfg, b, s, device,
                            steps + len(times))
        expected += _train_launches(cfg, 1)
    del out, st, step_fn
    if cuda:
        torch.cuda.empty_cache()
    print(f"# phase 7 (b): {time.perf_counter() - t_b:.2f}s")
    # (c) the recurrent families
    for arch, ob, os_ in train["others"]:
        ocfg = cfg_of(arch)
        n = train["other_steps"]
        print(f"== phase 7 (c): train {ocfg.name} ({ocfg.n_layers} layers, "
              f"d_model {ocfg.d_model}) at ({ob}, {os_}), {n} steps")
        t0 = time.perf_counter()
        otc = train_mod.TrainConfig(
            arch=arch, steps=n, global_batch=ob, seq_len=os_,
            lr=train["lr"], warmup=train["warmup"], log_every=1,
            use_reduced_config=train["use_reduced"], seed=0,
            device=str(device))
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        oout = train_mod.train(otc)
        sync()
        oh = oout["history"]
        opeak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda \
            else None
        print(f"  {n} steps in {time.perf_counter() - t0:.2f}s (set-up "
              f"and init included), losses "
              f"{[round(x, 4) for x in oh]}, peak device memory "
              + (f"{opeak:.2f} GiB" if opeak is not None
                 else "not measured"))
        assert len(oh) == n and all(np.isfinite(oh)), oh
        expected += _train_launches(ocfg, n)
        if cuda and arch in train["profiled"]:
            ostep = train_mod.make_train_step(
                build_model(ocfg, device), ocfg,
                optim.AdamWConfig(lr=train["lr"],
                                  warmup_steps=train["warmup"],
                                  total_steps=n), False, "none")
            _profile_train_step(ostep, oout, ocfg, ob, os_, device, n)
            expected += _train_launches(ocfg, 1)
            del ostep
        del oout
        if cuda:
            torch.cuda.empty_cache()
        print(f"# phase 7 (c) {ocfg.name}: {time.perf_counter() - t0:.2f}s")
    return expected


def golden_weights(defs, seed: int = 0):
    """A ParamDef tree (the port's or the reference's: the same leaves) as
    float32 numpy drawn from ``default_rng(seed)`` leaf by leaf in sorted
    key order, each leaf as its def says (zeros, ones, or a normal times
    ``scale`` or 1/sqrt(fan_in)), the rule of ``tree_init``: the same
    numbers on any machine, so no weights are stored."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def mk(d):
        if d.init in ("zeros", "ones"):
            return np.full(d.shape, d.init == "ones", np.float32)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        scale = d.scale if d.scale is not None else fan_in ** -0.5
        return (rng.standard_normal(d.shape, np.float32)
                * np.float32(scale)).astype(np.float32)

    def walk(tree):
        if isinstance(tree, dict):
            return {key: walk(tree[key]) for key in sorted(tree)}
        return mk(tree)

    return walk(defs)


def train_golden_port(arch: str, device, golden: dict = TRAIN_GOLDEN,
                      batches=None, mesh=None) -> dict:
    """The port's numbers for what tests/test_torch_golden_train.npz holds:
    the reduced arch in float32, the first step's per-leaf gradient norms
    (JAX's leaf order) and the loss of each of ``steps`` AdamW steps.
    ``batches`` (tokens, labels: int32 (steps, batch, seq) numpy, the
    file's) stand in for the data pipeline's, which they equal where
    numpy draws the reference's stream.  With a ``mesh`` (a DeviceMesh of
    the process group) the steps take the mesh path: the planner's
    placements, DTensor parameters, moments and batches."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.configs.base import ShapeCell, get_config, reduced
    from repro_torch.core import planner
    from repro_torch.launch.train import item, make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import replicating, sharding
    from repro_torch.tree import is_dtensor, tree_leaves, tree_map
    cfg = dc.replace(reduced(get_config(arch)), dtype="float32")
    model = build_model(cfg, device)
    params = params_from_numpy(golden_weights(model.defs), device)
    b, s = golden["batch"], golden["seq"]
    rules = None
    if mesh is not None:
        cell = ShapeCell("train", s, b, "train")
        plan = planner.plan(cfg, cell, tuple(mesh.shape),
                            mesh.mesh_dim_names, device=device)
        rules = sharding.resolve_rules(plan, mesh)
        bsh = sharding.batch_shardings(cfg, cell, plan, mesh)
        params = sharding.distribute(params, mesh, sharding.param_shardings(
            model, plan, mesh))

    def batch(i):
        if batches is None:
            out = _batch(cfg, b, s, i, device)
        else:
            out = {key: torch.from_numpy(np.ascontiguousarray(val[i])).to(
                device) for key, val in zip(("tokens", "labels"), batches)}
        return out if mesh is None else sharding.distribute(out, mesh, bsh)

    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with replicating(mesh is not None):
        loss, _ = model.loss_fn(live, batch(0), rules=rules, mesh=mesh)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    norms = np.array([torch.linalg.vector_norm(
        g.full_tensor() if is_dtensor(g) else g).item() for g in grads],
        np.float32)
    del live, grads
    step = make_train_step(model, cfg, optim.AdamWConfig(
        lr=golden["lr"], warmup_steps=golden["warmup"],
        total_steps=golden["steps"]), False, "none", rules, mesh)
    state, losses = optim.init(params), []
    for i in range(golden["steps"]):
        params, state, _, m = step(params, state, None, batch(i))
        losses.append(item(m["loss"]))
    return {"losses": np.array(losses, np.float32), "grad_norms": norms}


def golden_batches(arch: str, golden: dict = TRAIN_GOLDEN):
    """The data pipeline's batches of the golden case on this machine:
    (tokens, labels), int32 (steps, batch, seq)."""
    import numpy as np
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data import DataConfig, synth_batch
    cfg = reduced(get_config(arch))
    got = [synth_batch(DataConfig(global_batch=golden["batch"],
                                  seq_len=golden["seq"]), cfg, i)
           for i in range(golden["steps"])]
    return tuple(np.stack([g[key].numpy() for g in got])
                 for key in ("tokens", "labels"))


def family_cfg(case: str, dtype: str, get_config, reduced):
    """The reduced config of a FAMILY_GOLDEN case in ``dtype``, from either
    package's ``get_config`` / ``reduced``."""
    arch, _, impl = case.partition("+")
    over = dict(moe_impl=impl, moe_groups=FAMILY_GOLDEN["groups"]) \
        if impl else {}
    return dataclasses.replace(reduced(get_config(arch)), dtype=dtype,
                               **over)


def family_inputs(seed: int = 5, golden: dict = FAMILY_GOLDEN):
    """(tokens int32 (batch, prompt + steps + 1) over the reduced vocab
    512, frames float32 (batch, frames, 128)) from ``default_rng(seed)``;
    the file keeps them, so the card reads them from there."""
    import numpy as np
    rng = np.random.default_rng(seed)
    b = golden["batch"]
    toks = rng.integers(0, 512, (b, golden["prompt"] + golden["steps"] + 1))
    frames = rng.standard_normal((b, golden["frames"], 128), np.float32)
    return toks.astype(np.int32), frames


class moe_routing:
    """Context: every router call of the port's MoE layers recorded as
    (probabilities (t, E) float32, experts (t, k)) numpy; with ``forced``
    (expert arrays in call order) the router takes those experts, their
    weights from its own probabilities, instead of its own top k."""

    def __init__(self, forced=None):
        self.forced = None if forced is None else list(forced)
        self.calls = []

    def __enter__(self):
        import numpy as np
        import torch
        from repro_torch.models import moe
        self._mod, self._orig = moe, moe.top_k

        def top_k(probs, k):
            if self.forced is None:
                vals, idx = self._orig(probs, k)
            else:
                idx = torch.from_numpy(np.array(
                    self.forced.pop(0), np.int64)).to(probs.device)
                idx = idx.reshape(*probs.shape[:-1], k)
                vals = torch.gather(probs, -1, idx)
            self.calls.append((
                probs.detach().float().reshape(-1, probs.shape[-1])
                .cpu().numpy(), idx.reshape(-1, k).cpu().numpy()))
            return vals, idx

        moe.top_k = top_k
        return self

    def __exit__(self, *exc):
        self._mod.top_k = self._orig
        return False


def routing_flips(calls, want) -> list:
    """(call, row, margin) for every router row whose experts differ from
    ``want``'s (expert arrays in call order): the margin is ln P(a) -
    ln P(b) under the row's own probabilities, a the least likely expert
    it took that ``want`` did not, b the likeliest ``want`` took that it
    did not."""
    import numpy as np
    out = []
    for c, ((probs, idx), ref) in enumerate(zip(calls, want)):
        ref = np.asarray(ref).reshape(idx.shape)
        for r in range(idx.shape[0]):
            took, wanted = set(idx[r].tolist()), set(ref[r].tolist())
            if took == wanted:
                continue
            a = min(took - wanted, key=lambda e: probs[r, e])
            b = max(wanted - took, key=lambda e: probs[r, e])
            out.append((c, r, float(np.log(probs[r, a])
                                     - np.log(probs[r, b]))))
    return out


def first_divergence(flips) -> list:
    """The flips (`routing_flips`) of the first router call, in call
    order, whose experts differ: where two runs first part.  Each later
    call sees inputs that this one already moved (a token that took other
    experts is another token from there on), so only these rows must be
    near ties (their margins within NEAR_TIE); the runs' values are held
    with the experts replayed."""
    return [f for f in flips if f[0] == flips[0][0]] if flips else []


def family_outputs(model, params, tokens, frames, device,
                   golden: dict = FAMILY_GOLDEN) -> dict:
    """The port's numbers for one FAMILY_GOLDEN case: ``logits`` (the
    forward over the prompt), ``steps`` (the decode steps' logits),
    ``cross`` (the encoder-decoder's prefill cross K/V, stacked), ``loss``
    and ``grad_norm`` (float64 norm over every leaf), as float32 numpy
    over the real vocab.  The prompt runs as a prefill where the model has
    a decode path."""
    import numpy as np
    import torch
    from repro_torch.tree import tree_leaves, tree_map
    cfg = model.cfg
    b, n, steps = golden["batch"], golden["prompt"], golden["steps"]
    v = cfg.vocab_size
    toks = torch.as_tensor(tokens, dtype=torch.int32, device=device)
    fr = torch.as_tensor(frames, device=device)
    out = {}

    def np32(t):
        return t.detach().float().cpu().numpy()

    with torch.no_grad():
        if model.kind == "lm":
            caches = model.init_cache(b, n + steps)
            logits, caches, _ = model.forward(
                params, {"tokens": toks[:, :n]}, caches=caches)
            first = n
        else:
            batch = {"tokens": toks[:, :n], "frames": fr}
            logits = model.forward(params, batch)[0]
            if model.has_decode:
                caches = model.prefill(params, batch)
                out["cross"] = np.stack([np32(caches["cross"][key])
                                         for key in ("k", "v")])
            first = 0
        out["logits"] = np32(logits)[..., :v]
        if model.has_decode:
            out["steps"] = np.stack([
                np32(model.decode_step(params, caches,
                                       toks[:, t:t + 1], t)[0])[:, 0, :v]
                for t in range(first, first + steps)])
    batch = {"tokens": toks[:, :n], "labels": toks[:, 1:n + 1]}
    if model.kind == "encdec":
        batch["frames"] = fr
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = model.loss_fn(live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    out["loss"] = np.float32(loss.item())
    out["grad_norm"] = np.float32(math.sqrt(sum(
        float(torch.sum(g.double() ** 2)) for g in grads)))
    return out


def _routes(golden, key: str) -> list:
    """A case's recorded router calls (expert arrays in call order) from
    the golden file: the prompt's forward, each decode step's and the
    loss's forward."""
    return [golden[f"{key}/routes/{i}"]
            for i in range(int(golden[f"{key}/n_routes"]))]


def family_golden_port(case: str, dtype: str, device, golden) -> dict:
    """Run one case on ``device`` and hold it to the golden file (see
    FAMILY_GOLDEN); returns {what: worst error as a share of its scale}."""
    import numpy as np
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_numpy
    cfg = family_cfg(case, dtype, get_config, reduced)
    model = build_model(cfg, device)
    params = params_from_numpy(golden_weights(model.defs), device)
    key = f"{case}/{dtype}"
    tokens, frames = golden["tokens"], golden["frames"]
    if not cfg.is_moe:
        return hold_to_family_golden(
            family_outputs(model, params, tokens, frames, device), golden,
            key, dtype)
    want = _routes(golden, key)
    forced = dtype == "bfloat16"
    with moe_routing(want if forced else None) as rec:
        got = family_outputs(model, params, tokens, frames, device)
    worst = hold_to_family_golden(got, golden, key, dtype)
    if not forced:
        flips = routing_flips(rec.calls, want)
        assert not flips, (key, flips[:5])
        return worst
    # the router's own choice, where bf16 rounding may break near ties
    with moe_routing() as own:
        free = family_outputs(model, params, tokens, frames, device)
    flips = routing_flips(own.calls, want)
    first = first_divergence(flips)
    print(f"  {key}: own routing: {len(flips)} of "
          f"{sum(len(i) for _, i in own.calls)} router rows take other "
          f"experts than the reference; margins (ln P) "
          f"{[round(m, 5) for _, _, m in flips]}, the first call's at most "
          f"NEAR_TIE {NEAR_TIE:.4f}")
    assert all(m <= NEAR_TIE for _, _, m in first), (key, flips)
    # a token that took other experts moves its own values, those of every
    # later token of its sequence (causal attention) and, through the
    # experts' capacity, those of any later token of the batch (the
    # dispatch queues tokens in (batch, position) order and drops the
    # latest): the tokens before the first such token are held to the file
    b, n = FAMILY_GOLDEN["batch"], FAMILY_GOLDEN["prompt"]
    first = min([r for c, r, _ in flips if c < cfg.n_layers],
                default=b * n)          # in the prompt's router calls
    kept = (np.arange(b * n) < first).reshape(b, n)
    ref = golden[f"{key}/logits"]
    err = np.abs(free["logits"] - ref)[kept].max(initial=0.0)
    scale = np.abs(ref).max()
    print(f"  {key}: own routing, forward logits at the {int(kept.sum())} "
          f"of {kept.size} tokens (in batch order) before the first that "
          f"took other experts: max abs diff {err:.3e} ({err / scale:.2e} "
          f"of max)")
    assert err <= FAMILY_TOLS[dtype]["logits"] * scale, (key, err, scale)
    return worst


def hold_to_family_golden(got: dict, golden, key: str, dtype: str) -> dict:
    """Each value at FAMILY_TOLS[dtype]; prints and returns the errors."""
    import numpy as np
    tols = FAMILY_TOLS[dtype]
    worst = {}
    for name, val in got.items():
        want = golden[f"{key}/{name}"]
        assert np.shape(val) == np.shape(want), (key, name, np.shape(val),
                                                 np.shape(want))
        assert np.isfinite(val).all(), (key, name)
        err = float(np.abs(np.asarray(val, np.float64) - want).max())
        scale = float(np.abs(want).max())
        tol = tols["cache" if name == "cross" else
                   "grad" if name == "grad_norm" else name
                   if name in tols else "logits"]
        worst[name] = err / scale
        assert err <= tol * scale, (key, name, err, scale, tol)
    print(f"  {key}: " + ", ".join(f"{name} {val:.2e}"
                                   for name, val in worst.items())
          + " (max abs diff / max |value|)")
    return worst


def hold_to_train_golden(got: dict, golden, arch: str,
                         tols: dict = TRAIN_GOLDEN_TOLS) -> float:
    """Each key at its rtol (a chaotic arch's losses after the first update
    at CHAOTIC_LOSS_TOL); returns the worst relative error."""
    import numpy as np
    worst = 0.0
    for key, val in got.items():
        want = golden[f"{arch}/{key}"]
        assert val.shape == want.shape, (arch, key, val.shape, want.shape)
        rel = np.abs(val - want) / np.abs(want)
        tol = np.full(rel.shape, tols[key])
        if key == "losses" and arch in CHAOTIC_TRAIN:
            tol[1:] = CHAOTIC_LOSS_TOL
        assert bool((rel <= tol).all()), (arch, key, rel)
        worst = max(worst, float(rel.max()))
    return worst


def phase_train_golden(device, golden: dict = TRAIN_GOLDEN) -> \
        collections.Counter:
    """Phase 7 (d): the reduced archs against the reference's numbers, on
    the file's batches (the data pipeline's here, if this numpy draws the
    reference's stream: printed)."""
    import numpy as np
    from repro_torch.configs.base import get_config, reduced
    print(f"== phase 7 (d): the reduced models' training against "
          f"{GOLDEN_TRAIN.name}")
    expected = collections.Counter()
    with np.load(GOLDEN_TRAIN) as f:
        golden_file = dict(f)
    for arch in golden["archs"]:
        batches = tuple(golden_file[f"{arch}/{key}"]
                        for key in ("tokens", "labels"))
        same = all(np.array_equal(a, b) for a, b in
                   zip(golden_batches(arch, golden), batches))
        got = train_golden_port(arch, device, golden, batches)
        worst = hold_to_train_golden(got, golden_file, arch)
        print(f"  {arch}: {golden['steps']} losses "
              f"{[round(float(x), 5) for x in got['losses']]} and "
              f"{len(got['grad_norms'])} gradient norms, worst rel err "
              f"{worst:.2e}; the data pipeline here "
              + ("gives the file's batches byte for byte" if same else
                 f"draws other batches than the file's (numpy "
                 f"{np.__version__})"))
        expected += _train_launches(reduced(get_config(arch)),
                                    golden["steps"] + 1)
    return expected


def remat_grads(arch: str, device, remat, batch: int, seq: int):
    """One step of the reduced ``arch`` in float32 on `golden_weights` and
    the data pipeline's first batch under ``remat``: (loss, every leaf's
    gradient, the kernel launches it made)."""
    import dataclasses as dc
    import torch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.kernels import flash_attention, mlstm, rglru
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dc.replace(reduced(get_config(arch)), dtype="float32")
    model = build_model(cfg, device)
    live = tree_map(lambda p: p.requires_grad_(True), params_from_numpy(
        golden_weights(model.defs), device))
    mods = {"flash_attention": flash_attention, "rglru_scan": rglru,
            "mlstm_parallel": mlstm}
    before = {name: mod.LAUNCHES for name, mod in mods.items()}
    loss, _ = model.loss_fn(live, _batch(cfg, batch, seq, 0, device),
                            remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return float(loss.detach()), grads, collections.Counter(
        {name: mod.LAUNCHES - before[name] for name, mod in mods.items()})


def phase_remat(device, remat_cfg: dict = REMAT) -> collections.Counter:
    """Phase 7 (e): remat True and ``"dots"`` against no remat, each
    reduced arch, through the kernels' Functions on the card (`REMAT`).
    Returns the kernel launches these steps must have made."""
    from repro_torch.configs.base import get_config, reduced
    print("== phase 7 (e): remat through the kernels' Functions")
    expected = collections.Counter()
    b, s = remat_cfg["batch"], remat_cfg["seq"]
    for arch in remat_cfg["archs"]:
        cfg = reduced(get_config(arch))
        base_loss, base, _ = remat_grads(arch, device, False, b, s)
        expected += _train_launches(cfg, 1)
        for remat in (True, "dots"):
            loss, grads, launches = remat_grads(arch, device, remat, b, s)
            want = _train_launches(cfg, 1, remat)
            if device.type == "cuda":
                assert launches == want, (arch, remat, launches, want)
            expected += want
            loss_err = abs(loss - base_loss) / abs(base_loss)
            worst = 0.0
            for g, w in zip(grads, base):
                err = (g - w).abs().max().item()
                scale = w.abs().max().item()
                assert err <= REMAT_TOLS["grad"] * scale, (arch, remat, err,
                                                           scale)
                worst = max(worst, err / scale if scale else 0.0)
            assert loss_err <= REMAT_TOLS["loss"], (arch, remat, loss,
                                                    base_loss)
            print(f"  {cfg.name} ({b}, {s}) remat={remat!r}: loss rel diff "
                  f"{loss_err:.2e}, {len(grads)} gradients within "
                  f"{worst:.2e} of max |grad| of no remat's, kernel "
                  f"launches {dict(sorted(launches.items()))} (expected "
                  f"{dict(sorted(want.items()))} on the card)")
    return expected


def _attention_calls(cfg, what: str) -> int:
    """Attention calls (flash-attention launches on the card) of one
    ``"forward"``, ``"prefill"`` or ``"decode"`` step of ``cfg``: each
    attention layer's, the encoder-decoder's encoder layers and each
    decoder layer's self- and cross-attention, none for the LSTM."""
    if cfg.family == "lstm":
        return 0
    if cfg.is_encoder_decoder:
        return {"forward": cfg.n_encoder_layers + 2 * cfg.n_layers,
                "prefill": cfg.n_encoder_layers,
                "decode": 2 * cfg.n_layers}[what]
    return sum(cfg.block_kind(i) == "attn" for i in range(cfg.n_layers))


def phase_families_golden(device, golden: dict = FAMILY_GOLDEN) -> int:
    """Phase 8 (a): each FAMILY_GOLDEN case in both dtypes held to
    tests/test_torch_golden_families.npz.  Returns the flash-attention
    launches it must have made."""
    import numpy as np
    from repro_torch.configs.base import get_config, reduced
    print("== phase 8 (a): the reduced families against "
          "tests/test_torch_golden_families.npz")
    with np.load(GOLDEN_FAMILIES) as f:
        data = dict(f)
    n = 0
    for case in golden["cases"]:
        for dtype in ("float32", "bfloat16"):
            family_golden_port(case, dtype, device, data)
            cfg = family_cfg(case, dtype, get_config, reduced)
            # the prompt (a prefill, or the encoder-decoder's forward and
            # prefill), the steps, the loss's forward; bf16 MoE twice
            prompt = _attention_calls(cfg, "forward") + (
                _attention_calls(cfg, "prefill") if cfg.is_encoder_decoder
                else 0)
            per = prompt + golden["steps"] * _attention_calls(cfg, "decode") \
                * (cfg.family != "lstm") + _attention_calls(cfg, "forward")
            n += per * (2 if cfg.is_moe and dtype == "bfloat16" else 1)
    return n


def _moe_layer_check(model, params, ids, capacity_factor: float) -> None:
    """The first MoE layer on its real input (the embedded ``ids`` through
    the layer's attention): the dispatch at ``capacity_factor`` against a
    dense plain computation (every expert on every token, weighted by the
    same routing, accumulated in f32) at the bf16 tolerance, with the
    dispatch's drops at that capacity (none) and at the config's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import common, moe, transformer

    def ffn(x, wi, wo):                 # swiglu: the gate is the 2nd half
        h = x @ wi.to(x.dtype)
        if cfg.ffn_kind == "swiglu":
            u, g = h.chunk(2, dim=-1)
            h = F.silu(g) * u
        else:
            h = F.gelu(h, approximate="tanh")
        return (h @ wo.to(x.dtype)).float()

    cfg = model.cfg
    wide = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    d = cfg.d_model
    with torch.no_grad():
        bp = next(transformer._layers(params, None, cfg))[0]
        x = transformer._embed(params, cfg, ids)
        a, _ = transformer.attention_apply(
            bp["attn"], common.norm(cfg.norm_kind, x, bp["ln1"]), cfg)
        h = common.norm(cfg.norm_kind, x + a, bp["ln2"])
        mp = bp["moe"]
        with moe_routing() as rec:
            got, _ = moe.moe_apply(mp, h, wide)
        xt = h.reshape(-1, d)
        _, topw, topi = moe.route(mp, xt, cfg)
        assert (topi.cpu().numpy() == rec.calls[0][1]).all()
        want = ffn(xt, mp["shared"]["wi"], mp["shared"]["wo"]) \
            if cfg.n_shared_experts else torch.zeros(xt.shape,
                                                     device=xt.device)
        for e in range(cfg.n_experts):
            w = ((topi == e) * topw).sum(-1)
            want += w[:, None] * ffn(xt, mp["experts"]["wi"][e],
                                     mp["experts"]["wo"][e])
        err = (got.reshape(-1, d).float() - want).abs().max().item()
        scale = want.abs().max().item()
    drops = moe.dropped(topi, wide)
    print(f"  the first MoE layer at {tuple(ids.shape)} on its real input, "
          f"dispatch at capacity {capacity_factor} ({moe.capacity(wide, len(xt))} "
          f"slots, {drops} dropped) vs every expert densely: max abs diff "
          f"{err:.3e} of max {scale:.3e} ({err / scale:.2e}); at the "
          f"config's {cfg.capacity_factor} ({moe.capacity(cfg, len(xt))} "
          f"slots) the dispatch drops {moe.dropped(topi, cfg)} of "
          f"{topi.numel()} assignments")
    assert drops == 0 and math.isfinite(err)
    assert err <= ATTN_TOLS["bfloat16"] * scale, (err, scale)


def _prefill_timed(model, params, batch: dict, device, what: str):
    """``Model.prefill`` twice (the first warms up); prints the second's
    ms and checks every cache tensor is finite.  Returns the caches."""
    import torch
    from repro_torch.tree import tree_leaves
    times = []
    with torch.no_grad():
        for _ in range(2):
            t0 = time.perf_counter()
            caches = model.prefill(params, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
    leaves = tree_leaves(caches)
    assert all(bool(torch.isfinite(t).all()) for t in leaves)
    print(f"  Model.prefill {what}: {times[1] * 1e3:.2f} ms (first call "
          f"{times[0] * 1e3:.2f} ms), {len(leaves)} cache tensors, all "
          f"finite")
    return caches


class _Laps:
    """Host-clock seconds of a phase's parts: `lap` ends one, `line`
    prints them with the total."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()
        self.parts = []

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append(f"{name} {now - self.t:.2f}s")
        self.t = now

    def line(self, what: str) -> str:
        return (f"# {what}: {time.perf_counter() - self.t0:.2f}s ("
                + ", ".join(self.parts) + ")")


def phase_moe(device, fam: dict) -> int:
    """Phase 8 (b): qwen2-moe-a2.7b through ``serve``, ``Model.prefill``,
    the prefill-vs-decode check at capacity ``check_capacity`` (no drops:
    at the config's 1.25 a 2048-token forward drops its latest tokens in
    overflowing experts, which a decode step never does), the first MoE
    layer against a dense computation, and a profiled decode window.
    Returns the flash-attention launches it must have made."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import build_model, moe
    m = fam["moe"]
    serve_kw = dict(fam["serve"], use_reduced=fam["use_reduced"])
    cfg = get_config(m["arch"])
    if fam["use_reduced"]:
        cfg = reduced(cfg)
    laps = _Laps()
    print(f"== phase 8 (b): {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts top-"
          f"{cfg.experts_per_token} + {cfg.n_shared_experts} shared, "
          f"{cfg.n_heads}x{cfg.resolved_head_dim} heads, "
          f"{cfg.param_count() / 1e9:.3f} B parameters, f32 weights from "
          f"seed 0)")
    print(f"  serve {serve_kw}")
    _serve(m["arch"], device, serve_kw)        # its own weights, freed
    if device.type == "cuda":
        torch.cuda.empty_cache()
    laps.lap("serve")
    model = build_model(cfg, device)
    params = model.init(0)
    laps.lap("weights")
    b, s = m["prefill"]
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)), dtype=torch.int32, device=device)
    caches = _prefill_timed(model, params, {"tokens": ids}, device,
                            f"({b}, {s})")
    del caches
    laps.lap("prefill")
    check = build_model(dataclasses.replace(
        cfg, capacity_factor=m["check_capacity"]), device)
    print(f"  the check at capacity {m['check_capacity']}:")
    forwards, check_steps = _moe_consistency(check, params, device,
                                             m["check_len"])
    drops = [moe.dropped(torch.from_numpy(i), check.cfg)
             for _, i in forwards]
    at_config = [moe.dropped(torch.from_numpy(i), cfg) for _, i in forwards]
    print(f"  its forwards' {len(forwards)} router calls drop {sum(drops)} "
          f"assignments (at the config's {cfg.capacity_factor}: "
          f"{sum(at_config)})")
    assert sum(drops) == 0
    laps.lap("check")
    _moe_layer_check(model, params, ids, m["check_capacity"])
    laps.lap("layer check")
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(laps.line("phase 8 (b)"))
    a = _attention_calls(cfg, "decode")
    steps = serve_kw["prompt_len"] + serve_kw["gen"]
    # serve; two prefills; the check's two forwards and steps; the layer
    # check's one attention
    return a * (steps + 2 + 2 + check_steps) + 1


def phase_whisper(device, fam: dict) -> int:
    """Phase 8 (c): whisper-large-v3 through ``Model.prefill`` of frame
    embeddings (the encoder and each layer's cross K/V), decode steps from
    that cache against a forward of the same frames and tokens, a profiled
    decode window, ``serve``, and ``launch.train.train`` with a profiled
    step.  Returns the flash-attention launches it must have made."""
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build_model
    w = fam["whisper"]
    serve_kw = dict(fam["serve"], use_reduced=fam["use_reduced"])
    cuda = device.type == "cuda"
    cfg = get_config(w["arch"])
    if fam["use_reduced"]:
        cfg = reduced(cfg)
    laps = _Laps()
    print(f"== phase 8 (c): {cfg.name} ({cfg.n_encoder_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}x{cfg.resolved_head_dim} heads, decoder_len "
          f"{cfg.decoder_len}, {cfg.param_count() / 1e9:.3f} B parameters, "
          f"f32 weights from seed 0)")
    model = build_model(cfg, device)
    params = model.init(0)
    laps.lap("weights")
    b, nf = w["frames"]
    gen = torch.Generator(device=device).manual_seed(0)
    frames = torch.randn((b, nf, cfg.d_model), generator=gen, device=device)
    caches = _prefill_timed(model, params, {"frames": frames}, device,
                            f"of ({b}, {nf}) frames")
    n = w["steps"]
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, n)), dtype=torch.int32, device=device)
    with torch.no_grad():
        full = model.forward(params, {"frames": frames, "tokens": toks})[0]
        steps = torch.cat([model.decode_step(params, caches,
                                             toks[:, t:t + 1], t)[0]
                           for t in range(n)], dim=1)
    v = cfg.vocab_size
    err = (steps[..., :v] - full[..., :v]).abs().max().item()
    scale = full[..., :v].abs().max().item()
    same = (steps[..., :v].argmax(-1) == full[..., :v].argmax(-1)).float()
    print(f"  {n} decode steps from the prefill vs a forward of the same "
          f"frames and {n} tokens: max abs logit diff {err:.4e} of max "
          f"|logit| {scale:.4e} ({err / scale:.2e}); argmax agrees on "
          f"{same.mean().item() * 100:.0f}% of positions")
    assert math.isfinite(err) and err <= ATTN_TOLS["bfloat16"] * scale, \
        (err, scale)
    del caches
    del params, model
    if cuda:
        torch.cuda.empty_cache()
    laps.lap("prefill and steps")
    print(f"  serve {serve_kw}")
    _serve(w["arch"], device, serve_kw)
    if cuda:
        torch.cuda.empty_cache()
    laps.lap("serve")
    tb, ts = w["train"]
    k = w["train_steps"]
    print(f"  train at ({tb}, {ts}) frames and {min(cfg.decoder_len, ts)} "
          f"decoder tokens, {k} steps, lr {w['lr']}, warmup {w['warmup']}")
    t1 = time.perf_counter()
    tc = train_mod.TrainConfig(
        arch=w["arch"], steps=k, global_batch=tb, seq_len=ts, lr=w["lr"],
        warmup=w["warmup"], log_every=1, use_reduced_config=fam[
            "use_reduced"], seed=0, device=str(device))
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    out = train_mod.train(tc)
    if cuda:
        torch.cuda.synchronize(device)
    hist = out["history"]
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda \
        else None
    print(f"  {k} steps in {time.perf_counter() - t1:.2f}s (set-up and "
          f"init included), losses {[round(x, 4) for x in hist]}, peak "
          f"device memory "
          + (f"{peak:.2f} GiB" if peak is not None else "not measured"))
    assert len(hist) == k and all(np.isfinite(hist)), hist
    assert hist[-1] < hist[0], hist
    laps.lap("train")
    if cuda:
        step = train_mod.make_train_step(
            build_model(cfg, device), cfg, optim.AdamWConfig(
                lr=w["lr"], warmup_steps=w["warmup"], total_steps=k),
            False, "none")
        t2 = time.perf_counter()
        st = out["state"]
        batch = _batch(cfg, tb, ts, k, device)
        step(st.params, st.opt_state, st.err_state, batch)
        torch.cuda.synchronize(device)
        print(f"  one more step: {(time.perf_counter() - t2) * 1e3:.2f} ms")
        _profile_train_step(step, out, cfg, tb, ts, device, k + 1)
        del step
    del out
    if cuda:
        torch.cuda.empty_cache()
    laps.lap("timed and profiled steps")
    print(laps.line("phase 8 (c)"))
    dec = _attention_calls(cfg, "decode")
    train_steps = k + (2 if cuda else 0)
    return (2 * _attention_calls(cfg, "prefill")
            + _attention_calls(cfg, "forward") + n * dec
            + dec * (serve_kw["prompt_len"] + serve_kw["gen"])
            + train_steps * _attention_calls(cfg, "forward"))


def _device_profile(fn, n: int, what: str):
    """``fn()`` under torch.profiler (CPU + CUDA): prints wall time and
    device-busy time per each of its ``n`` units of ``what``, the idle
    share and the kernels by device time.  Returns the device-busy us, the
    device us per kernel name and, per ``repro_torch::`` range (the kernel
    Functions' backwards), [device us of its kernels, ranges], or None
    where the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # the Functions' backward ranges are not kernels: each host-side range
    # is read apart, as the device time of the kernels launched inside it
    # (the averaged key would add the device-side range's span, idle gaps
    # included)
    spans = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.name.startswith("repro_torch::") and \
                "CPU" in str(e.device_type):
            spans[e.name][0] += e.device_time_total
            spans[e.name][1] += 1
    kernels = [e for e in events
               if getattr(e, "device_type", None) is not None
               and "CUDA" in str(e.device_type)
               and not e.key.startswith("repro_torch::")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        print(f"  profiled {what}: the profiler recorded no device time "
              f"(device busy share not measured)")
        return None
    launches = sum(e.count for e in kernels)
    print(f"  profiled {what}: wall {wall / n * 1e3:.3f} ms each (profiler "
          f"on), device busy {busy_us / n / 1e3:.3f} ms each, idle share "
          f"{1 - busy_us * 1e-6 / wall:.3f}, {launches / n:.1f} kernel "
          f"launches each under {len(kernels)} names")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the eight largest, then the port's own kernels below them
    for e in ranked[:8] + [e for e in ranked[8:] if any(
            name in e.key for name in PORT_KERNEL_NAMES)]:
        print(f"    {e.self_device_time_total / n / 1e3:8.4f} ms "
              f"({e.self_device_time_total / busy_us * 100:4.1f} %) "
              f"{e.count / n:6.1f} launches  {e.key[:90]}")
    return busy_us, {e.key: e.self_device_time_total for e in kernels}, \
        spans


def _profile_decode(model, params, serve_kw: dict, device,
                    prompt_len: int = 4, gen: int = 8) -> int:
    """Where a serving step's time goes: ``generate`` at the serve batch
    over a short prompt, profiled.  Returns the decode steps it ran."""
    import numpy as np
    from repro_torch.launch.serve import generate
    prompts = np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (serve_kw["batch"], prompt_len))
    n = prompt_len + gen
    if device.type != "cuda":
        generate(model, params, prompts, gen)
    else:
        _device_profile(lambda: generate(model, params, prompts, gen), n,
                        f"{n} decode steps at batch {serve_kw['batch']}")
    return n


PARALLEL = dict(steps=3, collective_bytes=(1 << 20, 1 << 26), reps=5)


def phase_parallel(device, train: dict, phase7: dict,
                   par: dict = PARALLEL) -> collections.Counter:
    """Phase 9: the process group at world size 1 (NCCL on the card), the
    mesh path's train steps against phase 7 (b)'s, the bucketed
    all-reduce, the ``collective`` microbenchmark, and a 2-rank mesh where
    the host has two cards.  Returns the kernel launches of (a)'s steps
    (counted from zero around them)."""
    import torch
    import torch.distributed as dist
    from repro_torch import optim
    from repro_torch.calibrate import microbench
    from repro_torch.configs.base import ShapeCell, get_config, reduced
    from repro_torch.core import planner
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build_model
    from repro_torch.parallel import collectives, sharding
    from repro_torch.tree import is_dtensor, tree_leaves
    cuda = device.type == "cuda"
    card = card_line() if cuda else "host rehearsal"
    t0 = time.perf_counter()

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    rank, world = mesh_lib.init_distributed(device)
    backend = dist.get_backend()
    print(f"== phase 9: parallelism; process group {backend}, rank {rank} "
          f"of {world}  [{card}]")
    assert world == 1 and backend == ("nccl" if cuda else "gloo"), \
        (world, backend)
    try:
        # (a) phase 7 (b)'s first steps through the mesh path
        cfg = get_config(train["arch"])
        cfg = reduced(cfg) if train["use_reduced"] else cfg
        b, s, n = train["batch"], train["seq"], par["steps"]
        mesh = mesh_lib.make_mesh((1, 1), device=device)
        cell = ShapeCell("train", s, b, "train")
        plan = planner.plan(cfg, cell, (1, 1), mesh.mesh_dim_names,
                            device=device)
        rules = sharding.resolve_rules(plan, mesh)
        bsh = sharding.batch_shardings(cfg, cell, plan, mesh)
        model = build_model(cfg, device)
        params = model.init(0, shardings=sharding.param_shardings(
            model, plan, mesh), mesh=mesh)
        assert all(is_dtensor(p) for p in tree_leaves(params))
        opt = optim.init(params)
        step = train_mod.make_train_step(
            model, cfg, optim.AdamWConfig(lr=train["lr"],
                                          warmup_steps=train["warmup"],
                                          total_steps=train["steps"]),
            False, "none", rules, mesh)
        print(f"-- (a) {cfg.name} at ({b}, {s}), {n} steps on a 1x1 "
              f"DeviceMesh {mesh.mesh_dim_names}, plan "
              f"{plan.strategy.name}: DTensor parameters and moments")
        mods = _reset_launches()
        losses, times = [], []
        for i in range(n):
            batch = sharding.distribute(_batch(cfg, b, s, i, device), mesh,
                                        bsh)
            sync()
            t1 = time.perf_counter()
            params, opt, _, m = step(params, opt, None, batch)
            losses.append(train_mod.item(m["loss"]))
            sync()
            times.append(time.perf_counter() - t1)
        launched = _check_launches(mods, _train_launches(cfg, n), device,
                                   "phase 9 (a)")
        if cuda:
            assert launched["flash_attention"] > 0, "the mesh path never " \
                "launched the attention kernel"
        want = phase7["losses"][:n]
        err = max(abs(x - y) / abs(y) for x, y in zip(losses, want))
        mesh_ms = sorted(times)[len(times) // 2] * 1e3
        print(f"  losses {losses} against phase 7 (b)'s {want}: max rel "
              f"diff {err:.2e} (rtol 1e-5)")
        print(f"  step ms: mesh path {mesh_ms:.2f} (median of {n}, the "
              f"first included), unsharded {phase7['step_ms']:.2f} (phase "
              f"7 (b)'s median); mesh / unsharded "
              f"{mesh_ms / phase7['step_ms']:.3f}  [{card}]")
        assert err <= 1e-5, (losses, want)
        del params, opt, step, m, batch
        if cuda:
            torch.cuda.empty_cache()
        # (b) the bucketed all-reduce of a mixed bf16 / f32 tree
        gen = torch.Generator(device=device).manual_seed(0)
        tree = {"w": torch.randn(1024, 1024, generator=gen, device=device
                                 ).to(torch.bfloat16),
                "b": torch.randn(4096, generator=gen, device=device),
                "g": {"x": torch.randn(3, 5, generator=gen, device=device),
                      "y": torch.randn(7, generator=gen, device=device
                                       ).to(torch.bfloat16)}}
        got = collectives.bucketed_all_reduce(tree, bucket_bytes=1 << 20)
        n_buckets = len(collectives.flatten_to_buckets(tree, 1 << 20)[0])
        assert all(g.dtype == w.dtype and torch.equal(g, w)
                   for g, w in zip(tree_leaves(got), tree_leaves(tree)))
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(tree))
        print(f"-- (b) bucketed_all_reduce of a bf16 / f32 tree ({nbytes} "
              f"bytes, {n_buckets} buckets of 1 MiB at most): every leaf "
              f"the world's sum, dtypes kept")
        # (c) the collective microbenchmark at 1 device
        spec = microbench.MeasureSpec(
            suite="full", collective_bytes=par["collective_bytes"],
            collective_devices=1, reps=par["reps"])
        recs = []
        microbench.run_points(microbench.enumerate_points(spec), spec,
                              recs.append, device=device)
        assert [r["bytes"] for r in recs] == list(par["collective_bytes"])
        for r in recs:
            assert r["t_mean_s"] >= r["t_s"] > 0, r
            print(f"-- (c) collective {int(r['bytes'])} bytes over 1 rank "
                  f"({backend}): best {r['t_s'] * 1e6:.1f} us, mean "
                  f"{r['t_mean_s'] * 1e6:.1f} us of {r['reps']}  [{card}]")
    finally:
        dist.destroy_process_group()
    # (d) a 2-rank mesh, where the host has two cards
    if cuda and torch.cuda.device_count() > 1:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
             "--arch", train["arch"], "--batch", str(b), "--seq", str(s),
             "--steps", str(n), "--lr", str(train["lr"]), "--mesh", "1x2"],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        assert proc.returncode == 0, proc.stderr[-3000:]
        first = [float(line.split()[4]) for line in proc.stdout.splitlines()
                 if line.startswith("[train] step     0 loss")]
        assert len(first) == 1 and abs(first[0] - want[0]) <= \
            1e-3 * abs(want[0]), (first, want[0])
        print(f"-- (d) torchrun, 2 ranks, mesh 1x2: {n} steps, first loss "
              f"{first[0]:.4f} against phase 7 (b)'s {want[0]:.4f}")
    else:
        cards = torch.cuda.device_count() if cuda else 0
        print(f"-- (d) the host has {cards} card(s): no 2-rank mesh")
    print(f"# phase 9: {time.perf_counter() - t0:.2f}s")
    return launched


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


def _reset_launches() -> dict:
    """Every kernel wrapper's module, its count set to 0."""
    from repro_torch.kernels import flash_attention, gemm, mlstm, rglru
    mods = {"gemm": gemm, "flash_attention": flash_attention,
            "rglru_scan": rglru, "mlstm_parallel": mlstm}
    for mod in mods.values():
        mod.reset_launches()
    return mods


def _check_launches(mods: dict, expected: dict, device, what: str) -> dict:
    got = {name: mod.LAUNCHES for name, mod in mods.items()}
    if device.type != "cuda":
        expected = {}                   # the host takes the plain versions
    for name, n in got.items():
        print(f"# {name} kernel launches on {what}: {n} (expected "
              f"{expected.get(name, 0)})")
        assert n == expected.get(name, 0), (name, n, expected.get(name, 0))
    return got


def _model_point_launches(spec) -> collections.Counter:
    """Kernel launches of the suite's model-step points: a prefill runs
    every layer's kernel once, a decode step only attention's (the
    recurrences decode with plain tensor ops), a train step forward and
    backward (`_train_launches`); each point warmup + reps times."""
    from repro_torch.configs.base import get_config, reduced
    per_point = max(spec.warmup, 1) + max(spec.reps, 1)
    out = collections.Counter()
    for arch in spec.model_archs:
        cfg = reduced(get_config(arch))
        kinds = collections.Counter(cfg.block_kind(i)
                                    for i in range(cfg.n_layers))
        for phase in spec.model_phases:
            if phase == "train_step":
                out += _train_launches(cfg, per_point)
            elif phase == "prefill":
                out += collections.Counter({
                    "flash_attention": kinds["attn"] * per_point,
                    "rglru_scan": kinds["rglru"] * per_point,
                    "mlstm_parallel": kinds["mlstm"] * per_point})
            else:
                out["flash_attention"] += kinds["attn"] * per_point
    return out


def run(device, spec, workdir: Path, cases: dict, serve_kw: dict,
        check_len: int, recurrent: dict, steps: int = 40,
        starts: int = 2, search: dict = SEARCH,
        runner: dict = RUNNER, deepflow: dict = DEEPFLOW,
        train: dict = TRAIN, families: dict = FAMILIES,
        parallel: dict = PARALLEL) -> list:
    """Phases 2-9; returns the per-kernel result objects.  ``cases`` maps
    each kernel to its (compared, timed) cases.  ``steps`` x ``starts`` is
    the fit's depth, cut from 80 x 6 since the suite's nine model-step
    points of three archs made each of its evaluations ~5x costlier on
    the card (a launch-bound autograd loop)."""
    print("== phase 2: kernels against their plain versions")
    t0 = time.perf_counter()
    phases = {"gemm": phase_gemm, "flash_attention": phase_attention,
              "rglru_scan": phase_rglru, "mlstm_parallel": phase_mlstm}
    results = {name: phases[name](device, *cases[name]) for name in KERNELS}
    t1 = time.perf_counter()
    print(f"# phase 2: {t1 - t0:.2f}s")
    # the main paths of slices 1 and 2: counts from zero, read right after
    mods = _reset_launches()
    out = phase_calibrate(device, spec, workdir, steps, starts)
    t2 = time.perf_counter()
    print(f"# phase 3: {t2 - t1:.2f}s (measuring {out.stats.elapsed_s:.2f}s, "
          f"the rest fit, reports and validate)")
    phase_predict(device, out.profile_path)
    phase_search(device, search)
    runner_dir = workdir.parent / f"{workdir.name}-runner"
    rates = phase_runner(device, runner, runner_dir, out.profile_path)
    phase_deepflow(device, deepflow, runner_dir)
    phase_bucketed(device, runner, runner_dir, rates)
    t3 = time.perf_counter()
    print(f"# phase 4: {t3 - t2:.2f}s")
    serve_launches = phase_serve(device, serve_kw, check_len)
    t4 = time.perf_counter()
    print(f"# phase 5: {t4 - t3:.2f}s")
    per_point = max(spec.warmup, 1) + max(spec.reps, 1)
    expected = _model_point_launches(spec) + collections.Counter({
        "gemm": len(spec.pallas_shapes) * per_point,
        "flash_attention": serve_launches})
    launches = _check_launches(mods, expected, device, "phases 3-5")
    # this slice's path: the recurrent families
    mods = _reset_launches()
    expected = phase_recurrent(device, recurrent)
    print(f"# phase 6: {time.perf_counter() - t4:.2f}s")
    more = _check_launches(mods, expected, device, "phase 6")
    if device.type == "cuda":
        for name in ("rglru_scan", "mlstm_parallel"):
            assert more[name] > 0, f"phase 6 never launched {name}"
    # this slice's path: training
    t5 = time.perf_counter()
    phase_grads(device, train["grads"])
    t6 = time.perf_counter()
    print(f"# phase 7 (a): {t6 - t5:.2f}s")
    mods = _reset_launches()
    phase7 = {}
    expected = phase_train(device, train,
                           workdir.parent / f"{workdir.name}-train", phase7)
    expected += phase_train_golden(device)
    expected += phase_remat(device, train["remat"])
    print(f"# phase 7: {time.perf_counter() - t5:.2f}s")
    trained = _check_launches(mods, expected, device, "phase 7 (b)-(e)")
    if device.type == "cuda":
        for name in ("flash_attention", "rglru_scan", "mlstm_parallel"):
            assert trained[name] > 0, f"phase 7 never launched {name}"
    # this slice's path: the model families
    t7 = time.perf_counter()
    mods = _reset_launches()
    n = phase_families_golden(device)
    n += phase_moe(device, families)
    n += phase_whisper(device, families)
    print(f"# phase 8: {time.perf_counter() - t7:.2f}s")
    fam = _check_launches(mods, {"flash_attention": n}, device, "phase 8")
    if device.type == "cuda":
        assert fam["flash_attention"] > 0, "phase 8 never launched " \
            "flash_attention"
    # this slice's path: the mesh (phase 9 (a) counts its own launches)
    meshed = phase_parallel(device, train, phase7, parallel)
    return [_row(name, launches[name] + more[name] + trained[name]
                 + fam[name] + meshed[name], results[name])
            for name in KERNELS]


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
    cases = {
        "gemm": (tuple(dict.fromkeys(UNIT_SHAPES + GEMM_EDGES
                                     + spec.pallas_shapes)),
                 microbench.QWEN_LAYER_SHAPES),
        "flash_attention": (ATTN_UNIT + ATTN_PATH, ATTN_TIMED,
                            ATTN_TIMED_FAMILIES),
        "rglru_scan": (RGLRU_UNIT + RGLRU_PATH, RGLRU_PATH[:1]),
        "mlstm_parallel": (MLSTM_UNIT + MLSTM_PATH, MLSTM_TIMED),
    }
    kernels = run(device, spec, ROOT / "build" / "chip_smoke", cases, SERVE,
                  CHECK_LEN, RECURRENT)
    print(f"# chip_smoke phases done in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
