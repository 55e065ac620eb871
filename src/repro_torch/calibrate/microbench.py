"""Microbenchmark harness — measured wall times of the port's own kernels.

Every measurement times an executable that exists in the port, on the card
unless the caller asks for the CPU:

  gemm         ``torch.matmul`` (cuBLAS; TF32 off), the counterpart of the
               reference's jit'd ``jnp.dot`` (the fig-6 methodology)
  gemm_pallas  the hand-written Hopper GEMM (`repro_torch.kernels.gemm`,
               through ``ops.matmul(use_kernel=True)``); the kind keeps the
               reference's name so measurement files stay interchangeable
  elementwise  ``torch.add(b, a, alpha=1.5)`` — one kernel, as XLA fuses
               the reference's saxpy (the PPE's vector/bandwidth path)
  prefill      one ``Model.forward`` (no cache) of the port's LM runtime
               at smoke size (`configs.base.reduced`): every attention
               call launches the hand-written flash-attention kernel
  decode_step  one-token ``Model.decode_step`` over a full KV cache at
               smoke size — the KV-cache-read-bound step that anchors the
               model's main-memory bandwidth path
  train_step   the gradient of ``Model.loss_fn`` at smoke size, no
               optimizer (the reference's ``jax.grad(loss)``): the kernels
               forward, their autograd Functions backward
  collective   `repro_torch.parallel.collectives.bucketed_all_reduce` of
               the point's ``bytes`` (a float32 tree) over ``devices``
               ranks: NCCL over that many cards on ``cuda`` (a host with
               fewer cards raises before any point is measured), gloo
               over that many host processes on ``cpu``; in this process
               where it is in a process group of that many ranks (every
               rank calls), else, outside any group, in ``devices``
               spawned processes (the reference's forced-device
               subprocess)

Measurements stream to ``measurements.jsonl`` with the sweep runner's
fingerprint/resume discipline: ``spec.json`` pins the enumerated point set
(`MeasureSpec.fingerprint`, the same hex as the reference's for the same
spec), each finished point appends one JSONL record, and a resumed run
skips every key already on disk with zero re-measurement (crash-torn tail
lines are dropped by the shared `iter_jsonl` reader).  Both files are
byte-compatible with the reference's.

The records feed `repro_torch.calibrate.fitting` (parameter fit) and
`repro_torch.calibrate.report` (validation tables).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.sweepexec import iter_jsonl, json_safe

SPEC_VERSION = 1

# measurement kinds, in enumeration order
KINDS = ("gemm", "gemm_pallas", "elementwise", "collective",
         "train_step", "prefill", "decode_step")


# ---------------------------------------------------------------------------
# Specification (fully serializable — the resume identity)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeasureSpec:
    """Everything that determines the measurement point set."""

    suite: str = "quick"
    gemm_shapes: Tuple[Tuple[int, int, int], ...] = ()
    gemm_dtype_bytes: int = 4
    pallas_shapes: Tuple[Tuple[int, int, int], ...] = ()
    elementwise_sizes: Tuple[int, ...] = ()
    collective_bytes: Tuple[int, ...] = ()
    collective_devices: int = 2
    model_archs: Tuple[str, ...] = ()
    model_phases: Tuple[str, ...] = ("train_step", "prefill")
    model_seq: int = 128
    model_batch: int = 2
    reps: int = 3
    warmup: int = 1

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["gemm_shapes"] = [list(s) for s in self.gemm_shapes]
        d["pallas_shapes"] = [list(s) for s in self.pallas_shapes]
        for k in ("elementwise_sizes", "collective_bytes", "model_archs",
                  "model_phases"):
            d[k] = list(d[k])
        return d

    @staticmethod
    def from_dict(d: Dict) -> "MeasureSpec":
        d = dict(d)
        for k in ("gemm_shapes", "pallas_shapes"):
            d[k] = tuple(tuple(int(x) for x in s) for s in d.get(k) or ())
        for k in ("elementwise_sizes", "collective_bytes"):
            d[k] = tuple(int(x) for x in d.get(k) or ())
        for k in ("model_archs", "model_phases"):
            d[k] = tuple(d.get(k) or ())
        return MeasureSpec(**d)

    def fingerprint(self) -> str:
        blob = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


# the four distinct qwen1.5-0.5b layer GEMMs at full width, M = 4096 (one
# train_4k sequence): q/o (1024x1024), kv (2048x1024), up (5632x1024),
# down (1024x2816) — lmgraph.py's q, kv, o, up and down nodes
QWEN_LAYER_SHAPES: Tuple[Tuple[int, int, int], ...] = (
    (4096, 1024, 1024), (4096, 2048, 1024), (4096, 5632, 1024),
    (4096, 1024, 2816))


def default_spec(suite: str = "quick", reps: int = 3) -> MeasureSpec:
    """The standard suites.

    quick  GEMM-only: enough signal to anchor compute throughput, memory
           bandwidth, and kernel overhead.
    full   the reference's full suite (adds the hand-written GEMM,
           elementwise probes, collectives and model-family steps).
    slice  what the port runs on the card: the quick GEMMs through
           cuBLAS, the same shapes plus the full-width qwen1.5-0.5b layer
           GEMMs through the hand-written kernel, bandwidth probes, and
           the prefill, decode and train steps of qwen1.5-0.5b,
           recurrentgemma-2b and xlstm-125m at smoke size (the
           flash-attention, scan and mLSTM kernels).
    """
    gemm = tuple(
        (m, n, k)
        for m in (128, 256, 512, 1024)
        for n, k in ((m, m), (m, 2 * m))
    ) + ((256, 1024, 512), (1024, 256, 2048))
    if suite == "quick":
        return MeasureSpec(suite="quick", gemm_shapes=gemm, reps=reps)
    if suite == "full":
        return MeasureSpec(
            suite="full", gemm_shapes=gemm,
            pallas_shapes=((128, 128, 128), (256, 256, 256)),
            elementwise_sizes=(1 << 16, 1 << 20, 1 << 23),
            collective_bytes=(1 << 16, 1 << 20, 1 << 22),
            model_archs=("qwen1.5-0.5b", "xlstm-125m", "recurrentgemma-2b"),
            model_phases=("train_step", "prefill", "decode_step"),
            reps=reps)
    if suite == "slice":
        return MeasureSpec(
            suite="slice", gemm_shapes=gemm,
            pallas_shapes=gemm + QWEN_LAYER_SHAPES,
            elementwise_sizes=(1 << 16, 1 << 20, 1 << 23),
            model_archs=("qwen1.5-0.5b", "recurrentgemma-2b",
                         "xlstm-125m"),
            model_phases=("prefill", "decode_step", "train_step"),
            model_seq=128,
            model_batch=2, reps=reps)
    raise ValueError(f"unknown suite {suite!r}; expected quick|full|slice")


# ---------------------------------------------------------------------------
# Point enumeration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeasurePoint:
    """One enumerated measurement (strings/ints only — checkpointable)."""

    kind: str
    params: Tuple[Tuple[str, object], ...]   # sorted (name, value) pairs

    def get(self, name: str, default=None):
        return dict(self.params).get(name, default)

    def key(self) -> str:
        parts = [f"{k}={v}" for k, v in self.params]
        return "|".join([self.kind] + parts)


def _pt(kind: str, **params) -> MeasurePoint:
    return MeasurePoint(kind=kind, params=tuple(sorted(params.items())))


def enumerate_points(spec: MeasureSpec) -> List[MeasurePoint]:
    """Deterministic measurement point set for one spec."""
    pts: List[MeasurePoint] = []
    for m, n, k in spec.gemm_shapes:
        pts.append(_pt("gemm", m=m, n=n, k=k,
                       dtype_bytes=spec.gemm_dtype_bytes))
    for m, n, k in spec.pallas_shapes:
        pts.append(_pt("gemm_pallas", m=m, n=n, k=k,
                       dtype_bytes=spec.gemm_dtype_bytes))
    for n in spec.elementwise_sizes:
        pts.append(_pt("elementwise", n_elems=n))
    for b in spec.collective_bytes:
        pts.append(_pt("collective", bytes=b,
                       devices=spec.collective_devices))
    for arch in spec.model_archs:
        for phase in spec.model_phases:
            pts.append(_pt(phase, arch=arch, seq=spec.model_seq,
                           batch=spec.model_batch))
    return pts


# ---------------------------------------------------------------------------
# Timing primitives
# ---------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn: Callable, warmup: int, reps: int,
             device: torch.device) -> Tuple[float, float]:
    """(best, mean) host-clock seconds of ``fn()``, each run ended by a
    device synchronise (the reference's ``block_until_ready``)."""
    for _ in range(max(warmup, 1)):
        fn()
        _sync(device)
    ts = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return min(ts), sum(ts) / len(ts)


def _exact_fp32() -> None:
    """fp32 products in IEEE fp32, never TF32 (stated, not left to
    defaults, so a cuBLAS time is an fp32 time)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _gemm_operands(pt: MeasurePoint, device: torch.device):
    m, n, k = pt.get("m"), pt.get("n"), pt.get("k")
    db = int(pt.get("dtype_bytes", 4))
    dtype = torch.float32 if db == 4 else torch.bfloat16
    x = torch.ones((m, k), dtype=dtype, device=device)
    w = torch.ones((k, n), dtype=dtype, device=device)
    return m, n, k, db, x, w


def _measure_gemm(pt: MeasurePoint, spec: MeasureSpec,
                  device: torch.device) -> Dict:
    _exact_fp32()
    m, n, k, db, x, w = _gemm_operands(pt, device)
    best, mean = _time_fn(lambda: torch.matmul(x, w), spec.warmup,
                          spec.reps, device)
    return {"flops": 2.0 * m * n * k, "bytes": float((m * k + k * n + m * n)
                                                     * db),
            "t_s": best, "t_mean_s": mean}


def _measure_gemm_pallas(pt: MeasurePoint, spec: MeasureSpec,
                         device: torch.device) -> Dict:
    from repro_torch.kernels import ops
    m, n, k, db, x, w = _gemm_operands(pt, device)
    best, mean = _time_fn(lambda: ops.matmul(x, w, use_kernel=True),
                          spec.warmup, spec.reps, device)
    return {"flops": 2.0 * m * n * k,
            "bytes": float((m * k + k * n + m * n) * db),
            "t_s": best, "t_mean_s": mean}


def _measure_elementwise(pt: MeasurePoint, spec: MeasureSpec,
                         device: torch.device) -> Dict:
    n = int(pt.get("n_elems"))
    a = torch.ones((n,), dtype=torch.float32, device=device)
    b = torch.ones((n,), dtype=torch.float32, device=device)
    best, mean = _time_fn(lambda: torch.add(b, a, alpha=1.5), spec.warmup,
                          spec.reps, device)
    return {"flops": 2.0 * n, "bytes": 3.0 * n * 4,
            "t_s": best, "t_mean_s": mean}


# smoke-size shape cell used for model-step measurements; the prediction
# side (fitting._model_skeleton) builds its lmgraph from the identical
# (reduced cfg, cell) pair
_CELL_KINDS = {"train_step": "train", "prefill": "prefill",
               "decode_step": "decode"}


def model_cell(pt: MeasurePoint):
    from repro_torch.configs.base import ShapeCell
    kind = _CELL_KINDS[pt.kind]
    return ShapeCell(f"cal_{kind}", int(pt.get("seq")),
                     int(pt.get("batch")), kind)


def _smoke_model(pt: MeasurePoint, device: torch.device):
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import build_model
    cfg = reduced(get_config(str(pt.get("arch"))))
    model = build_model(cfg, device)
    return cfg, model, model.init(0), int(pt.get("seq")), \
        int(pt.get("batch"))


def _model_batch(cfg, batch: int, seq: int, device: torch.device) -> Dict:
    """Zero tokens (labels the tokens) of (batch, seq); for the
    encoder-decoder, zero frames of (batch, seq, d_model) and tokens cut
    to ``decoder_len``, as the reference's."""
    tokens = torch.zeros((batch, seq), dtype=torch.int32, device=device)
    if not cfg.is_encoder_decoder:
        return {"tokens": tokens, "labels": tokens}
    tokens = tokens[:, :cfg.decoder_len]
    return {"frames": torch.zeros((batch, seq, cfg.d_model),
                                  dtype=torch.float32, device=device),
            "tokens": tokens, "labels": tokens}


def _measure_prefill(pt: MeasurePoint, spec: MeasureSpec,
                     device: torch.device) -> Dict:
    """One forward pass over (batch, seq) tokens, no cache."""
    cfg, model, params, seq, batch = _smoke_model(pt, device)
    batch_d = _model_batch(cfg, batch, seq, device)
    with torch.no_grad():
        best, mean = _time_fn(lambda: model.forward(params, batch_d),
                              spec.warmup, spec.reps, device)
    return {"flops": 0.0, "bytes": 0.0, "t_s": best, "t_mean_s": mean}


def _measure_decode(pt: MeasurePoint, spec: MeasureSpec,
                    device: torch.device) -> Dict:
    """One-token decode over a FULL KV cache (pos = seq-1): the measured
    step is KV-cache-read-bound — attention reads the whole context per
    token — anchoring the dram-bandwidth path the serving scenarios lean
    on.  The cache is updated in place at slot seq-1 on every run, so
    every run does the same work."""
    from repro_torch.core.scenarios import kv_cache_bytes
    cfg, model, params, seq, batch = _smoke_model(pt, device)
    if not model.has_decode:
        raise RuntimeError(f"{cfg.name}: model family has no decode path")
    caches = model.init_cache(batch, seq)
    tokens = torch.zeros((batch, 1), dtype=torch.int32, device=device)
    with torch.no_grad():
        best, mean = _time_fn(
            lambda: model.decode_step(params, caches, tokens, seq - 1),
            spec.warmup, spec.reps, device)
    return {"flops": 0.0, "bytes": float(kv_cache_bytes(cfg, seq, batch)),
            "t_s": best, "t_mean_s": mean}


def _measure_train_step(pt: MeasurePoint, spec: MeasureSpec,
                        device: torch.device) -> Dict:
    """The gradient of the loss over (batch, seq) zero tokens (labels the
    tokens), no optimizer, as the reference's ``jax.grad(loss)``: forward
    and backward through the kernels' autograd Functions."""
    from repro_torch.tree import tree_leaves
    cfg, model, params, seq, batch = _smoke_model(pt, device)
    batch_d = _model_batch(cfg, batch, seq, device)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    best, mean = _time_fn(
        lambda: torch.autograd.grad(model.loss_fn(params, batch_d)[0],
                                    leaves),
        spec.warmup, spec.reps, device)
    return {"flops": 0.0, "bytes": 0.0, "t_s": best, "t_mean_s": mean}


def _measure_collective(pt: MeasurePoint, spec: MeasureSpec,
                        device: torch.device) -> Dict:
    """`bucketed_all_reduce` of a float32 tree of ``bytes`` over the
    process group, which must have ``devices`` ranks (`run_points` spawns
    one where this process is in none)."""
    import torch.distributed as dist
    from repro_torch.parallel import collectives
    n_dev = int(pt.get("devices", 2))
    size = dist.get_world_size() if dist.is_initialized() else 0
    if size != n_dev:
        raise RuntimeError(f"collective point needs a process group of "
                           f"{n_dev} ranks, this process is in one of "
                           f"{size} (run it through run_points)")
    payload_bytes = int(pt.get("bytes"))
    tree = {"g": torch.ones((max(payload_bytes // 4, 1),),
                            dtype=torch.float32, device=device)}
    best, mean = _time_fn(
        lambda: collectives.bucketed_all_reduce(tree),
        spec.warmup, spec.reps, device)
    return {"flops": 0.0, "bytes": float(payload_bytes), "t_s": best,
            "t_mean_s": mean}


_COLLECTIVE_SNIPPET = """
import json, sys
import torch
import torch.distributed as dist
from repro_torch.calibrate import microbench
from repro_torch.core.sweepexec import json_safe
spec = microbench.MeasureSpec.from_dict(json.loads(sys.argv[1]))
wanted = set(json.loads(sys.argv[2]))
device, store, rank, world = sys.argv[3], sys.argv[4], int(sys.argv[5]), \
    int(sys.argv[6])
torch.set_num_threads(1)
if device == "cuda":
    torch.cuda.set_device(rank)
dist.init_process_group("nccl" if device == "cuda" else "gloo",
                        init_method="file://" + store, rank=rank,
                        world_size=world)
try:
    for pt in microbench.enumerate_points(spec):
        if pt.kind == "collective" and pt.key() in wanted:
            rec = microbench.measure_point(pt, spec, device)
            if rank == 0:
                print("MEASURE:" + json.dumps(json_safe(rec)), flush=True)
finally:
    dist.destroy_process_group()
"""


def _collective_processes(spec: MeasureSpec, keys: Sequence[str],
                          device: torch.device) -> List[Dict]:
    """The pending collective points (by key) in ``collective_devices``
    spawned processes, rank r on card r for ``cuda``; rank 0's records.
    They meet through a file store in a fresh temporary directory (no
    port)."""
    import repro_torch
    n = spec.collective_devices
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH", "")) if p)
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", _COLLECTIVE_SNIPPET,
             json.dumps(spec.to_dict()), json.dumps(list(keys)),
             device.type, store, str(r), str(n)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(n)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for p, (_, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"collective process failed: {err[-3000:]}")
    return [json.loads(line[len("MEASURE:"):])
            for line in outs[0][0].splitlines()
            if line.startswith("MEASURE:")]


_MEASURERS: Dict[str, Callable[[MeasurePoint, MeasureSpec, torch.device],
                               Dict]] = {
    "gemm": _measure_gemm,
    "gemm_pallas": _measure_gemm_pallas,
    "elementwise": _measure_elementwise,
    "collective": _measure_collective,
    "train_step": _measure_train_step,
    "prefill": _measure_prefill,
    "decode_step": _measure_decode,
}


def measure_point(pt: MeasurePoint, spec: MeasureSpec,
                  device=None) -> Dict:
    """Measure one point -> JSONL record (label fields + timings)."""
    data = _MEASURERS[pt.kind](pt, spec, resolve_device(device))
    return {"key": pt.key(), "kind": pt.kind, **dict(pt.params),
            "reps": spec.reps, **data}


def run_points(points: Sequence[MeasurePoint], spec: MeasureSpec,
               on_record: Callable[[Dict], None],
               verbose: bool = False, device=None) -> int:
    """Measure ``points`` in order, invoking ``on_record`` per record.

    Collective points run in this process where it is in a process group
    of ``collective_devices`` ranks (every rank of the group calls and
    gets the records); outside any group they run all together in that
    many spawned processes.  A group of another size raises, and so, on
    ``cuda``, does a host with fewer cards than that, both before any
    point is measured."""
    import torch.distributed as dist
    dev = resolve_device(device)
    coll = [p for p in points if p.kind == "collective"]
    n_dev = spec.collective_devices
    if coll and dev.type == "cuda" and torch.cuda.device_count() < n_dev:
        raise RuntimeError(
            f"collective points need {n_dev} cards, the host has "
            f"{torch.cuda.device_count()}")
    spawned = bool(coll) and not dist.is_initialized()
    if coll and not spawned and dist.get_world_size() != n_dev:
        raise RuntimeError(
            f"collective points need a process group of {n_dev} ranks, "
            f"this process is in one of {dist.get_world_size()}")
    n = 0

    def emit(rec):
        nonlocal n
        on_record(rec)
        n += 1
        if verbose:
            print(f"# measured {rec['key']}: {rec['t_s'] * 1e6:.1f} us",
                  flush=True)

    if spawned:
        keys = {p.key() for p in coll}
        for rec in _collective_processes(spec, sorted(keys), dev):
            if rec["key"] in keys:
                emit(rec)
    for pt in points:
        if pt.kind != "collective" or not spawned:
            emit(measure_point(pt, spec, dev))
    return n


# ---------------------------------------------------------------------------
# The runner (spec.json + measurements.jsonl, resumable)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeasureStats:
    n_points_total: int
    n_skipped: int
    n_measured: int
    elapsed_s: float
    out_dir: Optional[str]
    records: List[Dict]


class MicrobenchRunner:
    """Streams measurements to ``out_dir`` with resume discipline.

    Layout:
      spec.json           {"version", "fingerprint", "spec": {...}}
      measurements.jsonl  one record per measured point

    A resumed run must present the identical spec (fingerprint-checked)
    and re-measures nothing already on disk.
    """

    def __init__(self, spec: MeasureSpec, out_dir: Optional[str] = None,
                 device=None):
        self.spec = spec
        self.out_dir = out_dir
        self.device = device
        self._fp = spec.fingerprint()

    @staticmethod
    def from_dir(out_dir: str, device=None) -> "MicrobenchRunner":
        with open(os.path.join(out_dir, "spec.json")) as fh:
            head = json.load(fh)
        return MicrobenchRunner(MeasureSpec.from_dict(head["spec"]),
                                out_dir=out_dir, device=device)

    def _paths(self):
        return (os.path.join(self.out_dir, "spec.json"),
                os.path.join(self.out_dir, "measurements.jsonl"))

    def existing(self) -> Dict[str, Dict]:
        """Records already streamed (torn tail lines dropped)."""
        if self.out_dir is None:
            return {}
        _, mpath = self._paths()
        return {r["key"]: r for r in iter_jsonl(mpath) if "key" in r}

    def run(self, resume: bool = False, verbose: bool = False
            ) -> MeasureStats:
        t0 = time.perf_counter()
        dev = resolve_device(self.device)
        points = enumerate_points(self.spec)
        done: Dict[str, Dict] = {}
        fh = None
        records: List[Dict] = []
        if self.out_dir is not None:
            os.makedirs(self.out_dir, exist_ok=True)
            spec_path, mpath = self._paths()
            if os.path.exists(spec_path):
                with open(spec_path) as f:
                    head = json.load(f)
                if head.get("fingerprint") != self._fp:
                    raise ValueError(
                        f"cannot reuse {self.out_dir}: measurement spec "
                        f"changed (was {head.get('fingerprint')}, now "
                        f"{self._fp}); point --out at a fresh directory")
                if not resume and os.path.exists(mpath):
                    raise FileExistsError(
                        f"{self.out_dir} already holds measurements; pass "
                        f"resume=True (CLI: --resume) to continue, or use "
                        f"a fresh directory")
            if resume:
                done = self.existing()
            tmp = spec_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"version": SPEC_VERSION, "fingerprint": self._fp,
                           "spec": self.spec.to_dict()}, f, indent=2)
            os.replace(tmp, spec_path)
            fh = open(mpath, "a")
        elif resume:
            raise ValueError("resume=True requires an out_dir")

        pending = [p for p in points if p.key() not in done]

        def commit(rec: Dict):
            records.append(rec)
            if fh is not None:
                fh.write(json.dumps(json_safe(rec)) + "\n")
                fh.flush()

        try:
            n = run_points(pending, self.spec, commit, verbose=verbose,
                           device=dev)
        finally:
            if fh is not None:
                fh.close()
        return MeasureStats(
            n_points_total=len(points), n_skipped=len(done), n_measured=n,
            elapsed_s=time.perf_counter() - t0, out_dir=self.out_dir,
            records=list(done.values()) + records)


def load_measurements(out_dir: str) -> List[Dict]:
    """All measurement records streamed into ``out_dir``, spec order."""
    runner = MicrobenchRunner.from_dir(out_dir)
    by_key = runner.existing()
    return [by_key[p.key()] for p in enumerate_points(runner.spec)
            if p.key() in by_key]
