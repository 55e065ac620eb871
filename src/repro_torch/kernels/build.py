"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ctypes — seconds per source, where
a build that includes PyTorch's headers takes minutes.  Libraries go to
``build/`` beside this module (listed in ``.gitignore``), named by a hash of
the source, the ``csrc`` headers it includes and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
Nothing is built at import: the first call that
needs a library builds it; `build` builds several at once, one ``nvcc``
process per source, all started together.  `refuse_autograd` is the check
the GEMM's wrapper makes before it launches: the GEMM has no backward
(nothing trains through it; the other wrappers are autograd Functions);
`check_aligned` the one the bf16 tensor-core kernels' wrappers add;
`no_data` tells the dry-run's tensors (fake or meta: shapes without
data), which take a kernel's fake-tensor rule and launch nothing; the rule
reports the call to the counters in `COUNTERS` through `kernel_call`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# the dry-run's active counters (`repro_torch.launch.counters.StepCounter`
# adds itself while active): each has ``kernel_call(name, flops, nbytes)``
COUNTERS: List = []


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built on a machine with the CUDA "
                       "toolkit")


def _target(name: str) -> str:
    """The library's path, named by a hash of the flags, the source and
    the ``csrc`` headers it includes (``#include "..."``)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as fh:
        source = fh.read()
    h.update(source)
    for header in re.findall(rb'^#include "([^"]+)"', source, re.M):
        with open(os.path.join(CSRC, header.decode()), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every missing library, one nvcc per source, in parallel.

    Returns the compiler's output per name (``-Xptxas -v``: registers,
    shared memory, spills); raises with that output if a build fails."""
    targets = {name: _target(name) for name in names}   # every source first
    os.makedirs(BUILD_DIR, exist_ok=True)
    logs, procs = {}, {}
    try:
        for name, out in targets.items():
            if os.path.exists(out):
                logs[name] = f"{out}: up to date"
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
            os.replace(tmp, out)
    finally:                            # no compiler outlives the call
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(_target(name))
        return lib


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise where a kernel without a backward would need one: it writes
    into a fresh tensor through ctypes, so autograd would lose every
    gradient through it without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward yet (ROADMAP queue 2 "
            f"item 6); call it under torch.no_grad() or on tensors that do "
            f"not require grad")


def no_data(t: torch.Tensor) -> bool:
    """Whether ``t`` is a shape without data (a fake tensor of the
    dry-run, or a meta tensor): a kernel's wrapper then takes its
    fake-tensor rule, which allocates the kernel's outputs, reports its
    FLOPs and bytes through `kernel_call` and launches nothing."""
    return t.is_meta or isinstance(t, FakeTensor)


def kernel_call(name: str, flops: float, nbytes: float) -> None:
    """A hand-written kernel's fake-tensor rule reports one call: its
    formula FLOPs and bytes go to every active counter."""
    for counter in COUNTERS:
        counter.kernel_call(name, flops, nbytes)


def aligned16(t: torch.Tensor) -> bool:
    """Whether ``t``'s data starts 16-byte aligned; for a tensor without
    data, whether its offset into its storage is (a storage's base is)."""
    if no_data(t):
        return t.storage_offset() * t.element_size() % 16 == 0
    return t.data_ptr() % 16 == 0


def check_aligned(name: str, **tensors: torch.Tensor) -> None:
    """The bf16 tensor-core kernels copy rows in 16-byte pieces
    (cp.async): each tensor's data must start 16-byte aligned and each
    stride over a dimension longer than 1 (the last has unit stride) must
    be a multiple of 8 elements.  Raises ValueError naming the start or
    the stride."""
    for arg, t in tensors.items():
        if not aligned16(t):
            where = (f"offset {t.storage_offset()}" if no_data(t)
                     else f"{t.data_ptr():#x}")
            raise ValueError(f"{name}: bf16 {arg} starts at {where}, not "
                             f"16-byte aligned")
        for dim, (n, s) in enumerate(zip(t.shape[:-1], t.stride()[:-1])):
            if n > 1 and s % 8:
                raise ValueError(
                    f"{name}: bf16 {arg} has stride {s} over dim {dim}, not "
                    f"a multiple of 8 elements (16 bytes)")
