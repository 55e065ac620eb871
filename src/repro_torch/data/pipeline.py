"""Sharded synthetic data pipeline with background prefetch, as
``repro.data.pipeline``.

Per-host sharding (each host draws only its shard of the global batch) and
deterministic per-(host, step) seeding, so a restarted job regenerates
byte-identical batches (exact resume).  The draws are the reference's: the
same numpy generator, seed formula and order of calls, so every batch is
byte for byte the reference's.  The token stream is a Zipf-ish synthetic
LM distribution with a repeating n-gram motif, so small models actually
descend.

Batches are CPU tensors (int32 tokens and labels, float32 ``frames`` /
``embeds``); the train loop moves them to its device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    zipf_a: float = 1.3
    structure_period: int = 16      # learnable n-gram period


def _host_batch(cfg: DataConfig) -> int:
    if cfg.global_batch % cfg.host_count:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {cfg.host_count} hosts")
    return cfg.global_batch // cfg.host_count


def synth_batch(cfg: DataConfig, arch: ArchConfig, step: int
                ) -> Dict[str, torch.Tensor]:
    """Deterministic (host, step) -> batch. Labels are next-token shifted."""
    rng = np.random.default_rng(
        (cfg.seed * 1_000_003 + step) * 4096 + cfg.host_index)
    b = _host_batch(cfg)
    s = cfg.seq_len + 1
    base = rng.zipf(cfg.zipf_a, size=(b, s)).astype(np.int64)
    # structured component: periodic motif the model can learn
    motif = rng.integers(0, arch.vocab_size, size=(b, cfg.structure_period))
    structured = motif[:, np.arange(s) % cfg.structure_period]
    choose = rng.random((b, s)) < 0.7
    toks = np.where(choose, structured, base % arch.vocab_size)
    toks = (toks % arch.vocab_size).astype(np.int32)
    out = {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
           "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}
    if arch.is_encoder_decoder:
        d = min(arch.decoder_len, cfg.seq_len)
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.seq_len, arch.d_model), dtype=np.float32))
        out["tokens"], out["labels"] = out["tokens"][:, :d], \
            out["labels"][:, :d]
    if arch.frontend == "vision_stub" and arch.n_patch_tokens:
        out["embeds"] = torch.from_numpy(rng.standard_normal(
            (b, min(arch.n_patch_tokens, cfg.seq_len), arch.d_model),
            dtype=np.float32))
    return out


class PrefetchIterator:
    """Background-thread prefetch (depth-N double buffering): yields
    ``(step, batch)`` from ``start_step`` on; `close` stops the thread."""

    def __init__(self, cfg: DataConfig, arch: ArchConfig,
                 start_step: int = 0, depth: int = 2):
        self.cfg, self.arch = cfg, arch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, self.arch, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
