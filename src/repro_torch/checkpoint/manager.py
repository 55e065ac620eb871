"""Fault-tolerant checkpointing: async, atomic, keep-N, as
``repro.checkpoint.manager``, in its on-disk layout:

    <dir>/step_000000123.tmp/...   (in-flight write)
    <dir>/step_000000123/
        meta.json                  (step, treedef, paths, shapes, dtypes)
        arr_00000.npy ...          (one file per leaf)
    <dir>/LATEST                   (atomic pointer file)

Leaves go in JAX's flatten order (dict keys sorted, recursively; a
NamedTuple is saved through ``_asdict``, as the reference's train state
saves its optimizer state) and ``paths`` in ``jax.tree_util.keystr`` form
(``['params']['embed']``), so a directory written by either package
restores in the other: the reference restores with ``like=`` and then never
reads ``treedef``.  The port cannot write JAX's treedef proto, so it writes
that field as an empty string; it rebuilds a tree without ``like`` from
``paths`` (nested dicts).

Atomicity: write to ``.tmp``, fsync the files, rename the directory, then
rewrite LATEST: a crash at any point leaves either the previous or the new
checkpoint valid.  Async: `save` copies the leaves to host memory at once
and writes them on a worker thread, so the train loop does not wait for
the disk.

Checkpoints hold logical (unsharded) arrays, as the reference's.  On a
mesh (DTensor leaves) every rank takes part in `save`: one rank per
distinct shard sends it to rank 0, which alone assembles each full array
and writes it (the other ranks hold nothing beyond their shards); a
blocking save ends with a barrier, so that every rank can read what it
wrote.  `restore` re-shards each leaf onto the caller's mesh, which may
have another shape than the one that saved it (the reference's elastic
restore): each rank reads its own shard of the file (memory-mapped).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import re
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import is_dtensor


def checkpoint_write_s(total_bytes: float, n_devices: float,
                       gbps_per_device: float) -> float:
    """Modeled wall-clock of one checkpoint save.

    Leaves are written in parallel across the fleet (each device owns its
    shard of the logical arrays), so write time is the per-device share
    over the per-device storage bandwidth.  Feeds the goodput objective
    (`repro_torch.core.scenarios`) together with `repro_torch.runtime.
    fault`'s MTBF model.
    """
    return float(total_bytes) / max(float(n_devices), 1.0) \
        / (float(gbps_per_device) * 1e9)


def checkpoint_restore_s(total_bytes: float, n_devices: float,
                         gbps_per_device: float) -> float:
    """Modeled wall-clock of one restore (parallel read, then re-shard)."""
    return float(total_bytes) / max(float(n_devices), 1.0) \
        / (float(gbps_per_device) * 1e9)


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in JAX's flatten order."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in _flatten(tree[key], f"{prefix}[{key!r}]")]
    return [(prefix, tree)]


def _unflatten_like(like: Any, leaves: iter, shardings: Any = None,
                    mesh=None) -> Any:
    """``like``'s structure (dicts and NamedTuples) with ``leaves`` in
    flatten order; each leaf placed on ``like``'s leaf's device, and, on a
    mesh, cut to the rank's shard of the leaf's placements (those of
    ``shardings`` where given, else ``like``'s DTensor's)."""
    if hasattr(like, "_asdict"):
        sub = shardings._asdict() if hasattr(shardings, "_asdict") \
            else shardings
        filled = _unflatten_like(like._asdict(), leaves, sub, mesh)
        return type(like)(**filled)
    if isinstance(like, dict):
        return {key: _unflatten_like(
                    like[key], leaves,
                    shardings[key] if isinstance(shardings, dict) else None,
                    mesh)
                for key in sorted(like)}
    leaf = next(leaves)
    if isinstance(like, torch.Tensor):
        if tuple(leaf.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {tuple(leaf.shape)} does not "
                             f"fit {tuple(like.shape)}")
        placements = shardings
        if placements is None and is_dtensor(like):
            placements, mesh = like.placements, like.device_mesh
        if placements is not None:
            from torch.distributed.tensor import DTensor
            from repro_torch.parallel.sharding import local_box
            box = local_box(tuple(leaf.shape), mesh, placements)
            local = _tensor(leaf[box]).to(mesh.device_type)
            return DTensor.from_local(local, mesh, placements,
                                      run_check=False, shape=leaf.shape,
                                      stride=_strides(leaf.shape))
        return _tensor(leaf).to(like.device)
    return _tensor(leaf)


def _tensor(x: np.ndarray) -> torch.Tensor:
    """A (memory-mapped) array read into a tensor of its own."""
    return torch.from_numpy(np.array(x))


def _strides(shape) -> Tuple[int, ...]:
    out, n = [], 1
    for size in reversed(tuple(shape)):
        out.append(n)
        n *= size
    return tuple(reversed(out))


_PATH_KEY = re.compile(r"\['((?:[^'\\]|\\.)*)'\]")


def _unflatten_paths(paths: List[str], leaves: List[Any]) -> dict:
    """Nested dicts from keystr paths of dict keys."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        keys = _PATH_KEY.findall(path)
        if "".join(f"[{k!r}]" for k in keys) != path or not keys:
            raise ValueError(f"checkpoint path {path!r} is not a path of "
                             f"string dict keys; restore it with like=")
        node = out
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return out


def _to_host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("checkpoint: numpy has no bfloat16; keep master "
                            "weights and optimizer state in float32")
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def _gather_to_host(x: Any) -> Optional[np.ndarray]:
    """A DTensor leaf's full array in rank 0's host memory (None on the
    other ranks).  The rank at coordinate 0 of each mesh dim the leaf is
    replicated over sends its shard to rank 0, so every element crosses
    once and only rank 0 holds the whole."""
    from repro_torch.parallel.sharding import local_box
    mesh, pl = x.device_mesh, x.placements
    local = x.to_local().detach().contiguous()

    def sends(coord):
        return all(c == 0 for c, p in zip(coord, pl) if not p.is_shard())

    if dist.get_rank() != 0:
        if sends(mesh.get_coordinate()) and local.numel():
            dist.send(local, 0)
        return None
    full = torch.empty(tuple(x.shape), dtype=local.dtype,
                       device=local.device)
    ranks = mesh.mesh
    for coord in itertools.product(*map(range, ranks.shape)):
        box = local_box(tuple(x.shape), mesh, pl, coord)
        part = full[box]
        if not sends(coord) or not part.numel():
            continue
        r = int(ranks[coord])
        if r == 0:
            part.copy_(local)
        else:
            buf = torch.empty(part.shape, dtype=local.dtype,
                              device=local.device)
            dist.recv(buf, r)
            part.copy_(buf)
    return _to_host(full)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = True

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, block: bool = False) -> None:
        """Snapshot to host memory synchronously, write asynchronously
        (on a mesh: every rank takes part, rank 0 assembles and writes)."""
        flat = _flatten(tree)
        mesh = any(is_dtensor(leaf) for _, leaf in flat)
        host = [(path, _gather_to_host(leaf) if is_dtensor(leaf)
                 else _to_host(leaf)) for path, leaf in flat]
        self.wait()                       # one in-flight save at a time
        if mesh and dist.get_rank() != 0:
            if block:
                dist.barrier()
            return
        if self.async_save and not block:
            self._pending = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._pending.start()
        else:
            self._write(step, host)
            if mesh:
                dist.barrier()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, host: List[Tuple[str, np.ndarray]]) -> None:
        with self._lock:
            final = os.path.join(self.directory, f"step_{step:09d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            meta = {"step": step,
                    "treedef": "",        # JAX's proto; see the docstring
                    "paths": [path for path, _ in host],
                    "shapes": [list(leaf.shape) for _, leaf in host],
                    "dtypes": [str(leaf.dtype) for _, leaf in host]}
            for i, (_, leaf) in enumerate(host):
                with open(os.path.join(tmp, f"arr_{i:05d}.npy"), "wb") as f:
                    np.save(f, leaf)
                    f.flush()
                    os.fsync(f.fileno())
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)         # atomic publish
            latest_tmp = os.path.join(self.directory, "LATEST.tmp")
            with open(latest_tmp, "w") as f:
                f.write(os.path.basename(final))
                f.flush()
                os.fsync(f.fileno())
            os.rename(latest_tmp, os.path.join(self.directory, "LATEST"))
            self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.directory, "LATEST")
        if os.path.exists(path):
            with open(path) as f:
                name = f.read().strip()
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.isdir(os.path.join(self.directory, name)):
                return int(m.group(1))
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None,
                shardings: Any = None, mesh=None) -> Any:
        """Load a checkpoint as CPU tensors.

        ``like`` (a tree of dicts, NamedTuples and tensors) supplies the
        structure, and each leaf goes to its tensor's device; without it
        the tree is nested dicts rebuilt from the saved paths.  On a mesh
        each leaf becomes a DTensor of the rank's shard: of the placements
        in ``shardings`` (a tree of ``like``'s structure, with ``mesh``)
        where given, else of ``like``'s DTensor leaves; the mesh may have
        another shape than the one that saved."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        leaves = [np.load(os.path.join(d, f"arr_{i:05d}.npy"),
                          mmap_mode="r") for i in range(len(meta["paths"]))]
        if like is None:
            return _unflatten_paths(meta["paths"], map(_tensor, leaves))
        n = len(_flatten(like))
        if n != len(leaves):
            raise ValueError(f"checkpoint step {step} holds {len(leaves)} "
                             f"leaves; like= has {n}")
        return _unflatten_like(like, iter(leaves), shardings, mesh)
