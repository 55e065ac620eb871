"""Distributed sweep fabric, PyTorch port: lease-based coordinator/worker
execution of the chunk protocol.

The counterpart of ``repro.core.sweepfabric``, with the same directory
layout, lease protocol, shard names and merge, so that workers of either
package join, finish and merge a fabric directory the other started.  The
shared sweep directory is the coordination medium, exactly like a classic
filesystem work queue, and the chunk protocol of
`repro_torch.core.sweepexec` provides the commit semantics (hash-keyed
done-lines as the single source of truth).

Roles:

  * **Coordinator** (`FabricCoordinator`, CLI ``pathfind sweep --workers
    N``): initializes the directory (spec head + fabric.json mode record),
    optionally spawns N local worker processes (``python -m
    repro_torch.pathfind sweep-worker --device D``, each with a CUDA
    context of its own on the coordinator's device), waits for global
    completion, and merges the per-worker shards into the standard
    single-host layout (``results.jsonl``/``checkpoint.jsonl``, or
    ``frontier.jsonl`` + ``frontier_state.npz`` in frontier mode) so every
    downstream consumer (``cooptimize --from``, `load_sweep`, `to_csv`)
    works unchanged.
  * **Workers** (`FabricWorker`, CLI ``pathfind sweep-worker --dir DIR``):
    plain processes — local children or an external preemptible fleet —
    that claim chunk **leases**, evaluate them on the pipelined executor
    on their ``device`` (the card unless the caller asks for ``"cpu"``),
    and stream results into per-worker journal shards.

Directory layout (the reference's): ``spec.json``, ``fabric.json``,
``order.json`` (advisory claim order), ``leases/``, ``shards/`` and
``workers/``.

Lease protocol (``DIR/leases/chunk_<i>.json``):

  * claim   = ``os.open(O_CREAT|O_EXCL)`` — atomic on POSIX, exactly one
    winner; the file holds ``{"worker", "expires"}``;
  * renew   = rewrite via tmp + ``os.replace`` every ttl/3 while the
    holder is alive (the heartbeat);
  * reclaim = when ``expires`` is in the past (or the file is torn and
    old), ``os.rename`` the lease to a per-claimant tombstone — rename
    is atomic, so exactly one thief wins — then claim fresh;
  * leases are **not** released after commit: claiming always checks the
    merged done-set first, so a committed chunk is never claimed again.

Crash safety is layered: the done-line protocol guarantees a chunk is
never *committed* twice even if two workers race on an expired lease
(commit-time ownership verification shrinks the race window; the
deterministic merge-on-read dedupe by chunk closes it), and per-incarnation
worker ids keep a dead worker's torn partial rows in shards whose
checkpoint never references them.  Frontier mode checkpoints each worker's
carried Pareto state per committed superbatch
(``shards/frontier_state.<wid>.npz``, the reference's npz layout) and the
coordinator reduces the shard states with
`pathfinder.frontier_merge_states` — an unbounded, dedup-by-point-index
skyline merge that is exactly commutative/associative/idempotent, so merge
order can never change the global frontier.

Workers install `repro_torch.runtime.fault.PreemptionHandler`: SIGTERM
finishes and commits the in-flight chunk/superbatch, releases unstarted
leases, and exits 0 — preemption costs at most the uncommitted tail.  The
commit callbacks run on the executor's writer and device stages; the
`LostLease` and `Preempted` they raise end the executor's run and reach
`FabricWorker.run` on the worker's own thread.

Fault injection (tests only) is env-driven and one-shot, with the
reference's variable names, so one set of knobs drives workers of either
package: ``REPRO_FABRIC_KILL="<point>:<n>:<token>"`` SIGKILLs the process
at the n-th crossing of injection point ``eval`` (after evaluation, before
any write), ``post_rows`` (between row append and done-line — the
torn-commit window), or ``renew`` (mid-heartbeat, tmp written but not yet
renamed); the token file makes the kill fire once across respawns.
``REPRO_FABRIC_STALL_S`` makes a worker claim its first batch and then
stall without heartbeating — the deliberate lease-expiry victim — and
``REPRO_FABRIC_EVAL_DELAY_S`` overrides ``eval_delay_s``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import signal
import subprocess
import sys
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import sweepexec

DEFAULT_TTL_S = 30.0
DEFAULT_POLL_S = 0.5
FABRIC_VERSION = 1


class LostLease(RuntimeError):
    """A chunk's lease was reclaimed by another worker (we stalled past
    the TTL); the holder must discard uncommitted work and rescan."""


class Preempted(RuntimeError):
    """SIGTERM arrived; in-flight work has been committed — unwind."""


def _paths(out_dir: str) -> Dict[str, str]:
    return {"spec": os.path.join(out_dir, "spec.json"),
            "fabric": os.path.join(out_dir, "fabric.json"),
            "order": os.path.join(out_dir, "order.json"),
            "leases": os.path.join(out_dir, "leases"),
            "shards": os.path.join(out_dir, "shards"),
            "workers": os.path.join(out_dir, "workers")}


# ---------------------------------------------------------------------------
# Advisory chunk order (surrogate-guided lease-queue priority)
# ---------------------------------------------------------------------------


def write_chunk_order(out_dir: str, indices: Sequence[int],
                      fingerprint: str) -> str:
    """Atomically write the directory's advisory claim order.

    ``order.json`` holds acquisition-ranked chunk indices (best first,
    from `surrogate.rank_chunks`) plus the spec fingerprint they were
    computed for.  The order is SCHEDULE-ONLY: workers consult it to
    pick what to claim next, but the lease protocol, done-set, chunk
    hashes and the deterministic first-wins shard merge are untouched —
    an ordered fleet's merged records are identical to an unordered
    fleet's, it just front-loads the frontier-adjacent chunks so a
    preempted fleet's first minutes are spent on the most informative
    points.
    """
    path = _paths(out_dir)["order"]
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"fingerprint": fingerprint,
                   "order": [int(i) for i in indices]}, fh)
    os.replace(tmp, path)
    return path


def load_chunk_order(out_dir: str, fingerprint: str,
                     n_chunks: int) -> Optional[List[int]]:
    """The directory's advisory claim order, or None.

    Defensive by design — the order can only ever *reorder* the scan:
    a missing/corrupt file, a fingerprint from another spec, out-of-range
    or duplicate indices are ignored (never fatal, a worker must not die
    over an advisory hint), and indices the order omits are appended in
    ascending order so every chunk is always reachable.
    """
    path = _paths(out_dir)["order"]
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            payload = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    if payload.get("fingerprint") != fingerprint:
        return None
    seen = set()
    order: List[int] = []
    try:
        raw = [int(i) for i in payload.get("order", [])]
    except (TypeError, ValueError):
        return None
    for i in raw:
        if 0 <= i < n_chunks and i not in seen:
            seen.add(i)
            order.append(i)
    order.extend(i for i in range(n_chunks) if i not in seen)
    return order


def shard_paths(out_dir: str, worker_id: str) -> Dict[str, str]:
    shards = os.path.join(out_dir, "shards")
    return {"results": os.path.join(shards,
                                    f"results.{worker_id}.jsonl"),
            "checkpoint": os.path.join(shards,
                                       f"checkpoint.{worker_id}.jsonl"),
            "frontier": os.path.join(shards,
                                     f"frontier_state.{worker_id}.npz"),
            "stats": os.path.join(out_dir, "workers",
                                  f"stats.{worker_id}.json")}


# ---------------------------------------------------------------------------
# Fault injection (tests/CI)
# ---------------------------------------------------------------------------


class _Injector:
    """One-shot env-driven SIGKILL at a named injection point."""

    def __init__(self):
        spec = os.environ.get("REPRO_FABRIC_KILL", "")
        self.point = self.token = None
        self.n = 0
        self._count: Dict[str, int] = {}
        if spec:
            point, n, token = spec.split(":", 2)
            self.point, self.n, self.token = point, int(n), token

    def fire(self, point: str) -> None:
        if self.point != point:
            return
        self._count[point] = self._count.get(point, 0) + 1
        if self._count[point] == self.n and not os.path.exists(self.token):
            with open(self.token, "w") as fh:
                fh.write(f"{point}:{os.getpid()}\n")
            os.kill(os.getpid(), signal.SIGKILL)


def _process_age_s() -> Optional[float]:
    """Seconds since this process started (its start time in
    ``/proc/self/stat``, in clock ticks since boot), or None where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rpartition(")")[2].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return None
    return age if age >= 0.0 else None


# ---------------------------------------------------------------------------
# Lease manager
# ---------------------------------------------------------------------------


class LeaseManager:
    """Atomic per-chunk lease files with TTL + heartbeat renewal.

    Wall-clock (`time.time`) expiry: every party lives on the same
    filesystem host-set, and the TTL (default 30 s) dwarfs realistic
    clock skew; a wrongly-stolen lease degrades to the LostLease path,
    never to a double commit.
    """

    def __init__(self, out_dir: str, worker: str,
                 ttl_s: float = DEFAULT_TTL_S,
                 injector: Optional[_Injector] = None):
        self.dir = _paths(out_dir)["leases"]
        self.worker = worker
        self.ttl_s = float(ttl_s)
        self._inj = injector or _Injector()
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, index: int) -> str:
        return os.path.join(self.dir, f"chunk_{index}.json")

    def _read(self, path: str) -> Optional[Dict]:
        try:
            with open(path) as fh:
                return json.load(fh)
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, OSError):
            return {}                      # torn write — content unusable

    def _expired(self, path: str) -> bool:
        rec = self._read(path)
        if rec is None:
            return False                   # vanished: not ours to steal
        if "expires" in rec:
            return float(rec["expires"]) < time.time()
        # torn lease: no readable expiry — fall back to file age
        try:
            return os.path.getmtime(path) + self.ttl_s < time.time()
        except OSError:
            return False

    def _create(self, index: int) -> bool:
        try:
            fd = os.open(self._path(index),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as fh:
            json.dump({"worker": self.worker,
                       "expires": time.time() + self.ttl_s}, fh)
        return True

    def claim(self, index: int) -> bool:
        """Claim an unleased chunk (O_CREAT|O_EXCL — exactly one winner);
        False when a lease file exists, expired or not: stealing is the
        separate, deliberate `steal_expired` step."""
        return self._create(index)

    def steal_expired(self, index: int) -> bool:
        """Reclaim an expired lease: atomic rename to a per-claimant
        tombstone (exactly one thief wins the rename), then claim
        fresh."""
        path = self._path(index)
        if not self._expired(path):
            return False
        tomb = os.path.join(
            self.dir, f"tomb.{index}.{self.worker}.{uuid.uuid4().hex[:6]}")
        try:
            os.rename(path, tomb)
        except FileNotFoundError:
            pass                           # another thief won the rename
        else:
            try:
                os.unlink(tomb)
            except OSError:
                pass
        return self._create(index)

    def owns(self, index: int) -> bool:
        rec = self._read(self._path(index))
        return bool(rec) and rec.get("worker") == self.worker

    def renew(self, indices: Sequence[int]) -> List[int]:
        """Heartbeat: push the expiry of every held lease forward.
        Returns the indices whose lease we no longer own (stolen)."""
        lost: List[int] = []
        for i in indices:
            path = self._path(i)
            rec = self._read(path)
            if not rec or rec.get("worker") != self.worker:
                lost.append(i)
                continue
            tmp = f"{path}.{self.worker}.tmp"
            with open(tmp, "w") as fh:
                json.dump({"worker": self.worker,
                           "expires": time.time() + self.ttl_s}, fh)
            self._inj.fire("renew")        # kill-matrix: mid-renewal
            os.replace(tmp, path)
        return lost

    def release(self, index: int) -> None:
        """Drop a lease we still hold (uncommitted work being abandoned:
        preemption exit or a LostLease rescan)."""
        if self.owns(index):
            try:
                os.unlink(self._path(index))
            except FileNotFoundError:
                pass

    def holder(self, index: int) -> Optional[str]:
        rec = self._read(self._path(index))
        return rec.get("worker") if rec else None


# ---------------------------------------------------------------------------
# Directory initialization + merged views
# ---------------------------------------------------------------------------


def init_dir(spec, out_dir: str, frontier_only: bool = False,
             frontier_capacity: Optional[int] = None) -> Dict:
    """Create (or join) a fabric sweep directory.

    Writes the standard spec head plus ``fabric.json`` recording the
    execution mode — workers read the mode from the directory, so a fleet
    can never disagree about what it is computing.  Joining an existing
    directory verifies both.
    """
    from repro_torch.core import pathfinder, sweeprunner
    p = _paths(out_dir)
    fp = spec.fingerprint()
    capacity = int(frontier_capacity or pathfinder.FRONTIER_CAPACITY)
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(p["leases"], exist_ok=True)
    os.makedirs(p["shards"], exist_ok=True)
    os.makedirs(p["workers"], exist_ok=True)
    head = {"mode": "frontier" if frontier_only else "full",
            "capacity": capacity, "version": FABRIC_VERSION}
    if os.path.exists(p["spec"]):
        sweepexec.check_fingerprint(p["spec"], fp)
    else:
        sweepexec.write_spec_head(p["spec"], sweeprunner.SPEC_VERSION, fp,
                                  spec.to_dict())
    if os.path.exists(p["fabric"]):
        with open(p["fabric"]) as fh:
            existing = json.load(fh)
        if existing.get("mode") != head["mode"] \
                or int(existing.get("capacity", 0)) != capacity:
            raise ValueError(
                f"fabric directory {out_dir} was initialized as "
                f"mode={existing.get('mode')}/capacity="
                f"{existing.get('capacity')}; rerun with matching flags "
                f"or use a fresh directory")
        head = existing
    else:
        tmp = p["fabric"] + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(head, fh, indent=2)
        os.replace(tmp, p["fabric"])
    return head


def load_dir(out_dir: str):
    """(spec, fabric head) of an initialized fabric directory."""
    from repro_torch.core import sweeprunner
    p = _paths(out_dir)
    head = sweepexec.load_spec_head(p["spec"])
    spec = sweeprunner.SweepSpec.from_dict(head["spec"])
    with open(p["fabric"]) as fh:
        fabric = json.load(fh)
    return spec, fabric


def _shard_journals(out_dir: str) -> List[sweepexec.ChunkJournal]:
    """One journal per worker shard, in sorted (deterministic) order —
    the order is the dedupe tie-break, so it must never depend on
    directory enumeration order."""
    shards = _paths(out_dir)["shards"]
    out = []
    for ckpt in sorted(glob.glob(os.path.join(shards,
                                              "checkpoint.*.jsonl"))):
        wid = os.path.basename(ckpt)[len("checkpoint."):-len(".jsonl")]
        out.append(sweepexec.ChunkJournal(
            os.path.join(shards, f"results.{wid}.jsonl"), ckpt))
    return out


def global_done(out_dir: str, chunks: Sequence,
                fingerprint: str) -> Dict[int, str]:
    """Union of committed chunks across every worker shard — the claim
    check, and the completion predicate."""
    done: Dict[int, str] = {}
    for j in _shard_journals(out_dir):
        done.update(j.load_done(chunks, fingerprint))
    return done


def _frontier_shards(out_dir: str) -> List[str]:
    shards = _paths(out_dir)["shards"]
    return sorted(glob.glob(os.path.join(shards, "frontier_state.*.npz")))


def global_frontier_done(out_dir: str, chunks: Sequence, fingerprint: str,
                         capacity: int) -> Dict[int, str]:
    """Union of chunks merged into any worker's checkpointed frontier
    state (frontier mode's completion predicate)."""
    done: Dict[int, str] = {}
    for path in _frontier_shards(out_dir):
        _, d = sweepexec.load_frontier_state(path, fingerprint, capacity,
                                             chunks)
        done.update(d)
    return done


def merge_results(out_dir: str) -> Tuple[List[Dict], Dict[int, str]]:
    """Merge worker shards into top-level ``results.jsonl`` +
    ``checkpoint.jsonl`` (the single-host layout).

    Dedupe is by chunk with first-wins over the sorted shard order: even
    if an expired-lease race ever let two workers commit the same chunk,
    exactly one copy survives, deterministically.  Returns the merged
    records (without their chunk tags) and the global done-map.
    """
    from repro_torch.core import sweeprunner
    spec, _ = load_dir(out_dir)
    fp = spec.fingerprint()
    chunks = sweeprunner.make_chunks(sweeprunner.enumerate_labels(spec),
                                     spec.chunk_size)
    journals = _shard_journals(out_dir)
    winner: Dict[int, sweepexec.ChunkJournal] = {}
    for j in journals:
        for i in j.load_done(chunks, fp):
            winner.setdefault(i, j)
    rows_by_chunk: Dict[int, List[Dict]] = {i: [] for i in winner}
    for j in journals:
        mine = {i for i, w in winner.items() if w is j}
        if not mine:
            continue
        for rec in sweepexec.iter_jsonl(j.results_path):
            if rec.get("chunk") in mine:
                rows_by_chunk[rec["chunk"]].append(rec)
    res_path = os.path.join(out_dir, "results.jsonl")
    ckpt_path = os.path.join(out_dir, "checkpoint.jsonl")
    records: List[Dict] = []
    with open(res_path + ".tmp", "w") as res, \
            open(ckpt_path + ".tmp", "w") as ckpt:
        for i in sorted(winner):
            for rec in rows_by_chunk[i]:
                res.write(sweepexec.dump_line(rec) + "\n")
                records.append({k: v for k, v in rec.items()
                                if k != "chunk"})
            ckpt.write(json.dumps(
                {"chunk": i, "hash": chunks[i].hash(fp),
                 "n": len(rows_by_chunk[i])}) + "\n")
    os.replace(res_path + ".tmp", res_path)
    os.replace(ckpt_path + ".tmp", ckpt_path)
    done = {i: chunks[i].hash(fp) for i in winner}
    return records, done


def merge_frontier(out_dir: str, device=None
                   ) -> Tuple[List[Dict], int, Dict[int, str]]:
    """Reduce every worker's checkpointed frontier state into the global
    frontier: ``(records, n_overflowed, done)``.

    The reduction is `pathfinder.frontier_merge_states` — unbounded,
    deduped by global point index, exactly order-independent — so shard
    enumeration order cannot change the result.  Writes ``frontier.jsonl``
    and a merged ``frontier_state.npz`` at the top level.  The records are
    rebuilt from the states' payload rows by an executor on ``device``
    (the card unless the caller asks for ``"cpu"``); nothing is evaluated.
    """
    from repro_torch.core import pathfinder, sweeppipeline, sweeprunner
    spec, fabric = load_dir(out_dir)
    fp = spec.fingerprint()
    capacity = int(fabric["capacity"])
    chunks = sweeprunner.make_chunks(sweeprunner.enumerate_labels(spec),
                                     spec.chunk_size)
    state = None
    done: Dict[int, str] = {}
    for path in _frontier_shards(out_dir):
        s, d = sweepexec.load_frontier_state(path, fp, capacity, chunks)
        done.update(d)
        state = s if state is None \
            else pathfinder.frontier_merge_states(state, s)
    if state is None:
        return [], 0, {}
    ex = sweeppipeline.PipelineExecutor(spec, cache=None, device=device)
    records, n_over = ex.frontier_records(state, chunks)
    front_path = os.path.join(out_dir, "frontier.jsonl")
    with open(front_path + ".tmp", "w") as fh:
        for rec in records:
            fh.write(json.dumps(sweepexec.json_safe(rec)) + "\n")
    os.replace(front_path + ".tmp", front_path)
    sweepexec.save_frontier_state(
        os.path.join(out_dir, "frontier_state.npz"), state, done,
        capacity, fp)
    return records, n_over, done


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WorkerStats:
    """Summary of one worker incarnation (also journaled, per commit, to
    ``workers/stats.<wid>.json`` so the fault-injection suite can assert
    zero re-evaluation of committed chunks across the whole fleet)."""

    worker: str
    n_chunks_committed: int = 0
    n_points: int = 0
    n_lost_leases: int = 0
    preempted: bool = False
    elapsed_s: float = 0.0
    # per-incarnation compile observability (deltas of
    # pathfinder.compile_cache_stats over this worker's lifetime: the
    # designs' host traces when bucketing, and the part that stalled)
    compile_seconds: float = 0.0
    stall_seconds: float = 0.0
    # seconds from the process's start until its device was ready (the
    # interpreter, the torch import, the CUDA context); None where the
    # process's start time cannot be read
    startup_s: Optional[float] = None


class FabricWorker:
    """One lease-claiming executor process over a fabric directory, its
    evaluations on ``device`` (the card unless the caller asks for
    ``"cpu"``; a missing card raises here, before any lease is taken)."""

    def __init__(self, out_dir: str, worker_id: Optional[str] = None,
                 ttl_s: float = DEFAULT_TTL_S,
                 poll_s: float = DEFAULT_POLL_S,
                 claim_batch: Optional[int] = None,
                 superbatch: Optional[int] = None,
                 eval_delay_s: float = 0.0,
                 max_chunks: Optional[int] = None,
                 compile_ahead: Optional[int] = None,
                 bucketing: Optional[bool] = None,
                 on_idle: Optional[Callable[[], None]] = None,
                 device=None):
        from repro_torch import resolve_device
        from repro_torch.core import pathfinder, sweeprunner
        self.device = resolve_device(device)
        self.out_dir = out_dir
        self.spec, self.fabric = load_dir(out_dir)
        self.mode = self.fabric["mode"]
        self.capacity = int(self.fabric["capacity"])
        # unique id per process incarnation: a respawned worker writes a
        # FRESH shard, so a dead incarnation's torn rows sit in a shard
        # whose checkpoint never references them
        self.worker_id = worker_id or \
            f"w{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self.ttl_s = float(ttl_s)
        self.poll_s = float(poll_s)
        self.superbatch = superbatch
        self.claim_batch = claim_batch or max(
            1, (superbatch or 256) // max(1, self.spec.chunk_size))
        self.eval_delay_s = float(
            os.environ.get("REPRO_FABRIC_EVAL_DELAY_S", eval_delay_s))
        self.stall_s = float(os.environ.get("REPRO_FABRIC_STALL_S", 0.0))
        self.max_chunks = max_chunks
        # execution-only dispatch knobs (inherited by the process-global
        # compile-ahead service); no effect on chunk hashes or commits
        self.compile_ahead = compile_ahead
        self.bucketing = bucketing
        self._compile_base = pathfinder.compile_cache_stats()
        self.on_idle = on_idle
        self._inj = _Injector()
        self._fp = self.spec.fingerprint()
        self._chunks = sweeprunner.make_chunks(
            sweeprunner.enumerate_labels(self.spec), self.spec.chunk_size)
        # advisory surrogate work order (DIR/order.json): claims are
        # attempted acquisition-first when present and fingerprint-matched;
        # chunk identities and the commit protocol are untouched, so the
        # order can only change the schedule, never the merged results
        order = load_chunk_order(out_dir, self._fp, len(self._chunks))
        self._scan = [self._chunks[i] for i in order] \
            if order is not None else self._chunks
        self._sp = shard_paths(out_dir, self.worker_id)
        self._lease = LeaseManager(out_dir, self.worker_id, ttl_s,
                                   injector=self._inj)
        self._journal = sweepexec.ChunkJournal(self._sp["results"],
                                               self._sp["checkpoint"])
        self._evaluated: List[Tuple[int, float]] = []
        self._committed: List[Tuple[int, float]] = []
        self._last_renew = time.time()
        self._stalled_once = False

    # -- bookkeeping ------------------------------------------------------
    def _write_stats(self, stats: WorkerStats) -> None:
        from repro_torch.core import pathfinder
        now = pathfinder.compile_cache_stats()
        stats.compile_seconds = now.get("compile_seconds", 0.0) - \
            self._compile_base.get("compile_seconds", 0.0)
        stats.stall_seconds = now.get("stall_seconds", 0.0) - \
            self._compile_base.get("stall_seconds", 0.0)
        tmp = self._sp["stats"] + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({**dataclasses.asdict(stats), "pid": os.getpid(),
                       "mode": self.mode, "device": str(self.device),
                       "evaluated": self._evaluated,
                       "committed": self._committed}, fh)
        os.replace(tmp, self._sp["stats"])

    def _global_done(self) -> Dict[int, str]:
        if self.mode == "frontier":
            return global_frontier_done(self.out_dir, self._chunks,
                                        self._fp, self.capacity)
        return global_done(self.out_dir, self._chunks, self._fp)

    def _heartbeat(self, held: Sequence[int]) -> None:
        if time.time() - self._last_renew < self.ttl_s / 3:
            return
        lost = self._lease.renew(held)
        self._last_renew = time.time()
        if lost:
            raise LostLease(f"leases stolen for chunks {sorted(lost)}")

    def _claim(self, done: Dict[int, str]) -> List:
        """Claim up to claim_batch pending chunks, in scan order: the
        advisory ``order.json`` ranking when present, else lowest index
        first (the reference's order, so a mixed fleet scans alike).

        Stealing an expired lease re-checks the merged done-set right
        before and after the steal: the previous holder may have
        committed the chunk moments ago (leases are deliberately not
        released after commit), and a stale ``done`` snapshot must not
        turn that into a re-evaluation.
        """
        claimed = []
        fresh_done: Optional[Dict[int, str]] = None
        for c in self._scan:
            if len(claimed) >= self.claim_batch:
                break
            if c.index in done:
                continue
            if self._lease.claim(c.index):
                claimed.append(c)
                continue
            # lease file exists — a steal candidate only if expired
            if fresh_done is None:
                fresh_done = self._global_done()
            if c.index in fresh_done:
                continue
            if self._lease.steal_expired(c.index):
                # the holder may have committed between our done-scan and
                # the rename — verify, and stand down if so
                fresh_done = self._global_done()
                if c.index in fresh_done:
                    self._lease.release(c.index)
                else:
                    claimed.append(c)
        if claimed and self.stall_s and not self._stalled_once:
            # deliberate lease-expiry victim: hold the claims without
            # heartbeating, long past the TTL
            self._stalled_once = True
            time.sleep(self.stall_s)
        return claimed

    def _release(self, chunks: Sequence) -> None:
        for c in chunks:
            self._lease.release(c.index)

    # -- main loop --------------------------------------------------------
    def run(self) -> WorkerStats:
        import torch

        from repro_torch.core import sweeppipeline
        from repro_torch.runtime import fault
        handler = fault.PreemptionHandler(on_preempt=lambda: print(
            f"# worker {self.worker_id}: preemption notice — committing "
            f"in-flight work, then exiting", file=sys.stderr, flush=True))
        ex = sweeppipeline.PipelineExecutor(
            self.spec, cache=None,
            superbatch=self.superbatch or sweeppipeline.SUPERBATCH,
            compile_ahead=self.compile_ahead, bucketing=self.bucketing,
            device=self.device)
        if self.device.type == "cuda":      # the CUDA context, made now
            torch.empty(1, device=self.device)
            torch.cuda.synchronize(self.device)
        stats = WorkerStats(worker=self.worker_id,
                            startup_s=_process_age_s())
        t0 = time.perf_counter()
        self._write_stats(stats)
        n_run = 0
        try:
            while True:
                done = self._global_done()
                if len(done) == len(self._chunks):
                    break
                if handler.preempted:
                    stats.preempted = True
                    break
                if self.max_chunks is not None \
                        and n_run >= self.max_chunks:
                    break
                claimed = self._claim(done)
                if not claimed:
                    if self.on_idle is not None:
                        self.on_idle()
                    time.sleep(self.poll_s)
                    continue
                try:
                    if self.mode == "frontier":
                        n_run += self._run_frontier_batch(
                            ex, claimed, stats, handler)
                    else:
                        n_run += self._run_full_batch(
                            ex, claimed, stats, handler)
                except LostLease:
                    stats.n_lost_leases += 1
                    self._release(claimed)
                    self._write_stats(stats)
                except Preempted:
                    stats.preempted = True
                    self._release(claimed)
                    break
        finally:
            self._journal.close()
            stats.elapsed_s = time.perf_counter() - t0
            self._write_stats(stats)
        return stats

    def _preflight(self, claimed: Sequence) -> None:
        """Verify-and-extend every claimed lease before evaluation starts:
        a worker that stalled past its TTL (or is about to pay a long cold
        compile) finds out NOW, not after burning the batch's compute."""
        lost = self._lease.renew([c.index for c in claimed])
        self._last_renew = time.time()
        if lost:
            raise LostLease(f"leases stolen before evaluation: "
                            f"{sorted(lost)}")

    def _run_full_batch(self, ex, claimed: List, stats: WorkerStats,
                        handler) -> int:
        self._preflight(claimed)
        committed: List = []

        def commit(chunk, records):
            self._inj.fire("eval")         # kill-matrix: mid-chunk
            self._evaluated.append((chunk.index, time.time()))
            if self.eval_delay_s:
                time.sleep(self.eval_delay_s)
            if not self._lease.owns(chunk.index):
                raise LostLease(f"chunk {chunk.index} lease stolen")
            self._journal.append_rows(chunk.index, records)
            self._inj.fire("post_rows")    # kill-matrix: torn commit
            self._journal.append_done(chunk.index,
                                      chunk.hash(self._fp), len(records))
            committed.append(chunk)
            stats.n_chunks_committed += 1
            stats.n_points += len(records)
            self._committed.append((chunk.index, time.time()))
            self._write_stats(stats)
            held = [c.index for c in claimed if c not in committed]
            self._heartbeat(held)
            if handler.preempted:
                # the chunk just committed; release what we haven't
                # started and exit — preemption costs zero finished work
                raise Preempted()

        try:
            ex.run(claimed, commit)
        except (LostLease, Preempted):
            for c in claimed:
                if c not in committed:
                    self._lease.release(c.index)
            raise
        return len(committed)

    def _run_frontier_batch(self, ex, claimed: List, stats: WorkerStats,
                            handler) -> int:
        """One claim batch through the device-resident frontier, carrying
        this incarnation's state across batches via its shard checkpoint
        (merged points cannot be un-merged, so the checkpoint — not
        memory — is the authority after any fault)."""
        self._preflight(claimed)
        state0, own_done = None, {}
        if os.path.exists(self._sp["frontier"]):
            state0, own_done = sweepexec.load_frontier_state(
                self._sp["frontier"], self._fp, self.capacity,
                self._chunks)
        n_batch = [0]

        def on_commit(indices, host_state):
            self._inj.fire("eval")
            now = time.time()
            self._evaluated.extend((i, now) for i in indices)
            if self.eval_delay_s:
                time.sleep(self.eval_delay_s * len(indices))
            lost = [i for i in indices if not self._lease.owns(i)]
            if lost:
                raise LostLease(f"chunks {lost} leases stolen")
            self._inj.fire("post_rows")    # pre-checkpoint window
            own_done.update(
                {i: self._chunks[i].hash(self._fp) for i in indices})
            sweepexec.save_frontier_state(
                self._sp["frontier"], host_state, own_done,
                self.capacity, self._fp)
            n_batch[0] += len(indices)
            stats.n_chunks_committed += len(indices)
            stats.n_points += sum(len(self._chunks[i].labels)
                                  for i in indices)
            now = time.time()
            self._committed.extend((i, now) for i in indices)
            self._write_stats(stats)
            held = [c.index for c in claimed
                    if c.index not in own_done]
            self._heartbeat(held)
            if handler.preempted:
                raise Preempted()

        try:
            ex.run_frontier(claimed, capacity=self.capacity, state=state0,
                            on_commit=on_commit, all_chunks=self._chunks)
        except (LostLease, Preempted):
            for c in claimed:
                if c.index not in own_done:
                    self._lease.release(c.index)
            raise
        return n_batch[0]


# ---------------------------------------------------------------------------
# Coordinator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FabricStats:
    """Coordinator-side summary of a fabric run (mirrors the fields the
    CLI prints for `sweeprunner.RunStats`)."""

    n_points_total: int
    n_chunks_total: int
    n_chunks_committed: int
    n_workers: int
    n_worker_exits: Dict[str, int]
    elapsed_s: float
    out_dir: str
    mode: str
    records: Optional[List[Dict]] = None
    n_frontier_overflowed: int = 0

    @property
    def complete(self) -> bool:
        return self.n_chunks_committed == self.n_chunks_total


class FabricCoordinator:
    """Initialize a fabric directory, (optionally) spawn local workers,
    wait for global completion, merge shards.

    The coordinator holds no execution state: killing and rerunning it —
    or running several — is always safe, because the directory is the
    only authority.  ``workers=0`` initializes and waits for an external
    fleet (``pathfind sweep-worker --dir DIR`` on any host sharing the
    filesystem, of either package).  Each local worker is a process of its
    own on ``device`` (the card unless the caller asks for ``"cpu"``), as
    is the merge of a frontier-mode directory; a missing card raises here,
    before any worker starts.
    """

    def __init__(self, spec, out_dir: str, workers: int = 2,
                 ttl_s: float = DEFAULT_TTL_S,
                 poll_s: float = DEFAULT_POLL_S,
                 frontier_only: bool = False,
                 frontier_capacity: Optional[int] = None,
                 superbatch: Optional[int] = None,
                 claim_batch: Optional[int] = None,
                 compile_ahead: Optional[int] = None,
                 bucketing: Optional[bool] = None,
                 eval_delay_s: float = 0.0,
                 max_respawns: int = 0,
                 worker_env: Optional[Dict[str, str]] = None,
                 chunk_order: Optional[Sequence[int]] = None,
                 verbose: bool = False, device=None):
        from repro_torch import resolve_device
        self.device = resolve_device(device)
        self.spec = spec
        self.out_dir = out_dir
        self.workers = int(workers)
        self.ttl_s = ttl_s
        self.poll_s = poll_s
        self.frontier_only = frontier_only
        self.frontier_capacity = frontier_capacity
        self.superbatch = superbatch
        self.claim_batch = claim_batch
        self.compile_ahead = compile_ahead
        self.bucketing = bucketing
        self.eval_delay_s = eval_delay_s
        self.max_respawns = max_respawns
        self.worker_env = worker_env
        # advisory work order (surrogate.rank_chunks output): written to
        # DIR/order.json before the fleet spawns; schedule-only
        self.chunk_order = chunk_order
        self.verbose = verbose

    def worker_cmd(self) -> List[str]:
        cmd = [sys.executable, "-m", "repro_torch.pathfind", "sweep-worker",
               "--dir", self.out_dir, "--ttl", str(self.ttl_s),
               "--poll", str(self.poll_s), "--device", str(self.device)]
        if self.superbatch is not None:
            cmd += ["--superbatch", str(self.superbatch)]
        if self.claim_batch is not None:
            cmd += ["--claim-batch", str(self.claim_batch)]
        if self.compile_ahead is not None:
            cmd += ["--compile-ahead", str(self.compile_ahead)]
        # the port does not bucket unless asked (the reference's default is
        # the opposite): pass the choice on either way
        if self.bucketing is not None:
            cmd += ["--bucketing" if self.bucketing else "--no-bucketing"]
        if self.eval_delay_s:
            cmd += ["--eval-delay", str(self.eval_delay_s)]
        return cmd

    def _spawn(self) -> subprocess.Popen:
        env = dict(os.environ)
        # a worker imports the package this coordinator runs
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH", "")) if p)
        if self.worker_env:
            env.update(self.worker_env)
        return subprocess.Popen(self.worker_cmd(), env=env)

    def run(self) -> FabricStats:
        from repro_torch.core import sweeprunner
        t0 = time.perf_counter()
        init_dir(self.spec, self.out_dir,
                 frontier_only=self.frontier_only,
                 frontier_capacity=self.frontier_capacity)
        fp = self.spec.fingerprint()
        if self.chunk_order is not None:
            write_chunk_order(self.out_dir, self.chunk_order, fp)
        chunks = sweeprunner.make_chunks(
            sweeprunner.enumerate_labels(self.spec), self.spec.chunk_size)
        if self.frontier_only:
            _, fabric = load_dir(self.out_dir)

            def done_now():
                return global_frontier_done(self.out_dir, chunks, fp,
                                            int(fabric["capacity"]))
        else:
            def done_now():
                return global_done(self.out_dir, chunks, fp)

        procs = [self._spawn() for _ in range(self.workers)]
        exits: Dict[str, int] = {}
        respawns = 0
        try:
            while True:
                done = done_now()
                if self.verbose:
                    print(f"# fabric: {len(done)}/{len(chunks)} chunks "
                          f"committed", flush=True)
                if len(done) == len(chunks):
                    break
                live = []
                for pr in procs:
                    rc = pr.poll()
                    if rc is None:
                        live.append(pr)
                        continue
                    exits[str(pr.pid)] = rc
                    if respawns < self.max_respawns:
                        respawns += 1
                        live.append(self._spawn())
                procs = live
                if not procs and self.workers > 0:
                    done = done_now()
                    if len(done) == len(chunks):
                        break
                    raise RuntimeError(
                        f"all fabric workers exited with "
                        f"{len(chunks) - len(done)} chunks uncommitted "
                        f"(exit codes {exits}); rerun to resume — "
                        f"committed work is preserved")
                time.sleep(self.poll_s)
            # completion: workers exit on their own once the global
            # done-set covers the enumeration
            for pr in procs:
                pr.wait(timeout=max(60.0, 4 * self.ttl_s))
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.terminate()
        n_over = 0
        if self.frontier_only:
            records, n_over, done = merge_frontier(self.out_dir,
                                                   device=self.device)
        else:
            records, done = merge_results(self.out_dir)
        return FabricStats(
            n_points_total=sum(len(c.labels) for c in chunks),
            n_chunks_total=len(chunks), n_chunks_committed=len(done),
            n_workers=self.workers, n_worker_exits=exits,
            elapsed_s=time.perf_counter() - t0, out_dir=self.out_dir,
            mode="frontier" if self.frontier_only else "full",
            records=records, n_frontier_overflowed=n_over)


__all__ = [
    "DEFAULT_POLL_S", "DEFAULT_TTL_S", "FabricCoordinator",
    "FabricStats", "FabricWorker", "LeaseManager", "LostLease",
    "Preempted", "WorkerStats", "global_done", "global_frontier_done",
    "init_dir", "load_chunk_order", "load_dir", "merge_frontier",
    "merge_results", "shard_paths", "write_chunk_order",
]
