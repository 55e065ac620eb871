"""Executor-service core of the port's sweep frontends.

The reference's chunk protocol (``repro.core.sweepexec``), line for line:
deterministic enumeration keyed by the spec fingerprint, per-chunk JSONL
commits whose done-line is the single source of truth, and crash-torn-tail
tolerance, so a sweep directory written by either package resumes in the
other.  `calibrate.microbench` streams ``measurements.jsonl`` through the
same reader and writer.

  * `iter_jsonl` / `json_safe` / `dump_line` — THE JSONL reader/writer
    pair (blank/torn lines skipped on read, RFC-8259-strict on write);
  * `ChunkJournal` — append-only results+checkpoint stream for one
    writer: rows first, then the hash-keyed done-line, so a crash can
    only ever leave rows of an *unfinished* chunk behind (`load_done`
    verifies hashes against the current enumeration, `compact` drops
    orphaned rows, `read_records` returns the committed view);
  * spec heads (`write_spec_head` / `load_spec_head` /
    `check_fingerprint`) — the resume identity of a sweep directory.

  * frontier-state checkpoints (`save_frontier_state` /
    `load_frontier_state`) — the carried device-resident Pareto state of
    ``--frontier-only`` sweeps plus the chunks merged into it, in the
    reference's ``frontier_state.npz`` layout.

Nothing here resolves design points: this layer owns *durability*, the
runner owns *evaluation*.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def iter_jsonl(path: str):
    """Parsed records of a JSONL file, skipping blank lines and the
    crash-torn tail line an interrupted writer can leave behind.  THE one
    reader shared by committed-view reads, resume compaction, and
    `load_sweep` — torn-line semantics must not diverge between them."""
    if not os.path.exists(path):
        return
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue


def json_safe(obj):
    """Replace non-finite floats with None so the streamed JSONL stays
    RFC-8259 valid (json.dumps would otherwise emit the non-standard
    ``Infinity`` token for infeasible serving points, which jq /
    JSON.parse / strict parsers reject).  In-memory records keep their
    real inf values; only the serialized form is sanitized."""
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def dump_line(row: Dict) -> str:
    """One JSONL line for a result row: strict dump first (one C-speed
    pass for the overwhelmingly common all-finite record), sanitizing
    fallback for rows carrying inf/nan metrics."""
    try:
        return json.dumps(row, allow_nan=False)
    except ValueError:
        return json.dumps(json_safe(row))


# ---------------------------------------------------------------------------
# Spec heads (the resume identity of a sweep directory)
# ---------------------------------------------------------------------------

def write_spec_head(path: str, version: int, fingerprint: str,
                    spec_dict: Dict) -> None:
    """Atomically (re)write a sweep directory's spec.json head."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"version": version, "fingerprint": fingerprint,
                   "spec": spec_dict}, fh, indent=2)
    os.replace(tmp, path)


def load_spec_head(path: str) -> Dict:
    if not os.path.exists(path):
        raise FileNotFoundError(f"cannot resume: {path} does not exist")
    with open(path) as fh:
        return json.load(fh)


def check_fingerprint(path: str, fingerprint: str) -> Dict:
    """Load a spec head and require its fingerprint to match — a resumed
    or joined execution must present the identical spec."""
    head = load_spec_head(path)
    if head.get("fingerprint") != fingerprint:
        raise ValueError(
            f"cannot resume: sweep spec changed "
            f"(checkpoint {head.get('fingerprint')}, now {fingerprint})")
    return head


# ---------------------------------------------------------------------------
# Chunk journal (results.jsonl + checkpoint.jsonl of ONE writer)
# ---------------------------------------------------------------------------


class ChunkJournal:
    """Append-only results + checkpoint stream for one writer.

    The commit protocol every frontend shares: `append_rows` streams a
    chunk's records (tagged with the chunk index), then `append_done`
    writes the hash-keyed done-line.  Only chunks whose done-line is
    present count as committed — `load_done` hash-verifies them against
    the current enumeration, and `compact` rewrites the results stream
    keeping committed rows only (what resume does with the partial rows a
    crash leaves behind).  Fabric workers keep one journal per worker
    *shard*; the merged view unions the shards' done sets.
    """

    def __init__(self, results_path: str, checkpoint_path: str):
        self.results_path = results_path
        self.checkpoint_path = checkpoint_path
        self._res_fh = None
        self._ckpt_fh = None

    # -- writing ----------------------------------------------------------
    def open(self) -> "ChunkJournal":
        if self._res_fh is None:
            self._res_fh = open(self.results_path, "a")
            self._ckpt_fh = open(self.checkpoint_path, "a")
        return self

    def close(self) -> None:
        if self._res_fh is not None:
            self._res_fh.close()
            self._ckpt_fh.close()
            self._res_fh = self._ckpt_fh = None

    def append_rows(self, chunk_index: int, records: Sequence[Dict]) -> None:
        self.open()
        for rec in records:
            self._res_fh.write(dump_line({"chunk": chunk_index, **rec})
                               + "\n")
        self._res_fh.flush()

    def append_done(self, chunk_index: int, chunk_hash: str,
                    n: int) -> None:
        """The commit point: after this line is durable the chunk is
        finished forever (resume will never re-evaluate it)."""
        self.open()
        self._ckpt_fh.write(json.dumps(
            {"chunk": chunk_index, "hash": chunk_hash, "n": n}) + "\n")
        self._ckpt_fh.flush()

    def commit(self, chunk_index: int, chunk_hash: str,
               records: Sequence[Dict]) -> None:
        self.append_rows(chunk_index, records)
        self.append_done(chunk_index, chunk_hash, len(records))

    # -- reading ----------------------------------------------------------
    def load_done(self, chunks: Sequence, fingerprint: str) -> Dict[int, str]:
        """Finished chunks recorded in this journal, hash-verified against
        the current enumeration (a stale/corrupt line is just treated as
        not-done and re-evaluated)."""
        done: Dict[int, str] = {}
        by_index = {c.index: c for c in chunks}
        for rec in iter_jsonl(self.checkpoint_path):
            c = by_index.get(rec.get("chunk"))
            if c is not None and rec.get("hash") == c.hash(fingerprint):
                done[c.index] = rec["hash"]
        return done

    def compact(self, done: Dict[int, str]) -> None:
        """Drop rows from unfinished chunks (crash between row append and
        done-line append) so resumed output has no duplicates."""
        if not os.path.exists(self.results_path):
            return
        tmp = self.results_path + ".tmp"
        with open(tmp, "w") as dst:
            for rec in iter_jsonl(self.results_path):
                if rec.get("chunk") in done:
                    dst.write(json.dumps(rec) + "\n")
        os.replace(tmp, self.results_path)

    def read_records(self,
                     done: Optional[Dict[int, str]] = None) -> List[Dict]:
        """All streamed records; with ``done`` given, only rows of
        committed chunks (the merged-read equivalent of `compact`)."""
        out = []
        for rec in iter_jsonl(self.results_path):
            if done is None or rec.get("chunk") in done:
                out.append(rec)
        return out


# ---------------------------------------------------------------------------
# Frontier-state checkpoints (carried device-resident Pareto state)
# ---------------------------------------------------------------------------


def save_frontier_state(path: str, state, done: Dict[int, str],
                        capacity: int, fingerprint: str) -> None:
    """Atomically persist a carried frontier state plus the set of merged
    (committed) chunks — THE frontier-mode checkpoint.  Written after
    every committed superbatch, so a SIGKILL loses at most the in-flight
    packs and a resume continues from the merged state with zero
    re-evaluation (the chunked-sweep semantics).  ``state`` is host
    arrays in the reference's dtypes (`pathfinder.frontier_host`)."""
    vals, payload, idx, overflow = state
    order = sorted(done)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, vals=vals, payload=payload, idx=idx,
                 overflow=overflow,
                 done_idx=np.asarray(order, dtype=np.int64),
                 done_hash=np.asarray([done[i] for i in order]),
                 fingerprint=np.asarray(fingerprint),
                 capacity=np.asarray(int(capacity)))
    os.replace(tmp, path)


def load_frontier_state(path: str, fingerprint: str, capacity: int,
                        chunks: Sequence):
    """(carried state, done chunks) of a frontier-state checkpoint.

    Unlike `ChunkJournal.load_done`, a mismatched chunk is fatal rather
    than re-evaluated: its points are already folded into the carried
    state and cannot be dropped again."""
    z = np.load(path)
    if z["fingerprint"].item() != fingerprint:
        raise ValueError("cannot resume: frontier state belongs to a "
                         "different spec fingerprint")
    if int(z["capacity"]) != int(capacity):
        raise ValueError(
            f"cannot resume: frontier capacity changed (checkpoint "
            f"{int(z['capacity'])}, now {capacity}); rerun with the "
            f"original --frontier-capacity")
    by_index = {c.index: c for c in chunks}
    done: Dict[int, str] = {}
    for i, h in zip(z["done_idx"].tolist(), z["done_hash"].tolist()):
        c = by_index.get(int(i))
        if c is None or c.hash(fingerprint) != str(h):
            raise ValueError(
                f"cannot resume: frontier state does not match the "
                f"current enumeration (chunk {i}); merged points "
                f"cannot be un-merged — rerun in a fresh directory")
        done[int(i)] = str(h)
    state = (z["vals"], z["payload"], z["idx"], z["overflow"])
    return state, done
