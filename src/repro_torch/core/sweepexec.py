"""JSONL reader/writer shared by the port's streaming record files.

The subset of the reference's executor-service core that the calibration
slice needs (`calibrate.microbench` streams ``measurements.jsonl`` through
it); the chunk journal, spec heads and frontier checkpoints come with the
sweep slice.

  * `iter_jsonl` / `json_safe` / `dump_line` — THE JSONL reader/writer
    pair (blank/torn lines skipped on read, RFC-8259-strict on write).
"""

from __future__ import annotations

import json
import os
from typing import Dict

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
