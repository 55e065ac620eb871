"""The port's compiled-function store and compile-ahead service, on the
CPU: ``tests/test_compileahead.py``'s store and service tests, ported.

Pin-aware eviction (a key pinned is never dropped; a design the service
queued is kept between its trace and its first dispatch), the store's
size setter, the service's dedupe per (key, signature), the compile and stall seconds (in
the port a design's trace is its compile), and a resumed sweep that does
not depend on bucketing or compile-ahead, with the CLI's compile line.
"""

import collections
import itertools
import json

import numpy as np
import pytest
import torch

from repro_torch import pathfind
from repro_torch.core import compileahead, pathfinder, sweeprunner

SPEC = dict(arches=("qwen1.5-0.5b",), mesh_shapes=((2, 2), (4, 4)),
            scenario="train", logic_nodes=("N7", "N5"),
            budget_scales=(0.9, 1.0, 1.1), n_tilings=4, chunk_size=4)
_UNIQ = itertools.count()


def _ukey(tag: str) -> tuple:
    return ("test-torch-compileahead", tag, next(_UNIQ))


def _build(n: float):
    return lambda: (lambda x: x * n)


def _scalar(c: float):
    """A design function: sibling designs of one bucket differ in ``c``."""
    def scalar(x):
        return (x * c + 1.0).sum() * torch.ones(3)
    return lambda: scalar


SCALAR_SPEC = (pathfinder.TensorSpec((4,)),)


@pytest.fixture
def small_store():
    """The store emptied and shrunk to two entries, restored after."""
    saved = collections.OrderedDict(pathfinder._COMPILED)
    prev = pathfinder.compiled_maxsize()
    pathfinder._COMPILED.clear()
    try:
        pathfinder.set_compiled_maxsize(2)
        yield
    finally:
        pathfinder.set_compiled_maxsize(prev)
        pathfinder._COMPILED.clear()
        pathfinder._COMPILED.update(saved)


def test_set_compiled_maxsize_validates_and_returns_previous():
    prev = pathfinder.compiled_maxsize()
    for bad in (0, -3):
        with pytest.raises(ValueError, match="positive"):
            pathfinder.set_compiled_maxsize(bad)
    assert pathfinder.compiled_maxsize() == prev
    assert pathfinder.set_compiled_maxsize(prev + 1) == prev
    assert pathfinder.set_compiled_maxsize(prev) == prev + 1
    s0 = pathfinder.compile_cache_stats()
    assert {"hits", "misses", "compile_seconds", "stall_seconds"} <= set(s0)
    key = _ukey("count")
    pathfinder.compiled_entry(key, _build(1.0))
    pathfinder.compiled_entry(key, _build(1.0))
    s1 = pathfinder.compile_cache_stats()
    assert (s1["misses"] - s0["misses"], s1["hits"] - s0["hits"]) == (1, 1)


def test_eviction_never_pops_pinned_entries_maxsize2(small_store):
    keep = _ukey("keep")
    pathfinder.compiled_entry(keep, _build(1.0))
    pathfinder.pin_compiled(keep)
    for i in range(5):
        pathfinder.compiled_entry(_ukey("filler"), _build(float(i)))
    assert keep in pathfinder._COMPILED, "a pinned entry was evicted"
    pathfinder.unpin_compiled(keep)
    pathfinder.compiled_entry(_ukey("filler"), _build(9.0))
    assert keep not in pathfinder._COMPILED
    assert len(pathfinder._COMPILED) <= 2


def test_service_warm_protects_until_first_dispatch_and_dedupes(
        monkeypatch):
    """A design warmed through the service is traced off the caller's
    path and survives the design registry's pressure until its pin is
    released; a (key, signature) queued, in flight or done is not
    submitted again."""
    svc = compileahead.service()
    monkeypatch.setattr(compileahead, "_DESIGNS_MAXSIZE", 1)
    dkey = _ukey("design")
    s0 = compileahead.bucket_stats()
    try:
        assert svc.warm_design(dkey, _scalar(2.0), SCALAR_SPEC,
                               device="cpu") is True
        assert pathfinder.is_pinned(dkey)
        assert svc.drain(timeout=120.0)
        assert compileahead.bucket_stats()["designs_traced"] == \
            s0["designs_traced"] + 1
        assert svc.warm_design(dkey, _scalar(2.0), SCALAR_SPEC,
                               device="cpu") is False
        compileahead.design_vector(_ukey("other"), _scalar(3.0),
                                   SCALAR_SPEC, "cpu")
        assert dkey in compileahead._DESIGNS
        fn = compileahead.design_batch_fn(dkey, _scalar(2.0), SCALAR_SPEC,
                                          "cpu")
        np.testing.assert_allclose(fn(torch.ones(2, 4)).numpy(),
                                   np.full((2, 3), 12.0), rtol=1e-6)
    finally:
        pathfinder.unpin_compiled(dkey)
    assert not pathfinder.is_pinned(dkey)
    compileahead.design_vector(_ukey("other"), _scalar(4.0), SCALAR_SPEC,
                               "cpu")
    assert dkey not in compileahead._DESIGNS


def test_compile_and_stall_seconds_accounting():
    """A design traced by the dispatcher is compile and stall time; one
    the service traced is compile time only, and its dispatch is free;
    `RunStats` reports a run's share."""
    s0 = pathfinder.compile_cache_stats()
    compileahead.design_vector(_ukey("inline"), _scalar(1.0), SCALAR_SPEC,
                               "cpu")
    s1 = pathfinder.compile_cache_stats()
    assert s1["compile_seconds"] > s0["compile_seconds"]
    assert s1["stall_seconds"] > s0["stall_seconds"]
    svc = compileahead.service()
    key = _ukey("ahead")
    try:
        assert svc.warm_design(key, _scalar(2.0), SCALAR_SPEC, device="cpu")
        assert svc.drain(timeout=120.0)
    finally:
        pathfinder.unpin_compiled(key)
    s2 = pathfinder.compile_cache_stats()
    assert s2["compile_seconds"] > s1["compile_seconds"]
    assert s2["stall_seconds"] == s1["stall_seconds"]
    fn = compileahead.design_batch_fn(key, _scalar(2.0), SCALAR_SPEC, "cpu")
    np.testing.assert_allclose(fn(torch.ones(2, 4)).numpy(),
                               np.full((2, 3), 12.0), rtol=1e-6)
    s3 = pathfinder.compile_cache_stats()
    assert s3["compile_seconds"] == s2["compile_seconds"]
    assert s3["stall_seconds"] == s2["stall_seconds"]
    spec = sweeprunner.SweepSpec(**dict(SPEC, n_tilings=3))   # fresh designs
    stats = sweeprunner.SweepRunner(spec, backend="serial", cache=None,
                                    bucketing=True, device="cpu").run()
    assert stats.compile_seconds > 0 and stats.compile_misses > 0
    assert 0 < stats.stall_seconds <= stats.compile_seconds


def test_resume_is_neutral_to_bucketing_and_compile_ahead(tmp_path, capsys):
    """A sweep stopped with bucketing off resumes with it on (and a
    compile-ahead depth): the same checkpoint lines and keys as one
    uninterrupted run, each chunk evaluated once; the CLI prints its
    compile line."""
    spec = sweeprunner.SweepSpec(**SPEC)
    d = tmp_path / "resumed"
    first = sweeprunner.SweepRunner(spec, out_dir=str(d), backend="serial",
                                    cache=None, bucketing=False,
                                    device="cpu").run(max_chunks=2)
    assert not first.complete
    rest = sweeprunner.SweepRunner(spec, out_dir=str(d), cache=None,
                                   bucketing=True, compile_ahead=1,
                                   device="cpu").run(resume=True)
    assert rest.complete and rest.n_chunks_skipped == 2
    whole = tmp_path / "whole"
    full = sweeprunner.SweepRunner(spec, out_dir=str(whole), cache=None,
                                   device="cpu").run()
    assert (d / "checkpoint.jsonl").read_text() == \
        (whole / "checkpoint.jsonl").read_text()
    assert sorted(r["key"] for r in rest.records) == \
        sorted(r["key"] for r in full.records)
    chunks = [json.loads(x)["chunk"]
              for x in (d / "checkpoint.jsonl").read_text().splitlines()]
    assert sorted(chunks) == list(range(full.n_chunks_total))
    rc = pathfind.main(["sweep", "--out", str(d), "--resume", "--device",
                        "cpu", "--compile-ahead", "2", "--no-bucketing",
                        "--no-compile-cache"])
    err = capsys.readouterr().err
    assert rc == 0 and f"skipped {full.n_chunks_total} checkpointed, " \
        "evaluated 0 " in err
    assert "# compile: 0.0s tracing designs into their buckets, 0.0s " \
        "stalling the eval path" in err
