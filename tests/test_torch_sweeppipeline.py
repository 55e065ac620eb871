"""The port's pipelined sweep executor against the reference, on the CPU.

The reference's small grids (``tests/test_sweeppipeline.py``'s SPEC and
SERVING_SPEC: the serving one has designs whose KV cache does not fit
next to designs that are feasible) run through the port's ``pipeline``
backend — inline and threaded, superbatches of one chunk and of all —
and must write the reference's serial directory: ``spec.json`` and
``checkpoint.jsonl`` byte for byte, records equal (labels, keys, flags and
the non-finite pattern exactly, floats within rtol 1e-5).  A serial
directory stopped after two chunks resumes on the pipeline with zero
re-evaluation, across packages both ways.  ``frontier_only`` writes
exactly the keys of `pareto_records` over the full sweep, and a
``frontier_state.npz`` written by either package resumes in the other.

Oracles: the reference's serial runner with its bucketing off and a
private `PredictionCache` (ROADMAP queue 3); its frontier is built from
its own parts (`frontier_fold`, `frontier_merge`, `save_frontier_state`)
over rows it scores point by point, because its pipelined executor would
fill the process-wide compiled-function caches.  Nothing here fills or
clears the reference's prediction cache.
"""

import json

import jax.numpy as jnp  # (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.core import compileahead
from repro.core import pathfinder as ref_pf
from repro.core import sweepexec as ref_exec
from repro.core import sweeprunner as ref_sr
from repro_torch.core import pathfinder, sweeppipeline, sweeprunner
from repro_torch.core.sweepexec import json_safe

RTOL = 1e-5
SPECS = {
    "train": dict(arches=("qwen1.5-0.5b",), mesh_shapes=((2, 2), (4, 4)),
                  scenario="train", logic_nodes=("N7", "N5"),
                  budget_scales=(0.9, 1.0, 1.1), n_tilings=4, chunk_size=4),
    "serving": dict(arches=("qwen1.5-0.5b",), mesh_shapes=((2, 2), (4, 4)),
                    scenario="serving", logic_nodes=("N7",),
                    budget_scales=(0.8, 1.0), n_tilings=4, chunk_size=3),
}
# serving-traffic with the composed objectives: a maximized objective
# (goodput) in the frontier, walled and infeasible points, two variants
# (tests/test_torch_sweeprunner.py's TRAFFIC grid)
TRAFFIC = dict(arches=("qwen1.5-0.5b", "recurrentgemma-2b"),
               mesh_shapes=((8, 8),), scenario="serving-traffic",
               logic_nodes=("N7", "N5"), hbms=("HBM2E", "HBM3"), slo_s=18.0,
               scenario_params={"qps": [0.25, 1.0]},
               objectives=("energy", "cost", "goodput"), chunk_size=4)


@pytest.fixture
def no_ref_bucketing():
    """The reference's bucketing off (ROADMAP queue 3), restored after."""
    prev = compileahead.set_bucketing_default(False)
    try:
        yield
    finally:
        compileahead.set_bucketing_default(prev)


def _ref_run(spec: dict, out_dir=None, **kw):
    return ref_sr.SweepRunner(ref_sr.SweepSpec(**spec),
                              out_dir=out_dir and str(out_dir),
                              backend="serial", bucketing=False,
                              cache=ref_pf.PredictionCache()).run(**kw)


def _port_run(spec: dict, out_dir=None, backend="pipeline", cache=None,
              superbatch=None, **kw):
    return sweeprunner.SweepRunner(
        sweeprunner.SweepSpec(**spec), out_dir=out_dir and str(out_dir),
        backend=backend, cache=cache, superbatch=superbatch,
        device="cpu").run(**kw)


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _same_records(got, want):
    """Records equal key by key: non-numbers and the non-finite pattern
    exactly, finite floats within RTOL."""
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if isinstance(v, float) and np.isfinite(v):
                assert isinstance(g[k], float), (k, g[k])
                assert abs(g[k] - v) <= RTOL * abs(v), (w["key"], k, g[k], v)
            else:
                assert g[k] == v or (v != v and g[k] != g[k]), \
                    (w["key"], k, g[k], v)


def _same_dirs(got, want):
    for name in ("spec.json", "checkpoint.jsonl"):
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
    _same_records(_lines(got / "results.jsonl"),
                  _lines(want / "results.jsonl"))


@pytest.mark.parametrize("name", list(SPECS))
def test_pipeline_records_are_the_reference_serial_records(tmp_path, name):
    """The runner's pipeline (its default) with superbatches of one chunk
    and of the whole grid, and the executor inline and threaded: the
    reference's serial directory and records; a second run on the same
    prediction cache is all hits and the same records."""
    spec = SPECS[name]
    want = _ref_run(spec, tmp_path / "ref")
    for superbatch in (None, spec["chunk_size"]):
        d = tmp_path / f"pipe-{superbatch}"
        stats = _port_run(spec, d, superbatch=superbatch)
        assert stats.backend == "pipeline" and stats.complete
        assert stats.n_points_evaluated == want.n_points_evaluated
        _same_dirs(d, tmp_path / "ref")
        _same_records(stats.records, want.records)
    if name == "serving":
        assert {r["feasible"] for r in want.records} == {True, False}
    port_spec = sweeprunner.SweepSpec(**spec)
    chunks = sweeprunner.make_chunks(sweeprunner.enumerate_labels(port_spec),
                                     port_spec.chunk_size)
    cache = pathfinder.PredictionCache()
    for threads in (False, True, False):
        ex = sweeppipeline.PipelineExecutor(port_spec, cache=cache,
                                            superbatch=2 * spec["chunk_size"],
                                            threads=threads, device="cpu")
        got = []
        n = ex.run(chunks, lambda c, recs: got.extend(recs))
        assert n == len(got)
        _same_records(json_safe(got), want.records)   # as the files hold
    ppd = sweeprunner.scenario_for(port_spec, chunks[0].labels[0].cell) \
        .points_per_design()
    n_keys = len(want.records) * ppd
    assert cache.stats["misses"] == n_keys and \
        cache.stats["hits"] == 2 * n_keys


def test_serial_directories_resume_on_the_pipeline_across_packages(
        tmp_path):
    """Stopped after two chunks and resumed on the port's pipeline: a
    directory the reference's serial runner started, and one the port's
    serial backend started; and a pipeline directory stopped after two
    chunks, resumed by the reference's serial runner.  Each ends as the
    uninterrupted reference directory; no chunk is evaluated twice."""
    spec = SPECS["train"]
    full = _ref_run(spec, tmp_path / "full")
    n_chunks = full.n_chunks_total
    assert n_chunks >= 3
    for starter in ("ref", "port"):
        d = tmp_path / f"{starter}-serial"
        if starter == "ref":
            part = _ref_run(spec, d, max_chunks=2)
        else:
            part = _port_run(spec, d, backend="serial", max_chunks=2)
        assert part.n_chunks_evaluated == 2 and not part.complete
        head = (d / "results.jsonl").read_text()
        stats = sweeprunner.SweepRunner.from_dir(
            str(d), cache=pathfinder.PredictionCache(),
            device="cpu").run(resume=True)
        assert stats.backend == "pipeline" and stats.complete
        assert stats.n_chunks_skipped == 2
        assert stats.n_chunks_evaluated == n_chunks - 2
        assert stats.cache_misses == stats.n_points_evaluated
        assert (d / "results.jsonl").read_text().startswith(head)
        _same_dirs(d, tmp_path / "full")
    d = tmp_path / "port-pipeline"
    part = _port_run(spec, d, max_chunks=2)
    assert part.n_chunks_evaluated == 2 and not part.complete
    stats = _ref_run(spec, d, resume=True)
    assert stats.n_chunks_skipped == 2
    assert stats.n_chunks_evaluated == n_chunks - 2
    _same_dirs(d, tmp_path / "full")


def _ref_frontier(spec, chunks, state):
    """The reference's frontier state after merging ``chunks`` into
    ``state``, from its own parts: each design scored point by point (its
    eager rows, no compiled function), folded by its `frontier_fold` and
    merged by its `frontier_merge`, a chunk a batch."""
    ppe = ref_sr.spec_ppe(spec)
    for c in chunks:
        vals, pays, idx = [], [], []
        for li, lb in enumerate(c.labels):
            dp = ref_sr.resolve_label(spec, lb)
            scn = ref_sr.scenario_for(spec, lb.cell)
            rows = ref_pf.evaluate(points=scn.eval_points(dp), ppe=ppe,
                                   cache=ref_pf.PredictionCache())
            rows = jnp.asarray(rows, dtype=jnp.float32)
            fold = scn.frontier_fold(dp.cfg, dp.strategy)
            vals.append(np.asarray(fold(rows, jnp.asarray(
                ref_pf.pack_hw(dp.hw)))))
            pays.append(np.asarray(rows).reshape(-1))
            idx.append(c.index * spec.chunk_size + li)
        state = ref_pf.frontier_merge(
            state, jnp.asarray(np.stack(vals)), jnp.asarray(np.stack(pays)),
            jnp.asarray(np.asarray(idx, dtype=np.int32)))
    return tuple(np.asarray(x) for x in state)


def _ref_frontier_keys(spec, chunks, state):
    """The keys of the reference's records rebuilt from a state's payload
    rows (its `record`), filtered by its `pareto_records`."""
    _, payload, idx, _ = ref_pf.frontier_unpack(state)
    recs, scn = [], None
    for i in np.argsort(idx):
        gi = int(idx[i])
        lb = chunks[gi // spec.chunk_size].labels[gi % spec.chunk_size]
        dp = ref_sr.resolve_label(spec, lb)
        scn = ref_sr.scenario_for(spec, lb.cell)
        rec = scn.record(dp, payload[i].astype(np.float64).reshape(
            scn.points_per_design(), len(ref_pf.METRICS)))
        rec["key"] = dp.key()
        recs.append(rec)
    return sorted(r["key"] for r in ref_sr.pareto_records(
        recs, tuple(scn.objectives)))


def test_frontier_only_is_pareto_records_and_resumes_across_packages(
        tmp_path, no_ref_bucketing):
    """``frontier_only`` (train, serving, and serving-traffic with a
    maximized objective): the keys of `pareto_records` over the full
    sweep, the port's and the reference's, its records the full sweep's,
    nothing overflowed.  A port state stopped after one chunk is resumed
    by the reference's merge, and a reference state by the port's
    ``resume``: both reach the full sweep's frontier, the resumed run
    evaluating only the chunks not merged."""
    for name, spec in (*SPECS.items(), ("traffic", TRAFFIC)):
        ref_spec = ref_sr.SweepSpec(**spec)
        ref_full = _ref_run(spec)
        objectives = ref_sr.scenario_for(
            ref_spec, ref_full.records[0]["cell"]).objectives
        want = sorted(r["key"] for r in ref_sr.pareto_records(
            ref_full.records, objectives))
        full = _port_run(spec)
        mine = sweeprunner.pareto_records(full.records, objectives)
        assert sorted(r["key"] for r in mine) == want and want, name
        d = tmp_path / name
        front = _port_run(spec, d, frontier_only=True)
        assert front.frontier_only and front.complete
        assert front.n_frontier_overflowed == 0
        assert front.n_points_evaluated == full.n_points_evaluated
        assert sorted(r["key"] for r in front.records) == want, name
        by_key = {r["key"]: r for r in front.records}
        _same_records([by_key[r["key"]] for r in mine], mine)
        assert sorted(r["key"] for r in _lines(d / "frontier.jsonl")) == want
        assert not (d / "results.jsonl").exists()

        chunks = ref_sr.make_chunks(ref_sr.enumerate_labels(ref_spec),
                                    ref_spec.chunk_size)
        fp = ref_spec.fingerprint()
        cap = pathfinder.FRONTIER_CAPACITY
        # the port's state after one chunk, finished by the reference
        d = tmp_path / f"{name}-port-started"
        part = _port_run(spec, d, frontier_only=True, max_chunks=1)
        assert not part.complete and part.n_chunks_evaluated == 1
        state, done = ref_exec.load_frontier_state(
            str(d / "frontier_state.npz"), fp, cap, chunks)
        assert sorted(done) == [0]
        state = _ref_frontier(ref_spec, chunks[1:], state)
        assert _ref_frontier_keys(ref_spec, chunks, state) == want, name
        # the reference's state after one chunk, resumed by the port
        d = tmp_path / f"{name}-ref-started"
        d.mkdir()
        ref_exec.write_spec_head(str(d / "spec.json"), ref_sr.SPEC_VERSION,
                                 fp, ref_spec.to_dict())
        ppd = ref_sr.scenario_for(ref_spec, chunks[0].labels[0].cell) \
            .points_per_design()
        state = _ref_frontier(ref_spec, chunks[:1], ref_pf.frontier_init(
            cap, len(objectives), ppd * len(ref_pf.METRICS)))
        ref_exec.save_frontier_state(str(d / "frontier_state.npz"), state,
                                     {0: chunks[0].hash(fp)}, cap, fp)
        stats = sweeprunner.SweepRunner.from_dir(
            str(d), cache=None, device="cpu").run(frontier_only=True,
                                                  resume=True)
        assert stats.complete and stats.n_chunks_skipped == 1
        assert stats.n_points_evaluated == \
            full.n_points_evaluated - len(chunks[0].labels)
        assert sorted(r["key"] for r in stats.records) == want, name


def test_stage_failures_and_later_knobs_raise(tmp_path):
    """An error in the producer, on the device stage or in the writer ends
    the run and is raised on the caller's thread, inline and threaded,
    full and frontier-only; the execution knobs take their values and
    refuse bad ones; the card is the default device and is never replaced
    by the host."""
    spec = sweeprunner.SweepSpec(**SPECS["train"])
    chunks = sweeprunner.make_chunks(sweeprunner.enumerate_labels(spec),
                                     spec.chunk_size)

    class Boom(RuntimeError):
        pass

    def fail_after(fn, n):
        calls = []

        def wrapped(*a, **kw):
            calls.append(1)
            if len(calls) > n:
                raise Boom(fn.__name__)
            return fn(*a, **kw)
        return wrapped

    for threads in (False, True):
        for stage in ("pack", "dispatch", "finalize", "commit"):
            ex = sweeppipeline.PipelineExecutor(
                spec, cache=None, superbatch=spec.chunk_size,
                threads=threads, device="cpu")
            committed = []

            def commit(c, recs):
                committed.append(c.index)
            if stage == "commit":
                commit = fail_after(commit, 1)
            else:
                setattr(ex, stage, fail_after(getattr(ex, stage), 1))
            with pytest.raises(Boom):
                ex.run(chunks, commit)
            assert committed in ([], [0]), (stage, threads, committed)
        ex = sweeppipeline.PipelineExecutor(spec, cache=None,
                                            superbatch=spec.chunk_size,
                                            threads=threads, device="cpu")
        ex.pack = fail_after(ex.pack, 1)
        with pytest.raises(Boom):
            ex.run_frontier(chunks)
        ex = sweeppipeline.PipelineExecutor(spec, cache=None,
                                            threads=threads, device="cpu")
        with pytest.raises(Boom):
            ex.run_frontier(chunks, on_commit=fail_after(lambda *a: None, 0))

    # the knobs of the compile-ahead slice take their values (bucketing
    # off and one device by default); their own checks raise
    for kw in (dict(devices=2), dict(bucketing=True), dict(compile_ahead=2),
               dict(bucketing=False, compile_ahead=0), {}):
        ex = sweeppipeline.PipelineExecutor(spec, device="cpu", **kw)
        assert ex.devices == kw.get("devices", 1)
        assert ex.bucketing == kw.get("bucketing", False)
        assert ex.compile_ahead == kw.get("compile_ahead",
                                          sweeppipeline.COMPILE_AHEAD)
        sweeprunner.SweepRunner(spec, device="cpu", **{
            k: v for k, v in kw.items() if k != "devices"})
    with pytest.raises(ValueError, match="compile_ahead"):
        sweeppipeline.PipelineExecutor(spec, device="cpu", compile_ahead=-1)
    with pytest.raises(ValueError, match="this host has"):
        sweeppipeline.PipelineExecutor(
            spec, device="cuda", devices=torch.cuda.device_count() + 1) \
            if torch.cuda.is_available() else pathfinder.shard_devices(
                "cuda", 1)
    assert sweeprunner.SweepRunner(spec, backend="device",
                                   device="cpu").backend == "device"
    assert sweeprunner.pick_backend("auto") == "pipeline"
    if not torch.cuda.is_available():
        for make in (lambda: sweeppipeline.PipelineExecutor(spec),
                     lambda: sweeprunner.SweepRunner(spec),
                     lambda: pathfinder.frontier_init(4, 2, 5)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    # a frontier state and a full sweep never share a directory
    d = tmp_path / "d"
    _port_run(SPECS["train"], d, max_chunks=1)
    with pytest.raises(ValueError, match="full-sweep checkpoint"):
        _port_run(SPECS["train"], d, frontier_only=True, resume=True)
    with pytest.raises(FileExistsError, match="checkpointed sweep"):
        _port_run(SPECS["train"], d, frontier_only=True)
    d = tmp_path / "f"
    _port_run(SPECS["train"], d, frontier_only=True, max_chunks=1)
    with pytest.raises(FileExistsError, match="frontier-state"):
        _port_run(SPECS["train"], d, frontier_only=True)
    with pytest.raises(ValueError, match="capacity"):
        _port_run(SPECS["train"], d, frontier_only=True, resume=True,
                  frontier_capacity=16)
