"""The port's chunked sweep runner against the reference's, on the CPU.

Each grid runs through both packages' `SweepRunner` into a directory of
its own: the reference's serial backend with its bucketing off and a
private prediction cache (ROADMAP queue 3; its process-wide caches are
neither filled nor cleared), the port's on the host.  ``spec.json`` and
``checkpoint.jsonl`` (the spec fingerprint and the chunk hashes) must be
the same bytes, and ``results.jsonl`` the same records: labels, keys,
chunk tags, feasibility and the pattern of non-finite values exactly,
numbers within rtol 1e-5 (float32 rows).  A directory either package
started resumes in the other with no chunk evaluated twice.
"""

import dataclasses
import json

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.calibrate import fitting as ref_fitting
from repro.core import pathfinder as ref_pf
from repro.core import sweeprunner as ref_sr
from repro_torch.core import pathfinder, sweeprunner
from repro_torch.core.sweepexec import json_safe

RTOL = 1e-5
# the reference's own fixtures: tests/test_cooptimize.py's SPEC and the
# serving_records fixture of tests/test_scenarios.py
FIXTURES = {
    "train": dict(arches=("qwen1.5-0.5b",), mesh_shapes=((2, 2), (4, 4)),
                  scenario="train", logic_nodes=("N7",), n_tilings=4,
                  chunk_size=8),
    "serving": dict(arches=("qwen1.5-0.5b", "qwen2-moe-a2.7b",
                            "recurrentgemma-2b"),
                    mesh_shapes=((16, 16),), scenario="serving",
                    n_tilings=4, chunk_size=8),
}
# serving-traffic with the composed objectives, a swept param and an SLO
# wall: feasible, infeasible and walled records
TRAFFIC = dict(arches=("qwen1.5-0.5b", "recurrentgemma-2b"),
               mesh_shapes=((8, 8),), scenario="serving-traffic",
               logic_nodes=("N7", "N5"), hbms=("HBM2E", "HBM3"),
               slo_s=18.0, scenario_params={"qps": [0.25, 1.0]},
               objectives=("energy", "cost", "goodput"), chunk_size=4)


def _ref_run(spec, out_dir, **kw):
    return ref_sr.SweepRunner(spec, out_dir=out_dir and str(out_dir),
                              backend="serial", bucketing=False,
                              cache=ref_pf.PredictionCache()).run(**kw)


def _port_run(spec, out_dir, **kw):
    return sweeprunner.SweepRunner(spec, out_dir=out_dir and str(out_dir),
                                   cache=pathfinder.PredictionCache(),
                                   device="cpu").run(**kw)


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _same_records(got, want):
    """Records equal key by key: non-numbers and the non-finite pattern
    exactly, numbers within RTOL."""
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if isinstance(v, float) and not isinstance(v, bool):
                assert isinstance(g[k], float), (k, g[k])
                assert g[k] == v or abs(g[k] - v) <= RTOL * abs(v), \
                    (w["key"], k, g[k], v)
            else:
                assert g[k] == v, (w["key"], k, g[k], v)


def _same_dirs(port_dir, ref_dir):
    assert (port_dir / "spec.json").read_bytes() == \
        (ref_dir / "spec.json").read_bytes()
    assert (port_dir / "checkpoint.jsonl").read_bytes() == \
        (ref_dir / "checkpoint.jsonl").read_bytes()
    _same_records(_lines(port_dir / "results.jsonl"),
                  _lines(ref_dir / "results.jsonl"))


@pytest.fixture(scope="module")
def traffic_dirs(tmp_path_factory):
    """The traffic grid, uninterrupted, in each package's directory."""
    base = tmp_path_factory.mktemp("traffic")
    ref_stats = _ref_run(ref_sr.SweepSpec(**TRAFFIC), base / "ref")
    port_stats = _port_run(sweeprunner.SweepSpec(**TRAFFIC), base / "port")
    return base, ref_stats, port_stats


@pytest.mark.parametrize("name", list(FIXTURES))
def test_runner_records_match_the_reference(tmp_path, name):
    ref_stats = _ref_run(ref_sr.SweepSpec(**FIXTURES[name]), tmp_path / "r")
    stats = _port_run(sweeprunner.SweepSpec(**FIXTURES[name]),
                      tmp_path / "p")
    assert stats.complete and stats.backend == "pipeline"
    for f in ("n_points_total", "n_chunks_total", "n_chunks_evaluated",
              "n_points_evaluated", "cache_hits", "cache_misses"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    _same_dirs(tmp_path / "p", tmp_path / "r")
    _same_records(stats.records, ref_stats.records)


def test_serving_traffic_grid_with_objectives_and_a_swept_param(
        traffic_dirs):
    base, ref_stats, stats = traffic_dirs
    _same_dirs(base / "port", base / "ref")
    recs = stats.records
    assert {r["cell"] for r in recs} == {
        "prefill_32k+decode_32k@qps=0.25", "prefill_32k+decode_32k@qps=1"}
    flags = [(r["feasible"], r["slo_ok"]) for r in recs]
    assert flags == [(r["feasible"], r["slo_ok"]) for r in ref_stats.records]
    assert {(True, True), (True, False), (False, False)} <= set(flags)
    # the Pareto objectives of every record, None where walled
    spec = sweeprunner.SweepSpec(**TRAFFIC)
    for r, w in zip(recs, ref_stats.records):
        got = sweeprunner.scenario_for(spec, r["cell"]).objective_values(r)
        want = ref_sr.scenario_for(ref_sr.SweepSpec(**TRAFFIC),
                                   w["cell"]).objective_values(w)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_allclose(got, want, rtol=RTOL)
    objs = ["ttft_p99_s", "energy_j_per_token", "goodput_tokens_per_s"]
    assert [r["key"] for r in sweeprunner.pareto_records(recs, objs)] == \
        [r["key"] for r in ref_sr.pareto_records(ref_stats.records, objs)]


def test_a_directory_resumes_across_packages_with_zero_reevaluation(
        tmp_path, traffic_dirs):
    """The reference starts the traffic grid and stops after two chunks;
    the port resumes it (and label mode scores one chunk as the runner
    did); then the other way round.  Each finishes equal to the
    uninterrupted run, and the starter's chunks are never evaluated
    again."""
    base, ref_full, port_full = traffic_dirs
    n_chunks = port_full.n_chunks_total
    assert n_chunks >= 4
    d = tmp_path / "ref_started"
    ref_part = _ref_run(ref_sr.SweepSpec(**TRAFFIC), d, max_chunks=2)
    assert not ref_part.complete
    head = (d / "results.jsonl").read_text()
    cache = pathfinder.PredictionCache()
    runner = sweeprunner.SweepRunner.from_dir(str(d), cache=cache,
                                              device="cpu")
    stats = runner.run(resume=True)
    assert stats.complete and stats.n_chunks_skipped == 2
    assert stats.n_chunks_evaluated == n_chunks - 2
    assert cache.stats["hits"] + cache.stats["misses"] == \
        2 * stats.n_points_evaluated      # two phases a point, no more
    assert (d / "results.jsonl").read_text().startswith(head)
    _same_dirs(d, base / "ref")

    chunk = sweeprunner.make_chunks(sweeprunner.enumerate_labels(
        runner.spec), runner.spec.chunk_size)[3]
    got = pathfinder.evaluate(spec=runner.spec, labels=chunk.labels,
                              cache=None, device="cpu")
    want = [{k: v for k, v in r.items() if k != "chunk"}
            for r in _lines(d / "results.jsonl") if r["chunk"] == 3]
    _same_records(json_safe(got), want)

    d = tmp_path / "port_started"
    part = _port_run(sweeprunner.SweepSpec(**TRAFFIC), d, max_chunks=3)
    assert part.n_chunks_evaluated == 3 and not part.complete
    ref_stats = ref_sr.SweepRunner.from_dir(
        str(d), backend="serial", bucketing=False,
        cache=ref_pf.PredictionCache()).run(resume=True)
    assert ref_stats.n_chunks_skipped == 3
    assert ref_stats.n_chunks_evaluated == n_chunks - 3
    _same_dirs(d, base / "ref")
    spec, recs = sweeprunner.load_sweep(str(d))
    want_spec, want = ref_sr.load_sweep(str(d))
    assert spec.to_dict() == want_spec.to_dict() and recs == want


def test_specs_serialize_as_the_references_and_refusals(tmp_path):
    """Fingerprints (the pinned profile-less one, and with a profile,
    params and objectives), from_dict round trips, and what the runner
    refuses: a second run over a checkpointed directory, resume without
    one, an unknown backend, a missing card."""
    pinned = dict(arches=("qwen1.5-0.5b",), mesh_shapes=((2, 2), (4, 4)),
                  scenario="train", logic_nodes=("N7", "N5"), n_tilings=4,
                  chunk_size=1)
    assert sweeprunner.SweepSpec(**pinned).fingerprint() == \
        "fadd310e03f4106b"
    profile = {"version": 1, "tech": "tpu_v5e", "measure_fingerprint": "x",
               "params": dict(ref_fitting.default_params(), compute_eff=0.5),
               "fit": {"n_tilings": 8}, "validation": {}}
    for kw in (pinned, FIXTURES["serving"], TRAFFIC,
               dict(TRAFFIC, profile=profile, budget_scales=(0.9, 1.1),
                    area_mm2=500.0, cells=("prefill_32k", "decode_32k"))):
        spec, ref = sweeprunner.SweepSpec(**kw), ref_sr.SweepSpec(**kw)
        d = spec.to_dict()
        assert d == ref.to_dict() and spec.fingerprint() == ref.fingerprint()
        for key in ("profile", "scenario_params", "objectives"):
            assert (key in d) == (kw.get(key) is not None), key
        assert sweeprunner.SweepSpec.from_dict(ref.to_dict()) == spec
        labels = sweeprunner.enumerate_labels(spec)
        want = ref_sr.enumerate_labels(ref)
        assert [lb.key() for lb in labels] == [lb.key() for lb in want]
        assert [c.hash(spec.fingerprint()) for c in sweeprunner.make_chunks(
            labels, 3)] == [c.hash(ref.fingerprint())
                            for c in ref_sr.make_chunks(want, 3)]
        if "profile" in kw:       # the calibrated hardware of a label
            hw = sweeprunner._hardware(spec, "N5", "HBM3", "IB-NDR-X8",
                                       1.1, device="cpu")
            want_hw = ref_sr._hardware(ref, "N5", "HBM3", "IB-NDR-X8", 1.1)
            np.testing.assert_array_equal(pathfinder.pack_hw(hw),
                                          ref_pf.pack_hw(want_hw))
            assert dataclasses.asdict(sweeprunner.spec_ppe(spec)) == \
                dataclasses.asdict(ref_sr.spec_ppe(ref))

    spec = sweeprunner.SweepSpec(**FIXTURES["train"])
    _port_run(spec, tmp_path)
    with pytest.raises(FileExistsError, match="--resume"):
        _port_run(spec, tmp_path)
    with pytest.raises(ValueError, match="out_dir"):
        _port_run(spec, None, resume=True)
    front = _port_run(spec, None, frontier_only=True)
    full = _port_run(spec, None)
    assert front.frontier_only and front.n_frontier_overflowed == 0
    assert [r["key"] for r in front.records] == [
        r["key"] for r in sweeprunner.pareto_records(
            full.records, ("time_s", "devices"))]
    assert sweeprunner.pick_backend("auto") == "pipeline"
    for backend in ("pipeline", "serial", "thread", "process", "device"):
        assert sweeprunner.SweepRunner(spec, backend=backend,
                                       device="cpu").backend == backend
    with pytest.raises(ValueError, match="unknown backend"):
        sweeprunner.pick_backend("gpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sweeprunner.SweepRunner(spec)
