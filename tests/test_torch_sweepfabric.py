"""The port's sweep fabric (``repro_torch.core.sweepfabric``) in process, on
the CPU, against the reference: directory guards, the first-wins merge and
the worker command line; workers in full and frontier mode against the
reference serial runner's records (rtol 1e-5, its bucketing off); and
fabric directories crossing between the packages in both directions.

The reference's own worker and frontier merge run here in process, its
bucketing off, and the reference's process-wide compiled-function store
and row cache are put back as they were after them (ROADMAP queue 3).
"""

import collections
import dataclasses
import glob
import os
import signal
import sys

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest

import fabrichelpers as fh
from repro.core import pathfinder as ref_pf
from repro.core import sweepfabric as ref_fabric
from repro.core import sweeppipeline as ref_pipe
from repro.core import sweeprunner as ref_sr
from repro_torch.core import sweepexec, sweepfabric, sweeprunner
from repro_torch.core.sweepfabric import FabricCoordinator, FabricWorker

AXES = dict(arches=("qwen1.5-0.5b",), mesh_shapes=((2, 2), (4, 4)),
            scenario="train", logic_nodes=("N7", "N5"), n_tilings=4,
            chunk_size=1)                               # 4 points, 4 chunks
SPEC = sweeprunner.SweepSpec(**AXES)
REF_SPEC = ref_sr.SweepSpec(**AXES)
CHUNKS = sweeprunner.make_chunks(sweeprunner.enumerate_labels(SPEC),
                                 SPEC.chunk_size)
FP = SPEC.fingerprint()
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def serial_records():
    """The reference serial runner's records, its bucketing off."""
    assert REF_SPEC.fingerprint() == FP
    return ref_sr.SweepRunner(REF_SPEC, backend="serial", bucketing=False,
                              cache=ref_pf.PredictionCache()).run().records


@pytest.fixture(autouse=True)
def sigterm_handler_restored():
    """A worker installs its preemption handler on SIGTERM; the test
    process gets its own back."""
    prev = signal.getsignal(signal.SIGTERM)
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev)


@pytest.fixture
def ref_caches_restored():
    """The reference's compiled-function store, its counters and the
    pipeline's row cache, put back as they were after the test."""
    with ref_pf._COMPILED_LOCK:
        store = collections.OrderedDict(ref_pf._COMPILED)
        stats = dict(ref_pf._COMPILE_STATS)
    rows = collections.OrderedDict(ref_pipe._ROW_CACHE)
    try:
        yield
    finally:
        with ref_pf._COMPILED_LOCK:
            ref_pf._COMPILED.clear()
            ref_pf._COMPILED.update(store)
            ref_pf._COMPILE_STATS.clear()
            ref_pf._COMPILE_STATS.update(stats)
        ref_pipe._ROW_CACHE.clear()
        ref_pipe._ROW_CACHE.update(rows)


def test_directory_guards_first_wins_merge_and_worker_cmd(tmp_path):
    """``init_dir`` refuses another mode or spec; a chunk two shards
    committed survives once, from the first shard in sorted order; the
    coordinator spawns the port's CLI with the device, the bucketing
    choice and the knobs."""
    out = str(tmp_path / "fab")
    head = sweepfabric.init_dir(SPEC, out)
    assert head == {"mode": "full", "capacity": 512, "version": 1}
    sweepfabric.init_dir(SPEC, out)                    # re-join
    with pytest.raises(ValueError, match="mode"):
        sweepfabric.init_dir(SPEC, out, frontier_only=True)
    with pytest.raises(ValueError, match="spec changed"):
        sweepfabric.init_dir(dataclasses.replace(SPEC, logic_nodes=("N7",)),
                             out)
    spec2, fabric = sweepfabric.load_dir(out)
    assert spec2.fingerprint() == FP and fabric["mode"] == "full"
    assert ref_fabric.load_dir(out)[0].fingerprint() == FP

    for wid, committed in (("a", (0, 1)), ("b", (0, 2))):
        sp = sweepfabric.shard_paths(out, wid)
        j = sweepexec.ChunkJournal(sp["results"], sp["checkpoint"]).open()
        for i in committed:
            j.commit(i, CHUNKS[i].hash(FP), [{"key": f"pt{i}", "src": wid}])
        j.close()
    records, done = sweepfabric.merge_results(out)
    assert sorted(done) == [0, 1, 2]
    assert {r["key"]: r["src"] for r in records} == \
        {"pt0": "a", "pt1": "a", "pt2": "b"}
    assert all("chunk" not in r for r in records)
    assert (records, done) == ref_fabric.merge_results(out)

    def worker_cmd(bucketing):
        return FabricCoordinator(SPEC, out, workers=0, superbatch=8,
                                 claim_batch=2, eval_delay_s=0.01,
                                 bucketing=bucketing,
                                 device="cpu").worker_cmd()

    cmd = worker_cmd(True)
    assert cmd[:4] == [sys.executable, "-m", "repro_torch.pathfind",
                       "sweep-worker"]
    for flag, val in (("--dir", out), ("--superbatch", "8"),
                      ("--claim-batch", "2"), ("--eval-delay", "0.01"),
                      ("--device", "cpu"), ("--ttl", "30.0")):
        assert cmd[cmd.index(flag) + 1] == val, flag
    assert "--bucketing" in cmd and "--no-bucketing" not in cmd
    assert "--no-bucketing" in worker_cmd(False)
    assert not {"--bucketing", "--no-bucketing"} & set(worker_cmd(None))


def test_workers_full_mode_match_the_reference_serial(tmp_path,
                                                      serial_records):
    """One worker sweeps a directory; two sequential workers (fresh
    incarnations, fresh shards) split another; both merges are the
    reference serial runner's records, and no ``xla_cache`` appears."""
    out = str(tmp_path / "one")
    sweepfabric.init_dir(SPEC, out)
    stats = FabricWorker(out, ttl_s=60.0, claim_batch=2,
                         device="cpu").run()
    assert stats.n_chunks_committed == len(CHUNKS) == 4
    assert stats.n_points == len(serial_records)
    assert not stats.preempted and stats.n_lost_leases == 0
    assert stats.startup_s is not None and stats.startup_s > 0
    assert not os.path.exists(os.path.join(out, "xla_cache"))
    records, done = sweepfabric.merge_results(out)
    assert len(done) == len(CHUNKS)
    fh.assert_no_duplicate_point_keys(records)
    fh.assert_records_match(records, serial_records)
    assert [r["key"] for r in fh.merged_record_lines(out)] == \
        [r["key"] for r in records]

    out = str(tmp_path / "two")
    sweepfabric.init_dir(SPEC, out)
    a = FabricWorker(out, worker_id="wa", ttl_s=60.0, claim_batch=1,
                     max_chunks=2, **CPU).run()
    assert a.n_chunks_committed == 2
    b = FabricWorker(out, worker_id="wb", ttl_s=60.0, claim_batch=2,
                     **CPU).run()
    assert b.n_chunks_committed == len(CHUNKS) - 2
    records, done = sweepfabric.merge_results(out)
    assert len(done) == len(CHUNKS)
    fh.assert_records_match(records, serial_records)
    fh.assert_no_committed_chunk_reevaluated(out)
    assert len(glob.glob(os.path.join(out, "shards",
                                      "checkpoint.*.jsonl"))) == 2


def test_worker_frontier_mode_matches_the_reference_frontier(
        tmp_path, serial_records, ref_caches_restored):
    """Two frontier-mode workers, each carrying its own state shard; the
    cross-worker merge is the reference's single-host frontier (its
    ``pareto_records`` over the serial records), and the reference's
    ``merge_frontier`` reads the same shards to the same records."""
    out = str(tmp_path / "fab")
    sweepfabric.init_dir(SPEC, out, frontier_only=True)
    a = FabricWorker(out, worker_id="wa", ttl_s=60.0, claim_batch=1,
                     max_chunks=2, **CPU).run()
    b = FabricWorker(out, worker_id="wb", ttl_s=60.0, claim_batch=2,
                     **CPU).run()
    assert (a.n_chunks_committed, b.n_chunks_committed) == (2, 2)
    records, n_over, done = sweepfabric.merge_frontier(out, device="cpu")
    assert len(done) == len(CHUNKS) and n_over == 0
    objectives = REF_SPEC.scenario_spec.variants()[0].resolve().objectives
    want = ref_sr.pareto_records(serial_records, objectives)
    fh.assert_records_match(records, want)
    for name in ("frontier.jsonl", "frontier_state.npz"):
        assert os.path.exists(os.path.join(out, name))
    fh.assert_no_committed_chunk_reevaluated(out)
    ref_records, ref_over, ref_done = ref_fabric.merge_frontier(out)
    assert ref_done == done and ref_over == 0
    fh.assert_records_match(ref_records, want)


def test_fabric_directories_cross_between_the_packages(
        tmp_path, serial_records, ref_caches_restored):
    """A directory the reference started, half committed by the
    reference's worker, is finished by a port worker and merged by the
    port's coordinator; a directory the port's workers filled is merged
    by the reference.  Both are the reference serial runner's records."""
    out = str(tmp_path / "from-ref")
    ref_fabric.init_dir(REF_SPEC, out)
    ref = ref_fabric.FabricWorker(out, worker_id="ref", ttl_s=60.0,
                                  claim_batch=1, max_chunks=2,
                                  compile_cache=False,
                                  bucketing=False).run()
    assert ref.n_chunks_committed == 2
    port = FabricWorker(out, worker_id="port", ttl_s=60.0, claim_batch=1,
                        **CPU).run()
    assert port.n_chunks_committed == len(CHUNKS) - 2
    stats = FabricCoordinator(SPEC, out, workers=0, poll_s=0.1,
                              device="cpu").run()
    assert stats.complete and stats.n_worker_exits == {}
    fh.assert_records_match(stats.records, serial_records)
    fh.assert_no_committed_chunk_reevaluated(out)

    out = str(tmp_path / "from-port")
    sweepfabric.init_dir(SPEC, out)
    for wid, n in (("p1", 1), ("p2", None)):
        FabricWorker(out, worker_id=wid, ttl_s=60.0, claim_batch=1,
                     max_chunks=n, **CPU).run()
    records, done = ref_fabric.merge_results(out)
    assert len(done) == len(CHUNKS)
    fh.assert_records_match(records, serial_records)
    assert sweepfabric.merge_results(out) == (records, done)
