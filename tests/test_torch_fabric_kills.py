"""The port's fabric under fire, on the CPU: real ``python -m
repro_torch.pathfind sweep-worker --device cpu`` processes SIGKILL'd
mid-chunk, mid-commit and mid-renewal (the reference's kill matrix and
its env knobs), a stalled worker whose expired leases are reclaimed, and
SIGTERM preemption that commits the in-flight chunk and exits 0.  The
survivors run in this process.  Throughout: no committed chunk is
evaluated again, and the merged records are the reference serial
runner's (rtol 1e-5, its bucketing off).
"""

import glob
import os
import signal
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest

import fabrichelpers as fh
from repro.core import pathfinder as ref_pf
from repro.core import sweeprunner as ref_sr
from repro_torch.core import sweepfabric, sweeprunner
from repro_torch.core.sweepfabric import FabricWorker, LeaseManager

AXES = dict(arches=("qwen1.5-0.5b",), mesh_shapes=((2, 2), (4, 4)),
            scenario="train", logic_nodes=("N7", "N5"), n_tilings=4,
            chunk_size=1)                               # 4 points, 4 chunks
SPEC = sweeprunner.SweepSpec(**AXES)
N_CHUNKS = 4


def spawn(out_dir: str, *, ttl: float, claim_batch: int, env=None,
          extra=()) -> subprocess.Popen:
    """One port worker process on the CPU over ``out_dir``."""
    cmd = [sys.executable, "-m", "repro_torch.pathfind", "sweep-worker",
           "--dir", out_dir, "--device", "cpu", "--ttl", str(ttl),
           "--poll", "0.2", "--claim-batch", str(claim_batch), *extra]
    # one host thread a worker: the test processes share the host's cores
    env = fh.env_for_worker(dict(env or {}, OMP_NUM_THREADS="1"))
    return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def survivor(out_dir: str) -> FabricWorker:
    return FabricWorker(out_dir, ttl_s=60.0, poll_s=0.2, claim_batch=4,
                        device="cpu")


@pytest.fixture(scope="module")
def serial_records():
    return ref_sr.SweepRunner(ref_sr.SweepSpec(**AXES), backend="serial",
                              bucketing=False,
                              cache=ref_pf.PredictionCache()).run().records


@pytest.fixture(autouse=True)
def sigterm_handler_restored():
    prev = signal.getsignal(signal.SIGTERM)
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev)


def _merged_and_held(out: str, serial_records) -> None:
    records, done = sweepfabric.merge_results(out)
    assert len(done) == N_CHUNKS, "the sweep did not resume to completion"
    fh.assert_no_duplicate_point_keys(records)
    fh.assert_no_committed_chunk_reevaluated(out)
    fh.assert_records_match(records, serial_records)


@pytest.mark.parametrize("point,nth", [
    ("eval", 2),        # mid-chunk: evaluated, nothing written
    ("post_rows", 2),   # torn commit: rows on disk, no done-line
    ("renew", 1),       # mid-heartbeat: renewal tmp written, not renamed
])
def test_kill_matrix_survivor_resumes(tmp_path, point, nth,
                                      serial_records):
    out = str(tmp_path / "fab")
    sweepfabric.init_dir(SPEC, out)
    token = str(tmp_path / "kill.token")
    victim = spawn(out, ttl=3.0, claim_batch=4,
                   env={"REPRO_FABRIC_KILL": f"{point}:{nth}:{token}"})
    fh.wait_procs([victim], 120.0)
    assert victim.returncode == -signal.SIGKILL
    assert os.path.exists(token), "the injection point never fired"
    stats = survivor(out).run()
    assert stats.n_chunks_committed >= 1 and not stats.preempted
    _merged_and_held(out, serial_records)


def test_stalled_worker_leases_are_reclaimed(tmp_path, serial_records):
    """A worker claims every chunk, then stalls past its TTL without a
    heartbeat; the healthy worker reclaims the expired leases and does
    all the work; the stalled one wakes, finds its batch lost, and exits
    0 with nothing committed."""
    out = str(tmp_path / "fab")
    sweepfabric.init_dir(SPEC, out)
    stalled = spawn(out, ttl=2.0, claim_batch=4,
                    env={"REPRO_FABRIC_STALL_S": "10"})
    fh.wait_for(lambda: len(glob.glob(os.path.join(
        out, "leases", "chunk_*.json"))) == N_CHUNKS, 60.0,
        "the stalled worker to claim every lease")
    he = survivor(out).run()
    assert he.n_chunks_committed == N_CHUNKS
    fh.wait_procs([stalled], 60.0)
    assert stalled.returncode == 0
    st = next(s for s in fh.read_stats(out) if s["pid"] == stalled.pid)
    assert st["n_chunks_committed"] == 0 and st["n_lost_leases"] >= 1
    for i in range(N_CHUNKS):
        assert LeaseManager(out, "probe").holder(i) == he.worker
    _merged_and_held(out, serial_records)


def test_sigterm_commits_inflight_then_exits_clean(tmp_path,
                                                   serial_records):
    out = str(tmp_path / "fab")
    sweepfabric.init_dir(SPEC, out)
    w = spawn(out, ttl=60.0, claim_batch=1, extra=("--eval-delay", "1.5"))
    fh.wait_for(lambda: any(s.get("committed") for s in
                            fh.read_stats(out)), 60.0, "the first commit")
    w.send_signal(signal.SIGTERM)
    fh.wait_procs([w], 60.0)
    assert w.returncode == 0                   # preemption is a clean exit
    s = next(s for s in fh.read_stats(out) if s["pid"] == w.pid)
    assert s["preempted"] is True and s["device"] == "cpu"
    assert 1 <= s["n_chunks_committed"] < N_CHUNKS
    committed = {c for c, _ in s["committed"]}
    assert {c for c, _ in s["evaluated"]} == committed
    probe = LeaseManager(out, "probe")
    for i in range(N_CHUNKS):
        if probe.holder(i) == s["worker"]:
            assert i in committed, f"unfinished chunk {i} still leased"
    survivor(out).run()
    _merged_and_held(out, serial_records)
