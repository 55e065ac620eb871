"""``python -m repro_torch.pathfind sweep --workers N --out DIR --device cpu``
end to end, and a killed frontier-mode worker, on the CPU.

The coordinator runs in this process and spawns two port workers; the
merged records and the printed CSV are the reference serial runner's
(rtol 1e-5, its bucketing off).  In frontier mode a worker killed after
its first checkpoint leaves a state shard that the cross-worker merge
still folds into the reference's frontier.
"""

import contextlib
import io
import os
import re
import signal
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest

import fabrichelpers as fh
from repro.core import pathfinder as ref_pf
from repro.core import sweeprunner as ref_sr
from repro_torch import pathfind
from repro_torch.core import sweepfabric, sweeprunner
from repro_torch.core.sweepfabric import FabricWorker

AXES = dict(arches=("qwen1.5-0.5b",), mesh_shapes=((2, 2), (4, 4)),
            scenario="train", logic_nodes=("N7", "N5"), n_tilings=4,
            chunk_size=1)                               # 4 points, 4 chunks
ARGV = ["--arch", "qwen1.5-0.5b", "--mesh", "2x2", "--mesh", "4x4",
        "--logic", "N7,N5", "--tilings", "4", "--chunk-size", "1"]
SPEC = sweeprunner.SweepSpec(**AXES)
RTOL = 1e-5
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]\d+)?")


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


def _same_text(got: str, want: str) -> None:
    """Equal text apart from numbers within RTOL plus one unit of the
    last printed digit."""
    assert _NUM.split(got) == _NUM.split(want), (got, want)
    for a, b in zip(_NUM.findall(got), _NUM.findall(want)):
        mant, _, exp = b.partition("e")
        unit = 10.0 ** (int(exp or 0) - len(mant.partition(".")[2]))
        assert abs(float(a) - float(b)) <= RTOL * abs(float(b)) + unit, \
            (a, b)


def test_sweep_workers_2_end_to_end(tmp_path, serial_records,
                                    monkeypatch):
    """Two spawned workers (one chunk a claim), the coordinator's merge in
    the single-host layout, the reference's CSV and summary line; each
    worker's stats journal says its device and start-up seconds."""
    out = tmp_path / "fleet"
    # one host thread a worker: the test processes share the host's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), \
            contextlib.redirect_stderr(stderr):
        rc = pathfind.main(["sweep", *ARGV, "--workers", "2",
                            "--superbatch", "1", "--lease-ttl", "60",
                            "--out", str(out), "--device", "cpu"])
    err = stderr.getvalue()
    assert rc == 0, err
    assert "# sweep[train] fabric: 4 points in 4 chunks across 2 workers; " \
        "4 committed in " in err
    scn = ref_sr.SweepSpec(**AXES).scenario_spec.variants()[0].resolve()
    _same_text(stdout.getvalue().strip(),
               ref_sr.to_csv(serial_records, scn).strip())
    records = fh.merged_record_lines(str(out))
    assert [r["chunk"] for r in records] == [0, 1, 2, 3]
    fh.assert_records_match([{k: v for k, v in r.items() if k != "chunk"}
                             for r in records], serial_records)
    fh.assert_no_committed_chunk_reevaluated(str(out))
    stats = fh.read_stats(str(out))
    assert len(stats) == 2 and sum(s["n_chunks_committed"]
                                   for s in stats) == 4
    for s in stats:
        assert s["device"] == "cpu" and s["startup_s"] > 0, s
    assert not (out / "xla_cache").exists()


def test_frontier_kill_and_cross_worker_merge(tmp_path, serial_records):
    """The victim commits its first chunk's frontier state, then dies in
    the next chunk's pre-checkpoint window; the survivor takes the rest
    once the lease expires, and the merge of both shards is the
    reference's frontier."""
    out = str(tmp_path / "fab")
    sweepfabric.init_dir(SPEC, out, frontier_only=True)
    token = str(tmp_path / "kill.token")
    victim = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.pathfind", "sweep-worker",
         "--dir", out, "--device", "cpu", "--ttl", "3", "--poll", "0.2",
         "--claim-batch", "1"],
        env=fh.env_for_worker({"REPRO_FABRIC_KILL": f"post_rows:2:{token}",
                               "OMP_NUM_THREADS": "1"}),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    fh.wait_procs([victim], 120.0)
    assert victim.returncode == -signal.SIGKILL and os.path.exists(token)
    shards = sorted(os.listdir(os.path.join(out, "shards")))
    assert len(shards) == 1 and shards[0].startswith("frontier_state.")
    stats = FabricWorker(out, ttl_s=60.0, poll_s=0.2, claim_batch=1,
                         device="cpu").run()
    assert stats.n_chunks_committed == 3
    records, n_over, done = sweepfabric.merge_frontier(out, device="cpu")
    assert len(done) == 4 and n_over == 0
    fh.assert_no_committed_chunk_reevaluated(out)
    objectives = ref_sr.SweepSpec(**AXES).scenario_spec.variants()[
        0].resolve().objectives
    fh.assert_records_match(records,
                            ref_sr.pareto_records(serial_records,
                                                  objectives))
