"""``python -m repro_torch.pathfind sweep`` on the executors, on the CPU:
``--frontier-only`` (stopped, resumed, refused where the reference
refuses, and read by ``size --from DIR`` as the reference reads it),
``--backend thread|process --workers N``, ``--superbatch``, and a
pipeline sweep killed with SIGKILL and resumed.  Every directory is held
to the reference's serial runner's (bucketing off, a private prediction
cache: ROADMAP queue 3); the reference's ``size --from`` reads records
only and evaluates nothing.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

from repro import pathfind as ref_pathfind
from repro.core import pathfinder as ref_pf
from repro.core import sweeprunner as ref_sr
from repro_torch import pathfind

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-5
# tests/test_torch_sweep_runner_cli.py's serving-traffic grid
TRAFFIC = ["--scenario", "serving-traffic", "--arch", "qwen1.5-0.5b",
           "--arch", "recurrentgemma-2b", "--mesh", "8x8", "--logic",
           "N7,N5", "--hbm", "HBM2E,HBM3", "--objectives",
           "energy,cost,goodput", "--scenario-param", "qps=0.25,1", "--slo",
           "18", "--chunk-size", "4"]
TRAIN = ["--arch", "qwen1.5-0.5b", "--mesh", "2x2", "--mesh", "4x4",
         "--logic", "N7,N5", "--scale", "0.9,1,1.1", "--tilings", "4",
         "--chunk-size", "2"]
CPU = ["--device", "cpu"]


def _main(argv, capsys, main=pathfind.main):
    rc = main([str(a) for a in argv])
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _lines(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _ref_records(argv) -> list:
    """The reference's serial records of a port command line's grid."""
    spec = pathfind._spec_from_args(pathfind._parser().parse_args(
        ["sweep", *argv]))
    return ref_sr.SweepRunner(
        ref_sr.SweepSpec.from_dict(spec.to_dict()), backend="serial",
        bucketing=False, cache=ref_pf.PredictionCache()).run().records


def _same_by_key(got, want):
    """Records equal by key (chunk tags aside): non-numbers exactly,
    numbers within RTOL."""
    got, want = ({r["key"]: {k: v for k, v in r.items() if k != "chunk"}
                  for r in recs} for recs in (got, want))
    assert got.keys() == want.keys() and want
    for key, w in want.items():
        assert list(got[key]) == list(w), key
        for k, v in w.items():
            g = got[key][k]
            if isinstance(v, float) and not isinstance(v, bool):
                assert abs(g - v) <= RTOL * abs(v), (key, k, g, v)
            else:
                assert g == v, (key, k, g, v)


_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]\d+)?")


def _same_text(got: str, want: str) -> None:
    """Equal text, apart from printed numbers within rtol 1e-5 plus one
    unit in the last printed digit."""
    assert _NUM.split(got) == _NUM.split(want), (got, want)
    for a, b in zip(_NUM.findall(got), _NUM.findall(want)):
        mant, _, exp = b.partition("e")
        unit = 10.0 ** (int(exp or 0) - len(mant.partition(".")[2]))
        assert abs(float(a) - float(b)) <= RTOL * abs(float(b)) + unit, \
            (a, b)


def test_frontier_only_stops_resumes_and_sizes_as_the_reference(
        tmp_path, capsys):
    """``--frontier-only --out DIR --max-chunks 2`` prints the resume
    line, ``--resume --frontier-only`` finishes with the keys of the
    reference's `pareto_records` over its full sweep; ``size --from DIR``
    on that frontier directory prints what the reference's prints; the
    reference's refusals (``--pareto``, a full-sweep directory, a second
    run into the directory) exit 2."""
    d = tmp_path / "front"
    rc, out, err = _main(["sweep", *TRAFFIC, *CPU, "--frontier-only",
                          "--out", d, "--max-chunks", 2], capsys)
    assert rc == 0 and (d / "frontier_state.npz").is_file()
    assert err.startswith("# sweep[serving-traffic] frontier-only "
                          "backend=pipeline: 16 points in 4 chunks; skipped "
                          "0 checkpointed, evaluated 2 (8 points) in ")
    assert f"# incomplete: resume with `python -m repro_torch.pathfind " \
        f"sweep --out {d} --resume --frontier-only --device cpu` (carried " \
        f"state in frontier_state.npz)" in err
    rc, out, err = _main(["sweep", "--out", d, "--resume", "--frontier-only",
                          *CPU], capsys)
    assert rc == 0 and "skipped 2 checkpointed, evaluated 2 (8 points)" \
        in err and "# incomplete" not in err
    spec = pathfind._spec_from_args(pathfind._parser().parse_args(
        ["sweep", *TRAFFIC]))
    objectives = spec.scenario_spec.variants()[0].resolve().objectives
    want = ref_sr.pareto_records(_ref_records(TRAFFIC), objectives)
    got = _lines(d / "frontier.jsonl")
    assert f"# frontier: {len(got)} non-dominated points over " \
        f"{'/'.join(objectives)}" in err
    _same_by_key(got, want)
    assert len(out.splitlines()) == len(got) + 1      # the CSV
    size = ["size", "--from", d, "--qps", "2", "--slo-ttft-p99", "18"]
    ref = _main(size, capsys, ref_pathfind.main)
    port = _main(size, capsys)
    assert port[0] == ref[0]
    for g, w in zip(port[1:], ref[1:]):
        _same_text(g.replace(str(d), "DIR"), w.replace(str(d), "DIR"))
    assert "zero sweep re-evaluations" in port[2]

    rc, _, err = _main(["sweep", *TRAFFIC, *CPU, "--frontier-only",
                        "--pareto", "ttft_p99_s"], capsys)
    assert rc == 2 and "already reduces to the scenario's Pareto" in err
    rc, _, err = _main(["sweep", *TRAFFIC, *CPU, "--frontier-only",
                        "--out", d], capsys)
    assert rc == 2 and "frontier-state checkpoint" in err
    full = tmp_path / "full"
    assert _main(["sweep", *TRAIN, *CPU, "--out", full, "--max-chunks", 1],
                 capsys)[0] == 0
    rc, _, err = _main(["sweep", "--out", full, "--resume",
                        "--frontier-only", *CPU], capsys)
    assert rc == 2 and "full-sweep checkpoint" in err


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_pool_backends_write_the_reference_directory(tmp_path, capsys,
                                                     backend):
    """``--backend thread|process --workers 2 --device cpu``: the
    reference's spec.json, its chunk lines (in completion order) and its
    records; the process pool's workers are started with spawn."""
    d = tmp_path / backend
    rc, _, err = _main(["sweep", *TRAIN, *CPU, "--backend", backend,
                        "--workers", 2, "--out", d], capsys)
    assert rc == 0 and f"backend={backend}: 12 points in 6 chunks" in err
    ref = tmp_path / "ref"
    spec = pathfind._spec_from_args(pathfind._parser().parse_args(
        ["sweep", *TRAIN]))
    ref_sr.SweepRunner(ref_sr.SweepSpec.from_dict(spec.to_dict()),
                       out_dir=str(ref), backend="serial", bucketing=False,
                       cache=ref_pf.PredictionCache()).run()
    assert (d / "spec.json").read_bytes() == (ref / "spec.json").read_bytes()
    assert sorted((d / "checkpoint.jsonl").read_text().splitlines()) == \
        sorted((ref / "checkpoint.jsonl").read_text().splitlines())
    _same_by_key(_lines(d / "results.jsonl"), _lines(ref / "results.jsonl"))


def test_superbatch_changes_nothing_but_the_dispatch(tmp_path, capsys):
    """``--superbatch`` 1, 4 and the default write the same directory;
    0 exits 2 with the reference's message, as ``--workers`` on the
    pipeline (the fabric) does without ``--out``."""
    dirs = []
    for sb in (None, 1, 4):
        d = tmp_path / f"sb-{sb}"
        argv = ["sweep", *TRAIN, *CPU, "--out", d] + (
            ["--superbatch", sb] if sb else [])
        assert _main(argv, capsys)[0] == 0
        dirs.append(d)
    for d in dirs[1:]:
        for name in ("spec.json", "checkpoint.jsonl"):
            assert (d / name).read_bytes() == (dirs[0] / name).read_bytes()
        assert _lines(d / "results.jsonl") == _lines(dirs[0] /
                                                     "results.jsonl")
    rc, _, err = _main(["sweep", *TRAIN, *CPU, "--superbatch", 0], capsys)
    assert rc == 2 and err == (
        "error: --superbatch must be a positive number of design points "
        "(got 0); drop the flag for the default (256)\n")
    rc, _, err = _main(["sweep", *TRAIN, *CPU, "--workers", 2], capsys)
    assert rc == 2 and err == (
        "error: --workers N on the pipeline backend is the distributed "
        "sweep fabric; it needs --out DIR (the shared coordination "
        "directory)\n")


def test_sigkill_of_a_pipeline_sweep_then_resume(tmp_path):
    """A pipeline sweep (one design a chunk and a superbatch) killed with
    SIGKILL once a chunk is committed, then ``--resume``: the committed
    chunks are skipped and the records are the reference's serial
    ones."""
    grid = ["--arch", "qwen1.5-0.5b", "--mesh", "2x2", "--mesh", "2x4",
            "--mesh", "4x4", "--mesh", "2x8", "--mesh", "8x8", "--mesh",
            "4x8", "--logic", "N7,N5", "--tilings", "4", "--chunk-size", "1"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO / "src"), os.environ.get("PYTHONPATH", ""))
        if p))
    out = tmp_path / "sweep"
    cmd = [sys.executable, "-m", "repro_torch.pathfind", "sweep", *grid,
           *CPU, "--superbatch", "1", "--backend", "pipeline", "--out",
           str(out)]
    proc = subprocess.Popen(cmd, env=env, cwd=REPO,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    ckpt = out / "checkpoint.jsonl"
    deadline = time.time() + 300
    try:
        while time.time() < deadline and proc.poll() is None:
            if ckpt.exists() and ckpt.read_text().count("\n") >= 1:
                proc.send_signal(signal.SIGKILL)
                break
            time.sleep(0.02)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    done_before = 0
    for line in ckpt.read_text().splitlines():
        try:
            json.loads(line)
            done_before += 1
        except json.JSONDecodeError:
            pass
    assert done_before >= 1, "the sweep committed no chunk before the kill"
    resumed = subprocess.run(
        [sys.executable, "-m", "repro_torch.pathfind", "sweep", "--out",
         str(out), "--resume", *CPU], env=env, capture_output=True,
        text=True, cwd=REPO, timeout=420)
    assert resumed.returncode == 0, resumed.stderr
    assert f"skipped {done_before} checkpointed" in resumed.stderr
    lines = ckpt.read_text().splitlines()
    assert sorted(json.loads(x)["chunk"] for x in lines) == \
        list(range(len(lines))), "a chunk committed twice or never"
    _same_by_key(_lines(out / "results.jsonl"), _ref_records(grid))
    assert np.isfinite([r["time_s"] for r in _lines(out /
                                                     "results.jsonl")]).all()
