"""The whole port slice on the CPU: calibrate -> files -> validate.

The port's CLI runs the quick suite on the host (``--device cpu``); the
reference reads every file it writes and scores the port's measurements
and profile to the same report; the files cross in both directions field
for field; chip_smoke.py's phases run on the host at a tiny size, and the
script itself refuses to run without a card.  The port and chip_smoke.py
import nothing of JAX or of the reference package.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.calibrate import fitting as ref_fitting
from repro.calibrate import microbench as ref_mb
from repro.calibrate import profiles as ref_profiles
from repro.calibrate import report as ref_report
from repro.core import age as ref_age
from repro.core import roofline as ref_roofline
from repro_torch import pathfind
from repro_torch.calibrate import microbench, profiles
from repro_torch.core import age, lmgraph, pathfinder, roofline
from repro_torch.core.parallelism import Strategy
from repro_torch.launch import train as port_train

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cal_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_cal") / "cal"
    rc = pathfind.main(["calibrate", "--suite", "quick", "--device", "cpu",
                        "--tech", "tpu_v5e", "--reps", "1", "--steps", "5",
                        "--starts", "2", "--tilings", "8", "--out",
                        str(out)])
    assert rc == 0
    return out


def test_reference_reads_the_port_output_and_agrees(cal_dir):
    prof = ref_profiles.load_profile(str(cal_dir / "profile.json"))
    recs = ref_mb.load_measurements(str(cal_dir))
    assert prof.tech == "tpu_v5e"
    assert prof.measure_fingerprint == ref_mb.default_spec(
        "quick", reps=1).fingerprint()
    assert len(recs) == len(ref_mb.enumerate_points(
        ref_mb.default_spec("quick")))
    want = ref_report.validation_report(
        recs, ref_age.tpu_v5e_microarch(), params=prof.params,
        ppe=ref_roofline.PPEConfig(n_tilings=8))
    got = json.loads((cal_dir / "report.json").read_text())
    assert set(got["groups"]) == set(want["groups"]) == {"gemm"}
    for g in want["groups"]:
        for key, v in want["groups"][g].items():
            np.testing.assert_allclose(got["groups"][g][key], v, rtol=1e-5,
                                       err_msg=key)
    for key, v in want["overall"].items():
        np.testing.assert_allclose(got["overall"][key], v, rtol=1e-5)


def test_validate_exits_zero(cal_dir, capsys):
    assert pathfind.main(["validate", "--out", str(cal_dir), "--device",
                          "cpu"]) == 0
    assert "gemm" in capsys.readouterr().out


def test_entry_points_need_the_card_unless_asked(cal_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pathfind.main(["validate", "--out", str(cal_dir)])
    with pytest.raises(RuntimeError, match="CUDA"):
        age.tpu_v5e_microarch()
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench.MicrobenchRunner(microbench.default_spec("quick")).run()
    with pytest.raises(RuntimeError, match="CUDA"):
        pathfind.main(["sweep", "--arch", "qwen1.5-0.5b", "--mesh", "8x8"])
    with pytest.raises(RuntimeError, match="CUDA"):
        pathfind.main(["plan", "--arch", "qwen1.5-0.5b", "--cell",
                       "train_4k", "--mesh", "16x16"])
    with pytest.raises(RuntimeError, match="CUDA"):
        pathfinder.sweep(["qwen1.5-0.5b"], ["train_4k"], [(8, 8)])
    with pytest.raises(RuntimeError, match="CUDA"):
        pathfinder.BatchedEvaluator(lmgraph.gemm_graph(64, 64, 64),
                                    Strategy("RC", kp1=1, kp2=1, dp=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.main(["--reduced", "--steps", "1"])
    # the fleet, its workers and the surrogate's exploration
    fleet = str(cal_dir.parent / "no-fleet")
    for argv in (["sweep", "--arch", "qwen1.5-0.5b", "--mesh", "2x2",
                  "--workers", "2", "--out", fleet],
                 ["sweep-worker", "--dir", fleet],
                 ["explore", "--arch", "qwen1.5-0.5b", "--mesh", "2x2"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            pathfind.main(argv)
    assert not os.path.exists(os.path.join(fleet, "shards"))


TINY = dict(suite="slice", gemm_shapes=((64, 64, 64), (128, 128, 256)),
            pallas_shapes=((64, 64, 64), (40, 120, 72)),
            elementwise_sizes=(1 << 12,), reps=1)


def test_files_cross_between_packages_field_for_field(tmp_path):
    """spec.json, measurements.jsonl and profile.json written by each
    package load in the other, every field intact."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_mb.MicrobenchRunner(ref_mb.MeasureSpec.from_dict(TINY),
                            out_dir=str(ref_dir)).run()
    microbench.MicrobenchRunner(microbench.MeasureSpec.from_dict(TINY),
                                out_dir=str(port_dir), device="cpu").run()
    for d in (ref_dir, port_dir):
        ref_recs = ref_mb.load_measurements(str(d))
        recs = microbench.load_measurements(str(d))
        assert recs == ref_recs and len(recs) == 5
        assert microbench.MicrobenchRunner.from_dir(str(d)).spec.to_dict() \
            == ref_mb.MicrobenchRunner.from_dir(str(d)).spec.to_dict()
    a = json.loads((ref_dir / "spec.json").read_text())
    b = json.loads((port_dir / "spec.json").read_text())
    assert a == b
    port_keys = [json.loads(line)
                 for line in (port_dir / "measurements.jsonl").open()]
    ref_keys = [json.loads(line)
                for line in (ref_dir / "measurements.jsonl").open()]
    assert [sorted(r) for r in port_keys] == [sorted(r) for r in ref_keys]

    params = dict(ref_fitting.default_params(), compute_eff=0.3,
                  kernel_overhead_s=7e-6)
    made = {
        "ref": ref_profiles.CalibrationProfile(
            tech="tpu_v5e", params=params, measure_fingerprint="abc",
            fit={"mre": 0.1, "n_tilings": 8}, validation={"x": {"n": 3}}),
        "port": profiles.CalibrationProfile(
            tech="tpu_v5e", params=params, measure_fingerprint="abc",
            fit={"mre": 0.1, "n_tilings": 8}, validation={"x": {"n": 3}}),
    }
    ref_profiles.save_profile(made["ref"], str(tmp_path / "ref.json"))
    profiles.save_profile(made["port"], str(tmp_path / "port.json"))
    assert (tmp_path / "ref.json").read_bytes() == \
        (tmp_path / "port.json").read_bytes()
    got = profiles.load_profile(str(tmp_path / "ref.json"))
    back = ref_profiles.load_profile(str(tmp_path / "port.json"))
    assert dataclasses.asdict(got) == dataclasses.asdict(made["ref"])
    assert dataclasses.asdict(back) == dataclasses.asdict(made["port"])
    # applied to the same template they give the same hardware and PPE
    ref_arch = ref_profiles.apply_profile(ref_age.tpu_v5e_microarch(), back)
    arch = profiles.apply_profile(age.tpu_v5e_microarch(device="cpu"), got)
    for f in age.LEAF_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(arch, f), np.float64),
                                   np.asarray(getattr(ref_arch, f),
                                              np.float64), rtol=1e-12)
    assert dataclasses.asdict(profiles.ppe_with_profile(
        roofline.PPEConfig(), got)) == dataclasses.asdict(
        ref_profiles.ppe_with_profile(ref_roofline.PPEConfig(), back))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_phases_rehearse_on_the_host(tmp_path, capsys,
                                                monkeypatch):
    cs = _chip_smoke()
    spec = microbench.MeasureSpec(**dict(
        TINY, model_archs=("qwen1.5-0.5b",),
        model_phases=("prefill", "decode_step"), model_seq=16))
    cases = {"gemm": (cs.UNIT_SHAPES[:2], ()),
             "flash_attention": (cs.ATTN_UNIT[-4:] + cs.ATTN_PATH[6:8], ()),
             "rglru_scan": (cs.RGLRU_UNIT[-2:], ()),
             "mlstm_parallel": (cs.MLSTM_UNIT[2:4], ())}
    recurrent = dict(cs.RECURRENT, prefill=(2, 16), check_len=16,
                     serve=dict(batch=2, prompt_len=4, gen=2),
                     use_reduced=True)
    # phase 4's search work on the golden file's grid, a short matrix
    search = dict(arches=("qwen1.5-0.5b", "recurrentgemma-2b"),
                  meshes=((8, 8), (16, 16)), logic=("N7", "N5", "N3"),
                  hbm=("HBM2E", "HBM3"), net=("IB-NDR-X8",), matrix_rows=256,
                  eager_rows=2)
    # phase 4 (d)'s runner over the golden file's archs
    runner = dict(cs.RUNNER, arches=cs.RUNNER["golden_arches"])
    # phase 4 (e): pathfind soe in the golden file's short run, a short
    # refinement of (d)'s directories
    deepflow = dict(cs.DEEPFLOW, soe=tuple(cs.SOE_CASES["soe_cli"][1][1:]),
                    cooptimize=("--top-k", "1", "--candidates", "1",
                                "--steps", "2", "--starts", "2"))
    # phase 7: a few Function cases, then training at smoke size
    train = dict(cs.TRAIN, batch=2, seq=16, steps=8, resume_at=5, timed=2,
                 others=(("recurrentgemma-2b", 2, 16), ("xlstm-125m", 2, 8)),
                 other_steps=2, use_reduced=True,
                 grads={"flash_attention": cs.GRAD_CASES["flash_attention"][
                     :2], "rglru_scan": cs.GRAD_CASES["rglru_scan"][:2],
                     "mlstm_parallel": cs.GRAD_CASES["mlstm_parallel"][:2]})
    # phase 8: the families reduced, at smoke size
    families = dict(cs.FAMILIES, use_reduced=True,
                    moe=dict(cs.FAMILIES["moe"], prefill=(2, 16),
                             check_len=16),
                    whisper=dict(cs.FAMILIES["whisper"], frames=(2, 24),
                                 steps=4, train=(2, 24)),
                    serve=dict(batch=2, prompt_len=4, gen=2))
    # phase 10: a fleet of one worker (and its respawn), each worker
    # process on one host thread, beside the other test processes; explore
    # over the golden archs' 16 points needs a budget above the
    # surrogate's training floor (the card's default budget runs over
    # every arch)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    fleet = dict(cs.FLEET, workers=1, explore=("--chunk-size", "1",
                                               "--eval-budget", "12"))
    phase_fleet = cs.phase_fleet

    def one_thread_fleet(*args, **kwargs):
        # the surrogate's small fits on one host thread in this process too
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return phase_fleet(*args, **kwargs)
        finally:
            torch.set_num_threads(prev)

    monkeypatch.setattr(cs, "phase_fleet", one_thread_fleet)
    # phase 11: one full-width cell of the CLI (a decode step, the
    # quickest), beside phase 7 (b)'s step at smoke size
    dry = dict(cs.DRYRUN, cli=(("qwen1.5-0.5b", "decode_32k", "single"),))
    rows = cs.run(torch.device("cpu"), spec, tmp_path / "cs", cases,
                  dict(batch=2, prompt_len=4, gen=2, use_reduced=True),
                  16, recurrent, steps=3, starts=2, search=search,
                  runner=runner, deepflow=deepflow, train=train,
                  families=families, fleet=fleet, dry=dry)
    out = capsys.readouterr().out
    assert "gemm_pallas" in out and "total_s" in out
    assert "strategy       RC-1-16-d16-p1" in out
    assert "sweep on cpu: 24 points" in out
    assert "24 rows held to test_torch_golden_sweep.npz" in out
    assert "all 256 rows held to the host's" in out
    assert "eager rows on cpu: 2 in" in out
    assert "then --resume: skipped 2, evaluated 2 (zero re-evaluated)" in out
    for scenario, n in (("train", 16), ("serving", 16),
                        ("serving-traffic", 32)):
        assert f"  {scenario}: {n} records held to the host's, {n} to " \
            "test_torch_golden_runner.jsonl" in out
    assert "pathfind size --from DIR" in out
    for scenario in ("train", "serving", "serving-traffic"):
        assert f"  {scenario} --backend serial on cpu: " in out
        assert f"  {scenario} --frontier-only on cpu: " in out
    assert "then --resume on the pipeline: skipped 1, evaluated 1" in out
    assert "resumed from frontier_state.npz: skipped 1" in out
    for backend in ("thread", "process"):
        assert f"  train (golden archs) --backend {backend} --workers " \
            in out
    for scenario in ("train", "serving", "serving-traffic"):
        assert f"  {scenario} --bucketing on cpu, from empty caches: " \
            "serial " in out
    assert out.count("the bucketed pipeline's records are the bucketed "
                     "serial's bit for bit") == 3
    assert out.count(" designs traced into ") == 6
    assert out.count("of 84 rows of (c)'s skeleton") == 2
    assert "buckets on cpu: 16 records" in out
    assert "groups, unbucketed on cpu: 16 records" in out
    for flags, held in (("--bucketing --compile-ahead 2 --no-compile-cache",
                         "the bucketed pipeline's records bit for bit"),
                        ("--no-bucketing", "the pipeline's records "),
                        ("--backend device", "the pipeline's records ")):
        assert f"  train (golden archs) {flags} on cpu: 16 points in " in out
        assert held in out
    assert "  evaluate_matrix(devices=1, block=8) of 4096 rows on cpu: " \
        in out
    assert "the host has 0 card(s): the 2-device split was not run" in out
    assert "# phase 4 (f): " in out
    assert "pathfind soe on cpu: RC-4-1-d16-p1 492.126 ms/iter, 6 " \
        "queries; 3 descents, 9 eq.-6 steps in" in out
    assert "the card's pathfind soe prints the reference's lines\n" in out
    assert "504 numbers held to test_torch_golden_soe.json" in out
    for name in ("train", "traffic"):
        assert f"  {name}: " in out and f"cooptimize --from {name} (" in out
    assert "decode_step" in out and "plan RC-1-1-d1-p1" in out
    assert "phase 6: recurrentgemma-2b-smoke" in out
    assert "phase 6: xlstm-125m-smoke" in out
    assert out.count("Model.prefill (2, 16)") == 3
    for name in ("flash_attention", "rglru_scan", "mlstm_parallel"):
        for dtype in ("float32", "bfloat16"):
            assert f"  {name} {dtype}: 2 cases, gradients within" in out
    assert "phase 7 (b): train qwen1.5-0.5b-smoke" in out
    assert "  resumed from the step-5 checkpoint (6 updates) for 2 " \
        "steps" in out
    assert "tokens/s; the planner's predicted step (RC-1-1-d1-p1" in out
    assert "phase 7 (c): train recurrentgemma-2b-smoke" in out
    assert "phase 7 (c): train xlstm-125m-smoke" in out
    assert out.count("worst rel err") == 3
    for arch in cs.REMAT["archs"]:
        for remat in ("True", "'dots'"):
            assert f"  {arch}-smoke (2, 64) remat={remat}: loss rel" in out
    for case in cs.FAMILY_GOLDEN["cases"]:
        for dtype in ("float32", "bfloat16"):
            assert f"  {case}/{dtype}: " in out
    assert "phase 8 (b): qwen2-moe-a2.7b-smoke" in out
    assert "drop 0 assignments" in out and "vs every expert densely" in out
    assert "phase 8 (c): whisper-large-v3-smoke" in out
    assert "== phase 9: parallelism; process group gloo, rank 0 of 1" in out
    assert "3 steps on a 1x1 DeviceMesh ('data', 'model')" in out
    assert "against phase 7 (b)'s" in out and "mesh / unsharded" in out
    assert "-- (b) bucketed_all_reduce of a bf16 / f32 tree" in out
    assert out.count("-- (c) collective ") == 2
    assert "-- (d) the host has 0 card(s): no 2-rank mesh" in out
    assert not torch.distributed.is_initialized()
    assert "== phase 10: the fleet and the surrogate on cpu" in out
    assert "  (a) pathfind sweep --workers 1 --out DIR (train, golden " \
        "archs): 16 points in 2 chunks, " in out
    assert "(d)'s pipeline records bit for bit, 16 golden records" in out
    assert out.count(" (interpreter, torch import, device context), ") \
        == 1
    assert "  (b) a fleet of 1 over 8 chunks, one SIGKILL'd at post_rows:2 " \
        "(exit codes [-9]) and one respawn: 2 incarnations" in out
    assert "  (b) a worker SIGTERM'd in its first superbatch: exit 0, " in out
    assert "  (c) --workers 1 --frontier-only (train, (d)'s axes): " in out
    assert "phase 4's --frontier-only frontier bit for bit" in out
    assert "evaluated 12/16 points over 1 rounds in " in out
    assert "of the exhaustive frontier found" in out
    assert "the surrogate's fit on 12 records" in out
    assert "claimed and committed in that order" in out
    assert "# phase 10: " in out and "# gemm kernel launches on phase 10: 0" \
        in out
    assert "# phase 11's processes waited for after phase 2: " in out
    assert "== phase 11: the multi-pod dry-run on fake tensors, the cpu " \
        "path, 3 processes run together before phase 3; host rehearsal" \
        in out
    assert "  (b) dryrun_step: exit 0, " in out and "s CPU" in out
    assert "  (c) dryrun_ffn: exit 0, " in out
    assert "-- (c) phi3-medium-14b prefill_32k on 16x16 cut to 2 layers, " \
        "rank 0's bytes received a step" in out
    assert ", at most the reference's " in out
    assert "  each kind the host's count to 1 %: held" in out
    assert "-- (a) python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b " \
        "--cell decode_32k --mesh single --device cpu: exit 0" in out
    assert "  single (16, 16) (256 fake ranks), RC-1-16-d16-p1: " in out
    assert "-- (b) phase 7 (b)'s step (qwen1.5-0.5b, (2, 16), f32, no " \
        "remat) through _step_metrics" in out
    assert "attention calls 0 against its flash_attention launches 0" in out
    assert "-- (b) qwen2-moe-a2.7b decode_32k on 16x16 cut to 2 layers, " \
        "rank 0's bytes received a step" in out
    for kind in ("all-gather", "all-reduce"):
        assert f"  {kind} " in out and "bytes, at most the reference's " in out
    assert "# phase 11: " in out and "# flash_attention kernel launches " \
        "on phase 11: 0" in out
    assert "4 decode steps from the prefill vs a forward" in out
    assert out.count("Model.prefill") == 4
    assert [r["name"] for r in rows] == ["gemm", "flash_attention",
                                         "rglru_scan", "mlstm_parallel"]
    assert [r["backward"] for r in rows] == [
        "none (refuses)", "plain recompute", "rglru_scan kernel, reversed",
        "plain recompute"]
    for row in rows:
        assert row["launches"] == 0
        assert set(row) == {"name", "route", "source", "replaces",
                            "backward", "launches", "max_abs_err", "ms",
                            "plain_ms", "bound_ms", "bound_by",
                            "library_ms"}
        assert (REPO / row["source"]).is_file()
        path, line = row["replaces"].split(":")
        assert "pallas_call" in (REPO / path).read_text().splitlines()[
            int(line) - 1]


def test_chip_smoke_refuses_without_a_card_or_the_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    for cwd in (REPO, alone):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_card.py"]
    assert len(files) > 20
    assert REPO / "src" / "repro_torch" / "core" / "sweeppipeline.py" in files
    assert REPO / "src" / "repro_torch" / "launch" / "mesh.py" in files
    for name in ("dryrun.py", "counters.py"):
        assert REPO / "src" / "repro_torch" / "launch" / name in files
    for name in ("sweepfabric.py", "surrogate.py"):
        assert REPO / "src" / "repro_torch" / "core" / name in files
    walked = {f.parent.name for f in files}
    assert {"core", "kernels", "calibrate", "models", "launch", "optim",
            "data", "runtime", "checkpoint", "parallel"} <= walked
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
