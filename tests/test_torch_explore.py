"""The port's ``explore`` (``repro_torch.core.surrogate.explore`` and
``python -m repro_torch.pathfind explore --device cpu``) against the
reference on the CPU: the budget is a hard ceiling and a resume skips
committed chunks, as the reference's loop does on the same grid; with the
budget at the grid, the frontier is the exhaustive one; and the CLI prints
the reference's lines (numbers within 1e-4 plus the last printed digit,
as ``chip_smoke._printed_close`` compares them; elapsed seconds masked).

The reference's explore evaluates through its label-mode ``evaluate``,
which buckets by default, so its oracles run inside a fixture that turns
its bucketing off and swaps in a private prediction cache, restoring both
(ROADMAP queue 3).
"""

import contextlib
import dataclasses
import io
import re

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest
import torch

from repro import pathfind as ref_pathfind
from repro.core import compileahead as ref_ca
from repro.core import pathfinder as ref_pf
from repro.core import surrogate as ref_sur
from repro.core import sweeprunner as ref_sr
from repro_torch import pathfind
from repro_torch.core import pathfinder, surrogate, sweepfabric, sweeprunner

AXES = dict(arches=("qwen1.5-0.5b",), mesh_shapes=((2, 2), (4, 1)),
            scenario="train", logic_nodes=("N7", "N5"), n_tilings=4,
            chunk_size=1)                 # the reference's tiny grid: 4
SPEC, REF_SPEC = sweeprunner.SweepSpec(**AXES), ref_sr.SweepSpec(**AXES)
SMALL = dict(ensemble=2, hidden=8, steps=30)
# a grid with fitting rounds for the CLI: 12 points, a budget of 10
CLI_AXES = ["--arch", "qwen1.5-0.5b", "--mesh", "2x2", "--mesh", "4x1",
            "--mesh", "4x4", "--logic", "N7,N5", "--hbm", "HBM2E,HBM3",
            "--tilings", "4", "--chunk-size", "1", "--ensemble", "2",
            "--hidden", "8", "--steps", "40", "--eval-budget", "10",
            "--init-chunks", "4", "--batch-chunks", "2"]
RTOL = 1e-4
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]\d+)?")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The ensemble's small products on one host thread (many threads
    only contend on a loaded host), the count put back after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture
def ref_bucketing_off():
    prev_bucketing = ref_ca.set_bucketing_default(False)
    prev = ref_pf.prediction_cache()
    ref_pf.set_prediction_cache(ref_pf.PredictionCache())
    try:
        yield
    finally:
        ref_pf.set_prediction_cache(prev)
        ref_ca.set_bucketing_default(prev_bucketing)


def _cfgs(**kw):
    return (surrogate.ExploreConfig(
        surrogate=surrogate.SurrogateConfig(**SMALL), **kw),
        ref_sur.ExploreConfig(surrogate=ref_sur.SurrogateConfig(**SMALL),
                              **kw))


def _summary(stats):
    return (stats.n_points_evaluated, stats.n_chunks_evaluated,
            stats.n_chunks_skipped, stats.rounds, stats.stop,
            sorted(r["key"] for r in stats.records),
            sorted(r["key"] for r in stats.frontier))


def test_explore_budget_is_a_hard_ceiling_and_resume_skips(
        tmp_path, ref_bucketing_off):
    """Budget 2, then a resume with the grid's budget: the same chunks,
    rounds and stops as the reference; the explored directory is a
    normal sweep directory the reference reads."""
    cfg, rcfg = _cfgs(eval_budget=2, init_chunks=1, batch_chunks=1,
                      min_fit_rows=1)
    out, rout = str(tmp_path / "ex"), str(tmp_path / "ref")
    first = surrogate.explore(SPEC, out_dir=out, cfg=cfg, cache=None,
                              device="cpu")
    want = ref_sur.explore(REF_SPEC, out_dir=rout, cfg=rcfg, cache=None)
    assert first.n_points_evaluated == 2 and first.stop == "budget"
    assert len(first.records) == first.n_points_evaluated
    assert _summary(first) == _summary(want)
    with pytest.raises(FileExistsError):
        surrogate.explore(SPEC, out_dir=out, cfg=cfg, cache=None,
                          device="cpu")
    cfg2 = dataclasses.replace(cfg, eval_budget=4)
    second = surrogate.explore(SPEC, out_dir=out, cfg=cfg2, resume=True,
                               cache=None, device="cpu")
    want2 = ref_sur.explore(REF_SPEC, out_dir=rout, resume=True, cache=None,
                            cfg=dataclasses.replace(rcfg, eval_budget=4))
    assert second.n_chunks_skipped == first.n_chunks_evaluated
    assert second.n_points_evaluated == 2 and second.stop == "exhausted"
    assert _summary(second) == _summary(want2)
    spec2, records = ref_sr.load_sweep(out)
    assert spec2.fingerprint() == SPEC.fingerprint() and len(records) == 4


def test_explore_frontier_matches_exhaustive_on_tiny_grid(
        ref_bucketing_off):
    """With the budget at the grid, explore is the exhaustive sweep: its
    frontier's keys are those of the reference serial runner's."""
    cfg, _ = _cfgs(eval_budget=4, init_chunks=2, batch_chunks=2,
                   min_fit_rows=2)
    stats = surrogate.explore(SPEC, cfg=cfg,
                              cache=pathfinder.PredictionCache(),
                              device="cpu")
    assert stats.n_points_evaluated == 4
    full = ref_sr.SweepRunner(REF_SPEC, backend="serial", bucketing=False,
                              cache=ref_pf.PredictionCache()).run().records
    objectives = REF_SPEC.scenario_spec.variants()[0].resolve().objectives
    assert sorted(r["key"] for r in stats.frontier) == sorted(
        r["key"] for r in ref_sr.pareto_records(full, objectives))


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue()


def _norm(text: str, root: str) -> str:
    """The port's command lines as the reference's, the directories as
    names, elapsed seconds masked."""
    text = text.replace("repro_torch.pathfind", "repro.pathfind")
    text = text.replace(" --device cpu`", "`").replace(root, "ROOT")
    return re.sub(r"in \d+\.\ds", "in Ts", text)


def _printed_close(got: str, want: str) -> None:
    assert _NUM.split(got) == _NUM.split(want), (got, want)
    for a, b in zip(_NUM.findall(got), _NUM.findall(want)):
        mant, _, exp = b.partition("e")
        unit = 10.0 ** (int(exp or 0) - len(mant.partition(".")[2]))
        assert abs(float(a) - float(b)) <= RTOL * abs(float(b)) + unit, \
            (a, b)


def test_pathfind_explore_prints_the_reference_lines(tmp_path,
                                                     ref_bucketing_off):
    """``explore --out DIR`` (seed chunks, then fitting rounds), its
    ``--resume``, and ``--order-dir`` on a fresh fabric directory trained
    ``--train-from`` the explored directory: the reference's standard
    output and error in each, and the same advisory order."""
    root = str(tmp_path)
    runs = {"port": (pathfind.main, ["--device", "cpu"]),
            "ref": (ref_pathfind.main, [])}
    outs = {}
    for name, (main, extra) in runs.items():
        d = tmp_path / name
        fab = d / "fab"
        sweepfabric.init_dir(SPEC, str(fab))
        outs[name] = [
            _run(main, ["explore", *CLI_AXES, "--out", d / "ex", *extra]),
            _run(main, ["explore", "--out", d / "ex", "--resume",
                        "--eval-budget", "2", "--ensemble", "2",
                        "--hidden", "8", "--steps", "40", *extra]),
            _run(main, ["explore", "--order-dir", fab, "--train-from",
                        d / "ex", "--ensemble", "2", "--hidden", "8",
                        "--steps", "40", *extra])]
        outs[name] = [(rc, _norm(o.replace(str(d), "DIR"), root),
                       _norm(e.replace(str(d), "DIR"), root))
                      for rc, o, e in outs[name]]
    for got, want in zip(outs["port"], outs["ref"]):
        assert got[0] == want[0] == 0, (got, want)
        _printed_close(got[1], want[1])
        _printed_close(got[2], want[2])
    first = outs["port"][0]
    assert "# explore: round 1 -> " in first[1]
    assert "# explore[train] acq=ucb: evaluated 10/12 points" in first[2]
    assert "# explore: wrote advisory order for 4 chunks" in \
        outs["port"][2][2]
    assert sweepfabric.load_chunk_order(
        str(tmp_path / "port" / "fab"), SPEC.fingerprint(), 4) == \
        sweepfabric.load_chunk_order(str(tmp_path / "ref" / "fab"),
                                     SPEC.fingerprint(), 4)
