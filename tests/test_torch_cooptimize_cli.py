"""``python -m repro_torch.pathfind soe|cooptimize --device cpu`` against
the reference, on the CPU: ``soe`` prints the reference's lines (held in
tests/test_torch_golden_soe.json; numbers within the last printed digit);
``cooptimize --from`` refines a sweep directory written by the reference's
serial runner, and the reference's `refine_sweep` refines one the port
wrote, to the same records (rtol 1e-5) and counts; the refined records
keep the sweep's schema; contradicting flags exit 2 with the reference's
message, and without ``--device`` both commands want the card.

The reference runs with its bucketing off and a private prediction cache
(ROADMAP queue 3).
"""

import contextlib
import dataclasses
import io
import json
import re

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest
import torch

from repro import pathfind as ref_pathfind
from repro.core import cooptimize as ref_co
from repro.core import pathfinder as ref_pf
from repro.core import sweeprunner as ref_sr
from repro_torch import pathfind
from repro_torch.core import cooptimize, pathfinder, scenarios, sweeprunner
from soehelpers import RTOL, chip_smoke, private_reference

CS = chip_smoke()
SPEC = dict(arches=("qwen1.5-0.5b",), mesh_shapes=((2, 2), (4, 4)),
            scenario="train", logic_nodes=("N7",), n_tilings=4, chunk_size=8)
FLAGS = dict(top_k=2, candidates_per_seed=1, steps=4, starts=2)
ARGV = ["--top-k", "2", "--candidates", "1", "--steps", "4", "--starts", "2"]
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]\d+)?")


def _same_text(got: str, want: str) -> None:
    """Equal text, apart from numbers within rtol 1e-5 plus one unit in
    the last printed digit."""
    assert _NUM.split(got) == _NUM.split(want), (got, want)
    for a, b in zip(_NUM.findall(got), _NUM.findall(want)):
        mant, _, exp = b.partition("e")
        unit = 10.0 ** (int(exp or 0) - len(mant.partition(".")[2]))
        assert abs(float(a) - float(b)) <= RTOL * abs(float(b)) + unit, \
            (a, b)


def _same_records(got, want):
    assert [r["key"] for r in got] == [r["key"] for r in want] and want
    for g, w in zip(got, want):
        assert list(g) == list(w), (list(g), list(w))
        for k, v in w.items():
            if isinstance(v, float):
                assert abs(g[k] - v) <= RTOL * abs(v), (w["key"], k, g[k], v)
            elif isinstance(v, dict):
                for kk, vv in v.items():
                    if isinstance(vv, dict):
                        for f, x in vv.items():
                            assert abs(g[k][kk][f] - x) <= 2e-5, (k, kk, f)
                    else:
                        assert abs(g[k][kk] - vv) <= RTOL * abs(vv), (k, kk)
            else:
                assert g[k] == v, (w["key"], k, g[k], v)


@pytest.fixture(scope="module")
def refined(tmp_path_factory):
    """The same train sweep written by each package's serial runner; the
    port's ``cooptimize --from`` the reference's directory, and the
    reference's `refine_sweep` on the port's."""
    root = tmp_path_factory.mktemp("coopt")
    dirs = {"ref": str(root / "ref"), "port": str(root / "port")}
    with private_reference():
        ref_sr.SweepRunner(ref_sr.SweepSpec(**SPEC), out_dir=dirs["ref"],
                           backend="serial", bucketing=False,
                           cache=ref_pf.PredictionCache()).run()
    sweeprunner.SweepRunner(sweeprunner.SweepSpec(**SPEC),
                            out_dir=dirs["port"],
                            cache=pathfinder.PredictionCache(),
                            device="cpu").run()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = pathfind.main(["cooptimize", "--from", dirs["ref"], *ARGV,
                            "--device", "cpu"])
    assert rc == 0, err.getvalue()
    with private_reference():
        ref_stats = ref_co.refine_sweep(dirs["port"],
                                        ref_co.RefineConfig(**FLAGS))
    return dict(dirs=dirs, stdout=out.getvalue(), stderr=err.getvalue(),
                ref=ref_stats)


def test_soe_prints_the_references_lines(capsys):
    """``pathfind soe`` at phase 4 (e)'s flags, in a short run, against
    the reference's printed lines: the strategy, the time, the queries
    and the budgets."""
    entry = json.loads(CS.GOLDEN_SOE.read_text())["soe_cli"][1]
    assert entry["argv"] == CS.SOE_CASES["soe_cli"][1]
    assert pathfind.main(entry["argv"] + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    _same_text(got, entry["stdout"])
    assert got.startswith("strategy  RC-4-1-d16-p1\n")
    assert "queries   6\n" in got          # 3 steps x 2 starts: batched


def test_cooptimize_refines_across_packages(refined):
    """The port refines the reference's directory and the reference the
    port's, to the same records: the CSV the port prints is the
    reference's records' CSV, and each record (labels, keys, flags,
    knobs, budgets, metrics) is the reference's."""
    ref = refined["ref"]
    recs = [json.loads(x) for x in
            open(f"{refined['dirs']['ref']}/refined.jsonl")]
    want = [json.loads(x) for x in open(ref.out_path)]
    assert len(recs) == ref.n_refined >= 1
    _same_records(recs, want)
    scn = scenarios.get_scenario("train")
    _same_text(refined["stdout"], ref_sr.to_csv(want, scn) + "\n")
    lines = refined["stderr"].splitlines()
    assert lines[0].startswith(
        f"# cooptimize[train]: {ref.n_records} sweep records -> frontier "
        f"{ref.n_frontier}; refined {ref.n_candidates} candidates around "
        f"{ref.n_seeds} seeds ({ref.n_objective_evals} objective evals, "
        f"{ref.n_unimproved} unimproved) in ")
    assert lines[1].startswith(f"# {ref.n_dominating}/{ref.n_refined} "
                               f"refined points dominate")


def test_refined_records_keep_the_sweep_schema(refined):
    """Label and scenario fields, the refinement's own fields, seeds from
    the frontier, and the records compose with `pareto_records` and
    `to_csv`; the counts are the reference's."""
    spec, records = sweeprunner.load_sweep(refined["dirs"]["ref"])
    scn = scenarios.get_scenario("train")
    stats = cooptimize.refine_sweep(
        (spec, records), cooptimize.RefineConfig(**FLAGS), device="cpu")
    ref = refined["ref"]
    for f in ("n_records", "n_frontier", "n_seeds", "n_candidates",
              "n_refined", "n_unimproved", "n_dominating",
              "n_objective_evals"):
        assert getattr(stats, f) == getattr(ref, f), f
    assert stats.out_path is None
    base = set(sweeprunner.LABEL_FIELDS) | set(scn.fields) | {"key"}
    frontier = {r["key"] for r in stats.frontier}
    for rec in stats.records:
        assert base <= set(rec) and rec["refined"] is True
        assert set(rec["knobs"]) == set(cooptimize.KNOBS)
        assert rec["seed_key"] in frontier
        assert set(rec["budgets"]) == {"area_frac", "power_frac",
                                       "perim_frac"}
    joint = sweeprunner.pareto_records(stats.frontier + stats.records,
                                       scn.objectives)
    if stats.n_dominating:
        assert any(r.get("refined") for r in joint)
    assert len(sweeprunner.to_csv(stats.records, scn).splitlines()) == \
        len(stats.records) + 1
    unimproved = cooptimize.refine_sweep(
        (spec, records), dataclasses.replace(cooptimize.RefineConfig(
            **FLAGS), steps=0), device="cpu")
    assert unimproved.n_refined == 0
    assert unimproved.n_unimproved == unimproved.n_candidates > 0


def test_contradicting_flags_exit_2_and_the_card_is_the_default(refined,
                                                                capsys):
    """A ``--scenario``, ``--scenario-param`` or ``--objectives`` that
    contradicts the spec in DIR exits 2 with the reference's message;
    without ``--device`` both commands run on the card, and raise where
    there is none."""
    d = refined["dirs"]["ref"]
    for flag in (["--scenario", "serving"],
                 ["--scenario-param", "qps=1"],
                 ["--objectives", "energy"]):
        argv = ["cooptimize", "--from", d, *flag]
        with private_reference():
            assert ref_pathfind.main(argv) == 2
        want = capsys.readouterr().err
        assert pathfind.main(argv + ["--device", "cpu"]) == 2
        got = capsys.readouterr().err
        assert got == want and got.startswith(f"error: {flag[0]}")
    if not torch.cuda.is_available():
        for argv in (["soe", "--arch", "qwen1.5-0.5b", "--cell",
                      "train_4k"], ["cooptimize", "--from", d]):
            with pytest.raises(RuntimeError, match="CUDA device"):
                pathfind.main(argv)
