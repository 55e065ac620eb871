"""``python -m repro_torch.pathfind size`` against the reference CLI, on the
CPU.

Fleet sizing reads a serving-traffic sweep's records and never evaluates
a point, so on one directory the two CLIs print the same bytes: a
directory the reference's runner wrote is sized by both, and the port's
own directory of the same grid prints the reference's text with numbers
within rtol 1e-5 of the printed value.  The fresh-sweep mode (axes
instead of ``--from``) is held to the reference's the same way.  The
reference runs with its bucketing off and a private prediction cache
(ROADMAP queue 3), both restored after each test.
"""

import re

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest

from repro import pathfind as ref_pathfind
from repro.core import compileahead
from repro.core import pathfinder as ref_pf
from repro.core import sweeprunner as ref_sr
from repro_torch import pathfind
from repro_torch.core import pathfinder, sweeprunner

RTOL = 1e-5
TRAFFIC = dict(arches=("qwen1.5-0.5b", "recurrentgemma-2b", "xlstm-125m"),
               mesh_shapes=((8, 8),), scenario="serving-traffic",
               logic_nodes=("N7", "N5"), hbms=("HBM2E", "HBM3"),
               scenario_params={"qps": [0.25, 1.0]},
               objectives=("energy", "cost", "goodput"), chunk_size=8)
QUERIES = (["--qps", "4", "--slo-ttft-p99", "18"],
           ["--qps", "2", "--slo-ttft-p99", "30", "--slo-tpot-p50", "0.9",
            "--rank-by", "energy_per_token", "--top-k", "3"],
           ["--qps", "8", "--slo-ttft-p50", "5", "--rank-by",
            "cost_per_token"],
           ["--qps", "4", "--slo-ttft-p99", "0.001"])     # none sizeable


@pytest.fixture
def private_ref():
    """The reference's bucketing off and a private prediction cache, both
    restored afterwards (neither filled nor cleared)."""
    prev_bucketing = compileahead.set_bucketing_default(False)
    prev = ref_pf.prediction_cache()
    ref_pf.set_prediction_cache(ref_pf.PredictionCache())
    try:
        yield
    finally:
        ref_pf.set_prediction_cache(prev)
        compileahead.set_bucketing_default(prev_bucketing)


_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]\d+)?")


def _unit(text: str) -> float:
    mant, _, exp = text.partition("e")
    places = len(mant.partition(".")[2])
    return 10.0 ** (int(exp or 0) - places)


def _same_text(got: str, want: str) -> None:
    """Equal text, apart from numbers that are the printed roundings of
    values within rtol 1e-5 of each other."""
    assert _NUM.split(got) == _NUM.split(want), (got, want)
    for a, b in zip(_NUM.findall(got), _NUM.findall(want)):
        assert abs(float(a) - float(b)) <= RTOL * abs(float(b)) + _unit(b), \
            (a, b)


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_size_from_a_directory_prints_what_the_reference_prints(
        private_ref, tmp_path, capsys):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_sr.SweepRunner(ref_sr.SweepSpec(**TRAFFIC), out_dir=ref_dir,
                       backend="serial", bucketing=False).run()
    sweeprunner.SweepRunner(sweeprunner.SweepSpec(**TRAFFIC),
                            out_dir=port_dir, device="cpu",
                            cache=pathfinder.PredictionCache()).run()
    n_sized = 0
    for q in QUERIES:
        want = _run(ref_pathfind.main, ["size", "--from", ref_dir] + q,
                    capsys)
        got = _run(pathfind.main, ["size", "--from", ref_dir] + q, capsys)
        assert got == want, q
        own = _run(pathfind.main, ["size", "--from", port_dir] + q, capsys)
        assert own[0] == want[0]
        _same_text(own[1], want[1])
        _same_text(own[2], want[2])
        n_sized += want[0] == 0
        assert want[2].startswith("# size: 24 serving-traffic records")
    assert n_sized == 3 and want[0] == 1


def test_size_of_a_fresh_sweep_prints_what_the_reference_prints(
        private_ref, tmp_path, capsys):
    """Without ``--from`` both CLIs sweep the axes first (the port on the
    host, the reference serially) and size the result; ``--out`` keeps the
    sweep's directory, which is the reference's."""
    axes = ["--arch", "recurrentgemma-2b", "--arch", "xlstm-125m", "--mesh",
            "8x8", "--logic", "N7,N5", "--scenario-param", "qps=0.25,1",
            "--qps", "4", "--slo-ttft-p99", "18"]
    want = _run(ref_pathfind.main, ["size"] + axes + [
        "--backend", "serial", "--out", str(tmp_path / "ref")], capsys)
    got = _run(pathfind.main, ["size"] + axes + [
        "--device", "cpu", "--out", str(tmp_path / "port")], capsys)
    assert got[0] == want[0] == 0
    _same_text(got[1], want[1])
    _same_text(got[2], want[2])
    assert (tmp_path / "port" / "checkpoint.jsonl").read_bytes() == \
        (tmp_path / "ref" / "checkpoint.jsonl").read_bytes()


def test_size_refusals_match_the_reference(private_ref, tmp_path, capsys):
    """A sweep of another scenario, no SLO wall, no axes: exit 2 with the
    reference's message."""
    train = str(tmp_path / "train")
    sweeprunner.SweepRunner(sweeprunner.SweepSpec(
        arches=("qwen1.5-0.5b",), mesh_shapes=((2, 2),), n_tilings=4),
        out_dir=train, device="cpu").run()
    traffic = str(tmp_path / "traffic")
    sweeprunner.SweepRunner(sweeprunner.SweepSpec(
        arches=("xlstm-125m",), mesh_shapes=((8, 8),),
        scenario="serving-traffic"), out_dir=traffic, device="cpu").run()
    for argv in (["size", "--from", train, "--qps", "1",
                  "--slo-ttft-p99", "1"],
                 ["size", "--from", traffic, "--qps", "1"],
                 ["size", "--qps", "1", "--slo-ttft-p99", "1"]):
        want = _run(ref_pathfind.main, argv, capsys)
        got = _run(pathfind.main, argv, capsys)
        assert got == want and got[0] == 2 and \
            got[2].startswith("error: "), argv
