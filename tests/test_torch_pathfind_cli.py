"""``python -m repro_torch.pathfind sweep|plan --device cpu`` against the
reference CLI, on the CPU: the same text, apart from numbers within rtol
1e-5; and the ``error:`` exits.

The reference CLI takes the process-wide prediction cache, so it runs with
a private one swapped in and the old one swapped back (neither filled nor
cleared), and with its bucketing off inside a fixture that restores it
(ROADMAP queue 3).
"""

import re

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest

from repro import pathfind as ref_pathfind
from repro.core import compileahead
from repro.core import pathfinder as ref_pf
from repro_torch import pathfind

RTOL = 1e-5
SWEEP_ARGV = ["sweep", "--arch", "qwen1.5-0.5b", "--mesh", "8x8",
              "--logic", "N7,N5,N3", "--hbm", "HBM2E,HBM3"]
# the sweep fabric's flags used wrongly: ``--workers`` on the default,
# pipeline backend without ``--out`` (the fabric's directory), with
# ``--max-chunks``, and ``--lease-ttl`` without ``--workers``
LATER_ARGV = (["--workers", "2"], ["--workers", "2", "--out", "d",
                                   "--max-chunks", "1"],
              ["--lease-ttl", "9"])
# the execution flags of the compile-ahead slice: each runs the sweep,
# on the chunked runner (whose summary has a compile line) but for
# --no-compile-cache, which alone the reference leaves to the in-memory
# sweep
EXEC_ARGV = (["--compile-ahead", "1"], ["--no-bucketing"],
             ["--bucketing", "--compile-ahead", "1"],
             ["--no-compile-cache"], ["--backend", "device"])
# the fabric's and the surrogate's subcommands, given too little
LATER_COMMANDS = (["explore", "--arch", "qwen1.5-0.5b"],
                  ["sweep-worker", "--dir", "no-such-dir"],
                  ["sweep-worker", "--dir", "d", "--superbatch", "0"])
UNKNOWN_ARGV = (["--arch", "no-such-arch"], ["--cell", "no_such_cell"],
                ["--logic", "N99"], ["--hbm", "HBM9"])


@pytest.fixture
def private_ref_cache():
    """The reference's process-wide prediction cache swapped for an empty
    one, and swapped back after the test, untouched; its bucketing off."""
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
    """One unit in the last printed digit of a number as printed."""
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


@pytest.mark.parametrize("pareto", [[], ["--pareto", "time_s,devices"]],
                         ids=["all", "pareto"])
def test_sweep_prints_what_the_reference_prints(private_ref_cache, tmp_path,
                                                capsys, pareto):
    """Standard output, standard error (with the ``# best:`` line) and the
    ``--csv`` file."""
    outs = {}
    for name, main, extra in (("ref", ref_pathfind.main, []),
                              ("port", pathfind.main, ["--device", "cpu"])):
        csv = tmp_path / f"{name}.csv"
        assert main(SWEEP_ARGV + pareto + extra + ["--csv", str(csv)]) == 0
        cap = capsys.readouterr()
        outs[name] = (cap.out, cap.err.replace(str(csv), "CSV"),
                      csv.read_text())
    for got, want in zip(outs["port"], outs["ref"]):
        _same_text(got, want)
    assert "# best: qwen1.5-0.5b/train_4k mesh=8x8" in outs["port"][1]
    assert len(outs["port"][0].splitlines()) == (2 if pareto else 7)


def test_plan_prints_what_the_reference_prints(private_ref_cache, capsys):
    argv = ["plan", "--arch", "qwen1.5-0.5b", "--cell", "train_4k",
            "--mesh", "16x16"]
    assert ref_pathfind.main(argv) == 0
    want = capsys.readouterr().out
    assert pathfind.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    _same_text(got, want)
    assert got.startswith("strategy       RC-1-16-d16-p1\n")


def test_runner_flags_exit_2_naming_item_6(private_ref_cache, capsys):
    """Item 6 (the chunked runner) is ported, and its flags route there
    (``tests/test_torch_sweep_runner_cli.py``); item 11's fabric and
    surrogate are ported too (``tests/test_torch_fabric_cli.py``,
    ``test_torch_explore.py``), so their flags and subcommands, used
    wrongly, exit 2 with the reference's message before anything is
    evaluated.  The compile-ahead slice's flags run the sweep;
    ``--compile-ahead 0`` exits 2 with the reference's message."""
    errs = []
    for argv in [SWEEP_ARGV + flag for flag in LATER_ARGV] + list(
            LATER_COMMANDS):
        assert ref_pathfind.main(argv) == 2, argv
        want = capsys.readouterr().err
        rc = pathfind.main(argv + ["--device", "cpu"])
        errs.append(capsys.readouterr().err)
        assert rc == 2 and errs[-1].startswith("error: ") and \
            errs[-1] == want, (argv, errs[-1], want)
    assert errs[0].startswith("error: --workers N on the pipeline backend "
                              "is the distributed sweep fabric; it needs "
                              "--out DIR")
    assert errs[2].startswith("error: --lease-ttl is a fabric knob")
    for flag in EXEC_ARGV:
        rc = pathfind.main(SWEEP_ARGV + flag + ["--device", "cpu"])
        out, err = capsys.readouterr()
        assert rc == 0 and out.startswith("arch,cell,mesh,"), (flag, err)
        assert ("# compile: " in err) == (flag[0] != "--no-compile-cache"), \
            (flag, err)
    assert pathfind.main(SWEEP_ARGV + ["--compile-ahead", "0", "--device",
                                       "cpu"]) == 2
    assert capsys.readouterr().err.startswith(
        "error: --compile-ahead must be a positive number")


def test_unknown_names_and_bad_meshes_exit_2(private_ref_cache, capsys):
    """Unknown arch, cell, logic or HBM print the reference's message; a
    bad mesh or a missing ``--arch`` / ``--mesh`` also exit 2."""
    for bad in UNKNOWN_ARGV:
        argv = ["sweep", "--mesh", "8x8"] + (
            bad if bad[0] == "--arch" else ["--arch", "qwen1.5-0.5b"] + bad)
        assert ref_pathfind.main(argv) == 2
        want = capsys.readouterr().err
        assert pathfind.main(argv + ["--device", "cpu"]) == 2
        got = capsys.readouterr().err
        assert got.startswith("error: ")
        assert got == want.replace("repro.configs", "repro_torch.configs")

    with pytest.raises(SystemExit) as exc:
        pathfind.main(["sweep", "--arch", "qwen1.5-0.5b", "--mesh", "8xq",
                       "--device", "cpu"])
    assert exc.value.code == 2
    assert "error: argument --mesh: bad mesh" in capsys.readouterr().err
    assert pathfind.main(["sweep", "--arch", "qwen1.5-0.5b", "--device",
                          "cpu"]) == 2
    assert capsys.readouterr().err.startswith("error: sweep needs")
