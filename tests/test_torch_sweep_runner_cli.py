"""``python -m repro_torch.pathfind sweep --out DIR [--resume]`` against the
reference CLI, on the CPU.

Both CLIs sweep the same serving-traffic grid into a directory of their
own, stop after two chunks, and resume.  The CSV on standard output is the
reference's text (numbers within rtol 1e-5 of the printed value), and so
are the ``# sweep[...]``, ``# cache:``, ``# incomplete: ...`` and
``# best[...]`` lines on standard error, apart from the wall time, the
reference's compiled-function counts and ``# compile:`` line (JAX's, not
the port's), the module name and the port's ``--device`` flag.

The reference CLI takes the process-wide prediction cache, so it runs with
a private one swapped in and the old one swapped back (neither filled nor
cleared); it is asked for its serial backend, without bucketing (ROADMAP
queue 3) and without its persistent compile cache (a process-wide JAX
setting), and the port for its serial backend too.
"""

import re

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest

from repro import pathfind as ref_pathfind
from repro.core import pathfinder as ref_pf
from repro_torch import pathfind

RTOL = 1e-5
GRID = ["sweep", "--scenario", "serving-traffic", "--arch", "qwen1.5-0.5b",
        "--arch", "recurrentgemma-2b", "--mesh", "8x8", "--logic", "N7,N5",
        "--hbm", "HBM2E,HBM3", "--objectives", "energy,cost,goodput",
        "--scenario-param", "qps=0.25,1", "--slo", "18", "--chunk-size", "4"]
REF_ONLY = ["--backend", "serial", "--no-bucketing", "--no-compile-cache"]
# the port's serial backend, as the reference's: the pipeline (the default
# of both) counts prediction-cache hits per superbatch, not per chunk
PORT_ONLY = ["--device", "cpu", "--backend", "serial"]


@pytest.fixture
def private_ref_cache():
    """The reference's process-wide prediction cache swapped for an empty
    one, and swapped back after the test, untouched."""
    prev = ref_pf.prediction_cache()
    ref_pf.set_prediction_cache(ref_pf.PredictionCache())
    try:
        yield
    finally:
        ref_pf.set_prediction_cache(prev)


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


def _stderr(text: str, out_dir: str) -> str:
    """The summary lines, with what may differ between the CLIs taken
    out: wall time, compile counters, module name, device, directory."""
    text = re.sub(r" in \d+\.\ds\n", " in Ts\n", text)
    text = re.sub(r"; compiled fns \d+ built / \d+ reused", "", text)
    text = re.sub(r"# compile: .*\n", "", text)
    text = text.replace("repro_torch.pathfind", "repro.pathfind")
    return text.replace(" --device cpu`", "`").replace(out_dir, "DIR")


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_sweep_out_and_resume_print_what_the_reference_prints(
        private_ref_cache, tmp_path, capsys):
    outs = {}
    for name, main, extra in (("ref", ref_pathfind.main, REF_ONLY),
                              ("port", pathfind.main, PORT_ONLY)):
        d = str(tmp_path / name)
        first = _run(main, GRID + extra + ["--out", d, "--max-chunks", "2"],
                     capsys)
        again = _run(main, ["sweep", "--out", d, "--resume", "--pareto",
                            "ttft_p99_s,energy_j_per_token", "--csv",
                            d + ".csv"] + extra, capsys)
        outs[name] = [(rc, out, _stderr(err.replace(d + ".csv", "CSV"), d))
                      for rc, out, err in (first, again)]
        outs[name].append((tmp_path / name / "checkpoint.jsonl").read_text())
        outs[name].append(open(d + ".csv").read())
    (rc1, out1, err1), (rc2, out2, err2), ckpt, csv = outs["port"]
    (_, ref_out1, ref_err1), (_, ref_out2, ref_err2), ref_ckpt, ref_csv = \
        outs["ref"]
    assert rc1 == rc2 == 0
    assert ckpt == ref_ckpt and ckpt.count("\n") == 4
    for got, want in ((out1, ref_out1), (err1, ref_err1), (out2, ref_out2),
                      (err2, ref_err2), (csv, ref_csv)):
        _same_text(got, want)
    assert err1.startswith("# sweep[serving-traffic] backend=serial: 16 "
                           "points in 4 chunks; skipped 0 checkpointed, "
                           "evaluated 2 (8 points) in Ts\n# cache: ")
    assert "# incomplete: resume with `python -m repro.pathfind sweep " \
           "--out DIR --resume`" in err1
    assert "skipped 2 checkpointed, evaluated 2 (8 points)" in err2
    assert "# best[ttft_p99_s]: recurrentgemma-2b|" in err2
    assert "# incomplete" not in err2
    assert len(out1.splitlines()) == 9 and len(out2.splitlines()) > 1


def test_resume_and_size_refuse_flags_that_contradict_the_directory(
        private_ref_cache, tmp_path, capsys):
    """A command that loads its spec from a directory refuses axis and
    scenario flags with the reference's message; ``--device`` is
    execution-only and allowed."""
    d = str(tmp_path / "d")
    assert pathfind.main(GRID + PORT_ONLY + ["--out", d,
                                             "--max-chunks", "1"]) == 0
    capsys.readouterr()
    for flags in (["--arch", "qwen1.5-0.5b"], ["--mesh", "4x4"],
                  ["--logic", "N5"], ["--scenario", "serving"],
                  ["--chunk-size", "8"], ["--tilings", "4"],
                  ["--profile", "p.json"], ["--objectives", "energy"],
                  ["--scenario-param", "qps=2"], ["--slo", "1"],
                  ["--scale", "0.9,1.1"], ["--area", "400"]):
        for cmd, extra in ((["sweep", "--out", d, "--resume"], REF_ONLY),
                           (["size", "--from", d, "--qps", "1"], [])):
            if cmd[0] == "size" and flags[0] == "--chunk-size":
                continue                  # size's --chunk-size is axes mode
            rc, _, want = _run(ref_pathfind.main, cmd + flags + extra,
                               capsys)
            got = _run(pathfind.main, cmd + flags + PORT_ONLY, capsys)
            assert rc == got[0] == 2 and got[2] == want, (cmd, flags)
            assert "drop these flags" in want
    assert _run(pathfind.main, ["sweep", "--resume"] + PORT_ONLY,
                capsys)[2] == "error: --resume requires --out DIR\n"
    rc, _, err = _run(pathfind.main, ["sweep", "--out", d, "--resume",
                                      "--max-chunks", "1"] + PORT_ONLY,
                      capsys)
    assert rc == 0 and "skipped 1 checkpointed, evaluated 1" in err
