"""The PyTorch port's examples (``examples/torch/``), each run as a user
runs it, at its smallest setting on the host (``--device cpu``)."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

CASES = {
    "quickstart": (["--steps", "6"], ("loss: ", "decoded (2, 8) tokens")),
    "serve_lm": (["--prompt-len", "4", "--gen", "2"],
                 ("qwen1.5-0.5b", "recurrentgemma-2b", "xlstm-125m")),
    "train_lm": (["--reduced", "--steps", "2", "--batch", "2", "--seq",
                  "16"], ("=== train_lm: qwen-100m-smoke", "loss: ")),
    "pathfind": (["--tilings", "2", "--steps", "2"],
                 ("Pareto(time, devices)", "best strategy",
                  "runtime sharding plan")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_host(name, tmp_path):
    args, wants = CASES[name]
    if name == "train_lm":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch" / f"{name}.py"),
         "--device", "cpu", *args], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for want in wants:
        assert want in proc.stdout, (want, proc.stdout[-2000:])
