"""The multi-pod dry-run (`repro_torch.launch.dryrun`) against the
reference's (`repro.launch.dryrun`, run in a process of its own by
`dryrunhelpers.reference`: importing it sets ``XLA_FLAGS`` for this
process and every process it starts).

Full width: the CLI's qwen1.5-0.5b x train_4k record at 16x16 and
``run_cell``'s decode_32k at 2x16x16 (fake groups of 256 and 512 ranks),
their plan fields held to the reference's planner (rtol 1e-5) and their
keys to the reference's record's; a failing cell exits 1.  Reduced
qwen1.5-0.5b at one device: the dot FLOPs of the host's path equal a walk
of the reference's step jaxpr (each loop body its trip count times), and
the card's path differs from them only by attention's backward, which
recomputes the plain version (4 b h s^2 d a layer).
"""

from __future__ import annotations

import json

import pytest
import torch

from dryrunhelpers import reference
from repro_torch.configs.base import SHAPE_CELLS, get_config, reduced
from repro_torch.launch import dryrun

EXTRA_KEYS = {"device", "kernels"}


def _held_to_reference(rec: dict, want: dict) -> None:
    assert rec["ok"], rec.get("traceback")
    assert set(rec) == set(want["record_keys"]) | EXTRA_KEYS
    plan = want["plan"]
    assert rec["strategy"] == plan["strategy"]
    assert rec["params"] == plan["params"]
    assert rec["active_params"] == plan["active_params"]
    assert rec["predicted_step_s"] == pytest.approx(
        plan["predicted_step_s"], rel=1e-5)
    assert rec["predicted_breakdown"].keys() == \
        plan["predicted_breakdown"].keys()
    for key, val in plan["predicted_breakdown"].items():
        assert rec["predicted_breakdown"][key] == pytest.approx(
            val, rel=1e-5, abs=1e-12), key
    assert rec["scan_corrected"] is False
    assert rec["flops_per_device"] == rec["flops_per_device_raw"] > 0
    assert rec["collectives"] == rec["collectives_raw"]
    assert rec["collectives"]["count"] > 0
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]


def test_cli_single_pod_train_record(tmp_path, capsys, monkeypatch):
    dryrun.main(["--arch", "qwen1.5-0.5b", "--cell", "train_4k", "--mesh",
                 "single", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[dryrun] OK  qwen1.5-0.5b" in out
    assert "[dryrun] done: 1 ok, 0 failed" in out
    rec = json.loads((tmp_path / "qwen1.5-0.5b__train_4k__single.json")
                     .read_text())
    _held_to_reference(rec, reference("qwen1.5-0.5b", "train_4k", "16x16",
                                      "--keys"))
    assert rec["mesh_shape"] == [16, 16] and rec["devices"] == 256
    assert rec["device"] == "cuda"
    # 24 layers, each forward once and once more in its remat
    assert rec["kernels"] == {"flash_attention": 48}
    assert not torch.distributed.is_initialized()
    # the record is read back unless --force; a failing cell exits 1
    monkeypatch.setattr(dryrun, "_step_metrics", None)
    dryrun.main(["--arch", "qwen1.5-0.5b", "--cell", "train_4k", "--mesh",
                 "single", "--out", str(tmp_path)])
    assert "[dryrun] done: 1 ok, 0 failed" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "qwen1.5-0.5b", "--cell", "train_4k",
                     "--mesh", "single", "--force", "--out",
                     str(tmp_path)])
    assert exc.value.code == 1
    assert "[dryrun] FAIL qwen1.5-0.5b" in capsys.readouterr().out
    failed = json.loads((tmp_path / "qwen1.5-0.5b__train_4k__single.json")
                        .read_text())
    assert failed["ok"] is False and "traceback" in failed
    # never inside a process group of the caller's
    with dryrun.fake_group(4):
        with pytest.raises(RuntimeError, match="already exists"):
            dryrun.run_cell("qwen1.5-0.5b", "train_4k", "single",
                            force=True, art_dir=str(tmp_path))
    assert not torch.distributed.is_initialized()


def test_multi_pod_decode_record(tmp_path):
    rec = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", "multi",
                          art_dir=str(tmp_path))
    _held_to_reference(rec, reference("qwen1.5-0.5b", "decode_32k",
                                      "2x16x16", "--keys"))
    assert rec["mesh_shape"] == [2, 16, 16] and rec["devices"] == 512
    assert rec["kernels"] == {"flash_attention": 24}


@pytest.mark.parametrize("cell", ["prefill_32k", "decode_32k", "train_4k"])
def test_dot_flops_equal_the_reference_jaxpr_walk(cell):
    cfg = reduced(get_config("qwen1.5-0.5b"))
    want = reference("qwen1.5-0.5b", cell, "1x1", "--reduced",
                     "--walk")["dot_flops"]
    host = dryrun._step_metrics("qwen1.5-0.5b", cell, None, (1, 1), True,
                                cfg, device="cpu")
    card = dryrun._step_metrics("qwen1.5-0.5b", cell, None, (1, 1), True,
                                cfg)
    assert host["flops"] == pytest.approx(want, rel=1e-6)
    assert host["kernels"] == {}
    # the card's path: the kernel's formula counts the dense products,
    # as the plain version does; a train step's attention backward
    # recomputes the plain forward (4 b h s^2 d) before its gradient
    c = SHAPE_CELLS[cell]
    n_attn = cfg.n_layers
    extra = 0.0
    if c.kind == "train":
        extra = n_attn * 4.0 * c.global_batch * cfg.n_heads \
            * c.seq_len ** 2 * cfg.resolved_head_dim
        assert card["kernels"] == {"flash_attention": 2 * n_attn}  # remat
    else:
        assert card["kernels"] == {"flash_attention": n_attn}
    assert card["flops"] - host["flops"] == extra
