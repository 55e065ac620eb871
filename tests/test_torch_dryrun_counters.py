"""The dry-run's counters (`repro_torch.launch.counters`), planted.

Each count is held exactly on inputs whose answer is known: a DTensor
product on a fake 16x16 group counts rank 0's local shapes once (not the
global shape ``FlopCounterMode`` counts, nor the global-shape op of
DTensor's sharding propagation); collectives of every kind, from DTensor,
functional collectives and ``torch.distributed`` calls; the memory of a
planted allocation sequence.  Then the step's memory against the
reference's ``memory_analysis`` (reduced qwen1.5-0.5b at 2x2, the
reference in a process of its own), and the reference's probe correction
fed the port's one-group count against its direct count of two groups.
A torch whose DTensor lacks a method the counter marks is refused.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from dryrunhelpers import reference
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import dryrun, mesh as mesh_lib
from repro_torch.launch.counters import StepCounter
from repro_torch.parallel import collectives
from repro_torch.tree import tree_leaves


@pytest.fixture
def mesh16():
    with dryrun.fake_group(256):
        yield mesh_lib.make_mesh((16, 16), device="cuda")


def _dt(mesh, shape, placements, dtype=torch.float32):
    return DTensor.from_local(torch.empty(shape, dtype=dtype, device="meta"),
                              mesh, placements, run_check=False)


def test_dtensor_product_counts_rank0_local_op_once(mesh16, monkeypatch):
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        a = _dt(mesh16, (8, 1024), (Shard(0), Replicate()))
        b = _dt(mesh16, (1024, 256), (Replicate(), Shard(1)))
        with FlopCounterMode(display=False) as flop_counter:
            a @ b
        for _ in range(2):          # the second hits DTensor's caches
            with StepCounter((a, b)) as c:
                out = a @ b
            assert out.to_local().shape == (8, 256)
            assert c.flops == 2.0 * 8 * 1024 * 256
            assert c.bytes == 4.0 * (8 * 1024 + 1024 * 256 + 8 * 256)
            assert c.collectives["count"] == 0 and c.kernels == {}
    # the global product, (128, 1024) @ (1024, 4096)
    assert flop_counter.get_total_flops() == 2 * 128 * 1024 * 4096
    # a torch whose DTensor lacks a marked method is refused, not counted
    from torch.distributed.tensor import _sharding_prop
    monkeypatch.delattr(_sharding_prop.ShardingPropagator,
                        "_propagate_tensor_meta_non_cached")
    with pytest.raises(RuntimeError, match="_propagate_tensor_meta"):
        with StepCounter():
            pass
    from repro_torch.kernels import build
    from repro_torch.launch.counters import _Metadata
    assert build.COUNTERS == [] and _Metadata._saved == []


def test_collectives_count_the_bytes_rank0_receives(mesh16):
    from torch.distributed import _functional_collectives as funcol
    cases = (
        ("all-gather", 16 * 8 * 256 * 4,      # 16 shards of (8, 256)
         lambda: _dt(mesh16, (8, 256), (Shard(0), Shard(1))).redistribute(
             mesh16, (Replicate(), Shard(1)))),
        ("all-reduce", 8 * 256 * 4,
         lambda: _dt(mesh16, (8, 256), (Partial(), Replicate()))
         .redistribute(mesh16, (Replicate(), Replicate()))),
        ("reduce-scatter", 1 * 256 * 4,       # a (16, 256) sum, 1 row each
         lambda: _dt(mesh16, (16, 256), (Partial(), Replicate()))
         .redistribute(mesh16, (Shard(0), Replicate()))),
        ("all-to-all", 32 * 4,
         lambda: funcol.all_to_all_single(
             torch.empty(32, device="meta"), None, None,
             mesh16.get_group("data"))),
        ("all-reduce", 4 * 4 * 4,
         lambda: dist.all_reduce(torch.empty(4, 4, device="meta"))),
        ("collective-permute", 5 * 4,
         lambda: dist.recv(torch.empty(5, device="meta"), src=1)),
    )
    with FakeTensorMode(allow_non_fake_inputs=True):
        for kind, nbytes, fn in cases:
            with StepCounter() as c:
                fn()
            want = {k: 0.0 for k in c.collectives}
            want.update({kind: float(nbytes), "count": 1})
            assert c.collectives == want, kind
        # the bucketed all-reduce: one per dtype's bucket
        tree = {"a": torch.empty(10, device="meta"),
                "b": torch.empty(3, dtype=torch.bfloat16, device="meta")}
        with StepCounter() as c:
            collectives.bucketed_all_reduce(tree)
        assert c.collectives["all-reduce"] == 10 * 4 + 3 * 2
        assert c.collectives["count"] == 2


def test_planted_memory():
    with FakeTensorMode():
        x = torch.empty(1000, device="meta")                 # 4000 bytes
        w = torch.empty(10, device="meta")                   # 40 bytes

        def step(x, w):
            x.add_(1)                   # in place on an input: no memory
            t1 = x * 2                  # +4000
            v = t1.view(10, 100)        # a view: no bytes
            t2 = v + 1                  # +4000 (8000 held)
            del t1, v                   # -4000
            out = t2.sum(dim=1) @ w     # +40 (freed at once), +4
            return out, w               # w: an input returned

        c = StepCounter((x, w, x[:10]))  # a view of an input: held once
        with c:
            outs = step(x, w)
        mem = c.finish(outs)
    assert mem == {"argument_bytes": 4040, "output_bytes": 44,
                   "temp_bytes": 8000, "peak_bytes": 4040 + 8000}
    # add_, mul and add read and write 4000 bytes each; the sum, the dot
    assert c.flops == 2.0 * 10 and c.bytes == (
        3 * 2 * 4000 + (4000 + 40) + (40 + 40 + 4))


def test_bytes_match_the_reference_memory_analysis_at_2x2():
    """Argument bytes equal; output bytes plus XLA's 8-byte pointer per
    leaf of the step's output tuple equal (the reference jits without
    donation: fresh output buffers, as the port's count takes them)."""
    cfg = reduced(get_config("qwen1.5-0.5b"))
    for cell in ("train_4k", "prefill_32k", "decode_32k"):
        want = reference("qwen1.5-0.5b", cell, "2x2", "--reduced",
                         "--memory")["memory"]
        with dryrun.fake_group(4):
            mesh = mesh_lib.make_mesh((2, 2), device="cuda")
            fake = FakeTensorMode(allow_non_fake_inputs=True)
            fn, args, _, plan, _ = dryrun.build_cell(
                "qwen1.5-0.5b", cell, mesh, (2, 2), cfg_override=cfg,
                fake_mode=fake)
            with fake:
                c = StepCounter(args)
                with c:
                    out = fn(*args)
                mem = c.finish(out)
                n_out = len(tree_leaves(_as_tree(out)))
        assert plan.strategy.name == "RC-1-2-d2-p1"
        assert mem["argument_bytes"] == want["argument_bytes"], cell
        assert mem["output_bytes"] + 8 * n_out == want["output_bytes"], cell


def _as_tree(out):
    """A step's output (tuples, named tuples, dicts) as nested dicts."""
    if isinstance(out, dict):
        return {k: _as_tree(v) for k, v in out.items()}
    if isinstance(out, tuple):
        return {str(i): _as_tree(v) for i, v in enumerate(out)}
    return out


def test_probes_combine_to_the_direct_count():
    """The reference's correction m_rem + n_groups (m_one - m_rem), fed
    the port's count of one pattern group, gives its direct count of two:
    every layer is counted, each alike (the card's path, one device: on a
    mesh DTensor picks each product's layout from the placements it meets,
    so the first layer's local work is not the second's).  FLOPs of the
    train step with its remat; FLOPs, bytes and collectives of the
    prefill.  A train step's bytes grow faster than its layers: the
    backward of each layer's slice of a stacked leaf writes a gradient of
    the whole stack (ROADMAP queue 2 item 6 (d))."""
    cfg = reduced(get_config("qwen1.5-0.5b"))
    probes, combine = dryrun._probe_configs(cfg)
    assert list(probes) == ["rem"] and probes["rem"].n_layers == 0
    for cell in ("train_4k", "prefill_32k"):
        def metrics(c):
            return dryrun._step_metrics("qwen1.5-0.5b", cell, None, (1, 1),
                                        True, c)

        full = metrics(cfg)
        one = metrics(dataclasses.replace(cfg, n_layers=1))
        pm = {"rem": metrics(probes["rem"])}
        got = dryrun._corrected(one, pm, combine)
        assert got["flops"] == full["flops"] > one["flops"] \
            > pm["rem"]["flops"], cell
        if cell == "train_4k":
            assert got["bytes"] < full["bytes"]
            assert full["kernels"] == {"flash_attention": 4}
        else:
            assert got["bytes"] == full["bytes"]
            assert got["coll"] == full["coll"]
            assert full["kernels"] == {"flash_attention": 2}
