"""The search layer's ``devices`` in the port, on the CPU's host shards.

On the card shard *i* of the rows runs on ``cuda:i``; on the host ``n``
shards run on a thread pool, the counterpart of the XLA forced host
devices the reference's own ``pmap`` tests use.  The split rows are the
one-device rows (rtol 1e-6) and the reference's (rtol 1e-5); the
``device`` backend writes the serial backend's directory; the pipeline's
split megabatches write its one-device records bit for bit; asking for
more cards than the host has raises, naming both numbers.
"""

import math

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPE_CELLS as REF_CELLS
from repro.configs.base import get_config as ref_config
from repro.core import age as ref_age
from repro.core import lmgraph as ref_lmgraph
from repro.core import pathfinder as ref_pf
from repro.core import techlib as ref_techlib
from repro.core.parallelism import Strategy as RefStrategy
from repro.core.roofline import PPEConfig as RefPPE
from repro_torch.configs.base import SHAPE_CELLS, get_config
from repro_torch.core import age, lmgraph, pathfinder, sweeppipeline
from repro_torch.core import sweeprunner, techlib
from repro_torch.core.parallelism import Strategy
from repro_torch.core.roofline import PPEConfig

ARCH = "qwen1.5-0.5b"
SPEC = dict(arches=(ARCH,), mesh_shapes=((2, 2), (4, 4)), scenario="train",
            logic_nodes=("N7", "N5"), budget_scales=(0.9, 1.0, 1.1),
            n_tilings=4, chunk_size=4)


@pytest.fixture
def two_host_devices():
    prev = pathfinder.set_host_devices(2)
    try:
        yield
    finally:
        pathfinder.set_host_devices(prev)


def test_split_rows_are_one_devices_and_the_references(two_host_devices):
    """`evaluate_matrix` over 2 host shards (9 rows, padded to a block of
    8 per shard) and `evaluate(shard_devices=True)` against one device,
    and both against the reference's matrix rows."""
    st = dict(kp1=1, kp2=2, dp=2)
    g = lmgraph.build_graph(get_config(ARCH), SHAPE_CELLS["train_4k"])
    template = age.generate(techlib.make_tech_config("N7", "HBM2E"),
                            age.Budgets.default(), device="cpu")
    base = pathfinder.pack_hw(template)
    rng = np.random.default_rng(2)
    hw = (base[None, :] * rng.uniform(0.9, 1.1, (9, base.shape[0]))
          ).astype(np.float32)
    ev = pathfinder.BatchedEvaluator(g, Strategy("RC", **st),
                                     ppe=PPEConfig(n_tilings=4), cache=None,
                                     device="cpu")
    one = ev.evaluate_matrix(template, hw, devices=1)
    assert pathfinder.local_device_count("cpu") == 2
    two = ev.evaluate_matrix(template, hw, block=8)     # default: 2 shards
    assert two.shape == one.shape
    np.testing.assert_allclose(two, one, rtol=1e-6)
    archs = [pathfinder.unpack_hw(template, torch.as_tensor(r)) for r in hw]
    np.testing.assert_allclose(ev.evaluate(archs, shard_devices=True), one,
                               rtol=1e-6)
    ref_ev = ref_pf.BatchedEvaluator(
        ref_lmgraph.build_graph(ref_config(ARCH), REF_CELLS["train_4k"]),
        RefStrategy("RC", **st), ppe=RefPPE(n_tilings=4), cache=None,
        bucketed=False)
    want = ref_ev.evaluate_matrix(
        ref_age.generate(ref_techlib.make_tech_config("N7", "HBM2E"),
                         ref_age.Budgets.default()), hw, devices=1)
    np.testing.assert_allclose(two, want, rtol=1e-5)
    assert ev.evaluate_matrix(template, hw[:0], devices=2).shape == (0, 5)


def test_device_backend_writes_the_serial_directory(tmp_path,
                                                    two_host_devices):
    """The ``device`` backend (serial, each chunk split over the host
    shards): the serial backend's chunk hashes, keys and records."""
    spec = sweeprunner.SweepSpec(**SPEC)
    dirs = {}
    for backend in ("serial", "device"):
        d = dirs[backend] = tmp_path / backend
        stats = sweeprunner.SweepRunner(spec, out_dir=str(d),
                                        backend=backend, cache=None,
                                        device="cpu").run()
        assert stats.complete and stats.backend == backend
    for name in ("spec.json", "checkpoint.jsonl"):
        assert (dirs["device"] / name).read_bytes() == \
            (dirs["serial"] / name).read_bytes(), name
    got, want = (sweeprunner.load_sweep(str(dirs[b]))[1]
                 for b in ("device", "serial"))
    assert [r["key"] for r in got] == [r["key"] for r in want] and want
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, float) and math.isfinite(v):
                assert abs(g[k] - v) <= 1e-6 * abs(v), (w["key"], k)
            else:
                assert g[k] == v, (w["key"], k)


@pytest.mark.parametrize("bucketing", [True, False],
                         ids=["bucketed", "unbucketed"])
def test_pipeline_splits_large_dispatches(bucketing):
    """With every dispatch large enough to split, the pipeline's
    megabatches (or groups) over 2 host shards write its one-device
    records bit for bit."""
    spec = sweeprunner.SweepSpec(**SPEC)
    chunks = sweeprunner.make_chunks(sweeprunner.enumerate_labels(spec),
                                     spec.chunk_size)
    records = {}
    for devices in (1, 2):
        ex = sweeppipeline.PipelineExecutor(
            spec, cache=None, devices=devices, bucketing=bucketing,
            shard_min_rows=1 if devices > 1 else 10 ** 9, device="cpu")
        assert ex.devices == devices and ex._pad_plan(20)[0] == devices
        out = []
        ex.run(chunks, lambda c, recs: out.extend(recs))
        records[devices] = out
    assert records[2] == records[1] and records[1]


def test_more_cards_than_the_host_has_raise():
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"devices={have + 1}: this host "
                                         f"has {have} CUDA device"):
        pathfinder.shard_devices("cuda", have + 1)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="positive"):
            pathfinder.shard_devices("cpu", bad)
    assert pathfinder.shard_devices("cpu", 3) == [torch.device("cpu")] * 3
    assert pathfinder.shard_devices("cuda") == [torch.device("cuda", 0)] \
        if have else pathfinder.shard_devices("cpu") == [torch.device("cpu")]
