"""The port's surrogate (``repro_torch.core.surrogate``) against the
reference's on the CPU, on the same numpy-seeded inputs: the featurizer's
matrix and the dataset exactly (float64), the ensemble's fit at the same
seed (predictions within RTOL / ATOL), the acquisitions, margins and
chunk scores exactly, and the advisory chunk order end to end."""

import json
import os
import random
import signal

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.core import sweepexec as ref_exec
from repro.core import sweepfabric as ref_fabric
from repro.core import surrogate as ref_sur
from repro.core import sweeprunner as ref_sr
from repro_torch.core import surrogate, sweepfabric, sweeprunner

# the fit's tolerance, port against reference at the same seed (the one
# chip_smoke.py holds the card's fit to against the host's)
RTOL, ATOL = surrogate.FIT_RTOL, surrogate.FIT_ATOL
AXES = dict(arches=("qwen1.5-0.5b",), mesh_shapes=((2, 2), (4, 1), (4, 4)),
            scenario="train", logic_nodes=("N7", "N5"),
            hbms=("HBM2E", "HBM3"), n_tilings=4, chunk_size=1)  # 12 points
SPEC, REF_SPEC = sweeprunner.SweepSpec(**AXES), ref_sr.SweepSpec(**AXES)
LABELS = sweeprunner.enumerate_labels(SPEC)
CHUNKS = sweeprunner.make_chunks(LABELS, SPEC.chunk_size)
FP = SPEC.fingerprint()
# serving-traffic with swept params: the variant-key columns
TRAFFIC = dict(arches=("qwen1.5-0.5b", "recurrentgemma-2b"),
               mesh_shapes=((2, 2),), scenario="serving-traffic",
               logic_nodes=("N7",), budget_scales=(0.9, 1.1), n_tilings=4,
               chunk_size=4,
               scenario_params={"qps": 0.1, "prefill_chunk": [1024.0,
                                                              8192.0]})


def fake_records(labels, seed=0):
    """Schema-shaped rows without the evaluator: seeded times, a quarter
    of them infeasible (classifier-only rows)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, lb in enumerate(labels):
        t = float(rng.uniform(0.5, 3.0))
        out.append({"key": f"k{i}", "arch": lb.arch, "cell": lb.cell,
                    "mesh": "x".join(map(str, lb.mesh)), "logic": lb.logic,
                    "hbm": lb.hbm, "net": lb.net, "scale": lb.scale,
                    "strategy": lb.strategy, "devices": int(np.prod(lb.mesh)),
                    "feasible": i % 4 != 3, "time_s": t,
                    "compute_s": 0.6 * t, "comm_s": 0.4 * t,
                    "exposed_comm_s": 0.2 * t})
    return out


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


@pytest.fixture(autouse=True)
def sigterm_handler_restored():
    prev = signal.getsignal(signal.SIGTERM)
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_featurizer_dataset_and_training_rows_equal_the_reference(tmp_path):
    """The standardized matrix and the dataset bit for bit, over the train
    grid and a serving-traffic grid with variant columns; a committed
    sweep directory with a torn tail reads to the same training rows."""
    for axes in (AXES, TRAFFIC):
        spec, ref_spec = sweeprunner.SweepSpec(**axes), ref_sr.SweepSpec(
            **axes)
        labels = sweeprunner.enumerate_labels(spec)
        fz = surrogate.Featurizer.from_spec(spec, device="cpu")
        rfz = ref_sur.Featurizer.from_spec(ref_spec)
        assert (fz.arch_vocab, fz.cell_vocab, fz.strategy_vocab,
                fz.variant_keys, fz.mesh_rank, fz.dim) == (
            rfz.arch_vocab, rfz.cell_vocab, rfz.strategy_vocab,
            rfz.variant_keys, rfz.mesh_rank, rfz.dim)
        X = fz.transform(spec, labels, "cpu")
        assert X.dtype == np.float64 and X.shape == (len(labels), fz.dim)
        np.testing.assert_array_equal(X, rfz.transform(
            ref_spec, ref_sr.enumerate_labels(ref_spec)))
        records = fake_records(labels)
        _, ds = surrogate.build_dataset(spec, records, device="cpu")
        _, rds = ref_sur.build_dataset(ref_spec, records)
        for f in ("X", "Y", "feasible", "y_mean", "y_std"):
            np.testing.assert_array_equal(getattr(ds, f), getattr(rds, f))
        assert (ds.objectives, ds.signs) == (rds.objectives, rds.signs)
    assert fz.variant_keys == ("prefill_chunk",)

    out = str(tmp_path / "sw")
    os.makedirs(out)
    ref_exec.write_spec_head(os.path.join(out, "spec.json"),
                             ref_sr.SPEC_VERSION, FP, REF_SPEC.to_dict())
    j = ref_exec.ChunkJournal(os.path.join(out, "results.jsonl"),
                              os.path.join(out, "checkpoint.jsonl")).open()
    rows = fake_records(LABELS)
    for c in CHUNKS[:6]:
        j.commit(c.index, c.hash(FP), [rows[c.index]])
    j.close()
    with open(os.path.join(out, "results.jsonl"), "a") as fh:
        fh.write('{"chunk": 9, "key": "torn", "time_s": 0.0')
    spec, got = surrogate.load_training_records(out)
    assert spec.fingerprint() == FP and got == \
        ref_sur.load_training_records(out)[1] == rows[:6]
    assert surrogate.dedupe_records(got + got[:2]) == got


@pytest.mark.parametrize("ensemble,hidden,steps", [(2, 8, 40), (4, 32, 300)])
def test_fit_predictions_match_the_reference(ensemble, hidden, steps,
                                             capsys):
    """The same seed gives the same members, resamples and Adam steps:
    (mu, sigma, p_feasible) of every label within RTOL / ATOL of the
    reference's; each member's stop step is printed (a float32 ulp can
    move a freeze by one step)."""
    records = fake_records(LABELS, seed=1)
    fz = surrogate.Featurizer.from_spec(SPEC, LABELS, device="cpu")
    X = fz.transform(SPEC, LABELS, "cpu")
    cfg = dict(ensemble=ensemble, hidden=hidden, steps=steps, seed=3)
    model = surrogate.fit_surrogate(
        SPEC, records, cfg=surrogate.SurrogateConfig(**cfg), featurizer=fz,
        device="cpu")
    ref = ref_sur.fit_surrogate(REF_SPEC, records,
                                cfg=ref_sur.SurrogateConfig(**cfg))
    with capsys.disabled():
        print(f"\n  fit {cfg}: members stopped at steps {model.stop_steps}; "
              f"loss {model.loss:.9g} (reference {ref.loss:.9g})")
    assert len(model.stop_steps) == ensemble
    assert model.params.shape == ref.params.shape
    np.testing.assert_allclose(model.loss, ref.loss, rtol=RTOL)
    np.testing.assert_array_equal(model.y_std, ref.y_std)
    for name, got, want, scale in zip(
            ("mu", "sigma", "p_feasible"), surrogate.predict(model, X),
            ref_sur.predict(ref, X), (model.y_std, model.y_std, 1.0)):
        ratio = np.abs(got - want) / (RTOL * np.abs(want) + ATOL * scale)
        assert ratio.max() <= 1.0, (name, ratio.max(), got, want)


def test_acquisitions_margins_and_chunk_ranking_equal_the_reference():
    """Margins, UCB, EPI, the feasibility discount and chunk scores equal
    the reference's on seeded draws; the port's are invariant under any
    subset of objective sign flips; chunks with tied scores rank in index
    order whatever order they come in."""
    rng = np.random.default_rng(1234)
    for k in (1, 2, 3):
        for _ in range(20):
            n, nf = int(rng.integers(1, 7)), int(rng.integers(0, 5))
            mu = rng.normal(size=(n, k))
            sigma = np.abs(rng.normal(size=(n, k)))
            front = rng.normal(size=(nf, k))
            signs = tuple(1.0 if i % 2 == 0 else -1.0 for i in range(k))
            np.testing.assert_array_equal(
                surrogate.dominance_margin(mu, front),
                ref_sur.dominance_margin(mu, front))
            for acq, racq in ((surrogate.ucb_acquisition,
                               ref_sur.ucb_acquisition),
                              (surrogate.epi_acquisition,
                               ref_sur.epi_acquisition)):
                a = acq(mu, sigma, front, signs)
                np.testing.assert_array_equal(a, racq(mu, sigma, front,
                                                      signs))
                if not nf:
                    continue
                for mask in range(2 ** k):
                    flips = np.array([-1.0 if mask >> i & 1 else 1.0
                                      for i in range(k)])
                    np.testing.assert_allclose(
                        acq(mu * flips, sigma, front * flips,
                            tuple(s * f for s, f in zip(signs, flips))),
                        a, rtol=1e-12, atol=1e-12)
            p = rng.uniform(size=n)
            acq = surrogate.ucb_acquisition(mu, sigma, front, signs)
            np.testing.assert_array_equal(
                surrogate.feasibility_weighted(acq, p),
                ref_sur.feasibility_weighted(acq, p))
    label_scores = rng.normal(size=len(LABELS))
    label_scores[::5] = -np.inf
    got = surrogate.chunk_scores(sweeprunner.make_chunks(LABELS, 4),
                                 label_scores)
    assert len(got) == 3 and got == ref_sur.chunk_scores(
        ref_sr.make_chunks(ref_sr.enumerate_labels(REF_SPEC), 4),
        label_scores)
    vals = [0.5, 0.5, 1.5, 1.5, float("nan"), 0.5, 1.5, 0.5]
    scores = {c.index: vals[i % len(vals)] for i, c in enumerate(CHUNKS)}
    want = [c.index for c in ref_sr.order_chunks(
        ref_sr.make_chunks(ref_sr.enumerate_labels(REF_SPEC), 1), scores)]
    shuffled = list(CHUNKS)
    for seed in range(20):
        random.Random(seed).shuffle(shuffled)
        assert [c.index for c in sweeprunner.order_chunks(
            shuffled, scores)] == want


def test_chunk_order_round_trip_ranking_and_advisory_scan(tmp_path):
    """``order.json`` crosses between the packages both ways with the
    reference's guards; ``rank_chunks`` / ``order_fabric_dir`` give the
    reference's order; a port worker scans in the advisory order (and in
    index order when the file is stale), and commits chunks in it."""
    out = str(tmp_path / "fab")
    sweepfabric.init_dir(SPEC, out)
    sweepfabric.write_chunk_order(out, [3, 1, 2, 0], FP)
    assert ref_fabric.load_chunk_order(out, FP, 4) == [3, 1, 2, 0]
    ref_fabric.write_chunk_order(out, [3, 1], FP)
    assert sweepfabric.load_chunk_order(out, FP, 4) == [3, 1, 0, 2]
    assert sweepfabric.load_chunk_order(out, "deadbeef", 4) is None
    for payload in ('{"fingerprint": "' + FP + '", "order": [3, ',
                    json.dumps({"fingerprint": FP, "order": [0, "x"]})):
        with open(os.path.join(out, "order.json"), "w") as fh:
            fh.write(payload)
        assert sweepfabric.load_chunk_order(out, FP, 4) is None
    with open(os.path.join(out, "order.json"), "w") as fh:
        json.dump({"fingerprint": FP, "order": [2, 99, 2, -1]}, fh)
    assert sweepfabric.load_chunk_order(out, FP, 4) == [2, 0, 1, 3]

    records = fake_records(LABELS, seed=2)
    cfg = dict(surrogate=dict(ensemble=2, hidden=8, steps=30))
    order = surrogate.rank_chunks(SPEC, records, cfg=surrogate.ExploreConfig(
        surrogate=surrogate.SurrogateConfig(**cfg["surrogate"])),
        device="cpu")
    want = ref_sur.rank_chunks(REF_SPEC, records, cfg=ref_sur.ExploreConfig(
        surrogate=ref_sur.SurrogateConfig(**cfg["surrogate"])))
    assert order == want and sorted(order) == list(range(len(CHUNKS)))
    written = surrogate.order_fabric_dir(
        out, records, cfg=surrogate.ExploreConfig(
            surrogate=surrogate.SurrogateConfig(**cfg["surrogate"])),
        device="cpu")
    assert written == order == sweepfabric.load_chunk_order(out, FP,
                                                            len(CHUNKS))
    w = sweepfabric.FabricWorker(out, worker_id="w0", claim_batch=1,
                                 device="cpu")
    assert [c.index for c in w._scan] == order
    stats = w.run()
    assert [c for c, _ in json.load(open(sweepfabric.shard_paths(
        out, "w0")["stats"]))["committed"]] == order
    assert stats.n_chunks_committed == len(CHUNKS)
    sweepfabric.write_chunk_order(out, order, "deadbeef")
    assert [c.index for c in sweepfabric.FabricWorker(
        out, worker_id="w1", device="cpu")._scan] == list(range(len(CHUNKS)))
