"""The port's device-resident streaming Pareto frontier against the
reference's, on the CPU.

`pathfinder.frontier_merge` is fed the same numpy-seeded batches as the
reference's jitted one, step by step: exact float32 ties, non-finite rows,
idx -1 padding, duplicates, overflow and the full-lexicographic truncation
(objectives, then point index); every carried state must be the
reference's bit for bit.  `frontier_unpack` and the unbounded
`frontier_merge_states` are held the same way over several orders and
partitions of the states, and the ``frontier_state.npz`` checkpoint files
cross packages.  Nothing here evaluates a design point, so the
reference's process-wide caches are not touched.
"""

import itertools

import jax.numpy as jnp  # (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.core import pathfinder as ref_pf
from repro.core import sweepexec as ref_exec
from repro.core import sweeprunner as ref_sr
from repro_torch.core import pathfinder, sweepexec, sweeprunner


def _batch(rng, n: int, k: int, d: int, lo: int = 0):
    """n rows of k objectives drawn from a few integers (so exact ties
    and dominance are common; 0.0 and -0.0 both), with +inf, NaN and -inf
    entries, -1 indices, and d payload columns."""
    vals = rng.integers(0, 5, (n, k)).astype(np.float32)
    vals[(vals == 0) & (rng.random((n, k)) < 0.5)] = -0.0
    vals[rng.random((n, k)) < 0.08] = np.inf
    vals[rng.random((n, k)) < 0.04] = np.nan
    vals[rng.random((n, k)) < 0.02] = -np.inf
    pay = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(lo, lo + 4 * n, n).astype(np.int32)
    idx[rng.random(n) < 0.1] = -1
    return vals, pay, idx


def _same_state(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _stream(merge, init, batches):
    state = init
    for vals, pay, idx in batches:
        state = merge(state, vals, pay, idx)
    return state


def _port_merge(state, vals, pay, idx):
    return pathfinder.frontier_merge(state, vals, pay, idx)


def _ref_merge(state, vals, pay, idx):
    return ref_pf.frontier_merge(state, jnp.asarray(vals), jnp.asarray(pay),
                                 jnp.asarray(idx))


def test_streaming_merge_is_the_references_bit_for_bit():
    """Seeded streams of 1 to 3 objectives at capacities 3 and 8 (batches
    of 10 rows: a few shapes, so the reference's eager ops are traced
    once each): each carried state (values, payload, indices, overflow)
    is the reference's."""
    rng = np.random.default_rng(0)
    d = 3
    for k, cap, trial in itertools.product((1, 2, 3), (3, 8), range(3)):
        batches = [_batch(rng, 10, k, d, 20 * b) for b in range(5)]
        got = pathfinder.frontier_init(cap, k, d, device="cpu")
        want = ref_pf.frontier_init(cap, k, d)
        _same_state(got, want)
        for b in batches:
            got = _port_merge(got, *b)
            want = _ref_merge(want, *b)
            _same_state(got, want)


def test_ties_padding_and_truncation_in_lexicographic_order():
    """The reference's own cases: exact ties both kept, a dominated point
    dropped and later a carried one evicted, non-finite rows and idx -1
    excluded; four mutually non-dominated points into capacity 2 keep
    the two first in (objectives, index) order and count two dropped."""
    state = pathfinder.frontier_init(4, 2, 1, device="cpu")
    vals = np.asarray([[1.0, 5.0], [1.0, 5.0], [5.0, 1.0], [4.0, 4.0],
                       [3.0, 3.0], [np.inf, 0.0], [0.0, 0.0]], np.float32)
    pay = np.arange(7, dtype=np.float32)[:, None]
    idx = np.asarray([0, 1, 2, 3, 4, 5, -1], np.int32)
    state = _port_merge(state, vals, pay, idx)
    _, out_pay, out_idx, over = pathfinder.frontier_unpack(state)
    assert out_idx.tolist() == [0, 1, 4, 2] and over == 0
    assert out_pay[:, 0].tolist() == [0.0, 1.0, 4.0, 2.0]
    state = _port_merge(state, np.asarray([[0.5, 0.5]], np.float32),
                        np.asarray([[9.0]], np.float32),
                        np.asarray([7], np.int32))
    assert pathfinder.frontier_unpack(state)[2].tolist() == [7]

    state = pathfinder.frontier_init(2, 2, 1, device="cpu")
    vals = np.asarray([[4.0, 1.0], [2.0, 3.0], [1.0, 4.0], [3.0, 2.0],
                       [2.0, 3.0]], np.float32)
    idx = np.asarray([3, 9, 5, 1, 4], np.int32)
    state = _port_merge(state, vals, np.zeros((5, 1), np.float32), idx)
    out_vals, _, out_idx, over = pathfinder.frontier_unpack(state)
    assert out_idx.tolist() == [5, 4] and over == 3
    assert out_vals.tolist() == [[1.0, 4.0], [2.0, 3.0]]
    # -0.0 and 0.0 are one key: the point index decides
    state = pathfinder.frontier_init(2, 1, 1, device="cpu")
    state = _port_merge(state, np.asarray([[-0.0], [0.0]], np.float32),
                        np.zeros((2, 1), np.float32),
                        np.asarray([8, 6], np.int32))
    assert pathfinder.frontier_unpack(state)[2].tolist() == [6, 8]


def test_merge_states_over_orders_and_partitions():
    """States streamed over partitions of one point set, merged in
    several orders: each merge is the reference's, and the live set is
    the same whatever the order or partition — the frontier of all the
    points."""
    rng = np.random.default_rng(7)
    k, d = 2, 3
    batches = [_batch(rng, 9, k, d, 40 * b) for b in range(6)]
    # global indices are unique across batches (no point seen twice
    # with different values)
    for b, (_, _, idx) in enumerate(batches):
        idx[idx >= 0] = 40 * b + np.flatnonzero(idx >= 0).astype(np.int32)
    live_sets = set()
    for parts in ((0, 1, 2, 3, 4, 5), (0, 0, 1, 1, 2, 2), (2, 0, 1, 0, 2, 1)):
        n_parts = max(parts) + 1
        states = []
        for p in range(n_parts):
            mine = [b for b, q in zip(batches, parts) if q == p]
            got = _stream(_port_merge,
                          pathfinder.frontier_init(64, k, d, device="cpu"),
                          mine)
            want = _stream(_ref_merge, ref_pf.frontier_init(64, k, d),
                           mine)
            _same_state(got, want)
            states.append(got)
        orders = [list(range(n_parts)), list(range(n_parts))[::-1]] + [
            list(rng.permutation(n_parts)) for _ in range(2)]
        for order in orders:
            acc, ref_acc = states[order[0]], states[order[0]]
            for i in order[1:]:
                acc = pathfinder.frontier_merge_states(acc, states[i])
                ref_acc = ref_pf.frontier_merge_states(
                    tuple(np.asarray(x) for x in ref_acc),
                    tuple(x.numpy() for x in states[i]))
                _same_state(acc, ref_acc)
            again = pathfinder.frontier_merge_states(acc, acc)   # idempotent
            _same_state(again, acc)
            vals, pay, idx, over = pathfinder.frontier_unpack(acc)
            want = ref_pf.frontier_unpack(ref_acc)
            for g, w in zip((vals, pay, idx, over), want):
                np.testing.assert_array_equal(g, w)
            live_sets.add(tuple(sorted(idx.tolist())))
    assert len(live_sets) == 1 and next(iter(live_sets))
    with pytest.raises(ValueError, match="same spec"):
        pathfinder.frontier_merge_states(
            pathfinder.frontier_init(4, 2, 1, device="cpu"),
            pathfinder.frontier_init(4, 3, 1, device="cpu"))


def test_frontier_state_files_cross_packages(tmp_path):
    """A state written by `sweepexec.save_frontier_state` of either
    package loads in the other: the same arrays, dtypes, merged chunks,
    and the same refusals (fingerprint, capacity, a changed chunk)."""
    spec = dict(arches=("qwen1.5-0.5b",), mesh_shapes=((2, 2), (4, 4)),
                logic_nodes=("N7", "N5"), n_tilings=4, chunk_size=2)
    port_spec, ref_spec = sweeprunner.SweepSpec(**spec), \
        ref_sr.SweepSpec(**spec)
    fp = port_spec.fingerprint()
    assert fp == ref_spec.fingerprint()
    chunks = sweeprunner.make_chunks(sweeprunner.enumerate_labels(port_spec),
                                     2)
    ref_chunks = ref_sr.make_chunks(ref_sr.enumerate_labels(ref_spec), 2)
    rng = np.random.default_rng(11)
    state = _port_merge(pathfinder.frontier_init(8, 2, 5, device="cpu"),
                        *_batch(rng, 6, 2, 5))
    done = {c.index: c.hash(fp) for c in chunks[:2]}
    port_path, ref_path = tmp_path / "port.npz", tmp_path / "ref.npz"
    sweepexec.save_frontier_state(str(port_path),
                                  pathfinder.frontier_host(state), done, 8,
                                  fp)
    ref_exec.save_frontier_state(str(ref_path),
                                 ref_pf.frontier_init(8, 2, 5), done, 8, fp)
    for path in (port_path, ref_path):
        with np.load(path) as a, np.load(port_path) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype, key
    got_state, got_done = ref_exec.load_frontier_state(str(port_path), fp,
                                                       8, ref_chunks)
    assert got_done == done
    _same_state(state, got_state)
    port_state, port_done = sweepexec.load_frontier_state(
        str(ref_path), fp, 8, chunks)
    assert port_done == done
    _same_state(port_state, ref_pf.frontier_init(8, 2, 5))
    for args, match in (((fp[::-1], 8, chunks), "different spec"),
                        ((fp, 16, chunks), "capacity"),
                        ((fp, 8, chunks[1:]), "does not match")):
        with pytest.raises(ValueError, match=match):
            sweepexec.load_frontier_state(str(ref_path), *args)
