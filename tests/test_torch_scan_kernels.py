"""The port's RG-LRU scan and mLSTM ops against the reference's, on the CPU.

On the CPU ``ops.rglru_scan`` / ``ops.mlstm`` with ``use_kernel=True``
take the kernels' plain versions (the CUDA kernels themselves are held to
those in tests/test_torch_card.py, on the card).  The reference side runs
its Pallas kernels in interpret mode and its ``ref.py`` oracles, on the
same numpy-seeded inputs, at ``tests/test_kernels.py``'s shapes and
tolerances: scan 1e-4 (the plain versions of both packages loop over t in
fp32, product then sum, so they are held to 1e-5), mLSTM 3e-3 in float32
and 3e-2 in bfloat16 (the TPU kernel rounds its weights to bfloat16 before
w.V, the plain version does not).  Flash attention's plain version is
checked at recurrentgemma's head dim 256.

The bf16 mLSTM kernel's design (csrc/mlstm.cu, ``mlstm_mma_kernel``) runs
only on the card; here a torch emulation of its tiled online form, with
its tiles and its rounding points, is held to the TPU kernel in interpret
mode in bfloat16 (3e-2) and to the plain version in float32 (1e-5: the
tiling alone moves nothing but the order of fp32 sums).

The RG-LRU scan's ring kernel (csrc/rglru_scan.cu, ``rglru_ring_kernel``)
likewise: a torch emulation of its indexing (blocks of 32 channels, tiles
of its rows copied 16 bytes at a time into its ring slots, zero-filled
lanes and rows) is held bit for bit to the plain version and, with each
step contracted to one rounding as XLA contracts the TPU kernel's step to
a fused multiply-add on the CPU, bit for bit to the TPU kernel in
interpret mode.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_ref
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.mlstm import mlstm_parallel as ref_mlstm
from repro.kernels.rglru import rglru_scan as ref_rglru
from repro_torch.kernels import build as port_build
from repro_torch.kernels import mlstm as port_mlstm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import rglru as port_rglru
from repro_torch.kernels.ref import (attention_ref, mlstm_parallel_ref,
                                     rglru_scan_ref)


def _np(x):
    return np.asarray(x, np.float32)


def _rglru_inputs(seed, batch, seq, width):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((batch, seq, width))))
         ).astype(np.float32)                                    # 0 < a < 1
    b = rng.standard_normal((batch, seq, width)).astype(np.float32)
    h0 = rng.standard_normal((batch, width)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("batch,seq,width", [
    (1, 128, 64), (2, 256, 128), (3, 96, 32), (2, 7, 37)])
def test_rglru_scan_matches_reference(batch, seq, width):
    a, b, h0 = _rglru_inputs(0, batch, seq, width)
    got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(h0), use_kernel=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == a.shape
    want = ref_rglru(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                     interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)
    oracle = ref_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(h0))
    np.testing.assert_allclose(got.numpy(), _np(oracle), rtol=1e-5,
                               atol=1e-5)
    plain = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(h0))
    assert torch.equal(plain, got)


def test_rglru_scan_bf16_inputs_widen_to_f32():
    a, b, h0 = _rglru_inputs(1, 2, 64, 48)
    ab = [jnp.asarray(x, jnp.bfloat16) for x in (a, b, h0)]
    want = ref_rglru(*ab, interpret=True)
    got = ops.rglru_scan(*(torch.from_numpy(_np(x)).to(torch.bfloat16)
                           for x in ab), use_kernel=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seq,bt", [(64, 16), (96, 64), (128, 128),
                                    (192, 32), (100, 16)])
def test_rglru_block_invariance(seq, bt):
    """The output is independent of block_t, which is clamped and recorded
    as the reference clamps it."""
    a, b, _ = _rglru_inputs(3, 1, seq, 32)
    h0 = np.zeros((1, 32), np.float32)
    got = port_rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(h0), block_t=bt)
    want_bt = min(bt, seq)
    while seq % want_bt:
        want_bt -= 1
    assert port_rglru.LAST_BLOCK_T == want_bt
    want = ref_rglru(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                     block_t=bt, interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)
    assert torch.equal(got, rglru_scan_ref(torch.from_numpy(a),
                                           torch.from_numpy(b),
                                           torch.from_numpy(h0)))


def test_rglru_decay_property():
    """With b = 0 the state decays monotonically for 0 < a < 1."""
    a = torch.full((1, 64, 16), 0.9)
    h = ops.rglru_scan(a, torch.zeros_like(a), torch.ones((1, 16)),
                       use_kernel=True)[0]
    assert np.all(np.diff(torch.linalg.vector_norm(h, dim=-1).numpy()) < 0)


def test_rglru_scan_refusals_and_no_launch_on_the_host():
    a = torch.rand((1, 8, 4))
    before = port_rglru.LAUNCHES
    port_rglru.rglru_scan(a, a, torch.zeros((1, 4)))
    assert port_rglru.LAUNCHES == before            # the plain version
    with pytest.raises(ValueError, match="h0"):
        port_rglru.rglru_scan(a, a, torch.zeros((1, 5)))
    with pytest.raises(ValueError):
        port_rglru.rglru_scan(a, a[:, :4], torch.zeros((1, 4)))
    with pytest.raises(TypeError):
        port_rglru.rglru_scan(a, a.double(), torch.zeros((1, 4)))
    with pytest.raises(ValueError, match="block_t"):
        port_rglru.rglru_scan(a, a, torch.zeros((1, 4)), block_t=0)


def _ring_constants():
    """LANES, RING_ROWS and RING_STAGES as csrc/rglru_scan.cu defines them."""
    src = (Path(port_build.CSRC) / "rglru_scan.cu").read_text()
    return [int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for name in ("LANES", "RING_ROWS", "RING_STAGES")]


def _rglru_ring_emulation(a, b, h0, fused=False):
    """csrc/rglru_scan.cu's ring kernel in torch, every (batch row, block
    of 32 channels) at once: tile i of RING_ROWS steps is copied into ring
    slot i % RING_STAGES, RING_STAGES - 1 tiles ahead of the walk, by each
    lane's 16-byte copies (zero-filled past ``width`` and past ``seq``);
    each step is a rounded product, then a rounded sum (``fused``: one
    rounding, from the exact float64 product).  Returns the output and the
    tiles walked."""
    lanes, rows, stages = _ring_constants()
    batch, seq, width = a.shape
    per_copy = 16 // a.element_size()
    assert width % per_copy == 0, "the element-wise variant's shape"
    per_row = lanes // per_copy                 # copies a tile row
    rows_per_pass = lanes // per_row
    n_blk, n_tiles = -(-width // lanes), -(-seq // rows)
    flat_a, flat_b = a.reshape(-1), b.reshape(-1)
    lane = torch.arange(lanes)
    crow, ccol = lane // per_row, (lane % per_row) * per_copy
    n = torch.arange(batch)[:, None, None, None, None]      # (n, blk, k, lane, e)
    c0 = (torch.arange(n_blk) * lanes)[None, :, None, None, None]
    r = (crow[None, :] + torch.arange(rows // rows_per_pass)[:, None]
         * rows_per_pass)[None, None, :, :, None]
    col = ccol[None, None, None, :, None] + torch.arange(per_copy)
    ring = torch.full((stages, 2, batch, n_blk, rows, lanes), torch.nan)

    def load_tile(tile):
        t0 = tile * rows
        ok = (c0 + ccol[None, None, None, :, None] < width) & (t0 + r < seq)
        off = torch.where(ok, (n * seq + t0 + r) * width + c0 + col, 0)
        covered = torch.zeros((batch, n_blk, rows, lanes), dtype=torch.int64)
        for x, src in enumerate((flat_a, flat_b)):
            vals = torch.where(ok, src[off].float(), 0.0)
            slot = ring[tile % stages, x]
            idx = (n.expand_as(off), c0.expand_as(off) // lanes,
                   r.expand_as(off), col.expand_as(off))
            slot[idx] = vals
            covered.index_put_(idx, torch.ones_like(off), accumulate=True)
        assert bool((covered == 2).all()), "each element copied once"

    c = (torch.arange(n_blk)[:, None] * lanes + lane).reshape(-1)
    live = c < width
    h = torch.zeros((batch, n_blk * lanes))
    h[:, live] = h0.float()
    out = torch.empty((batch, seq, width))
    for s in range(stages - 1):
        if s < n_tiles:
            load_tile(s)
    for i in range(n_tiles):
        if i + stages - 1 < n_tiles:
            load_tile(i + stages - 1)
        sa, sb = (ring[i % stages, x].reshape(batch, -1, rows, lanes)
                  .transpose(1, 2).reshape(batch, rows, -1) for x in (0, 1))
        for t in range(min(rows, seq - i * rows)):
            if fused:
                h = (sa[:, t].double() * h.double() + sb[:, t]).float()
            else:
                h = sa[:, t] * h + sb[:, t]
            out[:, i * rows + t] = h[:, live]
    return out, n_tiles


def _same_bits(got, want):
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype,batch,seq,width", [
    ("float32", 1, 1, 32), ("float32", 2, 64, 64), ("float32", 3, 65, 36),
    ("float32", 2, 200, 100), ("float32", 1, 300, 68),
    ("bfloat16", 1, 1, 8), ("bfloat16", 2, 100, 40),
    ("bfloat16", 2, 257, 96)])
def test_rglru_ring_kernel_design_emulated(dtype, batch, seq, width):
    """The ring kernel's indexing, ragged in seq (past whole tiles, below
    one tile and below the ring's depth) and in width (a partial block of
    32 channels): bit for bit the plain version and, contracted as XLA
    contracts the TPU kernel's step, the TPU kernel at every block_t."""
    a, b, h0 = _rglru_inputs(12, batch, seq, width)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    ta, tb = (torch.tensor(_np(x)).to(getattr(torch, dtype))
              for x in (ja, jb))
    th0 = torch.from_numpy(h0)
    got, walked = _rglru_ring_emulation(ta, tb, th0)
    rows = _ring_constants()[1]
    assert walked == -(-seq // rows)
    _same_bits(got, rglru_scan_ref(ta, tb, th0))
    fused, _ = _rglru_ring_emulation(ta, tb, th0, fused=True)
    for block_t in (1, 16, 128):
        want = ref_rglru(ja, jb, jnp.asarray(h0), block_t=block_t,
                         interpret=True)
        _same_bits(fused, torch.tensor(_np(want)))
    np.testing.assert_allclose(got.numpy(), fused.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_rglru_kernel_variant_choice():
    """The ring where its 16-byte copies take a and b: the path's shape
    in both dtypes, widths of whole copies (36 in float32); the
    element-wise kernel for other widths (37; 36 and 100 in bfloat16) and
    for a or b that does not start 16-byte aligned.  The host takes the
    plain version and records no variant."""
    def variant(shape, dtype, shift=0):
        flat = torch.empty(2 * int(np.prod(shape)) + shift, dtype=dtype)
        a = flat[shift:shift + int(np.prod(shape))].view(shape)
        return port_rglru.kernel_variant(a, flat[-a.numel():].view(shape))

    ring, elem = port_rglru.RING, port_rglru.ELEMENTWISE
    for dtype in (torch.float32, torch.bfloat16):
        assert variant((2, 2048, 2560), dtype) == ring
        assert variant((2, 7, 37), dtype) == elem
        assert variant((1, 4, 64), dtype, shift=1) == elem
        assert variant((1, 4, 64), dtype, shift=16 // (dtype.itemsize)) \
            == ring
    assert variant((1, 4, 36), torch.float32) == ring
    assert variant((1, 4, 36), torch.bfloat16) == elem
    assert variant((3, 5, 100), torch.bfloat16) == elem
    a = torch.rand((1, 8, 64))
    port_rglru.rglru_scan(a, a, torch.zeros((1, 64)))
    assert port_rglru.LAST_VARIANT is None


def _mlstm_inputs(seed, b, h, s, d):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    f = rng.standard_normal((b, h, s)).astype(np.float32) + 1.0
    log_f = -np.logaddexp(0.0, -f).astype(np.float32)        # log sigmoid
    f_cum = np.cumsum(log_f, axis=-1).astype(np.float32)
    log_i = (rng.standard_normal((b, h, s)) * 0.3).astype(np.float32)
    return q, k, v, f_cum, log_i


@pytest.mark.parametrize("b,h,s,d", [(1, 2, 128, 64), (2, 4, 256, 32)])
def test_mlstm_matches_reference(b, h, s, d):
    ins = _mlstm_inputs(0, b, h, s, d)
    got = ops.mlstm(*(torch.from_numpy(x) for x in ins), use_kernel=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, s, d)
    want = ref_mlstm(*(jnp.asarray(x) for x in ins), interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=3e-3, atol=3e-3)
    oracle = ref_ref.mlstm_parallel_ref(*(jnp.asarray(x) for x in ins))
    np.testing.assert_allclose(got.numpy(), _np(oracle), rtol=3e-3,
                               atol=3e-3)


@pytest.mark.parametrize("bq,bkv", [(32, 32), (64, 32), (128, 64),
                                    (32, 64)])
def test_mlstm_block_invariance(bq, bkv):
    ins = _mlstm_inputs(7, 1, 2, 128, 32)
    want = ref_mlstm(*(jnp.asarray(x) for x in ins), block_q=bq,
                     block_kv=bkv, interpret=True)
    got = port_mlstm.mlstm_parallel(*(torch.from_numpy(x) for x in ins),
                                    block_q=bq, block_kv=bkv)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("s", [1, 100, 130])
def test_mlstm_head_dim_192_any_length(s):
    """xlstm-125m's head dim, at lengths that are no multiple of a tile."""
    ins = _mlstm_inputs(8, 2, 4, s, 192)
    got = ops.mlstm(*(torch.from_numpy(x) for x in ins), use_kernel=True)
    want = ref_mlstm(*(jnp.asarray(x) for x in ins), interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=3e-3, atol=3e-3)


def test_mlstm_bf16_matches_the_tpu_kernel():
    ins = _mlstm_inputs(9, 1, 2, 128, 64)
    qkv = [jnp.asarray(x, jnp.bfloat16) for x in ins[:3]]
    want = ref_mlstm(*qkv, jnp.asarray(ins[3]), jnp.asarray(ins[4]),
                     interpret=True)
    got = ops.mlstm(*(torch.from_numpy(_np(x)).to(torch.bfloat16)
                      for x in qkv), torch.from_numpy(ins[3]),
                    torch.from_numpy(ins[4]), use_kernel=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=3e-2,
                               atol=3e-2)


def test_mlstm_refusals_and_no_launch_on_the_host():
    q = torch.zeros((1, 2, 8, 32))
    z = torch.zeros((1, 2, 8))
    before = port_mlstm.LAUNCHES
    torch.testing.assert_close(port_mlstm.mlstm_parallel(q, q, q, z, z),
                               mlstm_parallel_ref(q, q, q, z, z))
    assert port_mlstm.LAUNCHES == before
    q96 = torch.zeros((1, 2, 8, 96))
    with pytest.raises(ValueError, match="head dim 96"):
        port_mlstm.mlstm_parallel(q96, q96, q96, z, z)
    with pytest.raises(ValueError, match="f_cum"):
        port_mlstm.mlstm_parallel(q, q, q, z[:, :1], z)
    with pytest.raises(TypeError):
        port_mlstm.mlstm_parallel(q, q, q.double(), z, z)
    with pytest.raises(ValueError, match="block_q"):
        port_mlstm.mlstm_parallel(q, q, q, z, z, block_q=0)


@pytest.mark.parametrize("shape,kw", [
    ((1, 10, 1, 128, 128, 256), dict(causal=True)),
    ((2, 4, 1, 96, 96, 256), dict(causal=True, window=32)),
    ((1, 2, 2, 64, 160, 256), dict(causal=False)),
])
def test_attention_ref_at_head_dim_256(shape, kw):
    """recurrentgemma-2b's attention: the plain version against the
    reference's oracle and its Pallas kernel (interpret mode)."""
    b, h, hkv, sq, skv, d = shape
    rng = np.random.default_rng(10)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    got = ops.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                        use_kernel=True, **kw)
    want = ref_ref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    pallas = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), _np(pallas), rtol=2e-3,
                               atol=2e-3)
    assert torch.equal(got, attention_ref(*(torch.from_numpy(x)
                                            for x in (q, k, v)), **kw))


def _mlstm_kernel_emulation(q, k, v, f_cum, log_i):
    """csrc/mlstm.cu's bf16 kernel in torch: 64-row q tiles, kv tiles of
    64 keys up to the tile holding the q tile's last row
    (tiles above the diagonal skipped), K, V, F and i zero-filled past s;
    q * scale rounded to q's dtype; a = (F_t - F_j) + i_j, -1e30 above the
    diagonal, -inf past s; the running m; w = S exp(a - m) (0 past s); the
    denominator from the unrounded w, the numerator from w rounded to v's
    dtype; out = num / max(|den|, exp(-m)) in q's dtype.  Returns the
    output and the (q tile, kv tile) pairs walked."""
    b, h, s, d = q.shape
    bq, bkv = 64, 64
    low = q.dtype == torch.bfloat16
    n_kv = -(-s // bkv)

    def pad(x):                     # zero rows past s, to whole kv tiles
        shape = list(x.shape)
        shape[2] = n_kv * bkv - s
        return torch.cat([x.float(), x.new_zeros(shape, dtype=torch.float32)],
                         dim=2)

    qs = (q * torch.tensor(d ** -0.5, dtype=q.dtype)).float()
    kf, vf = pad(k), pad(v)
    fc, li = pad(f_cum[..., None])[..., 0], pad(log_i[..., None])[..., 0]
    out = torch.empty((b, h, s, d))
    pairs = 0
    for q0 in range(0, s, bq):
        rows = torch.arange(q0, min(q0 + bq, s))
        m = torch.full((b, h, len(rows), 1), port_ref.NEG_INF)
        den = torch.zeros((b, h, len(rows), 1))
        num = torch.zeros((b, h, len(rows), d))
        for k0 in range(0, int(rows[-1]) + 1, bkv):
            pairs += 1
            cols = torch.arange(k0, k0 + bkv)
            live = cols[None, :] < s
            sc = qs[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)
            a = (fc[:, :, rows, None] - fc[:, :, None, cols]) \
                + li[:, :, None, cols]
            a = torch.where(cols[None, :] <= rows[:, None], a,
                            torch.full((), port_ref.NEG_INF))
            a = torch.where(live, a, torch.full((), -torch.inf))
            m_new = torch.maximum(m, a.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            w = torch.where(live, sc * torch.exp(a - m_new), 0.0)
            den = den * corr + w.sum(-1, keepdim=True)
            wr = w.to(torch.bfloat16).float() if low else w
            num = num * corr + wr @ vf[:, :, cols]
            m = m_new
        out[:, :, rows] = num / torch.maximum(den.abs(), torch.exp(-m))
    return out.to(q.dtype), pairs


@pytest.mark.parametrize("s", [1, 15, 63, 65, 200])
@pytest.mark.parametrize("d", port_mlstm.HEAD_DIMS)
def test_mlstm_kernel_design_emulated(d, s):
    """The bf16 kernel's tiled online form: in bfloat16 against the TPU
    kernel (interpret mode), whose rounding points it shares, at 3e-2; in
    float32 against the plain version at 1e-5; only the causal tiles are
    walked."""
    ins = _mlstm_inputs(11, 1, 2, s, d)
    walked = sum((min(q0 + 64, s) - 1) // 64 + 1 for q0 in range(0, s, 64))
    qkv = [jnp.asarray(x, jnp.bfloat16) for x in ins[:3]]
    want = ref_mlstm(*qkv, jnp.asarray(ins[3]), jnp.asarray(ins[4]),
                     interpret=True)
    got, pairs = _mlstm_kernel_emulation(
        *(torch.from_numpy(_np(x)).to(torch.bfloat16) for x in qkv),
        torch.from_numpy(ins[3]), torch.from_numpy(ins[4]))
    assert got.dtype == torch.bfloat16 and pairs == walked
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=3e-2,
                               atol=3e-2)
    f32 = [torch.from_numpy(x) for x in ins]
    got, _ = _mlstm_kernel_emulation(*f32)
    torch.testing.assert_close(got, mlstm_parallel_ref(*f32), rtol=1e-5,
                               atol=1e-5)
