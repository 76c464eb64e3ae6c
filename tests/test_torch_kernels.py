"""The port's kernel functions (plain path, as on the CPU) against the JAX
package's oracles and its Pallas kernels in interpret mode.

K1/K2 (segment sums) and K3 (Möbius) must be exact on integer-valued
inputs: float32 sums of integers below 2^24 are exact in any order, and the
Möbius passes are the same subtractions in the same order.  K4 (BDeu) is
held to the JAX package's kernel tolerance, ``rtol=1e-4, atol=1e-2``.
"""

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bdeu import bdeu_score_batch as jax_bdeu_batch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.bdeu import bdeu_score_2d, bdeu_score_batch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bdeu import lgamma_f32
from repro_torch.kernels.mobius import mobius_matrix


def _seg_inputs(seed, n, p):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, p, size=n).astype(np.int32)
    seg[::7] = -1                       # the wrapper padding id
    seg[3::11] = p                      # the executor padding id
    return rng, seg


# ---------------------------------------------------------- K1, K2 -------

# The first four are the original cases; the rest are chip_smoke.py phase
# 10's edge shapes that a Pallas sweep in interpret mode can take: edge
# counts either side of a block's 256 threads and the IMDb hops' 400,000,
# segment counts around K1's privatisation limit (200 on an H100), with a
# 4-byte-offset view (``offset``) as the card's scalar path reads it.
@pytest.mark.parametrize("n,p,offset", [
    (1, 1, 0), (37, 5, 0), (513, 300, 0), (2000, 64, 0),
    (1, 1024, 0), (255, 199, 1), (256, 200, 0), (257, 201, 1),
    (400_000, 1, 0), (400_000, 200, 1), (400_000, 201, 0)])
def test_segsum_ones_matches_jax(n, p, offset):
    rng, seg = _seg_inputs(n + p, n + offset, p)
    w = rng.integers(0, 4, size=n + offset).astype(np.float32)
    seg_t, w_t = torch.from_numpy(seg)[offset:], torch.from_numpy(w)[offset:]
    seg, w = seg[offset:], w[offset:]
    got = ops.segsum_ones(seg_t, w_t, p)
    want_ref = jref.ones_segment_sum_ref(jnp.asarray(seg), jnp.asarray(w), p)
    want_pl = jops.ones_segment_sum(jnp.asarray(seg), jnp.asarray(w), p,
                                    interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pl))
    np.testing.assert_array_equal(
        ref.ones_segment_sum_ref(torch.from_numpy(seg), torch.from_numpy(w),
                                 p).numpy(), got.numpy())


@pytest.mark.parametrize("n", [1, 257, 400_000])
def test_segsum_ones_imdb_hop_width(n):
    """The IMDb hops' 10.8M segments, past what a Pallas one-hot sweep in
    interpret mode can take: against ``jax.ops.segment_sum`` (the JAX
    package's reference) only."""
    p = 10_800_000
    rng, seg = _seg_inputs(n, n, p)
    w = rng.integers(0, 4, size=n).astype(np.float32)
    got = ops.segsum_ones(torch.from_numpy(seg), torch.from_numpy(w), p)
    want = jref.ones_segment_sum_ref(jnp.asarray(seg), jnp.asarray(w), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ones_plan_regimes():
    """K1's regime chooser: the IMDb histograms (a few segments, an
    entity's rows) privatise, the IMDb hops (10.8M segments) go direct in
    slices, and the privatisation limit falls where the card's shared
    memory puts it."""
    from repro_torch.kernels.segsum import (H100, Card, OnesPlan,
                                            ones_plan,
                                            ones_privatisation_limit)
    # the largest IMDb hop: a 43 MB table is zeroed and scattered in four
    # 10.8 MB slices that L2 keeps, by one cooperative launch of a
    # 1,024-thread block an SM, and so is the 250,000-edge one; the
    # smallest (fewer than 50,000 edges a slice) takes a zero kernel,
    # then the scatter
    assert ones_plan(400_000, 10_800_000) == OnesPlan("direct", 132, 4)
    assert ones_plan(250_000, 10_800_000) == OnesPlan("direct", 132, 4)
    assert ones_plan(113_000, 10_800_000) == OnesPlan("direct", 111, 0)
    assert ones_plan(200_000, 10_800_000).slices == 4
    assert ones_plan(199_999, 10_800_000).slices == 0
    # a table of at most 12 MiB: a zero kernel, then the scatter
    assert ones_plan(400_000, 3 << 20) == OnesPlan("direct", 391, 0)
    assert ones_plan(400_000, (3 << 20) + 1).slices == 2
    assert ones_plan(10 ** 8, 2 ** 20).blocks == 8 * H100.sms
    # the histograms: sqrt(E / 6P) blocks balance a thread's edges against
    # the flush's atomics on the same P addresses
    assert [ones_plan(100_000, p) for p in (1, 3, 9, 27)] == [
        OnesPlan("private", b, 0) for b in (98, 74, 43, 24)]
    # 200 KB of tables at 1 KB a segment (256 threads x one float)
    limit = ones_privatisation_limit(H100)
    assert limit == 200
    assert ones_plan(10 ** 6, limit).regime == "private"
    assert ones_plan(10 ** 6, limit + 1).regime == "direct"
    # at 200 KB of tables an SM holds one block
    assert ones_plan(10 ** 9, limit).blocks == H100.sms
    # fewer than 4 edges a segment do not pay for the tables' flush
    assert ones_plan(4 * 27, 27) == OnesPlan("private", 1, 0)
    assert ones_plan(4 * 27 - 1, 27).regime == "direct"
    assert ones_plan(1, 1) == OnesPlan("direct", 1, 0)
    # a card with 48 KB per block has room for 48 segments
    small = Card(sms=132, smem_block=48 * 1024, smem_sm=100 * 1024)
    assert ones_privatisation_limit(small) == 48
    assert ones_plan(10 ** 6, 49, small).regime == "direct"
    # the ops wrapper counts K1's launches by regime
    ops.ONES_REGIMES["private"] = 2
    ops.reset_counts()
    assert ops.ONES_REGIMES == {"direct": 0, "private": 0}


# The card's regime edges at small size: one segment, widths not a multiple
# of 4, 49/50/51 segments either side of the privatisation limit (50 on an
# H100), and 4-byte-offset views of the ids and rows (``offset``), which
# take the kernel's scalar path on the card.
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,d,p", [(1, 1, 1), (40, 3, 7), (600, 17, 129),
                                   (1500, 40, 33), (300, 5, 1),
                                   (257, 6, 49), (256, 4, 50),
                                   (255, 257, 51)])
def test_segsum_rows_matches_jax(n, d, p, offset):
    rng, seg = _seg_inputs(n * d + p, n + offset, p)
    rows = rng.integers(0, 9, size=(n + offset, d)).astype(np.float32)
    seg_t, rows_t = torch.from_numpy(seg)[offset:], \
        torch.from_numpy(rows)[offset:]
    seg, rows = seg[offset:], rows[offset:]
    assert rows_t.is_contiguous() and seg_t.shape == (n,)
    got = ops.segsum_rows(seg_t, rows_t, p)
    want_ref = jref.edge_segment_sum_ref(jnp.asarray(seg),
                                         jnp.asarray(rows), p)
    want_pl = jops.edge_segment_sum(jnp.asarray(seg), jnp.asarray(rows), p,
                                    interpret=True)
    assert got.shape == (p, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pl))
    np.testing.assert_array_equal(
        ref.edge_segment_sum_ref(torch.from_numpy(seg),
                                 torch.from_numpy(rows), p).numpy(),
        got.numpy())


@pytest.mark.parametrize("start", ["zeros", "counts"])
def test_segsum_rows_accumulates_into_out(start):
    """The root combine's chunks all add into one table: equal to the sum
    of the JAX package's per-chunk segment sums, on top of what the table
    held (zeros, or counts already there)."""
    rng, seg = _seg_inputs(5, 900, 27)
    rows = rng.integers(0, 9, size=(900, 12)).astype(np.float32)
    want = (np.zeros((27, 12), np.float32) if start == "zeros" else
            rng.integers(0, 5, size=(27, 12)).astype(np.float32))
    out = torch.from_numpy(want.copy())
    for s in range(0, 900, 256):
        got = ops.segsum_rows(torch.from_numpy(seg[s:s + 256]),
                              torch.from_numpy(rows[s:s + 256]), 27, out=out)
        assert got is out
        want += np.asarray(jref.edge_segment_sum_ref(
            jnp.asarray(seg[s:s + 256]), jnp.asarray(rows[s:s + 256]), 27))
    np.testing.assert_array_equal(out.numpy(), want)
    with pytest.raises(ValueError):
        ops.segsum_rows(torch.from_numpy(seg), torch.from_numpy(rows), 27,
                        out=torch.zeros((27, 11)))


def test_rows_plan_regimes():
    """K2's regime chooser: the IMDb root combine privatises in one-lane
    1,024-column tiles, many segments go direct, and the privatisation
    limit falls where the card's shared memory puts it."""
    from repro_torch.kernels.segsum import (H100, REGIMES, Card, RowsPlan,
                                            direct_plan,
                                            privatisation_limit, rows_plan)
    assert REGIMES == ("direct", "private")     # the C entry's codes
    assert rows_plan(2743, 11664, 27) == RowsPlan("private", 1024, 22)
    assert rows_plan(18518, 1728, 3).regime == "private"
    assert rows_plan(100_000, 108, 27) == RowsPlan("private", 128, 264)
    assert rows_plan(10 ** 7, 12, 10 ** 6).regime == "direct"
    assert rows_plan(262144, 64, 1024) == RowsPlan("direct", 16, 1056)
    # 200 KB of tables at 4 KB a segment (256 threads x one float4)
    limit = privatisation_limit(H100)
    assert limit == 200 * 1024 // 4096 == 50
    assert rows_plan(10 ** 6, 64, limit).regime == "private"
    assert rows_plan(10 ** 6, 64, limit + 1).regime == "direct"
    # fewer than 4 edges a segment do not pay for the tables' flush
    assert rows_plan(4 * 27, 64, 27).regime == "private"
    assert rows_plan(4 * 27 - 1, 64, 27).regime == "direct"
    # a card with 48 KB per block has room for 11 segments
    small = Card(sms=132, smem_block=48 * 1024, smem_sm=100 * 1024)
    assert privatisation_limit(small) == 11
    assert rows_plan(10 ** 6, 64, 12, small).regime == "direct"
    # tiles cover D in quads; the direct regime takes up to a warp a row
    assert [rows_plan(10 ** 5, d, 3).tile for d in (1, 4, 5, 12, 257)] \
        == [4, 4, 8, 16, 512]
    assert [direct_plan(10 ** 5, d).tile for d in (1, 3, 5, 12, 64, 257)] \
        == [1, 1, 2, 4, 16, 32]
    assert direct_plan(1, 11664) == RowsPlan("direct", 32, 1)
    assert direct_plan(10 ** 8, 1).blocks == 8 * H100.sms
    # the ops wrapper counts launches by regime, and reset_counts zeroes it
    ops.ROW_REGIMES["direct"] = 3
    ops.reset_counts()
    assert ops.ROW_REGIMES == {"direct": 0, "private": 0}


def test_segsum_empty_inputs():
    seg = torch.zeros(0, dtype=torch.int32)
    assert ops.segsum_ones(seg, torch.zeros(0), 4).tolist() == [0.0] * 4
    assert ops.segsum_rows(seg, torch.zeros(0, 3), 2).shape == (2, 3)


# --------------------------------------------------------------- K3 -------

@pytest.mark.parametrize("k", range(7))
@pytest.mark.parametrize("b,d", [(1, 1), (3, 5), (2, 130)])
def test_mobius_matches_jax(k, b, d):
    rng = np.random.default_rng(100 * k + 10 * b + d)
    x = rng.integers(0, 50, size=(b, 1 << k, d)).astype(np.float32)
    got = ops.mobius(torch.from_numpy(x)).numpy()
    for i in range(b):
        np.testing.assert_array_equal(
            got[i], np.asarray(jref.mobius_ref(jnp.asarray(x[i]))))
        np.testing.assert_array_equal(
            got[i], np.asarray(jops.mobius(jnp.asarray(x[i]),
                                           interpret=True)))
        np.testing.assert_array_equal(
            ref.mobius_ref(torch.from_numpy(x[i])).numpy(), got[i])


def test_mobius_large_counts_bit_exact_vs_reference_order():
    """Counts above 2^24 round: the plain transform must round exactly as
    the JAX package's pass order does."""
    rng = np.random.default_rng(3)
    x = rng.uniform(1e9, 1e11, size=(4, 8, 6)).astype(np.float32)
    got = ops.mobius(torch.from_numpy(x)).numpy()
    for i in range(4):
        want = np.asarray(jref.mobius_ref(jnp.asarray(x[i])))
        assert got[i].tobytes() == want.tobytes()


def test_mobius_matrix_matches_jax():
    from repro.kernels.mobius_kernel import mobius_matrix as jax_matrix
    for k in range(5):
        np.testing.assert_array_equal(mobius_matrix(k).numpy(),
                                      jax_matrix(k))


# --------------------------------------------------------------- K4 -------

@pytest.mark.parametrize("b,q,r", [(1, 1, 2), (3, 3, 4), (4, 27, 3),
                                   (2, 100, 3), (2, 600, 7), (1, 1024, 33)])
@pytest.mark.parametrize("ess", [1.0, 10.0])
def test_bdeu_matches_jax(b, q, r, ess):
    rng = np.random.default_rng(b * q * r)
    nijk = rng.integers(0, 30, size=(b, q, r)).astype(np.float32)
    nijk *= rng.random((b, q, r)) < 0.7             # zero cells, as in counts
    got = ops.bdeu(torch.from_numpy(nijk), ess).numpy()
    want = np.asarray(jax_bdeu_batch(jnp.asarray(nijk), ess=ess))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    for i in range(b):
        pl = float(jops.bdeu(jnp.asarray(nijk[i]), ess=ess, interpret=True))
        np.testing.assert_allclose(got[i], pl, rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(
            float(ref.bdeu_ref(torch.from_numpy(nijk[i]), ess, q, r)),
            float(jref.bdeu_ref(jnp.asarray(nijk[i]), ess, q, r)),
            rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(
        bdeu_score_batch(torch.from_numpy(nijk), ess).numpy(), got)


def _kernel_order(nijk: torch.Tensor, ess: float, chunk: int) -> torch.Tensor:
    """The sum as ``csrc/bdeu.cu`` orders it: rows in chunks of ``chunk``
    (a power of two), lane ``j % 256`` adding row ``j``'s total for the
    rows below q only, then the pairwise tree without the levels whose
    upper half holds only lanes that got no row."""
    from repro_torch.kernels import bdeu as kb
    b, q, r = nijk.shape
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    aj, ajk = f32(ess / q), f32(ess / (q * r))
    cell = kb.lgamma_f32(nijk + ajk) - kb.lgamma_f32(ajk)
    nij, terms = nijk[..., 0], cell[..., 0]
    for k in range(1, r):
        nij = nij + nijk[..., k]
        terms = terms + cell[..., k]
    per_j = (kb.lgamma_f32(aj) - kb.lgamma_f32(nij + aj)) + terms
    acc = torch.zeros(b, 256)
    for base in range(0, q, chunk):
        for j in range(base, min(base + chunk, q)):
            acc[:, j % 256] = acc[:, j % 256] + per_j[:, j]
    live, width = min(q, 256), 256
    while width > 1:            # a level over lanes past `live` is left out
        width //= 2
        acc = acc[:, :width] + acc[:, width:] if live > width else \
            acc[:, :width]
    return acc[:, 0]


@pytest.mark.parametrize("kind", ["zeros", "tiny", "large"])
@pytest.mark.parametrize("q,r", [(1, 3), (2, 1), (31, 2), (32, 3),
                                 (33, 8), (36, 3), (255, 2), (256, 3)])
def test_bdeu_rows_narrow_lanes(kind, q, r):
    """The proof the kernel's order leans on: leaving out the padding's
    additions of +0.0 changes no bit.  ``_bdeu_rows`` over any power of
    two of lanes at least q (where the dropped lanes hold only +0.0) gives
    the bits of its 256 lanes, and so does the kernel's chunked order,
    which adds only the rows below q, at every chunk size it can take.
    All-zero families, counts of a few, and counts above 2^20."""
    from repro_torch.kernels.bdeu import LANES, _bdeu_rows
    rng = np.random.default_rng(q * 100 + r)
    b = 3
    if kind == "zeros":
        nijk = np.zeros((b, q, r), np.float32)
    elif kind == "tiny":
        nijk = rng.integers(0, 3, size=(b, q, r)).astype(np.float32)
    else:
        nijk = rng.integers(2 ** 20, 2 ** 24, size=(b, q, r)).astype(
            np.float32)
        nijk *= rng.random((b, q, r)) < 0.8
    x = torch.from_numpy(nijk)
    for ess in (1.0, 10.0):
        want = _bdeu_rows(x, ess / q, ess / (q * r)).numpy()
        lanes = LANES
        while lanes >= q:
            got = _bdeu_rows(x, ess / q, ess / (q * r), lanes=lanes)
            assert got.numpy().tobytes() == want.tobytes(), (lanes, ess)
            lanes //= 2
        for chunk in (1, 2, 32, 256, 1024):
            got = _kernel_order(x, ess, chunk)
            assert got.numpy().tobytes() == want.tobytes(), (chunk, ess)


@pytest.mark.parametrize("q,r,chunk", [(257, 3, 256), (1000, 2, 1024),
                                       (600, 33, 128)])
def test_bdeu_chunked_order_past_one_block(q, r, chunk):
    """More rows than lanes: the kernel's chunks (256 rows, 1,024 rows, or
    fewer where r is wide) keep each lane's rows in the plain version's
    order, bit for bit."""
    from repro_torch.kernels.bdeu import bdeu_plain
    rng = np.random.default_rng(q + r)
    nijk = rng.integers(0, 40, size=(2, q, r)).astype(np.float32)
    nijk *= rng.random((2, q, r)) < 0.6
    x = torch.from_numpy(nijk)
    assert _kernel_order(x, 1.0, chunk).numpy().tobytes() == \
        bdeu_plain(x, 1.0).numpy().tobytes()


def test_bdeu_large_counts():
    nijk = np.array([[[3e9, 1e10], [0.0, 7.0]]], np.float32)
    got = ops.bdeu(torch.from_numpy(nijk), 1.0).numpy()
    want = np.asarray(jax_bdeu_batch(jnp.asarray(nijk), ess=1.0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


def test_bdeu_score_equivalent_tie_is_exact():
    """Reversing an edge between two parentless nodes changes the BDeu
    score by the same amount either way; the per-family scores are built
    from the same float32 terms, so both deltas must agree to the last
    representable digit the scores carry."""
    rng = np.random.default_rng(0)
    joint = rng.integers(0, 40, size=(3, 4)).astype(np.float32)   # a x b
    s = lambda t: float(bdeu_score_2d(torch.from_numpy(t), 1.0))
    d_ab = s(joint) - s(joint.sum(axis=0, keepdims=True))          # a -> b
    d_ba = s(joint.T.copy()) - s(joint.sum(axis=1, keepdims=True).T)
    assert abs(d_ab - d_ba) < 1e-3


def test_lgamma_f32_accuracy():
    import math
    x = np.concatenate([np.arange(0, 3000, dtype=np.float64) + a
                        for a in (1 / 6, 1 / 54, 1 / 3456, 1.0)]
                       + [np.array([1e6, 1e9, 1e12, 1e15])]).astype(np.float32)
    got = lgamma_f32(torch.from_numpy(x)).double().numpy()
    want = np.array([math.lgamma(float(v)) for v in x])
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() < 2e-6
