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

@pytest.mark.parametrize("n,p", [(1, 1), (37, 5), (513, 300), (2000, 64)])
def test_segsum_ones_matches_jax(n, p):
    rng, seg = _seg_inputs(n + p, n, p)
    w = rng.integers(0, 4, size=n).astype(np.float32)
    got = ops.segsum_ones(torch.from_numpy(seg), torch.from_numpy(w), p)
    want_ref = jref.ones_segment_sum_ref(jnp.asarray(seg), jnp.asarray(w), p)
    want_pl = jops.ones_segment_sum(jnp.asarray(seg), jnp.asarray(w), p,
                                    interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pl))
    np.testing.assert_array_equal(
        ref.ones_segment_sum_ref(torch.from_numpy(seg), torch.from_numpy(w),
                                 p).numpy(), got.numpy())


@pytest.mark.parametrize("n,d,p", [(1, 1, 1), (40, 3, 7), (600, 17, 129),
                                   (1500, 40, 33)])
def test_segsum_rows_matches_jax(n, d, p):
    rng, seg = _seg_inputs(n * d + p, n, p)
    rows = rng.integers(0, 9, size=(n, d)).astype(np.float32)
    got = ops.segsum_rows(torch.from_numpy(seg), torch.from_numpy(rows), p)
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


def test_segsum_rows_accumulates_into_out():
    """The root combine's chunks all add into one table: equal to the sum
    of the JAX package's per-chunk segment sums."""
    rng, seg = _seg_inputs(5, 900, 27)
    rows = rng.integers(0, 9, size=(900, 12)).astype(np.float32)
    out = torch.zeros((27, 12))
    want = np.zeros((27, 12), np.float32)
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
