"""The port's attention kernels (plain path, as on the CPU) and the model's
attention functions against the JAX package.

K6 (flash attention) is held to the JAX package's kernel tolerance,
``rtol=atol=2e-5``, against its Pallas kernel in interpret mode and against
``block_attention`` with grouped KV heads.  Where the JAX kernel is wrong
(non-causal, ``Skv`` not a multiple of its key block: it zeroes its padded
keys and lets them into the softmax's normaliser), the port matches the
JAX package's oracle instead, and the test pins the JAX kernel's
divergence.  K5 (segment histogram) is held to ``tests/test_kernels.py``'s
tolerances.
"""

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.kernels.attention import (SLICE_HD, flash_attention_plain,
                                          head_slices)
from repro_torch.models import attention as tattn
from repro_torch.train.sharding import Mesh


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ------------------------------------------------------------------ K6 ----

@pytest.mark.parametrize("b,s,h,hd,causal,bq,bk", [
    (2, 64, 3, 16, True, 16, 16),
    (1, 128, 2, 32, True, 32, 64),
    (2, 48, 2, 8, False, 16, 16),
    (1, 100, 1, 20, True, 32, 32),        # non-divisible seq -> padding
])
def test_flash_attention_matches_jax_kernel(b, s, h, hd, causal, bq, bk):
    q, k, v = _normal(s * h + hd, *[(b, s, h, hd)] * 3)
    got = ops.flash_attention(*_t(q, k, v), causal=causal).numpy()
    want = jops.flash_attention(*_j(q, k, v), causal=causal, block_q=bq,
                                block_k=bk, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got, np.asarray(jref.flash_attention_ref(*_j(q, k, v), causal)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,sq,skv,h,hk,hd,causal", [
    (2, 64, 64, 4, 2, 16, True),          # the reduced model's heads
    (1, 96, 96, 16, 2, 32, True),         # Qwen2.5-3B's grouping, 8 per KV
    (2, 40, 72, 6, 3, 8, False),
    (1, 33, 33, 4, 1, 24, True),
])
def test_flash_attention_grouped_matches_block_attention(b, sq, skv, h, hk,
                                                         hd, causal):
    q, k, v = _normal(sq + skv + h, (b, sq, h, hd), (b, skv, hk, hd),
                      (b, skv, hk, hd))
    got = ops.flash_attention(*_t(q, k, v), causal=causal).numpy()
    want = jattn.block_attention(*_j(q, k, v), causal=causal, chunk=16)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    # the same heads repeated for the JAX kernel, which takes H == Hkv
    kr, vr = (np.repeat(a, h // hk, axis=2) for a in (k, v))
    if sq == skv:
        want_pl = jops.flash_attention(*_j(q, kr, vr), causal=causal,
                                       block_q=16, block_k=16,
                                       interpret=True)
        np.testing.assert_allclose(got, np.asarray(want_pl), rtol=2e-5,
                                   atol=2e-5)


def test_flash_attention_noncausal_ragged_keys_match_oracle():
    """Non-causal, ``S`` not a multiple of the key block: the port matches
    ``ref.flash_attention_ref``; the JAX Pallas kernel does not (ROADMAP C:
    its zeroed padded keys enter the normaliser)."""
    q, k, v = _normal(50, *[(1, 50, 2, 8)] * 3)
    got = ops.flash_attention(*_t(q, k, v), causal=False).numpy()
    oracle = np.asarray(jref.flash_attention_ref(*_j(q, k, v), False))
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)
    jax_kernel = np.asarray(jops.flash_attention(
        *_j(q, k, v), causal=False, block_q=16, block_k=16, interpret=True))
    assert np.abs(jax_kernel - oracle).max() > 1e-2
    # with S a multiple of the block, or causal, the JAX kernel agrees
    q48, k48, v48 = (a[:, :48] for a in (q, k, v))
    np.testing.assert_allclose(
        np.asarray(jops.flash_attention(*_j(q48, k48, v48), causal=False,
                                        block_q=16, block_k=16,
                                        interpret=True)),
        ops.flash_attention(*_t(q48, k48, v48), causal=False).numpy(),
        rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16_rounds_probabilities_to_v_dtype():
    """bf16 inputs: float32 softmax, probabilities rounded to bf16 before
    the product with v, the output in bf16; within bf16 rounding of the
    float32 oracle."""
    q, k, v = _normal(7, (2, 70, 4, 16), (2, 70, 2, 16), (2, 70, 2, 16))
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = ops.flash_attention(qb, kb, vb, causal=True)
    assert got.dtype == torch.bfloat16
    want = flash_attention_plain(qb.float(), kb.float(), vb.float(), True)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=2 ** -7, atol=2 ** -7)
    # chunks of query rows change nothing beyond bf16 rounding
    np.testing.assert_allclose(
        flash_attention_plain(qb, kb, vb, True, chunk=7).float().numpy(),
        got.float().numpy(), rtol=2 ** -7, atol=2 ** -7)


# The card's edge shapes (chip_smoke.py's phase 7: lengths either side of
# the kernels' 64- and 128-row tiles, Sq != Skv), cut to B <= 2, H <= 4 and
# S <= 300, at hd 128; the plain version, which is the card's oracle,
# against the JAX package's oracle with the KV heads repeated for it.
_EDGE_SHAPES = ([(s, s, c) for s in (1, 64, 127, 128, 129, 300)
                 for c in (True, False)] + [(200, 300, False)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hk", [(1, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("sq,skv,causal", _EDGE_SHAPES)
def test_flash_attention_edge_shapes_match_jax_oracle(sq, skv, causal, b, hk,
                                                      dtype):
    h, hd = 4, 128
    q, k, v = _normal(sq + skv + hk, (b, sq, h, hd), (b, skv, hk, hd),
                      (b, skv, hk, hd))
    qt, kt, vt = _t(q, k, v)
    if dtype == "bfloat16":    # the oracle sees the same rounded inputs
        qt, kt, vt = (x.bfloat16() for x in (qt, kt, vt))
        q, k, v = (x.float().numpy() for x in (qt, kt, vt))
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    kr, vr = (np.repeat(a, h // hk, axis=2) for a in (k, v))
    want = np.asarray(jref.flash_attention_ref(*_j(q, kr, vr), causal))
    tol = 2e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


# Head dims above 128 (chip_smoke.py's phase 7 at hd 160, 192, 256): the
# CUDA-core kernel at 160, mma.sync at Nemotron-4-340B's 192 and at 256, the
# widest that the TPU kernel's padding to a multiple of 128 reaches; the
# JAX kernel pads hd 160 and 192 to 256.  S is a multiple of the JAX
# kernel's key block, where it is right when not causal.
@pytest.mark.parametrize("hd", [160, 192, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hk", [(4, 4), (6, 2)])
def test_flash_attention_wide_heads_match_jax(hd, causal, h, hk):
    b, s = 2, 48
    q, k, v = _normal(hd + h + causal, (b, s, h, hd), (b, s, hk, hd),
                      (b, s, hk, hd))
    got = ops.flash_attention(*_t(q, k, v), causal=causal)
    assert got.shape == (b, s, h, hd)
    kr, vr = (np.repeat(a, h // hk, axis=2) for a in (k, v))
    want = jops.flash_attention(*_j(q, kr, vr), causal=causal, block_q=16,
                                block_k=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.flash_attention_ref(*_j(q, kr, vr),
                                                         causal)),
        rtol=2e-5, atol=2e-5)


# Head dims above 512, the sliced route's: 576 (padded to 640 by the JAX
# kernel) and 1,024, at small S.  The card's sliced kernel streams the head
# dim; its plain version is the one the card is held to.
@pytest.mark.parametrize("hd", [576, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_sliced_head_dims_match_jax(hd, causal):
    b, s, h, hk = 1, 32, 2, 1
    q, k, v = _normal(hd + causal, (b, s, h, hd), (b, s, hk, hd),
                      (b, s, hk, hd))
    got = ops.flash_attention(*_t(q, k, v), causal=causal)
    assert got.shape == (b, s, h, hd)
    kr, vr = (np.repeat(a, h // hk, axis=2) for a in (k, v))
    want = jops.flash_attention(*_j(q, kr, vr), causal=causal, block_q=16,
                                block_k=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("hd,want", [
    (513, [(0, 288), (288, 225)]),
    (576, [(0, 288), (288, 288)]),
    (640, [(0, 320), (320, 320)]),
    (1024, [(0, 512), (512, 512)]),
    (1025, [(0, 352), (352, 352), (704, 321)]),
])
def test_head_slices_cover_the_head_dim(hd, want):
    slices = head_slices(hd)
    assert slices == want
    assert sum(w for _, w in slices) == hd
    assert all(w <= SLICE_HD and (w % 32 == 0 or c0 + w == hd)
               for c0, w in slices)
    assert all(c0 == sum(w for _, w in slices[:i])
               for i, (c0, _) in enumerate(slices))


def test_flash_attention_checks_shapes():
    q = torch.zeros(1, 8, 6, 16)
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 8, 4, 16),
                            torch.zeros(1, 8, 4, 16))     # 4 does not divide 6
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 8, 3, 8),
                            torch.zeros(1, 8, 3, 8))      # hd differs
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 8, 3, 16),
                            torch.zeros(1, 9, 3, 16))     # k and v differ


# ------------------------------------------------- model attention --------

def test_decode_partial_and_combine_match_jax():
    q, k, v = _normal(3, (3, 8, 16), (3, 20, 2, 16), (3, 20, 2, 16))
    valid = np.arange(20)[None, :] <= np.array([[4], [19], [0]])
    valid[2] = False                                  # a fully masked shard
    got = tattn.decode_partial(*_t(q, k, v), torch.from_numpy(valid))
    want = jattn.decode_partial(*_j(q, k, v), jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(
        tattn.combine_partials(got).numpy(),
        np.asarray(jattn.combine_partials(want, None)), rtol=1e-5, atol=1e-6)
    # over a mesh axis: one shard (a group of one) is the total; more
    # shards run in tests/test_torch_train_mesh.py's decode
    one = Mesh({"data": 1, "model": 1}, groups={"data": None, "model": None})
    np.testing.assert_allclose(
        tattn.combine_partials(got, "model", one).numpy(),
        np.asarray(jattn.combine_partials(want, None)), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="no mesh"):
        tattn.combine_partials(got, "model")


# ------------------------------------------------------------------ K5 ----

@pytest.mark.parametrize("n,d,p", [(10, 3, 4), (513, 16, 7), (1000, 129, 300),
                                   (2048, 256, 256)])
def test_segment_hist_matches_jax(n, d, p):
    rng = np.random.default_rng(n + d + p)
    codes = rng.integers(0, p, size=n, dtype=np.int32)
    vals = rng.uniform(0, 2, size=(n, d)).astype(np.float32)
    got = ops.segment_hist(*_t(codes, vals), p).numpy()
    want = jref.segment_hist_ref(*_j(codes, vals), p)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-3)
    want_pl = jops.segment_hist(*_j(codes, vals), p, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_pl), rtol=1e-5,
                               atol=1e-3)


def test_segment_hist_drops_out_of_range_codes():
    codes = np.array([0, -1, 2, -1, 3, 7], np.int32)
    vals = np.ones((6, 5), np.float32)
    got = ops.segment_hist(*_t(codes, vals), 3).numpy()
    want = np.zeros((3, 5), np.float32)
    want[0] = want[2] = 1.0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jops.segment_hist(*_j(codes, vals), 3,
                                          interpret=True)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_segment_hist_random_shapes(seed):
    rng = np.random.default_rng(seed)
    n, d, p = (int(rng.integers(1, 700)), int(rng.integers(1, 40)),
               int(rng.integers(1, 50)))
    codes = rng.integers(0, p, size=n, dtype=np.int32)
    vals = rng.uniform(-1, 1, size=(n, d)).astype(np.float32)
    np.testing.assert_allclose(
        ops.segment_hist(*_t(codes, vals), p).numpy(),
        np.asarray(jref.segment_hist_ref(*_j(codes, vals), p)),
        rtol=1e-4, atol=1e-3)


def test_new_wrappers_count_plain_calls_on_the_host():
    ops.reset_counts()
    ops.segment_hist(torch.zeros(3, dtype=torch.int32), torch.ones(3, 2), 2)
    x = torch.zeros(1, 4, 2, 8)
    ops.flash_attention(x, x, x)
    assert ops.PLAIN_CALLS["segment_hist"] == 1
    assert ops.PLAIN_CALLS["flash_attention"] == 1
    assert ops.LAUNCHES["segment_hist"] == ops.LAUNCHES["flash_attention"] == 0
