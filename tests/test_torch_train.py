"""The port's training pieces against the JAX package's, on the same numpy
inputs: the token pipeline (bit for bit), ``rms_norm``'s hand-written VJP
and the attention backward (float32 within 1e-5), AdamW and Adafactor
(float32 within 1e-6, bf16 within one bf16 ulp), the decay mask on every
parameter of the reduced models the port builds, and int8 compression
with error feedback (bit for bit).  The LM's loss, train step, checkpoints
and launcher are in ``tests/test_torch_train_lm.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models import layers as jlayers
from repro.models.attention import block_attention
from repro.models.model import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.kernels.attention import flash_attention_backward
from repro_torch.models import layers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim import adamw, compress

F32_GRAD = dict(rtol=1e-5, atol=1e-5)
F32_OPT = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


# ------------------------------------------------------------ pipeline ----

@pytest.mark.parametrize("seed,step,hosts,host", [
    (0, 0, 1, 0), (3, 11, 1, 0), (7, 123456, 2, 1), (1, 5, 4, 2)])
def test_synthetic_corpus_equals_jax(seed, step, hosts, host):
    kw = dict(vocab=97, seq_len=24, global_batch=8, seed=seed, hosts=hosts,
              host_id=host)
    got = pipeline.SyntheticCorpus(pipeline.DataConfig(**kw)).batch(step)
    want = jpipe.SyntheticCorpus(jpipe.DataConfig(**kw)).batch(step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_prefetcher_yields_steps_in_order():
    cfg = pipeline.DataConfig(vocab=64, seq_len=8, global_batch=4, seed=1)
    corpus = pipeline.SyntheticCorpus(cfg)
    pf = pipeline.Prefetcher(corpus, start_step=42)
    try:
        for want in range(42, 47):
            step, batch = next(pf)
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          corpus.batch(want)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_corpus_refuses_an_uneven_host_split():
    cfg = pipeline.DataConfig(vocab=16, seq_len=4, global_batch=6, hosts=4)
    with pytest.raises(ValueError, match="does not split"):
        pipeline.SyntheticCorpus(cfg).batch(0)


# ------------------------------------------------------------ rms_norm ----

def _naive_rms(x, w, eps=1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * w.float()).to(x.dtype)


def test_rms_norm_vjp_matches_jax_and_autograd():
    """``test_custom_rms_norm_grad_matches_autodiff``'s loss, float32:
    against the JAX custom VJP and against autograd of the naive
    expression, within 1e-5."""
    rng = np.random.default_rng(0)
    x_np = (rng.standard_normal((4, 16, 32)) * 3).astype(np.float32)
    w_np = (rng.standard_normal(32) * 0.5 + 1.0).astype(np.float32)
    want = jax.grad(lambda x, w: jnp.sum(jnp.sin(jlayers.rms_norm(x, w))),
                    (0, 1))(jnp.asarray(x_np), jnp.asarray(w_np))
    grads = []
    for fn in (layers.rms_norm, _naive_rms):
        x = torch.from_numpy(x_np).requires_grad_()
        w = torch.from_numpy(w_np).requires_grad_()
        grads.append(torch.autograd.grad(torch.sin(fn(x, w)).sum(), (x, w)))
    (dx, dw), (nx, nw) = grads
    for got, ref in ((dx, want[0]), (dw, want[1]), (dx, nx), (dw, nw)):
        np.testing.assert_allclose(_np(got), _np(ref), **F32_GRAD)


def test_rms_norm_vjp_dtypes():
    """bf16 input, float32 scale: ``dx`` in bf16, ``dscale`` in float32
    summed over every leading axis; against the JAX VJP within bf16's
    2^-7 relative (dx) and float32's 1e-5 (dscale: its float32 sum of the
    same bf16 inputs)."""
    rng = np.random.default_rng(1)
    x_np = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    w_np = (rng.standard_normal(16) * 0.5 + 1.0).astype(np.float32)
    g_np = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    xb = jnp.asarray(x_np, jnp.bfloat16)
    _, vjp = jax.vjp(lambda x, w: jlayers.rms_norm(x, w), xb,
                     jnp.asarray(w_np))
    jdx, jdw = vjp(jnp.asarray(g_np, jnp.bfloat16))
    x = torch.from_numpy(x_np).bfloat16().requires_grad_()
    w = torch.from_numpy(w_np).requires_grad_()
    y = layers.rms_norm(x, w)
    dx, dw = torch.autograd.grad(y, (x, w), torch.from_numpy(g_np).bfloat16())
    assert y.dtype == dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    np.testing.assert_allclose(_np(dx), _np(jdx.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(_np(dw), _np(jdw), **F32_GRAD)


# ----------------------------------------------------------- attention ----

def _qkv(seed, b, s, h, hk, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, hd)).astype(np.float32)
    dout = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    return q, k, v, dout


def _jax_attention_grads(q, k, v, dout, causal, chunk):
    out, vjp = jax.vjp(lambda q, k, v: block_attention(q, k, v, causal,
                                                       chunk), *map(
        jnp.asarray, (q, k, v)))
    return out, vjp(jnp.asarray(dout))


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("b,s,h,hk,hd", [
    (2, 40, 4, 2, 16),      # GQA
    (1, 37, 4, 4, 8),       # one query head per KV head
    (1, 600, 8, 1, 16),     # past one 512-row chunk, not a multiple of it
])
def test_attention_grads_match_jax_block_attention(b, s, h, hk, hd, causal):
    """``ops.flash_attention`` under autograd (its plain path here) against
    ``jax.vjp`` of ``block_attention``, float32, within 1e-5."""
    q, k, v, dout = _qkv(s, b, s, h, hk, hd)
    want_out, want = _jax_attention_grads(q, k, v, dout, causal, 64)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ops.reset_counts()
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    assert ops.PLAIN_CALLS["flash_attention"] == 1
    assert ops.BACKWARD_CALLS["flash_attention"] == 1
    np.testing.assert_allclose(_np(out), _np(want_out), **F32_GRAD)
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(_np(g), _np(w), **F32_GRAD, err_msg=name)


@pytest.mark.parametrize("chunk", (7, 16, 100))
def test_attention_backward_chunks_agree(chunk):
    """The backward's chunk of query rows changes nothing past float32
    rounding: chunks that do not divide S, and one chunk for all."""
    q, k, v, dout = map(torch.from_numpy, _qkv(5, 2, 45, 6, 3, 8))
    want = flash_attention_backward(q, k, v, dout, True, chunk=45)
    got = flash_attention_backward(q, k, v, dout, True, chunk=chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32_GRAD)


def test_attention_backward_bf16_keeps_dtypes():
    """bf16 inputs: the gradients come back in bf16, within bf16's 2^-7 of
    the float32 gradients of the same (upcast) inputs, relative to their
    largest magnitude."""
    q, k, v, dout = (torch.from_numpy(a).bfloat16()
                     for a in _qkv(9, 1, 70, 4, 2, 32))
    got = flash_attention_backward(q, k, v, dout, True)
    want = flash_attention_backward(q.float(), k.float(), v.float(),
                                    dout.float(), True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        err = float((g.float() - w).abs().max())
        assert err <= 2 ** -7 * float(w.abs().max()), err


# ---------------------------------------------------------- optimizers ----

def _reduced_params(arch, dtype="float32"):
    cfg = jconfigs.get_reduced(arch).replace(dtype=dtype, param_dtype=dtype)
    return jax_build_model(cfg).init(jax.random.PRNGKey(0))


def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * 1e-2, p.dtype),
        params)


def _port(tree, cfg):
    return params_from_jax(jax.tree.map(np.asarray, tree), cfg)


def _within_a_bf16_ulp(got, want, name):
    """Each element within one bf16 ulp of the JAX package's (``2^-7 |w|``
    bounds it), plus float32 rounding at the tensor's scale (``2^-20 max
    |w|``): where ``p - lr * upd`` or ``b1 m + (1 - b1) g`` cancels, one
    float32 ulp of the operands is several bf16 ulps of the result."""
    g, w = got.float(), want.float()
    bound = 2 ** -7 * w.abs() + 2 ** -20 * float(w.abs().max())
    assert bool(((g - w).abs() <= bound).all()), name


ARCH = "qwen2.5-3b"


@pytest.mark.parametrize("dtype,state_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_adamw_update_matches_jax(dtype, state_dtype):
    """Two AdamW steps on the reduced qwen2.5-3b's JAX weights and two sets
    of gradients (clipped: their norm is above ``clip_norm``), in the
    cosine part of the schedule.  float32: parameters and moments within
    1e-6; bf16: within one bf16 ulp of the JAX package's
    (:func:`_within_a_bf16_ulp`)."""
    cfg = configs.get_reduced(ARCH).replace(dtype=dtype, param_dtype=dtype)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10,
                state_dtype=state_dtype, clip_norm=0.5)
    jopt = jadamw.AdamW(jadamw.OptConfig(**ocfg))
    opt = adamw.AdamW(adamw.OptConfig(**ocfg))
    jparams = _reduced_params(ARCH, dtype)
    jstate = jopt.init(jparams)
    params = _port(jparams, cfg)
    state = opt.init(params)
    for seed in (1, 2):
        jgrads = _grads_like(jparams, seed)
        jparams, jstate, jm = jopt.update(jparams, jgrads, jstate)
        params, state, m = opt.update(params, _port(jgrads, cfg), state)
    assert int(state["step"]) == int(jstate["step"]) == 2
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    # a float32 sum of squares over every gradient, in another order
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    for got, want in ((params, jparams), (state["m"], jstate["m"]),
                      (state["v"], jstate["v"])):
        want = _port(want, cfg)
        assert set(got) == set(want)
        for name in got:
            g, w = got[name], want[name]
            assert g.dtype == w.dtype, name
            if g.dtype == torch.bfloat16:
                _within_a_bf16_ulp(g, w, name)
            else:
                np.testing.assert_allclose(_np(g), _np(w), **F32_OPT,
                                           err_msg=name)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_adafactor_update_matches_jax(dtype):
    """Two Adafactor steps, both packages on the port's layout (a dict of
    each layer's weights by name, from ``params_from_jax``): the JAX
    package's Adafactor factors a leaf by its shape, and its LM stacks the
    layers ``[L, ...]``, which makes a layer's norm a matrix.  float32
    within 1e-6, bf16 within one bf16 ulp (:func:`_within_a_bf16_ulp`)."""
    cfg = configs.get_reduced(ARCH).replace(dtype=dtype, param_dtype=dtype)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, kind="adafactor")
    params = _port(_reduced_params(ARCH, dtype), cfg)
    jparams = {n: jnp.asarray(_np(p)).astype(
        jnp.bfloat16 if p.dtype == torch.bfloat16 else jnp.float32)
        for n, p in params.items()}
    jopt = jadamw.make_optimizer(jadamw.OptConfig(**ocfg))
    opt = adamw.make_optimizer(adamw.OptConfig(**ocfg))
    assert isinstance(opt, adamw.Adafactor)
    jstate, state = jopt.init(jparams), opt.init(params)
    for seed in (3, 4):
        jgrads = _grads_like(jparams, seed)
        jparams, jstate, jm = jopt.update(jparams, jgrads, jstate)
        params, state, m = opt.update(
            params, {n: torch.from_numpy(np.array(g, np.float32)).to(
                params[n].dtype) for n, g in jgrads.items()}, state)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    for name, p in params.items():
        w = torch.from_numpy(np.array(jparams[name], np.float32))
        if p.dtype == torch.bfloat16:
            _within_a_bf16_ulp(p, w, name)
        else:
            np.testing.assert_allclose(_np(p), _np(w), **F32_OPT,
                                       err_msg=name)
        for key, f in state["f"][name].items():
            np.testing.assert_allclose(_np(f), _np(jstate["f"][name][key]),
                                       rtol=1e-6, atol=0, err_msg=name)


def test_optimizers_decrease_a_quadratic():
    """``tests/test_substrate.py``'s property on the port."""
    for kind in ("adamw", "adafactor"):
        opt = adamw.make_optimizer(adamw.OptConfig(
            lr=5e-2, warmup_steps=0, total_steps=100, kind=kind,
            weight_decay=0.0))
        gen = torch.Generator().manual_seed(0)
        params = {"w": torch.randn((8, 16), generator=gen),
                  "norm1": torch.ones(16),
                  "embed": torch.randn((32, 8), generator=gen).bfloat16()}

        def loss_of(p):
            return ((p["w"] ** 2).sum()
                    + ((p["embed"].float() - 1.0) ** 2).sum()
                    + ((p["norm1"] - 0.5) ** 2).sum())

        state = opt.init(params)
        l0 = float(loss_of(params))
        for _ in range(50):
            leaves = {n: p.detach().requires_grad_() for n, p in
                      params.items()}
            grads = dict(zip(leaves, torch.autograd.grad(
                loss_of(leaves), list(leaves.values()))))
            params, state, metrics = opt.update(params, grads, state)
        assert float(loss_of(params)) < 0.5 * l0
        assert np.isfinite(float(metrics["lr"]))


def test_adamw_state_dtype():
    opt = adamw.AdamW(adamw.OptConfig(state_dtype="bfloat16"))
    st = opt.init({"w": torch.zeros((2, 3))})
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.bfloat16
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-8b",
                                  "nemotron-4-340b", "mistral-nemo-12b"])
def test_decay_mask_matches_jax(arch):
    """Every parameter of the reduced model: the port's mask by name equals
    the JAX package's by key path (so ``embed`` and the QKV biases are
    decayed, the norms not)."""
    jparams = _reduced_params(arch)
    masks = jax.tree_util.tree_map_with_path(
        lambda path, p: np.full(p.shape, jadamw._decay_mask(path)), jparams)
    cfg = configs.get_reduced(arch)
    want = params_from_jax(masks, cfg)
    names = dict(build_model(cfg, device="cpu").named_parameters())
    assert set(want) == set(names)
    for name, m in want.items():
        assert bool(m.all()) == adamw._decay_mask(name) == bool(m.any()), name
    if cfg.qkv_bias:
        assert adamw._decay_mask("blocks.0.attn.bq")
    assert adamw._decay_mask("embed")
    assert not adamw._decay_mask("blocks.1.norm2")


# ------------------------------------------------------------ compress ----

def test_compress_equals_jax_bit_for_bit():
    """Twenty steps of int8 compression with error feedback on float32 and
    bf16 gradients: the dequantised gradients and the buffers equal the
    JAX package's bit for bit (round half to even in both), and the sent
    stream tracks the true one (``tests/test_substrate.py``'s bound)."""
    rng = np.random.default_rng(0)
    base = {"w": rng.normal(0, 1e-3, (64, 64)).astype(np.float32),
            "b": rng.normal(0, 1.0, (33,)).astype(np.float32)}
    jfn, fn = jcompress.make_compressor(), compress.make_compressor()
    jstate = {"ef": jcompress.init_error_feedback(
        {k: jnp.asarray(v) for k, v in base.items()})}
    state = {"ef": compress.init_error_feedback(
        {k: torch.from_numpy(v) for k, v in base.items()})}
    total_true = np.zeros((64, 64), np.float32)
    total_sent = np.zeros((64, 64), np.float32)
    for i in range(20):
        g = {k: v * (1 + 0.1 * i) for k, v in base.items()}
        jg, jstate = jfn({k: jnp.asarray(v) for k, v in g.items()}, jstate)
        tg, state = fn({k: torch.from_numpy(v) for k, v in g.items()}, state)
        for k in g:
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
            np.testing.assert_array_equal(state["ef"][k].numpy(),
                                          np.asarray(jstate["ef"][k]))
        total_true += g["w"]
        total_sent += tg["w"].numpy()
    assert np.abs(total_sent - total_true).max() < 0.05 * np.abs(
        total_true).max()
    bf = {"w": torch.from_numpy(base["w"]).bfloat16()}
    out, st = fn(bf, {})
    jout, jst = jfn({"w": jnp.asarray(base["w"], jnp.bfloat16)}, {})
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"].float().numpy(),
                                  np.asarray(jout["w"], np.float32))
    np.testing.assert_array_equal(st["ef"]["w"].numpy(),
                                  np.asarray(jst["ef"]["w"]))
    assert compress.compression_ratio_bits() == \
        jcompress.compression_ratio_bits()
