"""Whisper's encoder-decoder (``EncDecLM``) against the JAX package, on the
CPU.

The reduced ``whisper-base`` (2 encoder and 2 decoder layers, ``d_model``
64, 4 heads of 16, vocab 384), the JAX package's ``EncDecLM.init`` carried
across by ``params_from_jax``, inputs from one numpy seed each:

* ``sinusoidal_positions`` against the reference's within 1e-6 (absolute;
  the table lies in [-1, 1]).
* float32: ``encode``, ``forward``, ``loss``, ``prefill`` (its last logits
  and the cache's ``k``, ``v``, ``xk``, ``xv``) and ``decode_step`` each
  within 1e-4 of the largest magnitude of the reference's output
  (``F32_REL``); the ``loss`` gradients against ``jax.grad`` within 1e-4
  of each gradient's largest magnitude.  The prefill writes into a cache
  longer than the prompt, as the JAX side's is padded
  (``tests/test_arch_smoke.py:80``).
* Each of those at the reduced config's 64 encoder frames, and at 50,
  which no key tile of K6 divides (the ragged key end of the encoder's
  self-attention and of the cross-attention).
* bf16: ``forward`` within 5e-2 (``rtol`` and ``atol``, the bar of
  ``tests/test_torch_lm.py``) of the JAX model in bf16 and of the JAX
  model in float32 on the same weights.

The reference's model path runs ``block_attention`` (it masks no
non-causal key and never reaches the Pallas kernel), so the port's
attention is held to the JAX model itself.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models.model import build_model as jax_build_model
from repro_torch import configs
from repro_torch.models import layers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import EncDecLM, build_model

ARCH = "whisper-base"
F32_REL = 1e-4              # of the reference output's largest magnitude
GRAD_REL = 1e-4             # of each gradient's largest magnitude
BF16 = dict(rtol=5e-2, atol=5e-2)
SIN_ATOL = 1e-6
FRAMES = (64, 50)
B, S = 2, 12


@pytest.mark.parametrize("seq,d", [(64, 64), (50, 64), (1500, 512),
                                   (448, 512)])
def test_sinusoidal_positions_match_jax(seq, d):
    got = layers.sinusoidal_positions(seq, d)
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jlayers.sinusoidal_positions(seq, d)),
        rtol=0, atol=SIN_ATOL)


def _cfgs(dtype, frames):
    kw = dict(dtype=dtype, param_dtype=dtype, enc_frames=frames)
    return (jconfigs.get_reduced(ARCH).replace(**kw),
            configs.get_reduced(ARCH).replace(**kw))


@functools.lru_cache(maxsize=None)
def _pair(dtype, frames, trainable=False):
    jcfg, cfg = _cfgs(dtype, frames)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    lm = build_model(cfg, device="cpu", trainable=trainable)
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       cfg))
    return jm, params, lm


def _inputs(seed, frames, d, vocab):
    rng = np.random.default_rng(seed)
    fr = rng.standard_normal((B, frames, d)).astype(np.float32)
    toks = rng.integers(0, vocab, (B, S), dtype=np.int32)
    labels = rng.integers(0, vocab, (B, S), dtype=np.int32)
    return fr, toks, labels


def _np(x):
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


def _close(got, want, rel=F32_REL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _batches(fr, toks, dtype=jnp.float32, **extra):
    jb = dict(frames=jnp.asarray(fr, dtype), tokens=jnp.asarray(toks),
              **{k: jnp.asarray(v) for k, v in extra.items()})
    tb = dict(frames=torch.from_numpy(fr), tokens=torch.from_numpy(toks),
              **{k: torch.from_numpy(v) for k, v in extra.items()})
    return jb, tb


def test_build_model_returns_the_encoder_decoder():
    cfg = configs.get_config(ARCH)
    lm = build_model(cfg, device="meta")
    assert isinstance(lm, EncDecLM)
    assert (len(lm.enc), len(lm.dec)) == (cfg.enc_layers, cfg.n_layers)
    n = sum(p.numel() for p in lm.parameters())
    # the reference's count leaves out enc_norm and each decoder layer's
    # norm_x
    assert cfg.param_count() == 70_607_872
    assert n - cfg.param_count() == (cfg.n_layers + 1) * cfg.d_model


@pytest.mark.parametrize("frames", FRAMES)
def test_encode_and_forward_match_jax(frames):
    jm, params, lm = _pair("float32", frames)
    cfg = lm.cfg
    fr, toks, _ = _inputs(0, frames, cfg.d_model, cfg.vocab)
    jb, tb = _batches(fr, toks)
    _close(lm.encode(tb["frames"]), jax.jit(jm.encode)(params, jb["frames"]),
           what="encode")
    want, aux = jax.jit(jm.forward)(params, jb)
    got = lm.forward(tb)
    assert got.shape == (B, S, cfg.vocab) and float(aux) == 0.0
    _close(got, want, what="forward")


@pytest.mark.parametrize("frames", FRAMES)
def test_loss_and_gradients_match_jax(frames):
    jm, params, lm = _pair("float32", frames, trainable=True)
    cfg = lm.cfg
    fr, toks, labels = _inputs(1, frames, cfg.d_model, cfg.vocab)
    jb, tb = _batches(fr, toks, labels=labels)
    (want, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(params, jb)
    got, met = lm.loss(tb)
    assert abs(float(got.detach()) - float(want)) <= F32_REL * abs(float(want))
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    names, leaves = zip(*lm.named_parameters())
    grads = torch.autograd.grad(got, leaves)
    want_grads = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    assert set(names) == set(want_grads)
    for n, g in zip(names, grads):
        _close(g, want_grads[n], GRAD_REL, n)


def _jax_padded(cache, s):
    """The JAX prefill's cache with ``k``/``v`` padded to ``s`` positions
    (``xk``/``xv`` stay: the encoder's length)."""
    return {k: jnp.pad(v, [(0, 0), (0, 0), (0, s - v.shape[2]), (0, 0),
                           (0, 0)]) if k in ("k", "v") else v
            for k, v in cache.items()}


@pytest.mark.parametrize("frames", FRAMES)
def test_prefill_and_decode_match_jax(frames):
    """A prefill of the first 7 tokens into a cache of ``S``, then decode
    steps for the rest, each step's logits against the JAX model's on its
    padded cache."""
    jm, params, lm = _pair("float32", frames)
    cfg = lm.cfg
    fr, toks, _ = _inputs(2, frames, cfg.d_model, cfg.vocab)
    p = 7
    jb, tb = _batches(fr, toks[:, :p])
    want_last, want_cache = jax.jit(jm.prefill)(params, jb)
    cache = lm.init_cache(B, S)
    assert cache["xk"].shape == (cfg.n_layers, B, frames, cfg.n_kv_heads,
                                 cfg.hd)
    got_last, cache = lm.prefill(tb, cache)
    _close(got_last, want_last, what="prefill")
    for name in ("k", "v", "xk", "xv"):
        got = cache[name][:, :, :p] if name in ("k", "v") else cache[name]
        _close(got, want_cache[name], what=name)
    jcache = _jax_padded(want_cache, S)
    decode = jax.jit(jm.decode_step)
    for i in range(p, S):
        want, jcache = decode(params, jcache, dict(
            token=jnp.asarray(toks[:, i:i + 1]),
            pos=jnp.asarray(i, jnp.int32)))
        got, cache = lm.decode_step(cache, dict(
            token=torch.from_numpy(toks[:, i:i + 1]), pos=i))
        _close(got, want, what=f"decode at {i}")


def test_prefill_without_a_cache_returns_the_prompts_length():
    jm, params, lm = _pair("float32", 50)
    cfg = lm.cfg
    fr, toks, _ = _inputs(3, 50, cfg.d_model, cfg.vocab)
    jb, tb = _batches(fr, toks)
    want_last, want_cache = jax.jit(jm.prefill)(params, jb)
    got_last, cache = lm.prefill(tb)
    _close(got_last, want_last, what="prefill")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in want_cache.items()}
    with pytest.raises(ValueError, match="does not hold"):
        lm.prefill(tb, lm.init_cache(B, S - 1))


@pytest.mark.parametrize("frames", FRAMES)
def test_bf16_forward_tracks_jax(frames):
    """The bf16 port against the JAX model in bf16 and in float32 on the
    same (bf16) weights, within 5e-2.  Prints the readings (``pytest
    -s``)."""
    jm, params, lm = _pair("bfloat16", frames)
    jcfg32, _ = _cfgs("float32", frames)
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    cfg = lm.cfg
    fr, toks, _ = _inputs(4, frames, cfg.d_model, cfg.vocab)
    fr = np.array(jnp.asarray(fr, jnp.bfloat16).astype(jnp.float32))
    jb, tb = _batches(fr, toks, jnp.bfloat16)
    jb32, _ = _batches(fr, toks)
    jax16 = _np(jax.jit(jm.forward)(params, jb)[0])
    truth = _np(jax.jit(jax_build_model(jcfg32).forward)(params32, jb32)[0])
    port = _np(lm.forward(tb))
    print(f"frames {frames}: max abs error against float32: port "
          f"{np.abs(port - truth).max():.4f}, JAX bf16 "
          f"{np.abs(jax16 - truth).max():.4f}; port against JAX bf16 "
          f"{np.abs(port - jax16).max():.4f}")
    np.testing.assert_allclose(port, jax16, **BF16)
    np.testing.assert_allclose(port, truth, **BF16)

