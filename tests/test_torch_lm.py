"""The port's LM serving path against the JAX package's ``LM``.

The reduced ``qwen2.5-3b`` (2 layers, ``d_model`` 64, ``get_reduced``) is
initialised by the JAX package (``LM.init(PRNGKey(0))``) and carried across
with ``params_from_jax``; the same numpy tokens go through both.

* float32: ``forward`` logits, ``prefill``'s last logits and K/V caches,
  ``decode_step`` on the padded cache, and a 24-step greedy loop as in
  ``examples/serve_batched.py`` agree to ``rtol=atol=1e-4``, with equal
  tokens.
* bfloat16: the port against the JAX package within 5e-2, the JAX arch
  test's decode tolerance.  Its 2e-2 does not hold across the two
  frameworks: they round bf16 products and sums in different places, and
  the port's full-sequence attention is the flash kernel's function
  (unnormalised probabilities rounded to bf16), where the JAX LM lowers
  ``block_attention`` (normalised probabilities rounded).  So on six token
  seeds both bf16 models are also held against the JAX LM run in float32
  on the same weights: the port within 5e-2 of it, and its mean abs error
  within 1.12 times the JAX LM's own (0.98-1.09 times on this tree; an
  RMSNorm computed in bf16 gives 1.13-1.42), so a fault of the bf16 path
  fails where a difference in where bf16 rounds does not.  Within the
  port, the JAX arch test's property holds at its own tolerances:
  prefill's last logits equal ``forward``'s within 2e-2, and
  ``decode_step``'s within 5e-2.
"""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models.model import build_model as jax_build_model
from repro_torch import configs
from repro_torch.models import layers, mlp
from repro_torch.models.attention import AttnParams, attn_init
from repro_torch.models.config import SHAPES, ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.mlp import mlp_init
from repro_torch.models.model import LM, EncDecLM, build_model
from repro_torch.models.transformer import Block, block_init

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2.5-3b"
F32 = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    """(JAX model, its params, port model) for the reduced config."""
    jcfg = jconfigs.get_reduced(ARCH).replace(dtype=dtype,
                                               param_dtype=dtype)
    cfg = configs.get_reduced(ARCH).replace(dtype=dtype, param_dtype=dtype)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    lm = build_model(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       cfg))
    return jm, params, lm


# A reduced Nemotron-4-340B at its head size, 192 (the published config's
# 18,432 / 96): K6's mma.sync route on the card, and its squared-ReLU MLP
# and KV grouping, here in float32 against the JAX LM.
NEMOTRON = "nemotron-4-340b"
NEMOTRON_HD192 = dict(n_layers=2, d_model=96, n_heads=4, n_kv_heads=2,
                      head_dim=192, dtype="float32", param_dtype="float32")


@functools.lru_cache(maxsize=None)
def _nemotron_pair():
    """(JAX model, its params, port model) for the reduced hd-192
    Nemotron in float32."""
    jcfg = jconfigs.get_reduced(NEMOTRON).replace(**NEMOTRON_HD192)
    cfg = configs.get_reduced(NEMOTRON).replace(**NEMOTRON_HD192)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    lm = build_model(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       cfg))
    return jm, params, lm


@functools.lru_cache(maxsize=None)
def _jax_float32_of_bf16():
    """The JAX LM in float32 on the bf16 pair's weights, upcast exactly."""
    _, params, _ = _pair("bfloat16")
    jcfg = jconfigs.get_reduced(ARCH).replace(dtype="float32",
                                               param_dtype="float32")
    return jax_build_model(jcfg), jax.tree.map(
        lambda a: a.astype(jnp.float32), params)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _np(x):
    return (x.float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# ---------------------------------------------------------- configs ------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_config_and_param_count_match_jax(arch):
    ours, theirs = configs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.param_count() == theirs.param_count()
    assert ours.param_count(active_only=True) == \
        theirs.param_count(active_only=True)
    red = configs.get_reduced(arch)
    assert dataclasses.asdict(red) == \
        dataclasses.asdict(jconfigs.get_reduced(arch))
    assert red.act_dtype() == torch.bfloat16 == red.p_dtype()


def test_qwen_full_size_and_registry():
    cfg = configs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab) == (36, 2048, 16, 2, 128, 11008, 151936)
    assert round(cfg.param_count() / 1e9, 2) == 3.09
    assert SHAPES["prefill_32k"].seq_len == 32768
    tiny = cfg.replace(name="tiny", n_layers=1)
    configs.register_config("tiny-test", tiny, tiny.replace(d_model=32))
    assert configs.get_config("tiny-test") is tiny
    assert configs.get_reduced("tiny-test").d_model == 32
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_build_model_refuses_what_is_not_ported(arch):
    """``build_model`` builds every reduced arch on the host, with its
    model kind (the encoder-decoder for Whisper) and finite weights; what
    it refuses is a block kind the port has no module for."""
    cfg = configs.get_reduced(arch)
    lm = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert isinstance(lm, EncDecLM) == cfg.enc_dec
    assert all(torch.isfinite(p.float()).all() for p in lm.parameters())
    with pytest.raises(NotImplementedError, match="block 'conv'"):
        build_model(cfg.replace(block="conv"), device="cpu")


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_build_model_builds_the_subquadratic_blocks(arch):
    """The reduced RWKV-6 and Hymba build on the host and serve: finite
    ``forward`` logits, and a prefill and a decode step into a cache
    (``tests/test_torch_subquadratic.py`` holds them to the JAX LM)."""
    cfg = configs.get_reduced(arch)
    lm = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    blk = lm.blocks[0]
    assert hasattr(blk, "rwkv") != hasattr(blk, "attn")
    assert hasattr(blk, "ssm") == (cfg.block == "hymba")
    toks = torch.from_numpy(_tokens(0, 2, 9, cfg.vocab))
    logits = lm.forward({"tokens": toks})
    assert logits.shape == (2, 9, cfg.vocab)
    assert torch.isfinite(logits).all()
    cache = lm.init_cache(2, 9)
    assert ("k" in cache) == (cfg.block == "hymba")
    last, cache = lm.prefill({"tokens": toks[:, :8]}, cache)
    step, _ = lm.decode_step(cache, {"token": toks[:, 8:], "pos": 8})
    assert torch.isfinite(last).all() and torch.isfinite(step).all()


def test_build_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_model(configs.get_reduced(ARCH))


# ----------------------------------------------------------- layers ------

def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.tile(np.array([0, 1, 7, 4095, 32767], np.int32), (2, 1))
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), F32)
    h = rng.standard_normal((3, 7, 64)).astype(np.float32) * 3
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    for dt in (np.float32, jnp.bfloat16):
        got = layers.rms_norm(torch.from_numpy(h).to(
            torch.float32 if dt is np.float32 else torch.bfloat16),
            torch.from_numpy(scale))
        want = jlayers.rms_norm(jnp.asarray(h).astype(dt), jnp.asarray(scale))
        _close(got, want, F32 if dt is np.float32 else dict(rtol=2 ** -8,
                                                             atol=2 ** -8))
    table = rng.standard_normal((50, 64)).astype(np.float32)
    _close(layers.tied_logits(torch.from_numpy(table), torch.from_numpy(h)),
           jlayers.tied_logits(jnp.asarray(table), jnp.asarray(h)), F32)
    ids = rng.integers(0, 50, (3, 4))
    np.testing.assert_array_equal(
        layers.embed_lookup(torch.from_numpy(table),
                            torch.from_numpy(ids)).numpy(),
        np.asarray(jlayers.embed_lookup(jnp.asarray(table),
                                        jnp.asarray(ids))))


@pytest.mark.parametrize("kind", ["swiglu", "sq_relu", "gelu"])
def test_mlp_matches_jax(kind):
    cfg = configs.get_reduced(ARCH).replace(mlp=kind, dtype="float32",
                                            param_dtype="float32")
    jp = jmlp.mlp_init(jax.random.PRNGKey(1), jconfigs.get_reduced(ARCH)
                       .replace(mlp=kind, param_dtype="float32"))
    p = mlp.MlpParams(cfg, torch.device("cpu"))
    for name in ("wi", "wo", "wg"):
        w = getattr(jp, name)
        if w is None:
            assert getattr(p, name) is None
        else:
            getattr(p, name).copy_(torch.from_numpy(np.array(w)))
    x = np.random.default_rng(2).standard_normal((2, 3, 64)).astype(
        np.float32)
    _close(mlp.mlp_apply(p, torch.from_numpy(x), kind),
           jmlp.mlp_apply(jp, jnp.asarray(x), kind), F32)


def test_init_draws_from_the_generator():
    cfg = configs.get_reduced(ARCH)
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    c = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    for (name, x), y, z in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
        assert name.endswith(("norm1", "norm2", "final_norm", "bq", "bk",
                              "bv")) or not torch.equal(x, z), name
    assert a.blocks[0].attn.bq.abs().sum() == 0
    # the functional inits draw the same weights as the modules' init_
    blk = block_init(torch.Generator().manual_seed(3), cfg)
    same = Block(cfg, torch.device("cpu")).init_(
        torch.Generator().manual_seed(3))
    for x, y in zip(blk.state_dict().values(), same.state_dict().values()):
        assert torch.equal(x, y)
    assert torch.equal(attn_init(torch.Generator().manual_seed(4), cfg).wq,
                       AttnParams(cfg, torch.device("cpu")).init_(
                           torch.Generator().manual_seed(4)).wq)
    assert torch.equal(mlp_init(torch.Generator().manual_seed(5), cfg).wg,
                       mlp.MlpParams(cfg, torch.device("cpu")).init_(
                           torch.Generator().manual_seed(5)).wg)
    assert a.final_norm.tolist() == [1.0] * cfg.d_model
    w = a.blocks[1].mlp.wo.float()
    assert abs(float(w.std()) - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5


def test_params_from_jax_fills_every_weight():
    jm, params, lm = _pair("float32")
    state = params_from_jax(jax.tree.map(np.asarray, params), lm.cfg)
    assert state.keys() == lm.state_dict().keys()
    assert state["blocks.1.attn.wq"].shape == (64, 64)   # [d_in, d_out]
    np.testing.assert_array_equal(state["blocks.1.mlp.wg"].numpy(),
                                  np.asarray(params["blocks"]["mlp"].wg[1]))


def test_nemotron_hd192_params_from_jax_fills_every_weight():
    _, params, lm = _nemotron_pair()
    cfg = lm.cfg
    assert (cfg.hd, cfg.mlp, cfg.n_heads // cfg.n_kv_heads) == (192,
                                                                "sq_relu", 2)
    state = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    assert state.keys() == lm.state_dict().keys()
    assert "blocks.0.mlp.wg" not in state                 # no SwiGLU gate
    assert state["blocks.1.attn.wq"].shape == (96, 4 * 192)
    assert state["blocks.1.attn.wk"].shape == (96, 2 * 192)
    for name, got in lm.state_dict().items():
        assert torch.equal(got, state[name]), name
    np.testing.assert_array_equal(state["blocks.1.attn.wo"].numpy(),
                                  np.asarray(params["blocks"]["attn"].wo[1]))


# ------------------------------------------------------- the LM ---------

def _jax_padded(cache, s):
    return {k: jnp.pad(v, [(0, 0), (0, 0), (0, s - v.shape[2]), (0, 0),
                           (0, 0)]) for k, v in cache.items()}


@pytest.mark.parametrize("dtype,tol", [("float32", F32),
                                       ("bfloat16", dict(rtol=5e-2,
                                                         atol=5e-2))])
def test_forward_prefill_decode_match_jax(dtype, tol):
    jm, params, lm = _pair(dtype)
    b, s = 2, 16
    toks = _tokens(0, b, s, lm.cfg.vocab)
    want_all, _ = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    got_all = lm.forward({"tokens": torch.from_numpy(toks)})
    assert got_all.dtype == torch.float32 and got_all.shape == (b, s, 384)
    _close(got_all, want_all, tol)

    want_last, want_cache = jax.jit(jm.prefill)(
        params, {"tokens": jnp.asarray(toks[:, :s - 1])})
    got_last, got_cache = lm.prefill({"tokens": torch.from_numpy(
        toks[:, :s - 1])})
    _close(got_last, want_last, tol)
    for name in ("k", "v"):
        assert got_cache[name].shape == want_cache[name].shape
        _close(got_cache[name], want_cache[name], tol)

    cache = lm.init_cache(b, s)
    lm.prefill({"tokens": torch.from_numpy(toks[:, :s - 1])}, cache)
    got1, _ = lm.decode_step(cache, {"token": torch.from_numpy(
        toks[:, s - 1:]), "pos": s - 1})
    want1, _ = jax.jit(jm.decode_step)(
        params, _jax_padded(want_cache, s),
        {"token": jnp.asarray(toks[:, s - 1:]),
         "pos": jnp.asarray(s - 1, jnp.int32)})
    _close(got1, want1, tol)


def test_nemotron_hd192_forward_prefill_decode_match_jax():
    """The reduced hd-192 Nemotron in float32: ``forward``, ``prefill``'s
    last logits and K/V caches and ``decode_step`` against the JAX LM at
    1e-4."""
    jm, params, lm = _nemotron_pair()
    b, s = 2, 16
    toks = _tokens(3, b, s, lm.cfg.vocab)
    want_all, _ = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    got_all = lm.forward({"tokens": torch.from_numpy(toks)})
    assert got_all.shape == (b, s, lm.cfg.vocab)
    _close(got_all, want_all, F32)
    want_last, want_cache = jax.jit(jm.prefill)(
        params, {"tokens": jnp.asarray(toks[:, :s - 1])})
    cache = lm.init_cache(b, s)
    got_last, _ = lm.prefill({"tokens": torch.from_numpy(toks[:, :s - 1])},
                             cache)
    _close(got_last, want_last, F32)
    for name in ("k", "v"):
        assert cache[name].shape[-1] == 192
        _close(cache[name][:, :, :s - 1], want_cache[name], F32)
    got1, _ = lm.decode_step(cache, {"token": torch.from_numpy(
        toks[:, s - 1:]), "pos": s - 1})
    want1, _ = jax.jit(jm.decode_step)(
        params, _jax_padded(want_cache, s),
        {"token": jnp.asarray(toks[:, s - 1:]),
         "pos": jnp.asarray(s - 1, jnp.int32)})
    _close(got1, want1, F32)


@pytest.mark.parametrize("seed", range(6))
def test_bf16_port_tracks_float32_jax(seed):
    """``forward`` and ``prefill``'s last logits of the bf16 port and of
    the bf16 JAX LM against the JAX LM in float32 on the same weights.
    Prints the readings (``pytest -s``)."""
    jm, params, lm = _pair("bfloat16")
    jm32, params32 = _jax_float32_of_bf16()
    b, s = 2, 16
    toks = _tokens(seed, b, s, lm.cfg.vocab)
    batch, head = {"tokens": jnp.asarray(toks)}, {"tokens": jnp.asarray(
        toks[:, :s - 1])}
    truth = _np(jax.jit(jm32.forward)(params32, batch)[0])
    truth_last = _np(jax.jit(jm32.prefill)(params32, head)[0])
    jax_bf16 = _np(jax.jit(jm.forward)(params, batch)[0])
    port = _np(lm.forward({"tokens": torch.from_numpy(toks)}))
    port_last = _np(lm.prefill({"tokens": torch.from_numpy(
        toks[:, :s - 1])})[0])
    mean_port = float(np.abs(port - truth).mean())
    mean_jax = float(np.abs(jax_bf16 - truth).mean())
    print(f"seed {seed}: forward abs error against float32, mean / max: "
          f"port {mean_port:.5f} / {np.abs(port - truth).max():.4f}, JAX "
          f"bf16 {mean_jax:.5f} / {np.abs(jax_bf16 - truth).max():.4f}; "
          f"port against JAX bf16, max {np.abs(port - jax_bf16).max():.4f}; "
          f"prefill last, max {np.abs(port_last - truth_last).max():.4f}")
    tol = dict(rtol=5e-2, atol=5e-2)
    _close(port, truth, tol)
    _close(port_last, truth_last, tol)
    assert mean_port <= 1.12 * mean_jax


def test_prefill_decode_consistency_bf16():
    """``tests/test_arch_smoke.py``'s property, within the port."""
    _, _, lm = _pair("bfloat16")
    b, s = 2, 16
    toks = torch.from_numpy(_tokens(1, b, s, lm.cfg.vocab))
    logits_all = lm.forward({"tokens": toks})
    cache = lm.init_cache(b, s)
    last, _ = lm.prefill({"tokens": toks[:, :s - 1]}, cache)
    _close(last, logits_all[:, s - 2], dict(rtol=2e-2, atol=2e-2))
    logits1, _ = lm.decode_step(cache, {"token": toks[:, s - 1:],
                                        "pos": s - 1})
    _close(logits1, logits_all[:, s - 1], dict(rtol=5e-2, atol=5e-2))
    with pytest.raises(ValueError):
        lm.decode_step(cache, {"token": toks[:, :1], "pos": s})
    with pytest.raises(ValueError):
        lm.prefill({"tokens": toks}, lm.init_cache(b, s - 1))


def test_greedy_serving_matches_jax():
    """``examples/serve_batched.py``'s loop: 4 prompts of 16 tokens, 24
    greedy tokens into a preallocated cache; float32, equal tokens."""
    jm, params, lm = _pair("float32")
    bsz, plen, n_new = 4, 16, 24
    prompts = np.random.default_rng(0).integers(0, lm.cfg.vocab,
                                                (bsz, plen), dtype=np.int32)
    logits, pcache = jax.jit(jm.prefill)(params,
                                         {"tokens": jnp.asarray(prompts)})
    cache = jm.init_cache(bsz, plen + n_new)
    for k in ("k", "v"):
        cache[k] = jax.lax.dynamic_update_slice(
            cache[k], pcache[k].astype(cache[k].dtype), (0,) * cache[k].ndim)
    decode = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    want, want_logits = [np.asarray(tok)], [np.asarray(logits)]
    for i in range(n_new - 1):
        logits, cache = decode(params, cache, {
            "token": tok, "pos": jnp.asarray(plen + i, jnp.int32)})
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok))
        want_logits.append(np.asarray(logits))

    tcache = lm.init_cache(bsz, plen + n_new)
    tlogits, _ = lm.prefill({"tokens": torch.from_numpy(prompts)}, tcache)
    ttok = tlogits.argmax(dim=-1)[:, None]
    got, got_logits = [ttok.numpy()], [tlogits.numpy()]
    for i in range(n_new - 1):
        tlogits, tcache = lm.decode_step(tcache, {"token": ttok,
                                                  "pos": plen + i})
        ttok = tlogits.argmax(dim=-1)[:, None]
        got.append(ttok.numpy())
        got_logits.append(tlogits.numpy())
    np.testing.assert_array_equal(np.concatenate(got, axis=1),
                                  np.concatenate(want, axis=1))
    np.testing.assert_allclose(np.stack(got_logits), np.stack(want_logits),
                               **F32)


def test_serve_example_runs_on_the_host():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_batched_torch.py"),
         ARCH, "6", "--device", "cpu"], capture_output=True, text=True,
        timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "prefill: 4 requests x 16 tokens" in out.stdout
    assert "decode: 5 steps x 4 requests" in out.stdout
    assert "OK" in out.stdout.splitlines()[-1]


def test_lm_is_a_module_holding_its_weights():
    _, _, lm = _pair("float32")
    assert isinstance(lm, LM) and isinstance(lm.cfg, ModelConfig)
    n = sum(p.numel() for p in lm.parameters())
    cfg = lm.cfg
    bias = cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
    assert n == cfg.param_count() + bias
    assert not any(p.requires_grad for p in lm.parameters())
