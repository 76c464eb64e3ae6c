"""The port's mixture-of-experts (``repro_torch.models.moe`` and the MoE
blocks of the LM) against the JAX package's, on the reduced
``qwen3-moe-30b-a3b`` (8 experts, top-2, SwiGLU experts) and the reduced
``arctic-480b`` (a dense MLP beside the experts), with the JAX package's
``LM.init`` weights carried across by ``params_from_jax`` and the same
numpy inputs through both, float32 unless a case says otherwise.

* ``moe_apply`` (the ``spmd`` body, one device): ``eidx`` equal, the
  output within 1e-5 and ``aux`` within 1e-6, at the default capacity and
  at a capacity factor that drops assignments (the same tokens dropped:
  equal zero rows, and the outputs within 1e-5).
* ``LM.loss`` (``ce``, ``aux``) and every gradient against
  ``jax.value_and_grad`` of the JAX ``LM.loss``, remat on and off: the
  loss within 1e-5 relative, ``aux`` and ``ce`` within 1e-6, the
  gradients within ``rtol=1e-4, atol=1e-5``.
* ``forward``, ``prefill`` and ``decode_step`` against the JAX LM at
  ``rtol=atol=1e-4``; and ``tests/test_arch_smoke.py``'s property within
  the port at lossless capacity (``capacity_factor = n_experts``), where
  the forward and the stepwise paths route alike.
* bf16: the port and the JAX LM in bf16 against the JAX LM in float32 on
  the same weights: routing agreement with float32 and the logits' mean
  error (statistics; the two frameworks round bf16 in different places).
* Planted faults that must fail: an unstable sort (other tokens dropped
  past capacity), and a combine that drops the gates.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models.model import build_model as jax_build_model
from repro_torch import configs
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b")
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
AUX_ATOL = 1e-6
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
F32 = dict(rtol=1e-4, atol=1e-4)
# capacity factors: the configs' 1.25 and one that drops assignments
# (capacity int(16 * 2 * 0.25 / 8) = 1 of 4 a row's expert gets on average)
DROPPING = 0.25


def _cfgs(arch, dtype="float32", **kw):
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return (jconfigs.get_reduced(arch).replace(**kw),
            configs.get_reduced(arch).replace(**kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch, dtype="float32"):
    jcfg, _ = _cfgs(arch, dtype)
    return jax_build_model(jcfg).init(jax.random.PRNGKey(0))


def _port(arch, dtype="float32", trainable=False, **kw):
    _, cfg = _cfgs(arch, dtype, **kw)
    lm = build_model(cfg, device="cpu", trainable=trainable)
    lm.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, _jax_params(arch, dtype)), cfg))
    return lm


def _np(x):
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


def _tokens(seed, b, s, vocab=384):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _x(seed, b=3, s=16, d=64):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _jax_layer0(arch):
    return jax.tree.map(lambda a: a[0], _jax_params(arch)["blocks"]["moe"])


def _jax_eidx(p, x, k):
    """The JAX body's routing, from JAX functions: ``top_k`` of the
    softmax of the float32 router logits."""
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                        p.router.astype(jnp.float32))
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1), k)[1])


def moe_against_jax(arch, factor, seed=1):
    """``moe_apply``'s spmd body against JAX's on the same weights and
    input; raises AssertionError where they part.  Returns the number of
    tokens whose every assignment was dropped."""
    jcfg, cfg = _cfgs(arch, capacity_factor=factor)
    p = _jax_layer0(arch)
    x = _x(seed)
    jout, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg))(
        p, jnp.asarray(x))
    lm = _port(arch, capacity_factor=factor)
    out, aux, eidx = tmoe.moe_route_apply(lm.blocks[0].moe,
                                          torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(eidx.numpy(),
                                  _jax_eidx(p, jnp.asarray(x), cfg.top_k))
    jout = np.asarray(jout)
    dropped = np.all(jout == 0, axis=-1)
    np.testing.assert_array_equal(np.all(_np(out) == 0, axis=-1), dropped)
    np.testing.assert_allclose(_np(out), jout, **OUT_TOL)
    assert abs(float(aux) - float(jaux)) <= AUX_ATOL
    return int(dropped.sum())


# -------------------------------------------------------------- moe_apply --

@pytest.mark.parametrize("factor", (1.25, DROPPING))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, factor):
    dropped = moe_against_jax(arch, factor)
    if factor == DROPPING:
        assert dropped > 0          # the case does drop whole tokens


def test_moe_init_draws_from_the_generator():
    _, cfg = _cfgs(ARCHS[0])
    a = tmoe.moe_init(torch.Generator().manual_seed(3), cfg)
    b = tmoe.moe_init(torch.Generator().manual_seed(3), cfg)
    for name in ("router", "wi", "wo", "wg"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.router.dtype == torch.float32
    assert tuple(a.wi.shape) == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert tuple(a.wo.shape) == (cfg.n_experts, cfg.d_ff, cfg.d_model)
    # wi's rows scale as D**-0.5, wo's as F**-0.5
    assert abs(float(a.wi.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert abs(float(a.wo.std()) * cfg.d_ff ** 0.5 - 1) < 0.05


def test_moe_routing_breaks_ties_toward_the_lower_expert():
    """Equal probabilities: ``jax.lax.top_k``'s order, the lower expert
    id first."""
    probs_like = torch.zeros(1, 1, 4)
    router = torch.zeros(4, 8)
    _, gate, eidx = tmoe._route(probs_like, router, 3)
    assert eidx.tolist() == [[[0, 1, 2]]]
    np.testing.assert_allclose(gate.numpy(), 1 / 3)
    want = np.asarray(jax.lax.top_k(jnp.full((8,), 0.125), 3)[1])
    assert eidx[0, 0].tolist() == want.tolist()


def test_planted_unstable_sort_fails(monkeypatch):
    """An argsort that orders equal experts' assignments last token
    first keeps other tokens past capacity: the comparison must fail."""
    orig = torch.argsort

    def unstable(x, dim=-1, descending=False, stable=False):
        ar = torch.arange(x.shape[dim], device=x.device)
        return orig(x * x.shape[dim] + (x.shape[dim] - 1 - ar), dim=dim,
                    descending=descending, stable=True)
    monkeypatch.setattr(torch, "argsort", unstable)
    with pytest.raises(AssertionError):
        moe_against_jax(ARCHS[0], DROPPING)


def test_planted_combine_without_gates_fails(monkeypatch):
    orig = tmoe._route

    def ungated(x, router, k):
        probs, gate, eidx = orig(x, router, k)
        return probs, torch.ones_like(gate), eidx
    monkeypatch.setattr(tmoe, "_route", ungated)
    with pytest.raises(AssertionError):
        moe_against_jax(ARCHS[0], 1.25)


# ------------------------------------------------------------- the LM ------

def _batch(seed=0, b=2, s=16):
    toks = _tokens(seed, b, s + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("remat", (True, False))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    jcfg, _ = _cfgs(arch, remat=remat)
    params = _jax_params(arch)
    batch = _batch()
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jax_build_model(jcfg).loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    lm = _port(arch, trainable=True, remat=remat)
    loss, met = lm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    names, leaves = zip(*lm.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(met["aux"]) > 0
    for key in ("ce", "aux"):
        assert abs(float(met[key]) - float(jmet[key])) <= AUX_ATOL, key
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), lm.cfg)
    assert set(grads) == set(want)
    assert any(".moe.router" in n for n in grads)
    for name, g in grads.items():
        np.testing.assert_allclose(_np(g), _np(want[name]), **GRAD_TOL,
                                   err_msg=name)


def _jax_padded(cache, s):
    return {k: jnp.pad(v, [(0, 0), (0, 0), (0, s - v.shape[2]), (0, 0),
                           (0, 0)]) for k, v in cache.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    jcfg, _ = _cfgs(arch)
    jm, params = jax_build_model(jcfg), _jax_params(arch)
    lm = _port(arch)
    b, s = 2, 16
    toks = _tokens(4, b, s)
    want_all, _ = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    got_all = lm.forward({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got_all), _np(want_all), **F32)
    want_last, want_cache = jax.jit(jm.prefill)(
        params, {"tokens": jnp.asarray(toks[:, :s - 1])})
    cache = lm.init_cache(b, s)
    got_last, _ = lm.prefill({"tokens": torch.from_numpy(toks[:, :s - 1])},
                             cache)
    np.testing.assert_allclose(_np(got_last), _np(want_last), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name][:, :, :s - 1]),
                                   _np(want_cache[name]), **F32)
    got1, _ = lm.decode_step(cache, {"token": torch.from_numpy(
        toks[:, s - 1:]), "pos": s - 1})
    want1, _ = jax.jit(jm.decode_step)(
        params, _jax_padded(want_cache, s),
        {"token": jnp.asarray(toks[:, s - 1:]),
         "pos": jnp.asarray(s - 1, jnp.int32)})
    np.testing.assert_allclose(_np(got1), _np(want1), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistent_with_forward_at_lossless_capacity(arch):
    """``tests/test_arch_smoke.py``'s property (there at 2e-2), in the
    port in float32: at ``capacity_factor = n_experts`` no assignment is
    dropped, so prefill and decode route each token as ``forward`` does;
    every position decoded after a one-token prefill."""
    lm = _port(arch, capacity_factor=8.0)
    b, s = 2, 12
    toks = torch.from_numpy(_tokens(5, b, s))
    full = lm.forward({"tokens": toks})
    cache = lm.init_cache(b, s)
    last, cache = lm.prefill({"tokens": toks[:, :1]}, cache)
    np.testing.assert_allclose(_np(last), _np(full[:, 0]), **F32)
    for pos in range(1, s):
        logits, cache = lm.decode_step(cache, {"token": toks[:, pos:pos + 1],
                                               "pos": pos})
        np.testing.assert_allclose(_np(logits), _np(full[:, pos]), **F32,
                                   err_msg=str(pos))


# ----------------------------------------------------------------- bf16 ----

@functools.lru_cache(maxsize=None)
def _bf16_readings(arch, seed):
    """At lossless capacity, against the float32 LM on the bf16 weights
    (upcast exactly; the port's float32, which equals JAX's to 1e-5
    above): the routing agreement of the port's bf16 model over every
    layer's assignments, and over the tokens routed alike in every layer,
    the mean and largest abs logit errors of the port's bf16 logits and of
    the JAX LM's in bf16."""
    b, s = 2, 16
    toks = _tokens(seed, b, s)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}
    kw = dict(capacity_factor=8.0)
    params = _jax_params(arch, "bfloat16")
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    jcfg16, cfg16 = _cfgs(arch, "bfloat16", **kw)
    jcfg32, cfg32 = _cfgs(arch, **kw)
    jax16 = _np(jax.jit(jax_build_model(jcfg16).forward)(params, jb)[0])
    models = []
    for cfg, ps in ((cfg16, params), (cfg32, params32)):
        lm = build_model(cfg, device="cpu")
        lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, ps),
                                           cfg))
        models.append(lm)
    port, truth = (_np(lm.forward(tb)) for lm in models)
    from repro_torch.train.monitor import routing_trace
    e16, e32 = (routing_trace(lm, tb) for lm in models)
    agree = float((e16 == e32).float().mean())
    alike = (e16 == e32).all(-1).all(0).numpy()          # [B, S]
    err, jerr = np.abs(port - truth)[alike], np.abs(jax16 - truth)[alike]
    return dict(agree=agree, alike=float(alike.mean()),
                port_mean=float(err.mean()), jax_mean=float(jerr.mean()),
                port_max=float(err.max()), jax_max=float(jerr.max()))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_port_tracks_float32_jax(arch, seed):
    """The bf16 port against the LM in float32 on the same weights, by
    statistics (the two frameworks round bf16 in different places, and a
    token near a routing tie may go to another expert): at least 90 % of
    the assignments of every layer routed as in float32; over the tokens
    routed alike in every layer, the port's mean abs logit error within
    1.25 times the JAX bf16 LM's own, and its largest within 1.5 times
    the JAX bf16 LM's largest.  Prints the readings (``pytest -s``)."""
    r = _bf16_readings(arch, seed)
    print(f"{arch} seed {seed}: routing agreement {r['agree']:.3f} "
          f"(tokens alike in every layer {r['alike']:.3f}); over those, "
          f"logits abs error against float32, mean / max: port "
          f"{r['port_mean']:.5f} / {r['port_max']:.4f}, JAX bf16 "
          f"{r['jax_mean']:.5f} / {r['jax_max']:.4f}")
    assert r["agree"] >= 0.9
    assert r["port_mean"] <= 1.25 * r["jax_mean"]
    assert r["port_max"] <= 1.5 * r["jax_max"]
