"""The port's sub-quadratic blocks against the JAX package's, on the reduced
``rwkv6-1.6b`` (2 layers, ``d_model`` 64, 4 heads of 16) and the reduced
``hymba-1.5b`` (4/2 attention heads and 4 SSM heads of 16), with the JAX
package's ``LM.init`` weights carried across by ``params_from_jax`` and the
same numpy inputs through both, float32 unless a case says otherwise.

Every parameter the JAX init sets to a constant (``mu_*`` 0.5,
``decay_base`` -2, ``u_bonus`` 0, ``ln_x``, the norms and ``d_skip`` 1,
``a_log`` 0) is first perturbed with seeded noise (:func:`perturbed`):
with the constants, swapped lerps or a dropped bonus would pass unseen.
Three planted faults must fail the comparison: ``mu_r`` and ``mu_k``
swapped, a per-head RMS in place of the whole-``D`` one, and ``u``
dropped (and the first and the last pass on the unperturbed weights).

* ``rwkv_token_mix``, ``rwkv_channel_mix``, ``ssm_apply`` (from zero and
  from a carried state) and the three decodes against the JAX functions
  at ``rtol=atol=1e-5`` (scaled by the largest magnitude, as
  ``tests/test_torch_linear_attn.py`` holds the core).
* ``LM.forward`` logits at ``rtol=atol=1e-4``; ``loss`` within 1e-5
  relative and every gradient against ``jax.value_and_grad`` within
  ``rtol=1e-4, atol=1e-5``; ``prefill``'s last logits and its cache
  (RWKV's ``tm_x``, ``cm_x`` and ``wkv``; Hymba's ``k``, ``v`` and
  ``ssm``), ``decode_step`` and a greedy loop with equal tokens.
* bf16: the port's and the JAX LM's bf16 logits against the JAX LM in
  float32 on the same weights; the port's mean abs error within 1.12
  times the JAX LM's own (``tests/test_torch_lm.py``'s rule).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models.model import build_model as jax_build_model
from repro_torch import configs
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

ARCHS = ("rwkv6-1.6b", "hymba-1.5b")
TOL = dict(rtol=1e-5, atol=1e-5)
F32 = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# the seeded noise added to each parameter the JAX init sets to a constant
NOISE = dict.fromkeys(("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck",
                       "mu_cr"), 0.15)
NOISE.update(decay_base=0.7, u_bonus=0.5, ln_x=0.2, norm1=0.2, norm2=0.2,
             final_norm=0.2, a_log=0.5, d_skip=0.3)


def _cfgs(arch, dtype="float32"):
    kw = dict(dtype=dtype, param_dtype=dtype)
    return (jconfigs.get_reduced(arch).replace(**kw),
            configs.get_reduced(arch).replace(**kw))


def perturbed(tree, rng, noise=None):
    """``tree`` (numpy leaves; dicts and named tuples) with
    ``noise[name]`` (default ``NOISE``) times N(0, 1) added to each leaf
    named in it, in the leaf's dtype."""
    noise = NOISE if noise is None else noise
    if isinstance(tree, dict):
        return {k: (_noisy(v, noise[k], rng) if k in noise
                    else perturbed(v, rng, noise)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(**{f: (_noisy(getattr(tree, f), noise[f], rng)
                                 if f in noise
                                 else perturbed(getattr(tree, f), rng, noise))
                             for f in tree._fields})
    return tree


def _noisy(a, scale, rng):
    a = np.asarray(a)
    assert np.all(a == a.flat[0]), "a perturbed leaf was not a constant"
    noise = scale * rng.standard_normal(a.shape)
    return (a.astype(np.float32) + noise).astype(a.dtype)


@functools.lru_cache(maxsize=None)
def _params(arch, dtype="float32", perturb=True):
    """The JAX ``LM.init`` weights of the reduced config (numpy leaves),
    perturbed with seed 7 unless ``perturb`` is false."""
    jcfg, _ = _cfgs(arch, dtype)
    params = jax.tree.map(np.asarray, jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    return perturbed(params, np.random.default_rng(7)) if perturb \
        else params


def _port(arch, dtype="float32", trainable=False, perturb=True):
    _, cfg = _cfgs(arch, dtype)
    lm = build_model(cfg, device="cpu", trainable=trainable)
    lm.load_state_dict(params_from_jax(_params(arch, dtype, perturb), cfg))
    return lm


def _np(x):
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


def _close(got, want, tol=TOL, err_msg=""):
    """``got`` within ``tol`` of ``want``, both scaled by ``want``'s largest
    magnitude (at least 1)."""
    got, want = _np(got), _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, **tol,
                               err_msg=err_msg)


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _x(seed, b=2, s=67, d=64):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _layer0(arch, mod):
    return jax.tree.map(lambda a: jnp.asarray(a[0]),
                        _params(arch)["blocks"][mod])


def _leaf_name(path):
    key = path[-1]
    return getattr(key, "key", getattr(key, "name", None))


def test_every_init_constant_is_perturbed():
    """No leaf is constant after :func:`perturbed`, and each leaf the JAX
    init set to a constant is one ``NOISE`` names."""
    for arch in ARCHS:
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                _params(arch)):
            assert np.unique(leaf).size > 1, jax.tree_util.keystr(path)
        const = {_leaf_name(path) for path, leaf in
                 jax.tree_util.tree_leaves_with_path(
                     _params(arch, perturb=False))
                 if np.unique(leaf).size == 1}
        assert const and const <= set(NOISE), const


# ---------------------------------------------------------- the mixes ----

def test_rwkv_mixes_match_jax():
    arch = ARCHS[0]
    jcfg, cfg = _cfgs(arch)
    jp = _layer0(arch, "rwkv")
    p = _port(arch).blocks[0].rwkv
    x, x2 = _x(1), _x(2, s=5)
    want, (wx, ws) = jrwkv.rwkv_token_mix(jp, jnp.asarray(x), jcfg)
    got, (gx, gs) = trwkv.rwkv_token_mix(p, torch.from_numpy(x), cfg)
    for g, w in ((got, want), (gx, wx), (gs, ws)):
        _close(g, w)
    # continuing from the carried state
    want2, (_, ws2) = jrwkv.rwkv_token_mix(jp, jnp.asarray(x2), jcfg,
                                           (wx, ws))
    got2, (_, gs2) = trwkv.rwkv_token_mix(p, torch.from_numpy(x2), cfg,
                                          (gx, gs))
    _close(got2, want2)
    _close(gs2, ws2)
    want, wc = jrwkv.rwkv_channel_mix(jp, jnp.asarray(x))
    got, gc = trwkv.rwkv_channel_mix(p, torch.from_numpy(x))
    _close(got, want)
    _close(gc, wc)
    want2, _ = jrwkv.rwkv_channel_mix(jp, jnp.asarray(x2), wc)
    got2, _ = trwkv.rwkv_channel_mix(p, torch.from_numpy(x2), gc)
    _close(got2, want2)
    # the decodes, one token on the carried states
    x1 = x2[:, 0]
    want, (wx1, ws1) = jrwkv.rwkv_token_mix_decode(jp, jnp.asarray(x1), jcfg,
                                                   (wx, ws))
    got, (gx1, gs1) = trwkv.rwkv_token_mix_decode(p, torch.from_numpy(x1),
                                                  cfg, (gx, gs))
    for g, w in ((got, want), (gx1, wx1), (gs1, ws1)):
        _close(g, w)
    want, _ = jrwkv.rwkv_channel_mix_decode(jp, jnp.asarray(x1), wc)
    got, _ = trwkv.rwkv_channel_mix_decode(p, torch.from_numpy(x1), gc)
    _close(got, want)


def test_ssm_matches_jax():
    arch = ARCHS[1]
    jcfg, cfg = _cfgs(arch)
    jp = _layer0(arch, "ssm")
    p = _port(arch).blocks[0].ssm
    x, x2 = _x(3), _x(4, s=5)
    want, ws = jssm.ssm_apply(jp, jnp.asarray(x), jcfg)
    got, gs = tssm.ssm_apply(p, torch.from_numpy(x), cfg)
    assert tuple(gs.shape) == (2, cfg.ssm_heads, cfg.ssm_state, cfg.hd)
    _close(got, want)
    _close(gs, ws)
    want2, ws2 = jssm.ssm_apply(jp, jnp.asarray(x2), jcfg, ws)
    got2, gs2 = tssm.ssm_apply(p, torch.from_numpy(x2), cfg, gs)
    _close(got2, want2)
    _close(gs2, ws2)
    want, ws1 = jssm.ssm_decode(jp, jnp.asarray(x2[:, 0]), jcfg, ws)
    got, gs1 = tssm.ssm_decode(p, torch.from_numpy(x2[:, 0]), cfg, gs)
    _close(got, want)
    _close(gs1, ws1)


# ------------------------------------------------------------- the LM ----

def _batch(seed=0, b=2, s=24):
    toks = _tokens(seed, b, s + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def forward_against_jax(arch, lm, perturb=True, seed=0):
    """``lm.forward`` against the JAX LM on the same weights (perturbed
    or the init's); raises AssertionError where they part."""
    jcfg, _ = _cfgs(arch)
    toks = _tokens(seed, 2, 24)
    want, _ = jax.jit(jax_build_model(jcfg).forward)(
        _params(arch, perturb=perturb), {"tokens": jnp.asarray(toks)})
    _close(lm.forward({"tokens": torch.from_numpy(toks)}), want, F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    forward_against_jax(arch, _port(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, _ = _cfgs(arch)
    params = _params(arch)
    batch = _batch()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jax_build_model(jcfg).loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    lm = _port(arch, trainable=True)
    loss, met = lm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    names, leaves = zip(*lm.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(met["aux"]) == 0.0
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), lm.cfg)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(_np(g), _np(want[name]), **GRAD_TOL,
                                   err_msg=name)


def _jax_cache(jm, pcache, b, total):
    """The JAX decode cache of ``total`` positions holding a prefill's."""
    cache = jm.init_cache(b, total)
    for name, t in pcache.items():
        cache[name] = (jax.lax.dynamic_update_slice(
            cache[name], t.astype(cache[name].dtype), (0,) * t.ndim)
            if name in ("k", "v") else t)
    return cache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_greedy_match_jax(arch):
    """``prefill``'s last logits and cache against the JAX LM's, then a
    greedy loop of 12 tokens: equal tokens, logits at 1e-4."""
    jcfg, _ = _cfgs(arch)
    jm, params, lm = jax_build_model(jcfg), _params(arch), _port(arch)
    b, plen, n_new = 2, 19, 12
    prompts = _tokens(5, b, plen)
    logits, pcache = jax.jit(jm.prefill)(params,
                                         {"tokens": jnp.asarray(prompts)})
    cache = lm.init_cache(b, plen + n_new)
    tlogits, cache = lm.prefill({"tokens": torch.from_numpy(prompts)},
                                cache)
    _close(tlogits, logits, F32)
    assert set(cache) == set(pcache)
    for name, want in pcache.items():
        got = cache[name][:, :, :plen] if name in ("k", "v") else \
            cache[name]
        _close(got, want, F32, name)
    jcache = _jax_cache(jm, pcache, b, plen + n_new)
    decode = jax.jit(jm.decode_step)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    ttok = tlogits.argmax(-1)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(tok))
    for i in range(n_new):
        logits, jcache = decode(params, jcache, {
            "token": tok, "pos": jnp.asarray(plen + i, jnp.int32)})
        tlogits, cache = lm.decode_step(cache, {"token": ttok,
                                                "pos": plen + i})
        _close(tlogits, logits, F32, str(i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        ttok = tlogits.argmax(-1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(tok))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistent_with_forward(arch):
    """``tests/test_arch_smoke.py``'s property in the port, in float32:
    every position decoded after a one-token prefill equals ``forward``."""
    lm = _port(arch)
    b, s = 2, 13
    toks = torch.from_numpy(_tokens(6, b, s))
    full = lm.forward({"tokens": toks})
    cache = lm.init_cache(b, s)
    last, cache = lm.prefill({"tokens": toks[:, :1]}, cache)
    _close(last, full[:, 0], F32)
    for pos in range(1, s):
        logits, cache = lm.decode_step(cache, {"token": toks[:, pos:pos + 1],
                                               "pos": pos})
        _close(logits, full[:, pos], F32, str(pos))


# ------------------------------------------------------- planted faults --

def _swap_mu_rk(lm):
    for blk in lm.blocks:
        with torch.no_grad():
            r = blk.rwkv.mu_r.clone()
            blk.rwkv.mu_r.copy_(blk.rwkv.mu_k)
            blk.rwkv.mu_k.copy_(r)


def _per_head_rms(monkeypatch, cfg):
    def per_head(p, o, g, dtype):
        hd = cfg.rwkv_head_dim
        o32 = o.float().unflatten(-1, (-1, hd))
        o32 = o32 * torch.rsqrt(torch.mean(o32 * o32, -1, keepdim=True)
                                + 1e-6)
        o32 = o32.flatten(-2)
        return (o32 * p.ln_x).to(dtype) * torch.nn.functional.silu(
            g.float()).to(dtype)
    monkeypatch.setattr(trwkv, "_ln_x_gate", per_head)


def _drop_u(monkeypatch):
    chunked = trwkv.chunked_linear_attention
    monkeypatch.setattr(trwkv, "chunked_linear_attention",
                        lambda *a, u=None, **kw: chunked(*a, u=None, **kw))


@pytest.mark.parametrize("fault", ("mu_swap", "per_head_rms", "u_dropped"))
def test_planted_faults_fail(fault, monkeypatch):
    arch = ARCHS[0]
    for perturb in (True, False):
        lm = _port(arch, perturb=perturb)
        if fault == "mu_swap":
            _swap_mu_rk(lm)
        elif fault == "per_head_rms":
            _per_head_rms(monkeypatch, lm.cfg)
        else:
            _drop_u(monkeypatch)
        if perturb or fault == "per_head_rms":
            with pytest.raises(AssertionError):
                forward_against_jax(arch, lm, perturb)
        else:       # the init's constants hide a swap and a dropped bonus
            forward_against_jax(arch, lm, perturb)
        monkeypatch.undo()


# ----------------------------------------------------------------- bf16 --

@functools.lru_cache(maxsize=None)
def _bf16_readings(arch, seed):
    """Mean and largest abs logit errors of the port's bf16 LM and the JAX
    LM's in bf16 against the JAX LM in float32 on the same (perturbed,
    bf16) weights, upcast exactly."""
    jcfg16, _ = _cfgs(arch, "bfloat16")
    jcfg32, _ = _cfgs(arch)
    params = _params(arch, "bfloat16")
    params32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    toks = _tokens(seed, 2, 24)
    jb = {"tokens": jnp.asarray(toks)}
    truth = _np(jax.jit(jax_build_model(jcfg32).forward)(params32, jb)[0])
    jax16 = _np(jax.jit(jax_build_model(jcfg16).forward)(params, jb)[0])
    port = _np(_port(arch, "bfloat16").forward(
        {"tokens": torch.from_numpy(toks)}))
    err, jerr = np.abs(port - truth), np.abs(jax16 - truth)
    return dict(port_mean=float(err.mean()), jax_mean=float(jerr.mean()),
                port_max=float(err.max()), jax_max=float(jerr.max()))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_port_tracks_float32_jax(arch, seed):
    """The bf16 port within 1.12 times the JAX bf16 LM's own mean abs
    logit error against float32.  Prints the readings (``pytest -s``)."""
    r = _bf16_readings(arch, seed)
    print(f"{arch} seed {seed}: logits abs error against float32, mean / "
          f"max: port {r['port_mean']:.5f} / {r['port_max']:.4f}, JAX bf16 "
          f"{r['jax_mean']:.5f} / {r['jax_max']:.4f}")
    assert r["port_mean"] <= 1.12 * r["jax_mean"]


# ---------------------------------------------------------- one device --

@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_on_one_device(arch):
    """``launch/train.py --arch`` trains the reduced model on the host:
    three AdamW steps, finite losses."""
    from repro_torch.launch import train as launcher
    losses = launcher.run(["--arch", arch, "--reduced", "--device", "cpu",
                           "--steps", "3", "--batch", "4", "--seq", "16",
                           "--microbatch", "2", "--log-every", "100"])
    assert len(losses) == 3 and all(np.isfinite(losses))
