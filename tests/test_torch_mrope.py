"""M-RoPE and embedding inputs (Qwen2-VL's backbone) against the JAX
package, on the CPU.

With all three M-RoPE id streams equal, M-RoPE is RoPE, and the
reference's stand-in inputs (``src/repro/launch/specs.py:44-46``) are just
that: a wrong section boundary or two swapped streams would pass them.  So
every case here runs on the ids of a VLM prompt (:func:`vlm_positions`): a
text run, an image block of a ``t x h x w`` grid (temporal id constant,
height id the row, width id the column, all from the text's length), then
text again from the largest id so far plus 1; each row of the batch with
its own text length.

* ``apply_mrope`` against JAX's at hd 16 and 128 (section boundaries 4, 6,
  8 and 32, 48, 64), float32 within 1e-6 and bf16 exactly.
* The reduced ``qwen2-vl-72b`` (2 layers, ``d_model`` 64, 4/2 heads of
  16), the JAX package's ``LM.init`` carried across by
  ``params_from_jax``, ``embeds`` ``[B, S, D]`` in place of tokens, float32
  (``tests/test_torch_lm.py``'s 1e-4): ``forward`` logits; ``prefill``'s
  last logits and K/V cache, then decode steps with ``embed1`` and with
  ``token`` (the reference sets all three ids to ``pos``); the loss
  within 1e-5 relative and every gradient within ``rtol=1e-4, atol=1e-5``
  (``tests/test_torch_train_lm.py``'s).
* bf16: the port within 5e-2 of the JAX LM in float32 on the same weights,
  and its mean abs error within 1.12 times the JAX LM's own in bf16
  (``test_bf16_port_tracks_float32_jax``'s rule).
* Two planted faults (the height and width streams swapped; the spectrum
  cut in equal thirds) must fail on these ids, and pass on text ids.
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
from repro_torch.models.model import build_model

ARCH = "qwen2-vl-72b"
F32 = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
B, S, GRID = 2, 24, (1, 4, 4)


def vlm_positions(b, s, grid, text=(4, 3)):
    """``[3, B, S]`` int32 ids: per row ``i``, ``text[i]`` text tokens,
    then a ``t x h x w`` image block (temporal ``text + frame``, height
    ``text + row``, width ``text + column``), then text from the largest
    id so far plus 1, all three streams equal."""
    t, h, w = grid
    out = np.zeros((3, b, s), np.int32)
    for i in range(b):
        n = text[i % len(text)]
        out[:, i, :n] = np.arange(n)
        frames, rows, cols = np.meshgrid(np.arange(t), np.arange(h),
                                         np.arange(w), indexing="ij")
        img = np.stack([frames, rows, cols]).reshape(3, -1) + n
        out[:, i, n:n + img.shape[1]] = img
        rest = s - n - img.shape[1]
        out[:, i, s - rest:] = img.max() + 1 + np.arange(rest)
    return out


def test_vlm_positions_are_a_real_prompts():
    pos = vlm_positions(1, 24, (1, 4, 4), text=(4,))[:, 0]
    assert pos[:, :4].tolist() == [[0, 1, 2, 3]] * 3
    assert set(pos[0, 4:20]) == {4}                      # temporal
    assert pos[1, 4:20].tolist() == [4 + r for r in range(4) for _ in
                                     range(4)]           # height: rows
    assert pos[2, 4:20].tolist() == [4 + c for _ in range(4) for c in
                                     range(4)]           # width: columns
    assert pos[:, 20:].tolist() == [[8, 9, 10, 11]] * 3


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("hd", (16, 128))
def test_apply_mrope_matches_jax(hd, dtype):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((B, S, 3, hd)).astype(np.float32)
    pos = vlm_positions(B, S, GRID)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jlayers.apply_mrope(jx, jnp.asarray(pos), 1e6)
                      .astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = layers.apply_mrope(tx, torch.from_numpy(pos), 1e6)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert layers.mrope_bounds(hd) == {16: (4, 6, 8),
                                       128: (32, 48, 64)}[hd]


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    jcfg = jconfigs.get_reduced(ARCH).replace(dtype=dtype,
                                               param_dtype=dtype)
    cfg = configs.get_reduced(ARCH).replace(dtype=dtype, param_dtype=dtype)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    lm = build_model(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       cfg))
    return jm, params, lm


def _inputs(seed, dtype="float32"):
    """``embeds [B, S, D]`` and ``labels [B, S]`` of a seed, and the VLM
    ids."""
    rng = np.random.default_rng(seed)
    d = configs.get_reduced(ARCH).d_model
    emb = rng.standard_normal((B, S, d)).astype(np.float32)
    labels = rng.integers(0, configs.get_reduced(ARCH).vocab, (B, S),
                          dtype=np.int32)
    return emb, labels, vlm_positions(B, S, GRID)


def _jbatch(emb, pos, dtype, **extra):
    return dict(embeds=jnp.asarray(emb, dtype), positions=jnp.asarray(pos),
                **{k: jnp.asarray(v) for k, v in extra.items()})


def _tbatch(emb, pos, dtype, **extra):
    return dict(embeds=torch.from_numpy(emb).to(getattr(torch, dtype)),
                positions=torch.from_numpy(pos),
                **{k: torch.from_numpy(v) for k, v in extra.items()})


def _np(x):
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


def test_forward_matches_jax():
    jm, params, lm = _pair("float32")
    emb, _, pos = _inputs(0)
    want, _ = jax.jit(jm.forward)(params, _jbatch(emb, pos, jnp.float32))
    got = lm.forward(_tbatch(emb, pos, "float32"))
    assert got.shape == (B, S, lm.cfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def _jax_padded(cache, s):
    return {k: jnp.pad(v, [(0, 0), (0, 0), (0, s - v.shape[2]), (0, 0),
                           (0, 0)]) for k, v in cache.items()}


@pytest.mark.parametrize("by", ("embed1", "token"))
def test_prefill_and_decode_match_jax(by):
    """A prefill of the first 18 positions (text, the image, 2 text
    tokens), then decode steps for the rest, fed ``embed1`` (the next
    embedding) or ``token`` (its row of the table)."""
    jm, params, lm = _pair("float32")
    emb, labels, pos = _inputs(1)
    p = 18
    want_last, want_cache = jax.jit(jm.prefill)(
        params, _jbatch(emb[:, :p], pos[:, :, :p], jnp.float32))
    cache = lm.init_cache(B, S)
    got_last, cache = lm.prefill(_tbatch(emb[:, :p], pos[:, :, :p],
                                         "float32"), cache)
    np.testing.assert_allclose(_np(got_last), _np(want_last), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name][:, :, :p]),
                                   _np(want_cache[name]), **F32)
    jcache = _jax_padded(want_cache, S)
    decode = jax.jit(jm.decode_step)
    for i in range(p, S):
        one = ({"embed1": emb[:, i:i + 1]} if by == "embed1"
               else {"token": labels[:, i:i + 1]})
        want, jcache = decode(params, jcache, dict(
            pos=jnp.asarray(i, jnp.int32),
            **{k: jnp.asarray(v) for k, v in one.items()}))
        got, cache = lm.decode_step(cache, dict(
            pos=i, **{k: torch.from_numpy(v) for k, v in one.items()}))
        np.testing.assert_allclose(_np(got), _np(want), **F32,
                                   err_msg=f"position {i}")


def test_loss_and_gradients_match_jax():
    jm, params, _ = _pair("float32")
    cfg = configs.get_reduced(ARCH).replace(dtype="float32",
                                            param_dtype="float32")
    lm = build_model(cfg, device="cpu", trainable=True)
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       cfg))
    emb, labels, pos = _inputs(2)
    (want, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, _jbatch(emb, pos, jnp.float32, labels=labels))
    got, _ = lm.loss(_tbatch(emb, pos, "float32", labels=labels))
    names, leaves = zip(*lm.named_parameters())
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    want_grads = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(_np(g), want_grads[n].numpy(),
                                   **GRAD_TOL, err_msg=n)


@pytest.mark.parametrize("seed", range(3))
def test_bf16_port_tracks_float32_jax(seed):
    """The bf16 port's ``forward`` against the JAX LM in float32 on the
    same (bf16) weights, beside the JAX LM's own bf16 error.  Prints the
    readings (``pytest -s``)."""
    jm, params, lm = _pair("bfloat16")
    jcfg32 = jconfigs.get_reduced(ARCH).replace(dtype="float32",
                                                 param_dtype="float32")
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    emb, _, pos = _inputs(10 + seed)
    emb = np.array(jnp.asarray(emb, jnp.bfloat16).astype(jnp.float32))
    truth = _np(jax.jit(jax_build_model(jcfg32).forward)(
        params32, _jbatch(emb, pos, jnp.float32))[0])
    jax16 = _np(jax.jit(jm.forward)(params, _jbatch(emb, pos,
                                                    jnp.bfloat16))[0])
    port = _np(lm.forward(_tbatch(emb, pos, "bfloat16")))
    mean_port = float(np.abs(port - truth).mean())
    mean_jax = float(np.abs(jax16 - truth).mean())
    print(f"seed {seed}: logits abs error against float32, mean / max: "
          f"port {mean_port:.5f} / {np.abs(port - truth).max():.4f}, JAX "
          f"bf16 {mean_jax:.5f} / {np.abs(jax16 - truth).max():.4f}")
    np.testing.assert_allclose(port, truth, **BF16)
    assert mean_port <= 1.12 * mean_jax


def _swap_height_width(apply):
    return lambda x, positions, theta: apply(x, positions[[0, 2, 1]], theta)


def _equal_thirds(apply):
    def thirds(x, positions, theta):
        return apply(x, positions, theta, sections=(1, 1, 1))
    return thirds


@pytest.mark.parametrize("fault", (_swap_height_width, _equal_thirds))
def test_planted_faults_fail_on_image_ids_only(fault, monkeypatch):
    """A fault in M-RoPE parts from JAX's forward on a VLM prompt's ids,
    and not on text ids (all streams equal), which are RoPE's."""
    from repro_torch.models import attention
    jm, params, lm = _pair("float32")
    emb, _, pos = _inputs(3)
    text = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    monkeypatch.setattr(attention, "apply_mrope",
                        fault(layers.apply_mrope))
    for ids, parts in ((pos, True), (text, False)):
        want, _ = jax.jit(jm.forward)(params, _jbatch(emb, ids,
                                                      jnp.float32))
        got = lm.forward(_tbatch(emb, ids, "float32"))
        if parts:
            with pytest.raises(AssertionError):
                np.testing.assert_allclose(_np(got), _np(want), **F32)
        else:
            np.testing.assert_allclose(_np(got), _np(want), **F32)
