"""The port's chunked linear attention (``repro_torch.models.linear_attn``)
against the JAX package's, on the same numpy inputs made from a seed, in
float32.

* ``chunked_linear_attention``: the output and the final state within
  1e-5 of the JAX function's, relative to the largest magnitude of each
  (``rtol=atol=1e-5`` on both scaled by it), at S in {1, 50, 67, 128,
  192} (67 is prime: the chunk rule falls to c = 1; 50 takes c = 50, 192
  three chunks of 64), with and without the bonus ``u`` and an initial
  state, for RWKV's shape (dk = dv) and the SSM's (dk = 16, dv = 24).
  An absolute 1e-5 is below float32's own rounding here: both packages
  sit about 2.5e-5 from a float64 recurrence on outputs of magnitude
  40-70, so the port is also held to that recurrence, no further from it
  than 1.5 times the JAX function (plus 1e-6 of the scale).
* ``linear_attention_decode`` stepped S times equals the chunked form
  (and the JAX decode step for step).
* Pass 2 over groups of chunks: one chunk a group gives the same bits as
  every chunk at once.
* Gradients with respect to every input against ``jax.grad`` of the JAX
  function, within 1e-4 relative to each gradient's largest magnitude,
  through the checkpointed groups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import linear_attn as jla
from repro_torch.models import linear_attn as tla

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LENGTHS = (1, 50, 67, 128, 192)
# (B, H, dk, dv): RWKV's dk = dv, the SSM's dk = N = 16 with dv the head dim
SHAPES = {"rwkv": (2, 3, 16, 16), "ssm": (2, 3, 16, 24)}


def _inputs(shape, s, seed=0):
    """Float32 numpy r, k, v, logw (in about [-0.4, -0.02]), u, state0."""
    b, h, dk, dv = SHAPES[shape]
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    logw = -np.exp(rng.normal(-2.0, 0.8, (b, s, h, dk))).astype(np.float32)
    return dict(r=f(b, s, h, dk), k=f(b, s, h, dk), v=f(b, s, h, dv),
                logw=logw, u=f(h, dk), state0=f(b, h, dk, dv))


def _close(got, want, tol=TOL, err_msg=""):
    """``got`` within ``tol`` of ``want``, both scaled by the largest
    magnitude of ``want`` (at least 1)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got / scale, want / scale, **tol,
                               err_msg=err_msg)


def _recurrence64(inp, with_u, with_state):
    """The recurrence of the module docstring, token by token in float64:
    ``(o, final state)``."""
    r, k, v, lw = (inp[n].astype(np.float64) for n in ("r", "k", "v",
                                                        "logw"))
    b, s, h, dk = r.shape
    st = (inp["state0"].astype(np.float64) if with_state
          else np.zeros((b, h, dk, v.shape[-1])))
    u = inp["u"].astype(np.float64) if with_u else np.zeros((h, dk))
    outs = []
    for t in range(s):
        kv = k[:, t][..., :, None] * v[:, t][..., None, :]
        outs.append(np.einsum("bhd,bhdv->bhv", r[:, t],
                              st + u[None, :, :, None] * kv))
        st = st * np.exp(lw[:, t])[..., None] + kv
    return np.stack(outs, 1), st


def _args(inp, with_u, with_state, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return ([conv(inp[n]) for n in ("r", "k", "v", "logw")],
            dict(u=conv(inp["u"]) if with_u else None,
                 state0=conv(inp["state0"]) if with_state else None))


@pytest.mark.parametrize("with_state", (False, True))
@pytest.mark.parametrize("with_u", (False, True))
@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_chunked_matches_jax(shape, s, with_u, with_state):
    inp = _inputs(shape, s)
    jargs, jkw = _args(inp, with_u, with_state, "jax")
    targs, tkw = _args(inp, with_u, with_state, "torch")
    want_o, want_s = jla.chunked_linear_attention(*jargs, chunk=64, **jkw)
    got_o, got_s = tla.chunked_linear_attention(*targs, chunk=64, **tkw)
    assert got_o.dtype == torch.float32 and got_s.dtype == torch.float32
    assert got_o.shape == tuple(want_o.shape)
    _close(got_o, want_o)
    _close(got_s, want_s)
    for got, want, truth in zip((got_o, got_s), (want_o, want_s),
                                _recurrence64(inp, with_u, with_state)):
        port = float(np.abs(got.numpy() - truth).max())
        ref = float(np.abs(np.asarray(want) - truth).max())
        assert port <= 1.5 * ref + 1e-6 * np.abs(truth).max(), (port, ref)


def test_chunk_rule():
    assert [tla.chunk_len(64, s) for s in (1, 50, 64, 67, 128, 192, 4096,
                                           32768)] == [1, 50, 64, 1, 64,
                                                        64, 64, 64]
    assert tla.chunk_len(64, 96) == 48


def test_output_in_the_query_dtype():
    """``o`` in ``r``'s dtype (bf16 for RWKV's r), the state float32."""
    inp = _inputs("rwkv", 50)
    targs, tkw = _args(inp, True, False, "torch")
    o, st = tla.chunked_linear_attention(targs[0].bfloat16(), *targs[1:],
                                         **tkw)
    assert o.dtype == torch.bfloat16 and st.dtype == torch.float32
    o1, st1 = tla.linear_attention_decode(
        targs[0][:, 0].bfloat16(), targs[1][:, 0], targs[2][:, 0],
        targs[3][:, 0], st, u=tkw["u"])
    assert o1.dtype == torch.bfloat16 and st1.dtype == torch.float32


@pytest.mark.parametrize("with_u", (False, True))
@pytest.mark.parametrize("shape", SHAPES)
def test_decode_steps_equal_chunked(shape, with_u):
    s = 67
    inp = _inputs(shape, s, seed=1)
    targs, tkw = _args(inp, with_u, True, "torch")
    jargs, jkw = _args(inp, with_u, True, "jax")
    want_o, want_s = tla.chunked_linear_attention(*targs, **tkw)
    state, jstate, outs = tkw["state0"], jkw["state0"], []
    for t in range(s):
        o, state = tla.linear_attention_decode(
            *(a[:, t] for a in targs), state, u=tkw["u"])
        jo, jstate = jla.linear_attention_decode(
            *(a[:, t] for a in jargs), jstate, u=jkw["u"])
        _close(o, jo)
        outs.append(o)
    _close(torch.stack(outs, 1), want_o.numpy())
    _close(state, want_s.numpy())
    _close(state, jstate)


def _one_chunk_a_group(monkeypatch):
    """Pass 2 in groups of one chunk (the smallest ``GROUP_BYTES``)."""
    monkeypatch.setattr(tla, "GROUP_BYTES", 1)


@pytest.mark.parametrize("shape", SHAPES)
def test_pass2_groups_change_nothing(shape, monkeypatch):
    """One chunk a group gives the bits of every chunk at once (three
    chunks of 64), with and without autograd."""
    inp = _inputs(shape, 192, seed=2)
    targs, tkw = _args(inp, True, True, "torch")
    leaves = [t.clone().requires_grad_() for t in targs]
    runs = []
    for grouped in (False, True):
        if grouped:
            _one_chunk_a_group(monkeypatch)
        with torch.no_grad():
            plain = tla.chunked_linear_attention(*targs, **tkw)
        o, st = tla.chunked_linear_attention(*leaves, **tkw)
        grads = torch.autograd.grad(o.sum() + st.square().sum(), leaves)
        runs.append((*plain, *grads))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("s", (67, 192))
@pytest.mark.parametrize("shape", SHAPES)
def test_grads_match_jax(shape, s, monkeypatch):
    """Gradients of a random projection of ``(o, final state)`` with
    respect to r, k, v, logw, u and state0, against ``jax.grad``, through
    one checkpointed group a chunk."""
    _one_chunk_a_group(monkeypatch)
    inp = _inputs(shape, s, seed=3)
    rng = np.random.default_rng(4)
    b, h, dk, dv = SHAPES[shape]
    wo = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    ws = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    names = ("r", "k", "v", "logw", "u", "state0")

    def jloss(r, k, v, logw, u, state0):
        o, st = jla.chunked_linear_attention(r, k, v, logw, u=u,
                                             state0=state0)
        return jnp.sum(o * wo) + jnp.sum(st * ws)

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(inp[n]) for n in names))
    leaves = [torch.from_numpy(inp[n]).requires_grad_() for n in names]
    o, st = tla.chunked_linear_attention(*leaves[:4], u=leaves[4],
                                         state0=leaves[5])
    loss = (o * torch.from_numpy(wo)).sum() + (st * torch.from_numpy(ws)
                                               ).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(names, got, want):
        _close(g, w, GRAD_TOL, name)
