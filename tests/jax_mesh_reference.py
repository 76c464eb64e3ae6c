"""The JAX package's sharded paths on four fake CPU devices, for
``tests/test_torch_train_mesh.py``: run as a script (XLA's device count is
set before jax starts), it reads the cases from an ``.npz`` and writes the
JAX results to another.

    python tests/jax_mesh_reference.py cases.npz out.npz

Flags in the caller's ``XLA_FLAGS`` are kept beside the device count (a
test passes single-thread flags so that the subprocess does not crowd the
other tests' processes).

Every mesh is built with ``AxisType.Auto`` axes, as
``tests/test_perf_features.py`` builds its mesh: under the ``Explicit``
axes ``jax.make_mesh`` gives by default, the package's
``with_sharding_constraint`` calls act as assertions and its launcher's
multi-device path stops (``src/repro/models/pspec.py:33``).  The package
itself is not edited.

* ``train/<name>``: the losses of ``make_train_step`` under ``jax.jit``,
  the parameters placed by ``param_shardings`` and each batch by
  ``batch_shardings`` (the reduced qwen2.5-3b in float32, or a variant);
  a case that names ``params`` starts from the weights stored under
  ``params/<that name>/<leaf path>`` (``init_params``) in place of
  ``LM.init``; the parameters after the last step are
  ``train/<name>/param/<leaf path>``.  The RWKV and
  Hymba cases run the reference's ``_chunk_mesh`` route where the chunk
  count ``n = S / 64`` divides ``model`` (``src/repro/models/
  linear_attn.py:30-50``): at ``model`` = 4 that needs S >= 256, since at
  S = 128 its 2 chunks fall back to the replicated path unseen.
* ``attn/<name>``: ``sharded_attention`` on the case's q, k, v.
* ``decode/<name>``: the logits of ``make_decode_step(model, mesh)`` at
  every position of the case's tokens, the cache placed by
  ``cache_shardings`` (its sequence axis over ``model``; RWKV's and
  Hymba's recurrent states over heads where they divide it), from the
  case's ``params`` where it names them.
* ``encdec/<name>``: an encoder-decoder's (Whisper's) prefill of the
  case's ``frames`` and first ``prompt`` tokens on the mesh, its cache
  padded to ``max_len`` and placed by ``cache_shardings``, then
  ``make_decode_step(model, mesh)`` at each later position: the
  prefill's last logits and each step's.  A ``train`` case of an
  encoder-decoder adds ``frames/<name>`` to every batch.
* ``moe/<name>/*``: ``moe_apply`` on the case's input under the mesh
  (the expert-parallel ``ep`` body where ``model`` divides the experts),
  layer 0's MoE weights of the case's config: the output, the auxiliary
  loss, and the gradients of ``sum(out ** 2) * 1e-3 + aux`` with respect
  to the input and each weight (``test_moe_ep_grads_match_spmd``'s
  loss).

A case's ``cfg`` may name another reduced config than ``ARCH`` under
``arch`` (the MoE cases: ``qwen3-moe-30b-a3b``, ``arctic-480b``; the
sub-quadratic ones: ``rwkv6-1.6b``, ``hymba-1.5b``, and a Hymba of 5 heads
given as config changes beside it).
"""

import os
import sys

os.environ["XLA_FLAGS"] = " ".join(
    ["--xla_force_host_platform_device_count=4"]
    + [f for f in os.environ.get("XLA_FLAGS", "").split()
       if not f.startswith("--xla_force_host_platform_device_count")])
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro.models.attention import sharded_attention  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.models.moe import moe_apply  # noqa: E402
from repro.optim import adamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.sharding import (batch_shardings, cache_shardings,  # noqa
                                  param_shardings)

ARCH = "qwen2.5-3b"


def make_mesh(shape):
    n = int(np.prod(shape))
    return jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])


def config(kw):
    kw = dict(kw)
    arch = kw.pop("arch", ARCH)
    return configs.get_reduced(arch).replace(dtype="float32",
                                             param_dtype="float32", **kw)


def leaf_paths(tree):
    """``{path: leaf}`` of a parameter tree, paths as ``jax.tree_util
    .keystr`` spells them."""
    return {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def init_params(model, arrays=None, name=None):
    """``LM.init(PRNGKey(0))``, or, with ``name``, the same tree holding
    ``arrays[f"params/{name}/{path}"]``."""
    if name is None:
        return model.init(jax.random.PRNGKey(0))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(arrays[f"params/{name}/{jax.tree_util.keystr(p)}"])
        for p, _ in paths])


def train(mesh_shape, cfg_kw, opt_kw, batches, arrays=None, params=None):
    cfg = config(cfg_kw)
    model = build_model(cfg)
    opt = adamw.make_optimizer(adamw.OptConfig(**opt_kw))
    mesh = make_mesh(mesh_shape)
    with jax.sharding.set_mesh(mesh):
        params = init_params(model, arrays, params)
        params = jax.device_put(params, param_shardings(params, mesh))
        state = {"params": params, "opt": opt.init(params)}
        fn = jax.jit(jstep.make_train_step(model, opt))
        losses = []
        for b in batches:
            b = {k: jnp.asarray(v) for k, v in b.items()}
            b = jax.device_put(b, batch_shardings(b, mesh))
            state, metrics = fn(state, b)
            losses.append(float(metrics["loss"]))
    return np.asarray(losses, np.float64), {
        k: np.asarray(v) for k, v in leaf_paths(state["params"]).items()}


def encdec_decode(mesh_shape, cfg_kw, frames, tokens, prompt, max_len):
    cfg = config(cfg_kw)
    model = build_model(cfg)
    mesh = make_mesh(mesh_shape)
    with jax.sharding.set_mesh(mesh):
        params = model.init(jax.random.PRNGKey(0))
        params = jax.device_put(params, param_shardings(params, mesh))
        last, cache = jax.jit(model.prefill)(params, {
            "frames": jnp.asarray(frames),
            "tokens": jnp.asarray(tokens[:, :prompt])})
        cache = {k: np.pad(np.asarray(v), [(0, 0), (0, 0), (0, max_len
                                                            - v.shape[2]),
                                           (0, 0), (0, 0)])
                 if k in ("k", "v") else np.asarray(v)
                 for k, v in cache.items()}
        cache = jax.device_put(cache, cache_shardings(cache, mesh))
        step = jax.jit(jstep.make_decode_step(model, mesh=mesh))
        out = [np.asarray(last)]
        for pos in range(prompt, tokens.shape[1]):
            logits, cache = step(params, cache, {
                "token": jnp.asarray(tokens[:, pos:pos + 1]),
                "pos": jnp.int32(pos)})
            out.append(np.asarray(logits))
    return np.stack(out, axis=1)


def attention(mesh_shape, q, k, v, causal, chunk):
    mesh = make_mesh(mesh_shape)
    with jax.sharding.set_mesh(mesh):
        out = jax.jit(lambda q, k, v: sharded_attention(
            q, k, v, causal=causal, chunk=chunk))(q, k, v)
    return np.asarray(out)


def decode(mesh_shape, cfg_kw, tokens, max_len, arrays=None, params=None):
    cfg = config(cfg_kw)
    model = build_model(cfg)
    mesh = make_mesh(mesh_shape)
    b = tokens.shape[0]
    out = []
    with jax.sharding.set_mesh(mesh):
        params = init_params(model, arrays, params)
        params = jax.device_put(params, param_shardings(params, mesh))
        cache = model.init_cache(b, max_len)
        cache = jax.device_put(cache, cache_shardings(cache, mesh))
        step = jax.jit(jstep.make_decode_step(model, mesh=mesh))
        for pos in range(tokens.shape[1]):
            logits, cache = step(params, cache, {
                "token": jnp.asarray(tokens[:, pos:pos + 1]),
                "pos": jnp.int32(pos)})
            out.append(np.asarray(logits))
    return np.stack(out, axis=1)


def moe(mesh_shape, cfg_kw, x):
    cfg = config(cfg_kw)
    mesh = make_mesh(mesh_shape)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    p = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])

    def loss(p, x):
        o, a = moe_apply(p, x, cfg)
        return jnp.sum(o ** 2) * 1e-3 + a, (o, a)

    with jax.sharding.set_mesh(mesh):
        (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    res = {"out": np.asarray(out), "aux": np.asarray(aux),
           "g_x": np.asarray(gx)}
    for name in ("router", "wi", "wo", "wg"):
        res[f"g_{name}"] = np.asarray(getattr(gp, name))
    return res


def main(cases_path, out_path):
    cases = np.load(cases_path, allow_pickle=True)
    spec = cases["spec"].item()
    out = {}
    for name, c in spec["train"].items():
        batches = [SyntheticCorpus(DataConfig(
            vocab=config(c["cfg"]).vocab, seq_len=c["seq"],
            global_batch=c["batch"], seed=c["seed"])).batch(i)
            for i in range(c["steps"])]
        if f"frames/{name}" in cases:
            batches = [dict(b, frames=cases[f"frames/{name}"])
                       for b in batches]
        out[f"train/{name}"], kept = train(c["mesh"], c["cfg"], c["opt"],
                                           batches, cases, c.get("params"))
        out.update({f"train/{name}/param/{k}": v for k, v in kept.items()})
    for name, c in spec.get("attn", {}).items():
        out[f"attn/{name}"] = attention(
            c["mesh"], *(cases[f"attn/{name}/{t}"] for t in "qkv"),
            c["causal"], c["chunk"])
    for name, c in spec.get("moe", {}).items():
        for key, a in moe(c["mesh"], c["cfg"], cases[f"moe/{name}/x"]
                          ).items():
            out[f"moe/{name}/{key}"] = a
    for name, c in spec.get("encdec", {}).items():
        out[f"encdec/{name}"] = encdec_decode(
            c["mesh"], c["cfg"], cases[f"encdec/{name}/frames"],
            cases[f"encdec/{name}/tokens"], c["prompt"], c["max_len"])
    for name, c in spec.get("decode", {}).items():
        out[f"decode/{name}"] = decode(c["mesh"], c["cfg"],
                                       cases[f"decode/{name}/tokens"],
                                       c["max_len"], cases, c.get("params"))
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
