"""The port's sharding rules (``repro_torch.train.sharding``) equal the JAX
package's (``repro.train.sharding``), leaf by leaf: every parameter of
every config the port builds, at reduced and full shapes, on meshes
``(1, 1)``, ``(2, 1)``, ``(1, 2)``, ``(2, 2)``, ``(1, 3)`` and ``(1, 4)``;
and ``batch_spec``, ``cache_spec`` and ``logits_sharding`` on the same
meshes.  JAX's side runs on an ``AbstractMesh`` (no devices), its
parameters from ``jax.eval_shape`` of ``LM.init``; the port's on a layout
alone (``abstract_mesh``), its model built on the ``meta`` device.  Also
the layout's arithmetic: rank coordinates, shards and local shapes,
``constrain`` as a no-op off a mesh, the decode cache's block, and the
mesh an update reads off the parameters.
"""

import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.models.model import build_model as jax_build_model
from repro.train import sharding as jsh
from repro_torch import configs
from repro_torch.models.model import build_model
from repro_torch.models.pspec import constrain, current_mesh, use_mesh
from repro_torch.models.transformer import check_supported, init_cache
from repro_torch.optim import adamw
from repro_torch.optim.compress import make_compressor
from repro_torch.parallel.mesh import param_layout
from repro_torch.train import sharding as tsh

MESHES = ((1, 1), (2, 1), (1, 2), (2, 2), (1, 3), (1, 4))


def _built(arch):
    try:
        check_supported(configs.get_config(arch))
        return True
    except NotImplementedError:
        return False


ARCHS = [a for a in configs.ARCHS if _built(a)]


def _norm(spec):
    """A spec as a tuple, a one-axis tuple entry as its name (JAX's
    ``PartitionSpec`` keeps it so)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _meshes(shape):
    names = ("data", "model")
    return (AbstractMesh(shape, names),
            tsh.abstract_mesh(dict(zip(names, shape))))


@functools.lru_cache(maxsize=None)
def _jax_leaves(arch, reduced):
    cfg = (jconfigs.get_reduced if reduced else jconfigs.get_config)(arch)
    shapes = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0))
    return [(path, leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]]


def _port_name(path):
    """The port's parameter name of a JAX leaf (layer 0 of a stacked
    block leaf) and whether the JAX leaf is stacked."""
    keys = [getattr(k, "key", getattr(k, "name", getattr(k, "idx", None)))
            for k in path]
    if keys[0] == "blocks":
        return "blocks.0." + ".".join(keys[1:]), True
    return ".".join(map(str, keys)), False


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("reduced", (True, False))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, reduced, shape):
    jmesh, tmesh = _meshes(shape)
    cfg = (configs.get_reduced if reduced else configs.get_config)(arch)
    model = build_model(cfg, device="meta")
    port = {n: tuple(p.shape) for n, p in model.named_parameters()}
    seen = set()
    for path, jshape in _jax_leaves(arch, reduced):
        want = tuple(jsh.spec_for_param(path, jshape, jmesh))
        want = want + (None,) * (len(jshape) - len(want))
        name, stacked = _port_name(path)
        if stacked:
            want = want[1:]
        names = ([name.replace("blocks.0.", f"blocks.{i}.")
                  for i in range(cfg.n_layers)] if stacked else [name])
        for n in names:
            assert n in port, n
            seen.add(n)
            got = tsh.spec_for_param(n, port[n], tmesh)
            assert _norm(got) == want, (n, got, want)
        assert tsh.spec_for_param(name, port[name], tmesh) == \
            tsh.param_shardings({name: torch.empty(port[name],
                                                   device="meta")},
                                tmesh)[name]
    assert seen == set(port)


@pytest.mark.parametrize("shape", MESHES)
def test_activation_specs_equal_jax(shape):
    jmesh, tmesh = _meshes(shape)
    for name, leaf in (("tokens", (8, 16)), ("labels", (3, 16)),
                       ("token", (2, 1)), ("positions", (3, 4, 16)),
                       ("embeds", (4, 16, 64)), ("pos", ()),
                       ("other", (5, 7))):
        assert _norm(tsh.batch_spec(name, leaf, tmesh)) == tuple(
            jsh.batch_spec(name, leaf, jmesh)), name
    for name, leaf in (("k", (2, 4, 64, 2, 16)), ("v", (2, 3, 64, 2, 16)),
                       ("xk", (2, 4, 30, 2, 16)),
                       ("wkv", (2, 4, 6, 8, 8)), ("ssm", (2, 4, 8, 4, 16)),
                       ("tm_x", (2, 4, 64)), ("other", (1, 2))):
        assert _norm(tsh.cache_spec(name, leaf, tmesh)) == tuple(
            jsh.cache_spec(name, leaf, jmesh)), name
    for batch, vocab in ((4, 384), (3, 151936), (4, 32001), (2, None)):
        assert _norm(tsh.logits_sharding(tmesh, batch, vocab)) == tuple(
            jsh.logits_sharding(jmesh, batch, vocab).spec)
    batch = {"tokens": torch.zeros(4, 16), "labels": torch.zeros(4, 16)}
    assert {k: _norm(v) for k, v in tsh.batch_shardings(batch, tmesh
                                                        ).items()} == {
        k: tuple(jsh.batch_spec(k, v.shape, jmesh)) for k, v in batch.items()}
    cache = {"k": torch.zeros(2, 4, 64, 2, 16)}
    assert _norm(tsh.cache_shardings(cache, tmesh)["k"]) == tuple(
        jsh.cache_spec("k", (2, 4, 64, 2, 16), jmesh))
    assert tsh.mesh_axes(tmesh) == jsh.mesh_axes(jmesh)


def test_mesh_layout_and_shards():
    """Rank-major coordinates, a rank's block of a tensor and its shape,
    and the spec's axes."""
    mesh = tsh.Mesh({"data": 2, "model": 3}, rank=4)
    assert mesh.coords == {"data": 1, "model": 1}
    assert mesh.axis_size(("data", "model")) == 6
    assert mesh.axis_index(("data", "model")) == 4
    x = torch.arange(4 * 6).reshape(4, 6)
    spec = (("data",), "model")
    assert tsh.local_shape((4, 6), spec, mesh) == (2, 2)
    assert torch.equal(tsh.shard(x, spec, mesh), x[2:4, 2:4])
    assert tsh.shard(x, (None, None), mesh) is x
    assert tsh.spec_axes(spec) == ("data", "model")
    with pytest.raises(ValueError, match="split"):
        tsh.local_shape((5, 6), spec, mesh)
    with pytest.raises(RuntimeError, match="layout alone"):
        mesh.group("model")
    with pytest.raises(ValueError):
        tsh.Mesh({"data": 2}, rank=2)


def test_constrain_is_a_no_op_off_a_mesh():
    x = torch.randn(4, 6)
    assert constrain(x, "B", "T") is x
    assert current_mesh() is None
    layout = tsh.abstract_mesh({"data": 2, "model": 2})
    with use_mesh(layout):
        assert current_mesh() is layout
        assert constrain(x, "B", "T") is x       # a layout holds no group
    assert current_mesh() is None


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("batch", (1, 4))
def test_init_cache_is_this_ranks_block_of_cache_spec(shape, batch):
    """``LM.init_cache`` over a mesh holds this rank's block of the cache
    as ``cache_spec`` lays it out (the models cut it without importing
    the rules)."""
    cfg = configs.get_reduced("qwen2.5-3b")
    for rank in range(shape[0] * shape[1]):
        mesh = tsh.Mesh(dict(zip(("data", "model"), shape)), rank)
        cache = init_cache(cfg, batch, 24, torch.device("meta"), mesh)
        whole = (cfg.n_layers, batch, 24, cfg.n_kv_heads, cfg.hd)
        assert tuple(cache["k"].shape) == tsh.local_shape(
            whole, tsh.cache_spec("k", whole, mesh), mesh)


def _sharded_params(spec=(None,), mesh=None):
    p = torch.nn.Parameter(torch.zeros(4))
    p.spec = spec
    if mesh is not None:
        p.mesh = mesh
    return {"w": p}


def test_param_layout_reads_the_mesh_off_the_parameters():
    mesh = tsh.abstract_mesh({"data": 1, "model": 2})
    got_mesh, specs = param_layout(_sharded_params(("model",), mesh))
    assert got_mesh is mesh and specs == {"w": ("model",)}
    assert param_layout({"w": torch.zeros(3)}) == (None, {"w": None})
    other = {**_sharded_params(mesh=mesh),
             "v": _sharded_params(mesh=tsh.abstract_mesh(
                 {"data": 1, "model": 2}))["w"]}
    with pytest.raises(ValueError, match="one mesh"):
        param_layout(other)


@pytest.mark.parametrize("kind", ("adamw", "adafactor", "compress"))
def test_an_update_of_shards_with_no_mesh_raises(kind):
    """Parameters that carry a spec but no mesh would be updated with
    per-shard norms and statistics: the optimizers and the compressor
    refuse them."""
    params = _sharded_params(("model",))
    grads = {"w": torch.ones(4)}
    with pytest.raises(ValueError, match="no mesh"):
        if kind == "compress":
            make_compressor()(grads, {}, params)
        else:
            opt = adamw.make_optimizer(adamw.OptConfig(kind=kind))
            opt.update(params, grads, opt.init(params))
