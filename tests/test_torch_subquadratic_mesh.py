"""RWKV trained over a training mesh (``repro_torch.models.linear_attn``'s
routes, ``.rwkv`` over ``model``) on the CPU, float32, held to one rank of
the port and to the JAX package's mesh runs; Hymba's are
``tests/test_torch_subquadratic_mesh_hymba.py``'s and their decode
``tests/test_torch_subquadratic_mesh_decode.py``'s, which share this
file's fixture helpers.

A module fixture (:func:`mesh_runs`) runs a gloo group of 4 spawned ranks
(meshes ``(2, 2)`` and ``(1, 4)``) and then one of 2 (the launcher), each
rank running ``tests/torch_mesh_ranks.py``'s ``subq_main`` at ``nice``
10, while the JAX package's sharded paths run on four fake devices in a
one-thread subprocess (``tests/jax_mesh_reference.py``, ``AxisType.Auto``
meshes).  The weights are the JAX package's ``LM.init`` with every
constant parameter perturbed (``tests/test_torch_subquadratic.py``'s
``perturbed``: with ``decay_base`` -2, ``ln_x`` 1, ``u_bonus`` 0 and
``d_skip`` 1 a rank reading another rank's slice of them would pass
unseen; ``a_log`` by ``SUBQ_NOISE_A_LOG``, below which the JAX package's
Hymba gradients stay finite at S = 256), carried across by
``params_from_jax``.  Every run is float32 at S = 256, where the 4
chunks of 64 divide 4 ranks.

* Training, 2 AdamW steps of 4 x 256: reduced ``rwkv6-1.6b`` at ``(2,
  2)`` and ``(1, 4)`` (the ``"heads"`` route).  The losses within 1e-6
  relative of one rank's and 1e-5 of JAX's run on the same mesh
  (``tests/test_torch_train_mesh.py``'s bars), every parameter within
  ``PARAM_ATOL`` of both and their mean difference within
  ``PARAM_MEAN_ATOL`` (:func:`check_params` says why).
* The routes the cases take, and the decode cache over a mesh: every
  entry this rank's block of ``cache_spec``.
* ``launch/train.py --arch rwkv6-1.6b --reduced --model-axis 2`` over 2
  ranks: finite losses, one rank's within bf16's rounding of the ranks'
  partial sums.
"""

import functools
import multiprocessing
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.model import build_model as jax_build_model
from repro_torch.launch import train as launcher
from repro_torch.models.convert import params_from_jax
from repro_torch.models.linear_attn import linear_attention_route
from repro_torch.models.model import build_model
from repro_torch.models.transformer import init_cache
from repro_torch.optim import adamw
from repro_torch.train import sharding as tsh
from repro_torch.train import step as tstep
from tests import torch_mesh_ranks as R
from tests.test_torch_subquadratic import NOISE, perturbed

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-6
JAX_LOSS_RTOL = 1e-5
# tests/test_torch_train_mesh.py holds every parameter within 1e-5 after
# AdamW steps at 16 tokens.  At 256 (1,024 tokens a sum) the ranks' float32
# sums part from one rank's by about 1e-7 in gradients whose size is near
# AdamW's eps (1e-6), and the first step's update, lr g / (|g| + eps),
# magnifies such a difference up to lr / (4 eps) = 250 times: 1 element in
# 10^5 reads 1.4e-5 to 1.7e-5 against one rank and against JAX.  A rank
# that sums a gradient tp times, or keeps 1/tp of it, moves nearly every
# element by about lr = 1e-3, which both bars below catch.
PARAM_ATOL = 5e-5
PARAM_MEAN_ATOL = 1e-7
# the launcher runs in bf16: the ranks sum partial products in another
# order than one rank, and bf16 rounds each sum (phase 18 (c) reads its
# first loss within 2e-2 of one rank's at full size)
LAUNCH_RTOL = 2e-2
WAIT_S = 240.0
XLA_ONE_THREAD = ("--xla_cpu_multi_thread_eigen=false "
                  "intra_op_parallelism_threads=1")


def _mesh_of(tp, world=4):
    return (world // tp, tp)


def _jcfg(variant):
    arch, kw = R.SUBQ_VARIANTS[variant]
    return jconfigs.get_reduced(arch).replace(
        dtype="float32", param_dtype="float32", **kw)


@functools.lru_cache(maxsize=None)
def _jax_params(variant, perturb=True, a_log=R.SUBQ_NOISE_A_LOG):
    params = jax.tree.map(np.asarray, jax_build_model(_jcfg(variant)).init(
        jax.random.PRNGKey(0)))
    if not perturb:
        return params
    return perturbed(params, np.random.default_rng(7),
                     dict(NOISE, a_log=a_log))


def _port_params(variant, perturb=True):
    return params_from_jax(_jax_params(variant, perturb),
                           R.subq_config(variant))


def _leaf_arrays(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _write_cases(work: Path, part: str) -> None:
    spec = {"train": {}, "decode": {}}
    arrays = {}
    for variant in R.SUBQ_VARIANTS:
        np.savez(work / f"params_subq_{variant}.npz",
                 **{k: v.numpy() for k, v in _port_params(variant).items()})
        arrays.update({f"params/{variant}/{k}": v for k, v in
                       _leaf_arrays(_jax_params(variant)).items()})
    if part != "decode":
        for name, (tp, variant) in R.subq_part(part)[0].items():
            arch, kw = R.SUBQ_VARIANTS[variant]
            spec["train"][name] = dict(
                mesh=_mesh_of(tp), cfg=dict(arch=arch, **kw), opt=R.ADAMW,
                seq=R.SUBQ_SEQ, batch=R.BATCH, seed=R.SEED,
                steps=R.SUBQ_STEPS, params=variant)
    if part == "decode":
        for name, (tp, variant, _) in R.SUBQ_DECODE.items():
            arch, kw = R.SUBQ_VARIANTS[variant]
            spec["decode"][name] = dict(mesh=_mesh_of(tp),
                                        cfg=dict(arch=arch, **kw),
                                        max_len=R.SUBQ_DECODE_MAX,
                                        params=variant)
            arrays[f"decode/{name}/tokens"] = R.subq_tokens(name)
    np.savez(work / "cases.npz", spec=np.array(spec, dtype=object), **arrays)


def _start_world(world, work, part):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=R.subq_main,
                         args=(rank, world, str(work), part), daemon=True)
             for rank in range(world)]
    prev = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for p in procs:
            p.start()
    finally:
        if prev is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = prev
    return procs


def _join(procs):
    try:
        for p in procs:
            p.join(WAIT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    return [p.exitcode for p in procs]


def mesh_runs(work: Path, part: str, worlds) -> dict:
    """``{"jax": {...}, world: {...}}``: the JAX reference's results for
    ``part``'s cases and each world's rank-0 results.  The groups run one
    after the other, the JAX subprocess (one thread) beside the first: at
    most five single-thread processes at once, each at ``nice`` 10."""
    _write_cases(work, part)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        XLA_FLAGS=XLA_ONE_THREAD)
    jax_out = work / "jax.npz"
    jproc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_mesh_reference.py"),
         str(work / "cases.npz"), str(jax_out)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        preexec_fn=lambda: os.nice(10))
    codes = []
    try:
        for world in worlds:
            codes += _join(_start_world(world, work, part))
        jlog, _ = jproc.communicate(timeout=WAIT_S)
    finally:
        if jproc.poll() is None:
            jproc.kill()
    errors = sorted(work.glob("error_subq*.txt"))
    assert not errors, "\n".join(e.read_text() for e in errors)
    assert codes == [0] * sum(worlds)
    assert jproc.returncode == 0, jlog[-3000:]
    out = {"jax": dict(np.load(jax_out))}
    for world in worlds:
        with open(work / f"subq{world}.pkl", "rb") as f:
            out[world] = pickle.load(f)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(tmp_path_factory.mktemp("subq_mesh"), "rwkv", (4, 2))


# ------------------------------------------------- single-rank references --

@functools.lru_cache(maxsize=None)
def _one_rank_train(variant):
    cfg = R.subq_config(variant)
    model = build_model(cfg, "cpu", trainable=True)
    model.load_state_dict(_port_params(variant))
    opt = adamw.make_optimizer(adamw.OptConfig(**R.ADAMW))
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    fn = tstep.make_train_step(model, opt)
    losses = []
    for b in R.subq_batches(cfg):
        state, metrics = fn(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    return losses, {n: p.detach().numpy()
                    for n, p in state["params"].items()}


def _jax_trained(runs, name, variant):
    """JAX's parameters after ``name``'s steps, by the port's names."""
    prefix = f"train/{name}/param/"
    leaves = {k[len(prefix):]: v for k, v in runs["jax"].items()
              if k.startswith(prefix)}
    shapes = jax.eval_shape(jax_build_model(_jcfg(variant)).init,
                            jax.random.PRNGKey(0))
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    tree = jax.tree_util.tree_unflatten(
        treedef, [leaves[jax.tree_util.keystr(p)] for p, _ in paths])
    return {n: t.numpy() for n, t in params_from_jax(
        tree, R.subq_config(variant)).items()}


def check_params(got, want):
    """Every parameter of ``want`` within ``PARAM_ATOL`` of ``got``'s, and
    the mean absolute difference over all of them within
    ``PARAM_MEAN_ATOL``."""
    assert set(got) == set(want)
    total = count = 0.0
    for n, p in want.items():
        assert got[n].shape == p.shape, n
        np.testing.assert_allclose(got[n], p, rtol=0, atol=PARAM_ATOL,
                                   err_msg=n)
        total += float(np.abs(got[n] - p).sum())
        count += p.size
    assert total / count <= PARAM_MEAN_ATOL


def check_one_rank(runs, name):
    """``name``'s mesh steps against one rank's: losses and parameters."""
    _, variant = R.SUBQ_TRAIN[name]
    got = runs[4][name]
    losses, params = _one_rank_train(variant)
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    check_params(got["params"], params)


def check_jax(runs, name):
    """``name``'s mesh steps against JAX's on the same mesh."""
    _, variant = R.SUBQ_TRAIN[name]
    got = runs[4][name]
    np.testing.assert_allclose(got["losses"], runs["jax"][f"train/{name}"],
                               rtol=JAX_LOSS_RTOL)
    check_params(got["params"], _jax_trained(runs, name, variant))


def check_moved(runs, name):
    """The steps moved every parameter past ten times the bar the
    comparisons hold, so a gradient lost on one rank would show."""
    _, variant = R.SUBQ_TRAIN[name]
    start = _port_params(variant)
    for n, p in runs[4][name]["params"].items():
        assert np.abs(p - start[n].numpy()).max() > 10 * PARAM_ATOL, n


TRAIN_CASES = sorted(R.subq_part("rwkv")[0])


def test_the_cases_take_the_routes_they_name():
    """The 5-head Hymba's SSM takes the chunks route on 4 ranks at S =
    256 (not at 128: 2 chunks), the reduced models the heads route."""
    for name, (tp, variant) in R.SUBQ_TRAIN.items():
        cfg = R.subq_config(variant)
        h = (cfg.d_model // cfg.rwkv_head_dim if cfg.block == "rwkv"
             else cfg.ssm_heads)
        want = "chunks" if variant == "hymba5" and tp == 4 else "heads"
        assert linear_attention_route(h, R.SUBQ_SEQ, tp) == want, name
    assert linear_attention_route(5, 128, 4) == "replicated"
    assert linear_attention_route(25, 2048, 2) == "chunks"
    assert linear_attention_route(32, 2048, 2) == "heads"
    assert linear_attention_route(25, 1, 2) == "replicated"


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_mesh_steps_match_one_rank(runs, name):
    check_one_rank(runs, name)


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_mesh_steps_match_jax_on_the_mesh(runs, name):
    check_jax(runs, name)


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_the_steps_moved_every_parameter(runs, name):
    check_moved(runs, name)


@pytest.mark.parametrize("variant", ("rwkv", "hymba", "hymba5"))
@pytest.mark.parametrize("shape", ((2, 2), (1, 4), (1, 2)))
def test_init_cache_is_this_ranks_block_of_cache_spec(variant, shape):
    """Over a mesh every entry of the recurrent caches is this rank's block
    as ``cache_spec`` lays it out: heads over ``model`` where they divide
    it, the batch over ``data``."""
    cfg = R.subq_config(variant)
    whole = init_cache(cfg, 4, 16, torch.device("meta"))
    for rank in range(shape[0] * shape[1]):
        mesh = tsh.Mesh(dict(zip(("data", "model"), shape)), rank)
        cache = init_cache(cfg, 4, 16, torch.device("meta"), mesh)
        assert set(cache) == set(whole)
        for name, t in whole.items():
            want = tsh.local_shape(t.shape, tsh.cache_spec(
                name, tuple(t.shape), mesh), mesh)
            assert tuple(cache[name].shape) == want, (name, rank)


def test_launcher_trains_rwkv_over_two_ranks(runs):
    got = runs[2]["launch"]
    want = launcher.run(R.SUBQ_LAUNCH_ARGV)
    assert len(got) == 3 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=LAUNCH_RTOL)
