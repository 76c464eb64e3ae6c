"""The port's MoE over ranks (``repro_torch.models.moe``'s expert-parallel
``ep`` body, the MoE LM's training step and its sequence-sharded decode)
on the CPU, float32, held to one rank of the port and to the JAX package.

A module fixture runs a gloo group of 4 spawned ranks (mesh ``(2, 2)``)
and then one of 2 (meshes ``(1, 2)`` and ``(2, 1)``), each rank running
``tests/torch_mesh_ranks.py``'s ``moe_main``, while the JAX package's
sharded paths run on four fake devices in a subprocess
(``tests/jax_mesh_reference.py``, ``AxisType.Auto`` meshes).  The weights
are the JAX package's ``LM.init`` of the reduced ``qwen3-moe-30b-a3b``
(8 experts, top-2) and ``arctic-480b``, carried across by
``params_from_jax``.

* ``moe_apply`` over the mesh (the ``ep`` body: experts split over
  ``model``, the batch over ``data``, the global auxiliary loss) against
  one rank's ``spmd`` body on the same input: the output within 1e-6,
  ``aux`` within 1e-7, and the gradients of ``sum(out ** 2) * 1e-3 +
  aux`` (input and every weight) within ``rtol=1e-5, atol=1e-7``; and
  against JAX's ``ep`` body on its mesh within 1e-5.
* A planted fault, the routing's gradient (``aux``'s with it) counted
  ``tp`` times, must part from one rank's gradients.
* Training steps (AdamW, 2 microbatches: over ``(2, 2)`` the global
  batch's microbatches, gathered and cut again) against one rank's: the
  losses within 1e-6 relative and ``aux`` within 1e-6, every parameter
  within 1e-5 after the last step; the first loss of ``(2, 2)`` against
  JAX's ``make_train_step`` under the same mesh within 1e-5.
* The decode over a cache whose sequence axis is split over ``model``
  against one rank's at ``rtol=atol=1e-4``.
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
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.train import step as tstep
from tests import torch_mesh_ranks as R

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (4, 2)
OUT_ATOL = 1e-6
AUX_ATOL = 1e-7
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)
JAX_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-5
JAX_LOSS_RTOL = 1e-5
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
WAIT_S = 240.0
WEIGHTS = ("router", "wi", "wo", "wg")
# the JAX reference runs on one thread: beside the 6 ranks it would
# otherwise crowd the other tests' processes on a loaded machine
XLA_ONE_THREAD = ("--xla_cpu_multi_thread_eigen=false "
                  "intra_op_parallelism_threads=1")
# the training cases whose first step the JAX reference takes too
JAX_TRAIN = ("moe_22",)


def _mesh_of(tp, world):
    return (world // tp, tp)


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    cfg = R.moe_config(arch)
    jcfg = jconfigs.get_reduced(R.MOE_ARCHS[arch]).replace(
        dtype="float32", param_dtype="float32")
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return params_from_jax(jax.tree.map(np.asarray, params), cfg)


def _write_cases(work: Path) -> None:
    for arch in R.MOE_ARCHS:
        np.savez(work / f"params_moe_{arch}.npz",
                 **{k: v.numpy() for k, v in _port_params(arch).items()})
    spec = {"train": {}, "attn": {}, "decode": {}, "moe": {}}
    arrays = {}
    for world in WORLDS:
        for name, (tp, arch, _, micro) in R.MOE_TRAIN[world].items():
            if name not in JAX_TRAIN:
                continue
            spec["train"][name] = dict(
                mesh=_mesh_of(tp, world), cfg=dict(
                    arch=R.MOE_ARCHS[arch], microbatch=micro),
                opt=R.ADAMW, seq=R.SEQ, batch=R.BATCH, seed=R.SEED, steps=1)
        for name, (tp, planted) in R.MOE_EP[world].items():
            if not planted:
                spec["moe"][name] = dict(mesh=_mesh_of(tp, world),
                                         cfg=dict(arch=R.MOE_ARCHS["qwen3"]))
                arrays[f"moe/{name}/x"] = R.moe_x()
    np.savez(work / "cases.npz", spec=np.array(spec, dtype=object), **arrays)


def _start_world(world, work):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=R.moe_main, args=(rank, world, str(work)),
                         daemon=True) for rank in range(world)]
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"jax": {...}, 4: {...}, 2: {...}}``: the JAX reference's results
    and each world's rank-0 results.  The two groups run one after the
    other, the JAX subprocess (on one thread) beside the first: at most
    five single-thread processes at once, each at ``nice`` 10, so that the
    other tests' processes on a loaded machine are not crowded out."""
    work = tmp_path_factory.mktemp("moe_mesh")
    _write_cases(work)
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
        for world in WORLDS:
            codes += _join(_start_world(world, work))
        jlog, _ = jproc.communicate(timeout=WAIT_S)
    finally:
        if jproc.poll() is None:
            jproc.kill()
    errors = sorted(work.glob("error_moe*.txt"))
    assert not errors, "\n".join(e.read_text() for e in errors)
    assert codes == [0] * sum(WORLDS)
    assert jproc.returncode == 0, jlog[-3000:]
    out = {"jax": dict(np.load(jax_out))}
    for world in WORLDS:
        with open(work / f"moe{world}.pkl", "rb") as f:
            out[world] = pickle.load(f)
    return out


# ------------------------------------------------- single-rank references --

@functools.lru_cache(maxsize=None)
def _one_rank_moe():
    """The spmd body on one rank: out, aux and the gradients of
    ``sum(out ** 2) * 1e-3 + aux``."""
    cfg = R.moe_config("qwen3")
    p = tmoe.MoeParams(cfg, torch.device("cpu"), trainable=True)
    state = _port_params("qwen3")
    with torch.no_grad():
        for n in WEIGHTS:
            getattr(p, n).copy_(state[f"blocks.0.moe.{n}"])
    x = torch.from_numpy(R.moe_x()).requires_grad_()
    out, aux = tmoe.moe_apply(p, x, cfg)
    loss = (out ** 2).sum() * 1e-3 + aux
    grads = torch.autograd.grad(loss, [x] + [getattr(p, n) for n in WEIGHTS])
    res = dict(out=out.detach().numpy(), aux=float(aux),
               g_x=grads[0].numpy())
    res.update({f"g_{n}": g.numpy() for n, g in zip(WEIGHTS, grads[1:])})
    return res


EP_CASES = [(name, world) for world in WORLDS
            for name, (_, planted) in R.MOE_EP[world].items() if not planted]


@pytest.mark.parametrize("name,world", EP_CASES)
def test_ep_body_matches_one_rank_and_jax(runs, name, world):
    got, want = runs[world][name], _one_rank_moe()
    np.testing.assert_allclose(got["out"], want["out"], rtol=0,
                               atol=OUT_ATOL)
    assert abs(got["aux"] - want["aux"]) <= AUX_ATOL
    for key in ["g_x"] + [f"g_{n}" for n in WEIGHTS]:
        np.testing.assert_allclose(got[key], want[key], **GRAD_TOL,
                                   err_msg=key)
        np.testing.assert_allclose(got[key], runs["jax"][f"moe/{name}/{key}"],
                                   **JAX_TOL, err_msg=key)
    np.testing.assert_allclose(got["out"], runs["jax"][f"moe/{name}/out"],
                               **JAX_TOL)
    assert abs(got["aux"] - float(runs["jax"][f"moe/{name}/aux"])) <= 1e-6


def test_planted_aux_counted_tp_times_fails(runs):
    got, want = runs[2]["fault_12"], _one_rank_moe()
    np.testing.assert_allclose(got["out"], want["out"], rtol=0,
                               atol=OUT_ATOL)          # the forward is right
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got["g_x"], want["g_x"], **GRAD_TOL)


@functools.lru_cache(maxsize=None)
def _one_rank_train(arch, steps, micro):
    cfg = R.moe_config(arch, micro)
    model = build_model(cfg, "cpu", trainable=True)
    opt = adamw.make_optimizer(adamw.OptConfig(**R.ADAMW))
    state = tstep.init_train_state(model, opt,
                                   torch.Generator().manual_seed(0))
    model.load_state_dict(_port_params(arch))
    fn = tstep.make_train_step(model, opt)
    losses, auxes = [], []
    for b in R.batches(cfg, steps):
        state, metrics = fn(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["aux"]))
    return losses, auxes, {n: p.detach().numpy()
                           for n, p in state["params"].items()}


TRAIN_CASES = [(name, world) for world in WORLDS
               for name in R.MOE_TRAIN[world]]


@pytest.mark.parametrize("name,world", TRAIN_CASES)
def test_sharded_moe_steps_match_one_rank_and_jax(runs, name, world):
    _, arch, steps, micro = R.MOE_TRAIN[world][name]
    got = runs[world][name]
    losses, auxes, params = _one_rank_train(arch, steps, micro)
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["aux"], auxes, rtol=0, atol=1e-6)
    assert set(got["params"]) == set(params)
    assert any(".moe.wi" in n for n in params)
    for n, p in params.items():
        np.testing.assert_allclose(got["params"][n], p, rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    if name in JAX_TRAIN:
        np.testing.assert_allclose(got["losses"][0],
                                   runs["jax"][f"train/{name}"][0],
                                   rtol=JAX_LOSS_RTOL)


DECODE_CASES = [(name, world) for world in WORLDS
                for name in R.MOE_DECODE[world]]


@functools.lru_cache(maxsize=None)
def _one_rank_decode(name, prompt):
    model = build_model(R.moe_config("qwen3"), "cpu")
    model.load_state_dict(_port_params("qwen3"))
    toks = torch.from_numpy(R.decode_tokens(name))
    cache = model.init_cache(R.DECODE_TOKENS[0], R.DECODE_MAX)
    last, cache = model.prefill({"tokens": toks[:, :prompt]}, cache)
    out = [last]
    for pos in range(prompt, toks.shape[1]):
        logits, cache = model.decode_step(cache, {
            "token": toks[:, pos:pos + 1], "pos": pos})
        out.append(logits)
    return torch.stack(out, 1).numpy()


@pytest.mark.parametrize("name,world", DECODE_CASES)
def test_sequence_sharded_moe_decode_matches_one_rank(runs, name, world):
    _, prompt = R.MOE_DECODE[world][name]
    got = runs[world][name]["logits"]
    want = _one_rank_decode(name, prompt)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **LOGITS_TOL)
