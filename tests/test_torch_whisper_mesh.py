"""Whisper's encoder-decoder over a training mesh (``EncDecLM.shard_``,
the encoder's and decoder's attentions and the cross-attention over
``model``, the sequence-split decode) on the CPU, float32, held to one
rank of the port and to the JAX package's mesh runs.

A module fixture (:func:`runs`) runs a gloo group of 4 spawned ranks
(meshes ``(2, 2)`` and ``(1, 4)``) and then one of 2 (mesh ``(1, 2)``,
and the launcher), each rank running ``tests/torch_mesh_ranks.py``'s
``whisper_main`` at ``nice`` 10, while the JAX package's sharded paths run
on four fake devices in two one-thread subprocesses
(``tests/jax_mesh_reference.py``, ``AxisType.Auto`` meshes).  The weights
are the JAX package's ``EncDecLM.init``, carried across by
``params_from_jax``; the stub frames are one seeded ``[4, 64, 64]`` array
for every step.

* Training, 3 AdamW steps (``eps`` 1e-6) of 4 x 16 tokens: the reduced
  ``whisper-base`` (4 heads of 16: the ``"heads"`` route) at ``(2, 2)``
  in 2 microbatches, at ``(1, 4)`` and at ``(1, 2)``; 6 heads at ``(1,
  4)`` (every attention on the ``"sequence"`` route); a vocab of 385 at
  ``(2, 2)`` (the tied head replicated, as whisper-base's 51,865 is over
  2 or 4).  The losses within 1e-6 relative of one rank's and every
  parameter within 1e-5 (``tests/test_torch_train_mesh.py``'s bars); the
  reduced model's at ``(2, 2)`` and ``(1, 4)`` also within 1e-5 of JAX's
  run on the same mesh, losses and parameters.
* Prefill and the sequence-split decode over ``(1, 2)`` and ``(1, 4)``
  (and the 6-head variant over ``(1, 4)``): a prompt of 6 into a cache of
  16, then decode steps through position 11, crossing into rank 1's half
  (rank 2's quarter) at position 8; every logit within ``LOGITS_TOL`` of
  one rank's and of JAX's ``make_decode_step(model, mesh)`` from its
  prefilled cache.
* ``init_cache`` over ``(1, 2)``, ``(2, 1)``, ``(2, 2)`` and ``(1, 4)``:
  each rank's block of ``cache_spec``, ``xk``/``xv`` included.
* The launcher (``--arch whisper-base --reduced``, float32) over 2 ranks
  at model axes 2 and 1 (the second cuts the stub frames over 2 data
  ranks) against one rank's losses.
* The ``(1, 2)`` run's state, checkpointed over the mesh and restored on
  one rank: every parameter bit for bit.
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
from repro_torch.checkpoint import store
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.launch import train as launcher
from repro_torch.models.attention import attention_route
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.models.transformer import init_cache
from repro_torch.optim import adamw
from repro_torch.train import sharding as tsh
from repro_torch.train import step as tstep
from tests import torch_mesh_ranks as R

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-5
JAX_LOSS_RTOL = 1e-5
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
LAUNCH_RTOL = 1e-5
WAIT_S = 240.0
XLA_ONE_THREAD = ("--xla_cpu_multi_thread_eigen=false "
                  "intra_op_parallelism_threads=1")
TRAIN = dict(R.WHISPER_TRAIN, whisper_12=R.WHISPER_CKPT)
# the training cases the JAX package runs on the same mesh: the reduced
# model at (2, 2) and (1, 4); each compiles for about 15 s on one thread,
# and the variants are held to one rank
JAX_TRAIN = ("whisper_22", "whisper_14")
JAX_PARTS = ("train", "encdec")
DECODE = {**R.WHISPER_DECODE[2], **R.WHISPER_DECODE[4]}


def _mesh_of(tp, name):
    world = 2 if name.endswith("_12") else 4
    return (world // tp, tp)


def _jcfg(variant, microbatch=1):
    return jconfigs.get_reduced("whisper-base").replace(
        dtype="float32", param_dtype="float32", microbatch=microbatch,
        **R.WHISPER_VARIANTS[variant])


@functools.lru_cache(maxsize=None)
def _jax_params(variant):
    return jax.tree.map(np.asarray, jax_build_model(_jcfg(variant)).init(
        jax.random.PRNGKey(0)))


def _port_params(variant):
    return params_from_jax(_jax_params(variant), R.whisper_config(variant))


def _write_cases(work: Path) -> None:
    for variant in R.WHISPER_VARIANTS:
        np.savez(work / f"params_{variant}.npz",
                 **{k: v.numpy() for k, v in _port_params(variant).items()})
    spec = {"train": {}, "encdec": {}}
    arrays = {}
    for name in JAX_TRAIN:
        tp, variant, micro = TRAIN[name]
        cfg = R.whisper_config(variant)
        spec["train"][name] = dict(
            mesh=_mesh_of(tp, name), opt=R.ADAMW, seq=R.SEQ, batch=R.BATCH,
            seed=R.SEED, steps=R.WHISPER_STEPS, cfg=dict(
                arch="whisper-base", microbatch=micro,
                **R.WHISPER_VARIANTS[variant]))
        arrays[f"frames/{name}"] = R.whisper_frames(cfg)
    for name, (tp, variant, prompt) in DECODE.items():
        cfg = R.whisper_config(variant)
        spec["encdec"][name] = dict(
            mesh=_mesh_of(tp, name), prompt=prompt,
            max_len=R.WHISPER_DECODE_MAX, cfg=dict(
                arch="whisper-base", **R.WHISPER_VARIANTS[variant]))
        arrays[f"encdec/{name}/frames"] = R.whisper_frames(
            cfg, R.WHISPER_DECODE_TOKENS[0])
        arrays[f"encdec/{name}/tokens"] = R.whisper_tokens(name, cfg.vocab)
    for part in JAX_PARTS:        # the training cases apart from the rest
        np.savez(work / f"cases_{part}.npz", spec=np.array(
            {k: v if k == part else {} for k, v in spec.items()},
            dtype=object), **arrays)


def _start_jax(work, env, part):
    return subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_mesh_reference.py"),
         str(work / f"cases_{part}.npz"), str(work / f"jax_{part}.npz")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, preexec_fn=lambda: os.nice(10))


def _start_world(world, work):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=R.whisper_main, args=(rank, world, str(work)),
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
    """``{"jax": {...}, 4: {...}, 2: {...}, "work": path}``: the JAX
    reference's results and each world's rank-0 results.  The groups run
    one after the other, two JAX subprocesses (one thread each: the
    training cases, the decode cases) beside them: at most six
    single-thread processes at once, each at ``nice`` 10."""
    work = tmp_path_factory.mktemp("whisper_mesh")
    _write_cases(work)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        XLA_FLAGS=XLA_ONE_THREAD)
    jprocs = [_start_jax(work, env, part) for part in JAX_PARTS]
    codes, jlogs = [], []
    try:
        for world in (4, 2):
            codes += _join(_start_world(world, work))
        jlogs = [p.communicate(timeout=WAIT_S)[0] for p in jprocs]
    finally:
        for p in jprocs:
            if p.poll() is None:
                p.kill()
    errors = sorted(work.glob("error_whisper*.txt"))
    assert not errors, "\n".join(e.read_text() for e in errors)
    assert codes == [0] * 6
    for p, log in zip(jprocs, jlogs):
        assert p.returncode == 0, log[-3000:]
    out = {"jax": {}, "work": work}
    for part in JAX_PARTS:
        out["jax"].update(np.load(work / f"jax_{part}.npz"))
    for world in (4, 2):
        with open(work / f"whisper{world}.pkl", "rb") as f:
            out[world] = pickle.load(f)
    return out


def _got(runs, name):
    return runs[2 if name.endswith("_12") else 4][name]


# ------------------------------------------------- single-rank references --

def _one_rank_model(variant, trainable=False, microbatch=1):
    model = build_model(R.whisper_config(variant, microbatch), "cpu",
                        trainable=trainable)
    model.load_state_dict(_port_params(variant))
    return model


@functools.lru_cache(maxsize=None)
def _one_rank_train(variant, microbatch):
    model = _one_rank_model(variant, True, microbatch)
    opt = adamw.make_optimizer(adamw.OptConfig(**R.ADAMW))
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    fn = tstep.make_train_step(model, opt)
    losses = []
    for b in R.whisper_batches(model.cfg):
        state, metrics = fn(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    return losses, {n: p.detach().numpy()
                    for n, p in state["params"].items()}


def _one_rank_decode(name):
    _, variant, prompt = DECODE[name]
    model = _one_rank_model(variant)
    cfg = model.cfg
    logits = R.whisper_decode_logits(
        model, torch.from_numpy(R.whisper_frames(
            cfg, R.WHISPER_DECODE_TOKENS[0])),
        torch.from_numpy(R.whisper_tokens(name, cfg.vocab)), prompt,
        tstep.make_decode_step(model))
    return logits.numpy()


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
        tree, R.whisper_config(variant)).items()}


def _check_params(got, want):
    assert set(got) == set(want)
    for n, p in want.items():
        assert got[n].shape == p.shape, n
        np.testing.assert_allclose(got[n], p, rtol=0, atol=PARAM_ATOL,
                                   err_msg=n)


# ------------------------------------------------------------------ tests --

def test_the_cases_take_the_routes_they_name():
    """At (1, 4) the 6-head variant's encoder (64 frames), decoder (16
    tokens) and cross-attention (16 query rows) take the sequence route,
    the 4-head model's the heads route; one decode row takes the heads
    route or none; the tied head is vocab-parallel but for the 385 vocab
    and whisper-base's; decode position 8 opens rank 1's half of a cache
    of 16 over 2 and rank 2's quarter over 4."""
    frames, seq = R.whisper_config("whisper").enc_frames, R.SEQ
    for name, (tp, variant, _) in TRAIN.items():
        cfg = R.whisper_config(variant)
        want = "sequence" if cfg.n_heads % tp else "heads"
        for rows in (frames, seq):
            assert attention_route(cfg.n_heads, rows, tp) == want, name
        assert attention_route(cfg.n_heads, 1, tp) == (
            "replicated" if cfg.n_heads % tp else "heads")
        assert (cfg.vocab % tp == 0) == (variant != "whisper_v385"), name
    assert 51865 % 2 and 51865 % 4
    assert attention_route(8, 1500, 2) == attention_route(8, 1, 2) == "heads"
    for tp in (2, 4):
        half = R.WHISPER_DECODE_MAX // tp
        prompt, last = 6, R.WHISPER_DECODE_TOKENS[1] - 1
        assert prompt < 8 <= last and 8 % half == 0


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_mesh_steps_match_one_rank(runs, name):
    _, variant, micro = TRAIN[name]
    got = _got(runs, name)
    losses, params = _one_rank_train(variant, micro)
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    _check_params(got["params"], params)


@pytest.mark.parametrize("name", JAX_TRAIN)
def test_mesh_steps_match_jax_on_the_mesh(runs, name):
    _, variant, _ = TRAIN[name]
    got = _got(runs, name)
    np.testing.assert_allclose(got["losses"], runs["jax"][f"train/{name}"],
                               rtol=JAX_LOSS_RTOL)
    _check_params(got["params"], _jax_trained(runs, name, variant))


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_the_steps_moved_every_parameter(runs, name):
    """Every parameter moved by more than ten times the bar the
    comparisons hold, so a gradient lost on one rank would show."""
    start = _port_params(TRAIN[name][1])
    for n, p in _got(runs, name)["params"].items():
        assert np.abs(p - start[n].numpy()).max() > 10 * PARAM_ATOL, n


@pytest.mark.parametrize("name", sorted(DECODE))
def test_split_cache_decode_matches_one_rank(runs, name):
    got = _got(runs, name)["logits"]
    want = _one_rank_decode(name)
    assert got.shape == want.shape == (
        R.WHISPER_DECODE_TOKENS[0],
        R.WHISPER_DECODE_TOKENS[1] - DECODE[name][2] + 1,
        R.whisper_config(DECODE[name][1]).vocab)
    np.testing.assert_allclose(got, want, **LOGITS_TOL)


@pytest.mark.parametrize("name", sorted(DECODE))
def test_split_cache_decode_matches_jax_on_the_mesh(runs, name):
    np.testing.assert_allclose(_got(runs, name)["logits"],
                               runs["jax"][f"encdec/{name}"], **LOGITS_TOL)


@pytest.mark.parametrize("shape", ((1, 2), (2, 1), (2, 2), (1, 4)))
def test_init_cache_is_this_ranks_block_of_cache_spec(shape):
    """Every rank's ``k``/``v`` are its slice of the positions and its part
    of the batch, ``xk``/``xv`` every frame and KV head of its part."""
    cfg = R.whisper_config("whisper")
    whole = init_cache(cfg, 4, 16, torch.device("meta"))
    assert set(whole) == {"k", "v", "xk", "xv"}
    for rank in range(shape[0] * shape[1]):
        mesh = tsh.Mesh(dict(zip(("data", "model"), shape)), rank)
        cache = init_cache(cfg, 4, 16, torch.device("meta"), mesh)
        assert set(cache) == set(whole)
        for name, t in whole.items():
            want = tsh.local_shape(t.shape, tsh.cache_spec(
                name, tuple(t.shape), mesh), mesh)
            assert tuple(cache[name].shape) == want, (name, rank)
        assert cache["xk"].shape[2:] == (cfg.enc_frames, cfg.n_kv_heads,
                                         cfg.hd)


def _one_rank_launch(n_data):
    """One rank's losses over the launcher's steps: the launcher itself
    for one data rank; for ``n_data``, the launcher's model, optimizer and
    stub frames over the global batch the data ranks' parts make (each
    data rank reads its own part of the pipeline, ``hosts`` = the data
    axis, stacked in rank order)."""
    if n_data == 1:
        return launcher.run(R.WHISPER_LAUNCH_ARGV)
    args = launcher.parse_args(R.WHISPER_LAUNCH_ARGV)
    cfg = configs_reduced_launch(args)
    model = build_model(cfg, "cpu", trainable=True)
    opt = adamw.make_optimizer(adamw.OptConfig(
        lr=args.lr, total_steps=args.steps, eps=args.adam_eps,
        warmup_steps=min(20, args.steps // 5)))
    state = tstep.init_train_state(model, opt, torch.Generator(
        "cpu").manual_seed(args.seed))
    fn = tstep.make_train_step(model, opt)
    losses = []
    for i in range(args.steps):
        host = {k: np.concatenate([SyntheticCorpus(DataConfig(
            vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
            seed=args.seed, hosts=n_data, host_id=h)).batch(i)[k]
            for h in range(n_data)]) for k in ("tokens", "labels")}
        batch = launcher.make_model_batch(cfg, host, torch.device("cpu"))
        state, metrics = fn(state, batch)
        losses.append(float(metrics["loss"]))
    return losses


def configs_reduced_launch(args):
    """The config the launcher trains for ``args``."""
    return launcher.get_reduced(args.arch).replace(
        microbatch=args.microbatch, dtype=args.dtype,
        param_dtype=args.dtype)


@pytest.mark.parametrize("tp", (2, 1))
def test_launcher_trains_whisper_over_two_ranks(runs, tp):
    """Model axis 2 (mesh (1, 2)): the one-rank launcher's losses; model
    axis 1 (mesh (2, 1)): one rank's steps over the batch the two data
    ranks' parts make, with the stub frames a one-rank run draws for it."""
    got = runs[2][f"launch_{tp}"]
    want = _one_rank_launch(2 // tp)
    assert len(got) == 3 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=LAUNCH_RTOL)


def test_checkpoint_over_a_mesh_restores_on_one_rank(runs):
    """The (1, 2) state, saved over the mesh, restored on one rank: every
    parameter bit for bit what the ranks gathered."""
    model = _one_rank_model("whisper", trainable=True)
    opt = adamw.make_optimizer(adamw.OptConfig(**R.ADAMW))
    params = dict(model.named_parameters())
    like = {"params": params, "opt": opt.init(params)}
    back = store.restore_checkpoint(runs["work"] / "ckpt", R.WHISPER_STEPS,
                                    like, "cpu")
    want = runs[2]["whisper_12"]["params"]
    assert set(back["params"]) == set(want)
    for n, p in want.items():
        got = back["params"][n].numpy()
        assert got.dtype == p.dtype and np.array_equal(got, p), n
