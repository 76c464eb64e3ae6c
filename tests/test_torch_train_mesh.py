"""Multi-rank training and the sequence-sharded decode of the port
(``repro_torch.train.sharding``, ``repro_torch.parallel``,
``launch.mesh.make_train_mesh``, the sharded LM) on the CPU, float32, held
to the single-rank port and to the JAX package.

A module fixture starts, at once: two gloo groups of spawned ranks (2
ranks: mesh ``(1, 2)``; 4 ranks: meshes ``(2, 2)`` and ``(1, 4)``), which
run every case of ``tests/torch_mesh_ranks.py`` SPMD, and the JAX
package's sharded paths on four fake devices in a subprocess
(``tests/jax_mesh_reference.py``, ``AxisType.Auto`` meshes).  The weights
are the JAX package's ``LM.init``, carried across by ``params_from_jax``.

* The sharded step against the single-rank port: 3 AdamW steps (``eps``
  1e-6, 2 microbatches) and 1 Adafactor step; the losses within 1e-6
  relative, every parameter within 1e-5.  Int8 compression of shards
  against the whole tensors' on the same gradients, bit for bit (on a
  step's gradients, which the ranks sum in another order, a code at a
  rounding boundary may go either way).  Also at
  ``(1, 4)``, where the 2 KV heads are split in halves by ``wk``'s spec
  (``Hkv < tp``), and with 6 query heads at ``(1, 4)`` (``Hq % tp != 0``:
  the sequence-parallel route).
* The first step against JAX's step under the same mesh: within 1e-5.
* ``sharded_attention`` against JAX's (heads and sequence routes, causal
  and not), its gradients against the single-rank port's.
* The sequence-sharded decode (prefill, then decode steps over a cache
  whose sequence axis is split over ``model``) against JAX's
  ``make_decode_step(model, mesh)`` and the single-rank port.
* The launcher with ``--model-axis 2`` on 2 and 4 ranks against one rank.
* An elastic checkpoint: saved on 4 ranks ``(2, 2)``, restored on 2
  ranks ``(1, 2)``, by the port on one rank and by the JAX package: bit for
  bit.
"""

import functools
import json
import multiprocessing
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import store as jstore
from repro.models import attention as jattn
from repro.models.model import build_model as jax_build_model
from repro_torch.checkpoint import store
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.kernels.attention import flash_attention_plain
from repro_torch.launch import train as launcher
from repro_torch.models import attention as tattn
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.optim.compress import make_compressor
from repro_torch.train import step as tstep
from tests import torch_mesh_ranks as R

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-5
JAX_LOSS_RTOL = 1e-5
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
WAIT_S = 240.0
# the JAX reference's cases: the first step of each sharded training case
# whose mesh JAX can hold, every attention and decode case
JAX_TRAIN = {"adamw_22": (2, 2), "h6_14": (1, 4), "adamw_14": (1, 4)}


def _mesh_of(tp, world):
    return (world // tp, tp)


@functools.lru_cache(maxsize=None)
def _jax_params(variant):
    cfg = jconfigs.get_reduced(R.ARCH).replace(
        dtype="float32", param_dtype="float32", **R.VARIANTS[variant])
    return jax_build_model(cfg).init(jax.random.PRNGKey(0))


def _port_params(variant):
    return params_from_jax(jax.tree.map(np.asarray, _jax_params(variant)),
                           R.config(variant))


def _write_cases(work: Path) -> None:
    for variant in R.VARIANTS:
        np.savez(work / f"params_{variant}.npz",
                 **{k: v.numpy() for k, v in _port_params(variant).items()})
    spec = {"train": {}, "attn": {}, "decode": {}}
    arrays = {}
    for name, mesh in JAX_TRAIN.items():
        world = 4
        tp, variant, opt, _, micro, _ = R.TRAIN[world][name]
        spec["train"][name] = dict(mesh=mesh, cfg=dict(
            microbatch=micro, **R.VARIANTS[variant]), opt=opt, seq=R.SEQ,
            batch=R.BATCH, seed=R.SEED, steps=1)
    for world in WORLDS:
        for name, (tp, hq, hk, causal) in R.ATTN[world].items():
            spec["attn"][name] = dict(mesh=_mesh_of(tp, world),
                                      causal=causal, chunk=4)
            q, k, v, _ = R.attn_inputs(name, hq, hk)
            arrays.update({f"attn/{name}/q": q, f"attn/{name}/k": k,
                           f"attn/{name}/v": v})
        for name, (tp, _) in R.DECODE[world].items():
            spec["decode"][name] = dict(mesh=_mesh_of(tp, world), cfg={},
                                        max_len=R.DECODE_MAX)
            arrays[f"decode/{name}/tokens"] = R.decode_tokens(name)
    np.savez(work / "cases.npz", spec=np.array(spec, dtype=object), **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"jax": {...}, 2: {...}, 4: {...}}``: the JAX reference's results
    and each world's rank-0 results."""
    work = tmp_path_factory.mktemp("train_mesh")
    _write_cases(work)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    jax_out = work / "jax.npz"
    jproc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_mesh_reference.py"),
         str(work / "cases.npz"), str(jax_out)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=R.main, args=(rank, world, str(work)),
                         daemon=True)
             for world in WORLDS for rank in range(world)]
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
    try:
        jlog, _ = jproc.communicate(timeout=WAIT_S)
        for p in procs:
            p.join(WAIT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        if jproc.poll() is None:
            jproc.kill()
    errors = sorted(work.glob("error*.txt"))
    assert not errors, "\n".join(e.read_text() for e in errors)
    assert [p.exitcode for p in procs] == [0] * len(procs)
    assert jproc.returncode == 0, jlog[-3000:]
    out = {"jax": dict(np.load(jax_out))}
    for world in WORLDS:
        with open(work / f"out{world}.pkl", "rb") as f:
            out[world] = pickle.load(f)
    out["ckpt"] = work / "ckpt"
    return out


# ------------------------------------------------- single-rank references --

@functools.lru_cache(maxsize=None)
def _one_rank_train(name, world):
    tp, variant, opt_kw, steps, micro, compress = R.TRAIN[world][name]
    cfg = R.config(variant, micro)
    model = build_model(cfg, "cpu", trainable=True)
    opt = adamw.make_optimizer(adamw.OptConfig(**opt_kw))
    state = tstep.init_train_state(model, opt,
                                   torch.Generator().manual_seed(0))
    model.load_state_dict(_port_params(variant))
    fn = tstep.make_train_step(model, opt,
                               make_compressor() if compress else None)
    losses = []
    for b in R.batches(cfg, steps):
        state, metrics = fn(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    return losses, {n: p.detach().numpy()
                    for n, p in state["params"].items()}


CASES = [(name, world) for world in WORLDS for name in R.TRAIN[world]]


@pytest.mark.parametrize("name,world", CASES)
def test_sharded_step_matches_one_rank(runs, name, world):
    got = runs[world][name]
    losses, params = _one_rank_train(name, world)
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    assert set(got["params"]) == set(params)
    for n, p in params.items():
        assert got["params"][n].shape == p.shape, n
        np.testing.assert_allclose(got["params"][n], p, rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)


COMPRESS_CASES = [(name, world) for world in WORLDS
                  for name in R.COMPRESS[world]]


@pytest.mark.parametrize("name,world", COMPRESS_CASES)
def test_compressed_shards_equal_one_rank(runs, name, world):
    """Each scale is the whole tensor's: the codes and the error feedback
    equal one rank's bit for bit."""
    model = build_model(R.config("qwen"), "cpu", trainable=True)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    grads, ef = R.compress_inputs(name, shapes)
    new_g, state = make_compressor()(
        {n: torch.from_numpy(a) for n, a in grads.items()},
        {"ef": {n: torch.from_numpy(a) for n, a in ef.items()}})
    got = runs[world][name]
    for n in shapes:
        assert got["grads"][n].tobytes() == new_g[n].numpy().tobytes(), n
        assert got["ef"][n].tobytes() == state["ef"][n].numpy().tobytes(), n


@pytest.mark.parametrize("name", sorted(JAX_TRAIN))
def test_first_step_matches_jax_on_the_mesh(runs, name):
    np.testing.assert_allclose(runs[4][name]["losses"][0],
                               runs["jax"][f"train/{name}"][0],
                               rtol=JAX_LOSS_RTOL)


ATTN_CASES = [(name, world) for world in WORLDS for name in R.ATTN[world]]


@pytest.mark.parametrize("name,world", ATTN_CASES)
def test_sharded_attention_matches_jax(runs, name, world):
    tp, hq, hk, causal = R.ATTN[world][name]
    assert tattn.attention_route(hq, 8, tp) == name.split("_")[0]
    got = runs[world][name]
    np.testing.assert_allclose(got["out"], runs["jax"][f"attn/{name}"],
                               **ATTN_TOL)
    q, k, v, w = (torch.from_numpy(a) for a in R.attn_inputs(name, hq, hk))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = tattn.sharded_attention(*leaves, causal=causal, chunk=4)
    grads = torch.autograd.grad((out * w).sum(), leaves)
    for g, want in zip(got["grads"], grads):
        np.testing.assert_allclose(g, want.numpy(), **ATTN_TOL)


@pytest.mark.parametrize("q_offset", (0, 5, 8, 13))
@pytest.mark.parametrize("sq,skv,causal,valid", [
    (8, 24, True, False), (6, 24, True, True), (8, 8, False, True)])
def test_block_attention_q_offset_matches_jax(q_offset, sq, skv, causal,
                                              valid):
    """The plain reference and K6's plain version (forward and backward)
    with a query offset, against the JAX package's ``block_attention``."""
    rng = np.random.default_rng(q_offset + sq)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
            for _ in range(2))
    kv_valid = rng.random((2, skv)) < 0.8 if valid else None
    if kv_valid is not None:
        kv_valid[:, 0] = True
    want = np.asarray(jattn.block_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 4,
        None if kv_valid is None else jnp.asarray(kv_valid),
        q_offset=q_offset))
    got = tattn.block_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal, 4,
        None if kv_valid is None else torch.from_numpy(kv_valid),
        q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    if kv_valid is None:
        plain = flash_attention_plain(
            *(torch.from_numpy(a) for a in (q, k, v)), causal, chunk=3,
            q_offset=q_offset)
        np.testing.assert_allclose(plain.numpy(), want, **ATTN_TOL)


DECODE_CASES = [(name, world) for world in WORLDS
                for name in R.DECODE[world]]


@functools.lru_cache(maxsize=None)
def _one_rank_decode(name, world):
    _, prompt = R.DECODE[world][name]
    model = build_model(R.config("qwen"), "cpu")
    model.load_state_dict(_port_params("qwen"))
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
def test_sequence_sharded_decode_matches_jax(runs, name, world):
    _, prompt = R.DECODE[world][name]
    got = runs[world][name]["logits"]
    want = runs["jax"][f"decode/{name}"][:, prompt - 1:]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **LOGITS_TOL)
    np.testing.assert_allclose(got, _one_rank_decode(name, world),
                               **LOGITS_TOL)


def _hosts_batches(n_data, steps):
    """The global batch the data ranks read between them: each rank's part
    (``hosts`` = the data axis), stacked in rank order."""
    cfg = R.config("qwen")
    return [{k: np.concatenate([SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=R.SEQ, global_batch=R.BATCH, seed=0,
        hosts=n_data, host_id=h)).batch(i)[k] for h in range(n_data)])
        for k in ("tokens", "labels")} for i in range(steps)]


@pytest.mark.parametrize("world", WORLDS)
def test_launcher_over_ranks_matches_one_rank(runs, world):
    """``--model-axis 2``: on 2 ranks the single-rank launcher's losses;
    on 4 ranks (2 data ranks, each reading its part of the batch) one
    rank's steps over the batch the two parts make."""
    got = runs[world]["launch"]
    if world == 2:
        want = launcher.run(R.LAUNCH_ARGV)
    else:
        cfg = R.config("qwen", 2)
        model = build_model(cfg, "cpu", trainable=True)
        opt = adamw.make_optimizer(adamw.OptConfig(
            lr=1e-3, total_steps=3, warmup_steps=0, eps=1e-6))
        state = tstep.init_train_state(model, opt,
                                       torch.Generator().manual_seed(0))
        fn = tstep.make_train_step(model, opt)
        want = []
        for b in _hosts_batches(2, 3):
            state, metrics = fn(state, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
            want.append(float(metrics["loss"]))
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_elastic_checkpoint_restores_bit_for_bit(runs):
    """The state of ``adamw_22`` saved by 4 ranks: restored on 2 ranks
    (gathered whole), by the port on one rank and by the JAX package, the
    same bits; its parameters are the ones the 4 ranks trained."""
    restored = runs[2]["restored"]
    manifest = json.loads((runs["ckpt"] / "step_00000003" /
                           "manifest.json").read_text())
    assert set(manifest["arrays"]) == set(restored)
    tree = _tree_of(manifest)
    port = store.restore_checkpoint(runs["ckpt"], 3, tree, device="cpu")
    jback = jstore.restore_checkpoint(runs["ckpt"], 3, jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tree))
    leaves = store._paths(port)
    assert len(leaves) == len(jax.tree.leaves(jback)) == len(restored)
    for (path, t), jleaf in zip(leaves, jax.tree.leaves(jback)):
        a = t.numpy()
        assert a.tobytes() == restored[path].tobytes(), path
        assert np.asarray(jleaf).tobytes() == a.tobytes(), path
    for name, p in runs[4]["adamw_22"]["params"].items():
        assert restored[f"['params'][{name!r}]"].tobytes() == p.tobytes(), \
            name


def _tree_of(manifest):
    """A nested dict of zero arrays in the stored structure (paths of
    ``['a']['b']`` keys)."""
    tree = {}
    for path, info in manifest["arrays"].items():
        keys = [k.strip("'") for k in path[2:-2].split("']['")]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.zeros(info["shape"], np.dtype(info["dtype"]))
    return tree
