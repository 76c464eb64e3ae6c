"""The ranks of ``tests/test_torch_train_mesh.py``: gloo processes on the
CPU that join a group at a ``FileStore``, build the training meshes and
run every multi-rank case of the test module SPMD, float32.  Rank 0
pickles the results (whole tensors, gathered over the mesh) for the
test process, which holds them to the single-rank port and to the JAX
package.

The cases are plain data (``CASES``), so the test process reads the same
shapes, weights and batches.  The weights are the JAX package's
``LM.init`` (``params_from_jax``), which the test process writes to
``params_<name>.npz`` before the ranks start.

:func:`moe_main` is the ranks' body of ``tests/test_torch_moe_mesh.py``:
the MoE cases (``MOE_*``) on the reduced ``qwen3-moe-30b-a3b`` and
``arctic-480b``, float32.  :func:`subq_main` is the ranks' body of
``tests/test_torch_subquadratic_mesh.py`` (RWKV trained over meshes
``(2, 2)`` and ``(1, 4)``, and the launcher),
``tests/test_torch_subquadratic_mesh_hymba.py`` (Hymba trained over them)
and ``tests/test_torch_subquadratic_mesh_decode.py`` (their decode): the
``SUBQ_*`` cases.  :func:`whisper_main` is the ranks' body of
``tests/test_torch_whisper_mesh.py``: the reduced ``whisper-base`` and
its variants trained over meshes ``(2, 2)`` and ``(1, 4)``, its prefill
and sequence-split decode over ``(1, 2)`` and ``(1, 4)``, a checkpoint
saved over ``(1, 2)`` and the launcher over 2 ranks: the ``WHISPER_*``
cases.
"""

import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import init_group, make_train_mesh
from repro_torch.models.attention import sharded_attention
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model
from repro_torch.models.pspec import constrain, use_mesh
from repro_torch.optim import adamw
from repro_torch.optim.compress import make_compressor
from repro_torch.parallel.collectives import all_gather, copy_to, reduce
from repro_torch.train import step as tstep
from repro_torch.train.sharding import (param_shardings, shard, shard_batch,
                                        spec_for_param, unshard)

ARCH = "qwen2.5-3b"
TIMEOUT_S = 120.0
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=3, eps=1e-6)
ADAFACTOR = dict(lr=1e-3, warmup_steps=1, total_steps=3, kind="adafactor")
# config variants by name: the reduced qwen2.5-3b (4 query heads over 2 KV
# heads, hd 16), and 6 query heads, which no model axis above 3 divides
VARIANTS = {"qwen": {}, "h6": {"n_heads": 6}}
# name -> (model axis, variant, optimizer, steps, microbatch, compress);
# the batches are SyntheticCorpus(seq 16, global batch 4, seed 2)
TRAIN = {
    2: {"adamw_12": (2, "qwen", ADAMW, 3, 2, False),
        "adafactor_12": (2, "qwen", ADAFACTOR, 1, 1, False)},
    4: {"adamw_22": (2, "qwen", ADAMW, 3, 2, False),
        "adafactor_22": (2, "qwen", ADAFACTOR, 1, 1, False),
        "adamw_14": (4, "qwen", ADAMW, 1, 1, False),
        "h6_14": (4, "h6", ADAMW, 1, 1, False)},
}
# int8 compression of the shards of given gradients and error feedback
# (whole tensors drawn from the name's seed): name -> model axis
COMPRESS = {2: {"compress_12": 2}, 4: {"compress_22": 2}}
# name -> (model axis, q heads, kv heads, causal); [2, 8, H, 16] inputs
ATTN = {
    2: {"sequence_12": (2, 3, 1, True), "heads_12": (2, 4, 1, True)},
    4: {"sequence_14": (4, 6, 2, True), "heads_14": (4, 8, 2, True),
        "sequence_14_full": (4, 6, 2, False), "heads_22": (2, 4, 2, True)},
}
# name -> (model axis, prompt length); tokens [2, 12], a cache of 16
DECODE = {2: {"decode_12": (2, 8)},
          4: {"decode_22": (2, 8), "decode_14": (4, 8)}}
DECODE_TOKENS, DECODE_MAX = (2, 12), 16
# the launcher: 3 AdamW steps of 4 x 16 in 2 microbatches, float32
LAUNCH_ARGV = ["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "4",
               "--seq", "16", "--microbatch", "2", "--lr", "1e-3",
               "--dtype", "float32", "--adam-eps", "1e-6", "--device",
               "cpu", "--log-every", "1"]
BATCH, SEQ, SEED = 4, 16, 2


def config(variant, microbatch=1):
    return configs.get_reduced(ARCH).replace(
        dtype="float32", param_dtype="float32", microbatch=microbatch,
        **VARIANTS[variant])


def batches(cfg, steps):
    return [SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                       global_batch=BATCH, seed=SEED)
                            ).batch(i) for i in range(steps)]


def attn_inputs(name, hq, hk):
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v, w = (rng.standard_normal(s).astype(np.float32) for s in (
        (2, 8, hq, 16), (2, 8, hk, 16), (2, 8, hk, 16), (2, 8, hq, 16)))
    return q, k, v, w


def decode_tokens(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    return rng.integers(0, 384, DECODE_TOKENS).astype(np.int32)


def load_weights(model, workdir, variant, mesh=None):
    """The JAX weights the test process wrote, into ``model`` (whole, or
    this rank's shards)."""
    with np.load(os.path.join(workdir, f"params_{variant}.npz")) as z:
        with torch.no_grad():
            for name, p in model.named_parameters():
                t = torch.from_numpy(z[name])
                p.copy_(t if mesh is None else shard(t, p.spec, mesh))


def train_state(cfg, opt_kw, workdir, variant, mesh=None):
    model = build_model(cfg, "cpu", trainable=True)
    opt = adamw.make_optimizer(adamw.OptConfig(**opt_kw))
    state = tstep.init_train_state(model, opt,
                                   torch.Generator().manual_seed(0), mesh)
    load_weights(model, workdir, variant, mesh)
    return model, opt, state


def run_train(mesh, name, spec, workdir):
    tp, variant, opt_kw, steps, micro, compress = spec
    cfg = config(variant, micro)
    model, opt, state = train_state(cfg, opt_kw, workdir, variant, mesh)
    fn = tstep.make_train_step(model, opt, make_compressor()
                               if compress else None)
    losses = []
    for b in batches(cfg, steps):
        b = shard_batch({k: torch.from_numpy(v) for k, v in b.items()}, mesh)
        state, metrics = fn(state, b)
        losses.append(float(metrics["loss"]))
    params = {n: unshard(p.detach(), p.spec, mesh).numpy()
              for n, p in state["params"].items()}
    return dict(losses=losses, params=params,
                grad_norm=float(metrics.get("grad_norm", float("nan")))), \
        (model, state)


def compress_inputs(name, shapes):
    """Whole gradients and error-feedback buffers for ``shapes``."""
    rng = np.random.default_rng(sum(map(ord, name)))
    return ({n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()},
            {n: (1e-3 * rng.standard_normal(s)).astype(np.float32)
             for n, s in shapes.items()})


def run_compress(mesh, name):
    model = build_model(config("qwen"), "cpu", trainable=True)
    model.init(torch.Generator().manual_seed(0))
    model.shard_(mesh, param_shardings(dict(model.named_parameters()), mesh))
    params = dict(model.named_parameters())
    grads, ef = compress_inputs(name, {n: p.global_shape
                                       for n, p in params.items()})
    cut = lambda tree: {n: shard(torch.from_numpy(a), params[n].spec, mesh)
                        for n, a in tree.items()}              # noqa: E731
    new_g, state = make_compressor()(cut(grads), {"ef": cut(ef)}, params)
    whole = lambda tree: {n: unshard(t, params[n].spec, mesh).numpy()
                          for n, t in tree.items()}             # noqa: E731
    return dict(grads=whole(new_g), ef=whole(state["ef"]))


def run_attention(mesh, name, spec):
    _, hq, hk, causal = spec
    q, k, v, w = (torch.from_numpy(a) for a in attn_inputs(name, hq, hk))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    with use_mesh(mesh):
        parts = [constrain(t, "B", None, None, None) for t in leaves]
        out = sharded_attention(*parts, causal=causal, chunk=4)
        loss = (out * constrain(w, "B", None, None, None)).sum()
        grads = torch.autograd.grad(loss, leaves)
    # the gradients are whole already: each constrain's backward gathers
    return dict(out=all_gather(out.detach(), 0, mesh.group("data")).numpy(),
                grads=[g.numpy() for g in grads])


def run_decode(mesh, name, spec, workdir):
    _, prompt = spec
    cfg = config("qwen")
    model = build_model(cfg, "cpu")
    model.init(torch.Generator().manual_seed(0))
    model.shard_(mesh, param_shardings(dict(model.named_parameters()), mesh))
    load_weights(model, workdir, "qwen", mesh)
    toks = shard_batch({"tokens": torch.from_numpy(decode_tokens(name))},
                       mesh)["tokens"]
    cache = model.init_cache(DECODE_TOKENS[0], DECODE_MAX)
    last, cache = tstep.make_prefill_step(model)({"tokens": toks[:, :prompt]},
                                                 cache)
    step = tstep.make_decode_step(model, mesh)
    logits = [last]
    for pos in range(prompt, toks.shape[1]):
        out, cache = step(cache, {"token": toks[:, pos:pos + 1], "pos": pos})
        logits.append(out)
    return dict(logits=all_gather(torch.stack(logits, 1), 0,
                                  mesh.group("data")).numpy())


def run_world(rank, world, workdir):
    meshes = {2: make_train_mesh(2, "cpu")}
    if world == 4:
        meshes[4] = make_train_mesh(4, "cpu")
    out = {}
    for name, spec in TRAIN[world].items():
        res, kept = run_train(meshes[spec[0]], name, spec, workdir)
        out[name] = res
        if world == 4 and name == "adamw_22":
            model, state = kept
            store.save_checkpoint(os.path.join(workdir, "ckpt"), 3, state,
                                  mesh=meshes[2],
                                  specs=tstep.state_specs(state,
                                                          state["params"]))
            if rank == 0:
                open(os.path.join(workdir, "ckpt_done"), "w").close()
    for name, tp in COMPRESS[world].items():
        out[name] = run_compress(meshes[tp], name)
    for name, spec in ATTN[world].items():
        out[name] = run_attention(meshes[spec[0]], name, spec)
    for name, spec in DECODE[world].items():
        out[name] = run_decode(meshes[spec[0]], name, spec, workdir)
    out["launch"] = launcher.train(launcher.parse_args(
        LAUNCH_ARGV + ["--model-axis", "2"])).losses
    if world == 2:                    # the 4-rank checkpoint, on 2 ranks
        flag = os.path.join(workdir, "ckpt_done")
        deadline = time.time() + TIMEOUT_S
        while not os.path.exists(flag):
            if time.time() > deadline:
                raise TimeoutError("the 4-rank checkpoint never came")
            time.sleep(0.1)
        _, _, like = train_state(config("qwen", 2), ADAMW, workdir, "qwen",
                                 meshes[2])
        specs = tstep.state_specs(like, like["params"])
        back = store.restore_checkpoint(os.path.join(workdir, "ckpt"), 3,
                                        like, "cpu", meshes[2], specs)
        out["restored"] = {path: unshard(leaf, specs.get(path),
                                         meshes[2]).numpy()
                           for path, leaf in store._paths(back)}
    return out


def main(rank, world, workdir):
    """A rank's body: join the group, run the world's cases, leave."""
    torch.set_num_threads(1)
    try:
        init_group(rank, world, os.path.join(workdir, f"store{world}"),
                   timeout_s=TIMEOUT_S)
        try:
            out = run_world(rank, world, workdir)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            with open(os.path.join(workdir, f"out{world}.pkl"), "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(workdir, f"error{world}_{rank}.txt"),
                  "w") as f:
            f.write(traceback.format_exc())
        raise


# ------------------------------------------------------------------ MoE ---

MOE_ARCHS = {"qwen3": "qwen3-moe-30b-a3b", "arctic": "arctic-480b"}
# name -> (model axis, arch, steps, microbatch): AdamW (ADAMW) on the
# batches above
MOE_TRAIN = {
    2: {"moe_12": (2, "qwen3", 3, 2), "moe_21": (1, "qwen3", 3, 2)},
    4: {"moe_22": (2, "qwen3", 3, 2), "arctic_22": (2, "arctic", 2, 1)},
}
# moe_apply alone over the mesh (its ep body), and the sum of squares of
# its output plus aux differentiated: name -> (model axis, planted fault);
# the planted fault routes from copy_to(x) over model, so the routing's
# gradient (the auxiliary loss's with it) is counted tp times
MOE_EP = {2: {"ep_12": (2, False), "ep_21": (1, False),
              "fault_12": (2, True)},
          4: {"ep_22": (2, False)}}
# name -> (model axis, prompt length): the sequence-sharded decode
MOE_DECODE = {2: {"moe_decode_12": (2, 8)}, 4: {"moe_decode_22": (2, 8)}}
MOE_X = (4, 16, 64)


def moe_config(arch, microbatch=1):
    return configs.get_reduced(MOE_ARCHS[arch]).replace(
        dtype="float32", param_dtype="float32", microbatch=microbatch)


def moe_x():
    """moe_apply's input of the MOE_EP cases, [4, 16, 64]."""
    return np.random.default_rng(7).standard_normal(MOE_X).astype(np.float32)


def moe_layer0(workdir, arch="qwen3", mesh=None):
    """Layer 0's MoE weights of ``arch`` (trainable), whole, or this
    rank's shards carrying their specs."""
    cfg = moe_config(arch)
    p = tmoe.MoeParams(cfg, torch.device("cpu"), trainable=True)
    with np.load(os.path.join(workdir, f"params_moe_{arch}.npz")) as z:
        with torch.no_grad():
            for name, w in p.named_parameters():
                t = torch.from_numpy(z[f"blocks.0.moe.{name}"])
                if mesh is not None:
                    w.spec = spec_for_param(f"blocks.0.moe.{name}",
                                            tuple(t.shape), mesh)
                    w.mesh = mesh
                    t = shard(t, w.spec, mesh)
                w.data = t.clone()
    return cfg, p


def run_moe_ep(mesh, name, spec, workdir):
    _, planted = spec
    cfg, p = moe_layer0(workdir, mesh=mesh)
    x = shard(torch.from_numpy(moe_x()), (("data",), None, None), mesh)
    x.requires_grad_()
    route = tmoe._route
    if planted:
        grp = mesh.group("model")
        tmoe._route = lambda x_, r, k: route(copy_to(x_, grp), r, k)
    try:
        out, aux = tmoe.moe_apply(p, x, cfg, mesh)
    finally:
        tmoe._route = route
    loss = reduce((out ** 2).sum() * 1e-3, mesh.group("data")) + aux
    names, leaves = zip(*p.named_parameters())
    grads = torch.autograd.grad(loss, (x,) + leaves)
    data = mesh.group("data")
    res = dict(out=all_gather(out.detach(), 0, data).numpy(),
               aux=float(aux), g_x=all_gather(grads[0], 0, data).numpy())
    for n, w, g in zip(names, leaves, grads[1:]):
        res[f"g_{n}"] = unshard(g, w.spec, mesh).numpy()
    return res


def load_moe_weights(model, workdir, arch, mesh=None):
    with np.load(os.path.join(workdir, f"params_moe_{arch}.npz")) as z:
        with torch.no_grad():
            for name, p in model.named_parameters():
                t = torch.from_numpy(z[name])
                p.copy_(t if mesh is None else shard(t, p.spec, mesh))


def run_moe_train(mesh, name, spec, workdir):
    _, arch, steps, micro = spec
    cfg = moe_config(arch, micro)
    model = build_model(cfg, "cpu", trainable=True)
    opt = adamw.make_optimizer(adamw.OptConfig(**ADAMW))
    state = tstep.init_train_state(model, opt,
                                   torch.Generator().manual_seed(0), mesh)
    load_moe_weights(model, workdir, arch, mesh)
    fn = tstep.make_train_step(model, opt)
    losses, auxes = [], []
    for b in batches(cfg, steps):
        b = shard_batch({k: torch.from_numpy(v) for k, v in b.items()}, mesh)
        state, metrics = fn(state, b)
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["aux"]))
    params = {n: unshard(p.detach(), p.spec, mesh).numpy()
              for n, p in state["params"].items()}
    return dict(losses=losses, aux=auxes, params=params)


def run_moe_decode(mesh, name, spec, workdir):
    _, prompt = spec
    model = build_model(moe_config("qwen3"), "cpu")
    model.init(torch.Generator().manual_seed(0))
    model.shard_(mesh, param_shardings(dict(model.named_parameters()), mesh))
    load_moe_weights(model, workdir, "qwen3", mesh)
    toks = shard_batch({"tokens": torch.from_numpy(decode_tokens(name))},
                       mesh)["tokens"]
    cache = model.init_cache(DECODE_TOKENS[0], DECODE_MAX)
    last, cache = tstep.make_prefill_step(model)({"tokens": toks[:, :prompt]},
                                                 cache)
    step = tstep.make_decode_step(model, mesh)
    logits = [last]
    for pos in range(prompt, toks.shape[1]):
        out, cache = step(cache, {"token": toks[:, pos:pos + 1], "pos": pos})
        logits.append(out)
    return dict(logits=all_gather(torch.stack(logits, 1), 0,
                                  mesh.group("data")).numpy())


def moe_main(rank, world, workdir):
    """A rank's body for the MoE cases: join the group, make the meshes
    ``(world / tp, tp)`` the cases ask for, run them, and rank 0 pickles
    the results to ``moe<world>.pkl``.  The rank runs at a lower priority
    (``nice`` 10), so that on a loaded machine the other tests' processes
    keep their share of the cores."""
    os.nice(10)
    torch.set_num_threads(1)
    try:
        init_group(rank, world, os.path.join(workdir, f"moe_store{world}"),
                   timeout_s=TIMEOUT_S)
        try:
            meshes = {}
            out = {}
            for cases, run in ((MOE_EP, run_moe_ep),
                               (MOE_TRAIN, run_moe_train),
                               (MOE_DECODE, run_moe_decode)):
                for name, spec in cases[world].items():
                    tp = spec[0]
                    if tp not in meshes:
                        meshes[tp] = make_train_mesh(tp, "cpu")
                    out[name] = run(meshes[tp], name, spec, workdir)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            with open(os.path.join(workdir, f"moe{world}.pkl"), "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(workdir, f"error_moe{world}_{rank}.txt"),
                  "w") as f:
            f.write(traceback.format_exc())
        raise


# ------------------------------------------------------- RWKV and Hymba ---

# variant -> (arch, config changes): the reduced rwkv6-1.6b (4 heads of 16)
# and hymba-1.5b (4/2 attention and 4 SSM heads of 16), and a Hymba of 5
# heads of 16 (5/1 attention, 5 SSM heads), which divide no model axis
# above 1, as Hymba-1.5B's 25 divide neither 2 nor 4
SUBQ_VARIANTS = {"rwkv": ("rwkv6-1.6b", {}), "hymba": ("hymba-1.5b", {}),
                 "hymba5": ("hymba-1.5b", dict(
                     n_heads=5, n_kv_heads=1, ssm_heads=5, head_dim=16,
                     d_model=80))}
# name -> (model axis, variant): SUBQ_STEPS AdamW steps (ADAMW) of the
# SyntheticCorpus batches of SUBQ_SEQ tokens (global batch BATCH, seed
# SEED) on a 4-rank mesh (4 / tp, tp).  At 256 tokens there are 4 chunks
# of 64, which 4 ranks divide: the 5-head Hymba's SSM takes the "chunks"
# route there (its attention the sequence route); the rest take "heads".
SUBQ_TRAIN = {"rwkv_22": (2, "rwkv"), "rwkv_14": (4, "rwkv"),
              "hymba5_14": (4, "hymba5"), "hymba_22": (2, "hymba")}
SUBQ_STEPS, SUBQ_SEQ = 2, 256
# name -> (model axis, variant, prompt): the logits of a decode step at
# every one of SUBQ_DECODE_TOKENS' positions into a cache of
# SUBQ_DECODE_MAX, and of a prefill of ``prompt`` tokens followed by
# decode steps
SUBQ_DECODE = {"rwkv_decode_14": (4, "rwkv", 4),
               "hymba_decode_14": (4, "hymba", 4),
               "hymba5_decode_14": (4, "hymba5", 4)}
SUBQ_DECODE_TOKENS, SUBQ_DECODE_MAX = (2, 8), 16
# the launcher over 2 ranks: 3 AdamW steps of 4 x 16 in 2 microbatches
SUBQ_LAUNCH_ARGV = ["--arch", "rwkv6-1.6b", "--reduced", "--steps", "3",
                    "--batch", "4", "--seq", "16", "--microbatch", "2",
                    "--device", "cpu", "--log-every", "1"]


# the noise added to the constants of the JAX init (tests/
# test_torch_subquadratic.py's NOISE) but a_log's: at 0.5, Hymba's decay
# over a chunk of 64 passes exp's float32 range in the JAX package's
# masked pairs (exponentiated before they are selected away), and its
# gradients turn NaN at S = 256; the port's stay finite
SUBQ_NOISE_A_LOG = 0.05


def subq_config(variant):
    arch, kw = SUBQ_VARIANTS[variant]
    return configs.get_reduced(arch).replace(
        dtype="float32", param_dtype="float32", **kw)


def subq_batches(cfg, steps=SUBQ_STEPS, seq=SUBQ_SEQ, seed=SEED):
    return [SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                       global_batch=BATCH, seed=seed)
                            ).batch(i) for i in range(steps)]


def subq_tokens(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    return rng.integers(0, 256, SUBQ_DECODE_TOKENS).astype(np.int32)


def subq_model(workdir, variant, mesh=None, trainable=False):
    """The test process's (perturbed JAX) weights of ``variant`` in a model
    on the host: whole, or this rank's shards of ``mesh``."""
    model = build_model(subq_config(variant), "cpu", trainable=trainable)
    if mesh is not None:
        model.shard_(mesh, param_shardings(dict(model.named_parameters()),
                                           mesh))
    with np.load(os.path.join(workdir, f"params_subq_{variant}.npz")) as z:
        with torch.no_grad():
            for name, p in model.named_parameters():
                t = torch.from_numpy(z[name])
                p.copy_(t if mesh is None else shard(t, p.spec, mesh))
    return model


def run_subq_train(mesh, name, spec, workdir):
    _, variant = spec
    model = subq_model(workdir, variant, mesh, trainable=True)
    opt = adamw.make_optimizer(adamw.OptConfig(**ADAMW))
    state = {"params": dict(model.named_parameters())}
    state["opt"] = opt.init(state["params"])
    fn = tstep.make_train_step(model, opt)
    losses = []
    for b in subq_batches(model.cfg):
        b = shard_batch({k: torch.from_numpy(v) for k, v in b.items()}, mesh)
        state, metrics = fn(state, b)
        losses.append(float(metrics["loss"]))
    params = {n: unshard(p.detach(), p.spec, mesh).numpy()
              for n, p in state["params"].items()}
    return dict(losses=losses, params=params)


def subq_decode_logits(model, toks, prompt, step):
    """``[B, T, V]`` logits: a decode step at every position of ``toks``
    from an empty cache, then (``prompt``) a prefill of the first
    ``prompt`` tokens and decode steps for the rest into a new cache (its
    logits from position ``prompt - 1`` on)."""
    b, t = toks.shape
    every = []
    cache = model.init_cache(b, SUBQ_DECODE_MAX)
    for pos in range(t):
        out, cache = step(cache, {"token": toks[:, pos:pos + 1],
                                  "pos": pos})
        every.append(out)
    cache = model.init_cache(b, SUBQ_DECODE_MAX)
    last, cache = model.prefill({"tokens": toks[:, :prompt]}, cache)
    after = [last]
    for pos in range(prompt, t):
        out, cache = step(cache, {"token": toks[:, pos:pos + 1],
                                  "pos": pos})
        after.append(out)
    return torch.stack(every, 1), torch.stack(after, 1)


def run_subq_decode(mesh, name, spec, workdir):
    _, variant, prompt = spec
    model = subq_model(workdir, variant, mesh)
    toks = shard_batch({"tokens": torch.from_numpy(subq_tokens(name))},
                       mesh)["tokens"]
    every, after = subq_decode_logits(model, toks, prompt,
                                      tstep.make_decode_step(model, mesh))
    data = mesh.group("data")
    return dict(every=all_gather(every, 0, data).numpy(),
                after=all_gather(after, 0, data).numpy())


def subq_part(part):
    """``(cases, run)`` of a part: ``"decode"``'s ``SUBQ_DECODE``, or the
    ``SUBQ_TRAIN`` cases whose variant starts with the part's name
    (``"rwkv"``, ``"hymba"``)."""
    if part == "decode":
        return SUBQ_DECODE, run_subq_decode
    return ({n: c for n, c in SUBQ_TRAIN.items() if c[1].startswith(part)},
            run_subq_train)


def subq_main(rank, world, workdir, part):
    """A rank's body for the RWKV and Hymba cases of ``part``
    (:func:`subq_part`): join the group; on 4 ranks run the part's cases
    on the meshes they ask for, on 2 ranks the launcher with
    ``--model-axis 2``; rank 0 pickles the results to
    ``subq<world>.pkl``.  At ``nice`` 10, as :func:`moe_main`."""
    os.nice(10)
    torch.set_num_threads(1)
    try:
        init_group(rank, world, os.path.join(workdir, f"subq_store{world}"),
                   timeout_s=TIMEOUT_S)
        try:
            out = {}
            if world == 2:
                out["launch"] = launcher.train(launcher.parse_args(
                    SUBQ_LAUNCH_ARGV + ["--model-axis", "2"])).losses
            else:
                meshes = {}
                cases, run = subq_part(part)
                for name, spec in cases.items():
                    tp = spec[0]
                    if tp not in meshes:
                        meshes[tp] = make_train_mesh(tp, "cpu")
                    out[name] = run(meshes[tp], name, spec, workdir)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            with open(os.path.join(workdir, f"subq{world}.pkl"), "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(workdir, f"error_subq{world}_{rank}.txt"),
                  "w") as f:
            f.write(traceback.format_exc())
        raise


# ------------------------------------------------------------- Whisper ---

# variant -> config changes of the reduced whisper-base (2 + 2 layers,
# d_model 64, 4 heads of 16, 64 frames, vocab 384), float32: 6 heads of
# 16, which divide no model axis above 3 (every attention takes the
# "sequence" route at (1, 4)), and a vocab of 385, which divides no model
# axis (the tied head replicated, as whisper-base's 51,865 is)
WHISPER_VARIANTS = {"whisper": {}, "whisper_h6": dict(n_heads=6,
                                                      n_kv_heads=6),
                    "whisper_v385": dict(vocab=385)}
# name -> (model axis, variant, microbatch): WHISPER_STEPS AdamW steps
# (ADAMW) of the SyntheticCorpus batches (seq SEQ, global batch BATCH,
# seed SEED) over whisper_frames(), on a 4-rank mesh (4 / tp, tp)
WHISPER_TRAIN = {"whisper_22": (2, "whisper", 2),
                 "whisper_14": (4, "whisper", 1),
                 "whisper_h6_14": (4, "whisper_h6", 1),
                 "whisper_v385_22": (2, "whisper_v385", 1)}
WHISPER_STEPS = 3
# the same steps over (1, 2) on 2 ranks, whose state is saved
WHISPER_CKPT = (2, "whisper", 1)
# name -> (model axis, variant, prompt): a prefill of ``prompt`` tokens of
# WHISPER_DECODE_TOKENS into a cache of WHISPER_DECODE_MAX, then decode
# steps for the rest: position 8, the first of rank 1's half at (1, 2) and
# of rank 2's quarter at (1, 4), is the third decode step
WHISPER_DECODE = {2: {"wdecode_12": (2, "whisper", 6)},
                  4: {"wdecode_14": (4, "whisper", 6),
                      "wdecode_h6_14": (4, "whisper_h6", 6)}}
WHISPER_DECODE_TOKENS, WHISPER_DECODE_MAX = (2, 12), 16
# the launcher over 2 ranks at model axes 2 and 1 (meshes (1, 2) and
# (2, 1): the second cuts the stub frames over 2 data ranks), float32
WHISPER_LAUNCH_ARGV = ["--arch", "whisper-base", "--reduced", "--steps",
                       "3", "--batch", "4", "--seq", "16", "--microbatch",
                       "2", "--lr", "1e-3", "--dtype", "float32",
                       "--adam-eps", "1e-6", "--device", "cpu",
                       "--log-every", "1"]


def whisper_config(variant, microbatch=1):
    return configs.get_reduced("whisper-base").replace(
        dtype="float32", param_dtype="float32", microbatch=microbatch,
        **WHISPER_VARIANTS[variant])


def whisper_frames(cfg, b=BATCH, seed=3):
    """The stub frames ``[b, enc_frames, D]`` of every step, float32."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.enc_frames, cfg.d_model)).astype(
        np.float32)


def whisper_batches(cfg, steps=WHISPER_STEPS):
    frames = whisper_frames(cfg)
    return [dict(b, frames=frames) for b in batches(cfg, steps)]


def whisper_tokens(name, vocab):
    rng = np.random.default_rng(sum(map(ord, name)))
    return rng.integers(0, vocab, WHISPER_DECODE_TOKENS).astype(np.int32)


def whisper_model(workdir, variant, mesh=None, trainable=False,
                  microbatch=1):
    """The test process's (JAX ``EncDecLM.init``) weights of ``variant``
    in a model on the host: whole, or this rank's shards of ``mesh``."""
    model = build_model(whisper_config(variant, microbatch), "cpu",
                        trainable=trainable)
    if mesh is not None:
        model.shard_(mesh, param_shardings(dict(model.named_parameters()),
                                           mesh))
    with np.load(os.path.join(workdir, f"params_{variant}.npz")) as z:
        with torch.no_grad():
            for name, p in model.named_parameters():
                t = torch.from_numpy(z[name])
                p.copy_(t if mesh is None else shard(t, p.spec, mesh))
    return model


def run_whisper_train(mesh, name, spec, workdir):
    _, variant, micro = spec
    model = whisper_model(workdir, variant, mesh, True, micro)
    opt = adamw.make_optimizer(adamw.OptConfig(**ADAMW))
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    fn = tstep.make_train_step(model, opt)
    losses = []
    for b in whisper_batches(model.cfg):
        b = shard_batch({k: torch.from_numpy(v) for k, v in b.items()}, mesh)
        state, metrics = fn(state, b)
        losses.append(float(metrics["loss"]))
    params = {n: unshard(p.detach(), p.spec, mesh).numpy()
              for n, p in state["params"].items()}
    return dict(losses=losses, params=params), state


def whisper_decode_logits(model, frames, toks, prompt, step):
    """``[B, T - prompt + 1, V]``: the prefill's last logits, then each
    decode step's, teacher-forced, into a cache of WHISPER_DECODE_MAX."""
    cache = model.init_cache(WHISPER_DECODE_TOKENS[0], WHISPER_DECODE_MAX)
    last, cache = tstep.make_prefill_step(model)(
        {"frames": frames, "tokens": toks[:, :prompt]}, cache)
    out = [last]
    for pos in range(prompt, toks.shape[1]):
        logits, cache = step(cache, {"token": toks[:, pos:pos + 1],
                                     "pos": pos})
        out.append(logits)
    return torch.stack(out, 1)


def run_whisper_decode(mesh, name, spec, workdir):
    _, variant, prompt = spec
    model = whisper_model(workdir, variant, mesh)
    cfg = model.cfg
    part = shard_batch({
        "tokens": torch.from_numpy(whisper_tokens(name, cfg.vocab)),
        "frames": torch.from_numpy(whisper_frames(
            cfg, WHISPER_DECODE_TOKENS[0]))}, mesh)
    logits = whisper_decode_logits(model, part["frames"], part["tokens"],
                                   prompt, tstep.make_decode_step(model,
                                                                  mesh))
    return dict(logits=all_gather(logits, 0, mesh.group("data")).numpy())


def whisper_main(rank, world, workdir):
    """A rank's body for the Whisper cases: join the group; on 4 ranks
    run ``WHISPER_TRAIN`` and the 4-rank ``WHISPER_DECODE`` cases, on 2
    ranks the 2-rank decode, the reduced whisper's steps over (1, 2)
    (``WHISPER_CKPT``), its state saved to ``workdir/ckpt``, and the launcher
    at model axes 2 and 1; rank 0 pickles the results to
    ``whisper<world>.pkl``.  At ``nice`` 10, as :func:`moe_main`."""
    os.nice(10)
    torch.set_num_threads(1)
    try:
        init_group(rank, world, os.path.join(workdir,
                                             f"whisper_store{world}"),
                   timeout_s=TIMEOUT_S)
        try:
            meshes, out = {}, {}

            def mesh_of(tp):
                if tp not in meshes:
                    meshes[tp] = make_train_mesh(tp, "cpu")
                return meshes[tp]
            if world == 4:
                for name, spec in WHISPER_TRAIN.items():
                    out[name] = run_whisper_train(mesh_of(spec[0]), name,
                                                  spec, workdir)[0]
            for name, spec in WHISPER_DECODE[world].items():
                out[name] = run_whisper_decode(mesh_of(spec[0]), name, spec,
                                               workdir)
            if world == 2:
                mesh = mesh_of(2)
                out["whisper_12"], state = run_whisper_train(
                    mesh, "whisper_12", WHISPER_CKPT, workdir)
                store.save_checkpoint(
                    os.path.join(workdir, "ckpt"), WHISPER_STEPS, state,
                    mesh=mesh, specs=tstep.state_specs(state,
                                                       state["params"]))
                for tp in (2, 1):
                    out[f"launch_{tp}"] = launcher.train(launcher.parse_args(
                        WHISPER_LAUNCH_ARGV + ["--model-axis", str(tp)])
                    ).losses
        finally:
            dist.destroy_process_group()
        if rank == 0:
            with open(os.path.join(workdir, f"whisper{world}.pkl"),
                      "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(workdir, f"error_whisper{world}_{rank}.txt"),
                  "w") as f:
            f.write(traceback.format_exc())
        raise
