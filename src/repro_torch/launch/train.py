"""End-to-end training launcher; the JAX package's ``repro.launch.train``.

Runs any ``--arch`` (full or reduced config) with the training path:
microbatch accumulation, AdamW/Adafactor, checkpoint/resume, optional
int8 gradient compression, and the deterministic data pipeline.  It
runs on the CUDA card unless ``--device`` names another device.  The
encoder-decoder (Whisper) and the models fed embeddings (Qwen2-VL) train
on the synthetic tokens through the reference's stub frontends
(:func:`make_model_batch`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt --resume \\
        --device cpu

Over the ranks of a ``torch.distributed`` group it trains SPMD on a
``(data, model)`` mesh of ``(world // --model-axis, --model-axis)``
(``train/sharding.py``): under ``torch.distributed.run`` (world and rank
from the environment; the group it starts is gloo's, which ranks sharing
one card need) or in ranks that joined a group already
(``launch.mesh.init_group``).  Each data rank reads its part of the
global batch, only rank 0 prints, and the checkpoint holds the global
arrays (rank 0 writes them)::

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.train --reduced \\
        --model-axis 2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Callable, Dict, List, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint.store import (latest_step, restore_checkpoint,
                                save_checkpoint)
from ..configs import ARCHS, get_config, get_reduced
from ..core.device import resolve_device
from ..data.pipeline import DataConfig, Prefetcher, SyntheticCorpus
from ..models.config import ModelConfig, ShapeConfig
from ..models.model import build_model
from ..models.transformer import check_supported
from ..optim.adamw import OptConfig, make_optimizer
from ..optim.compress import make_compressor
from ..train.sharding import (batch_shardings, batch_spec, mesh_axes,
                              param_shardings, shard)
from ..train.step import init_train_state, make_train_step, state_specs
from .mesh import make_local_mesh, make_train_mesh

__all__ = ["ARCHS", "get_config", "get_reduced", "latest_step",
           "restore_checkpoint", "save_checkpoint", "DataConfig",
           "Prefetcher", "SyntheticCorpus", "ShapeConfig", "build_model",
           "OptConfig", "make_optimizer", "make_compressor",
           "make_local_mesh", "make_train_mesh", "batch_shardings",
           "param_shardings", "init_train_state", "make_train_step",
           "parse_args", "train", "run", "make_model_batch", "TrainRun"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b",
                    help=f"one of {ARCHS} or a register_config()'d name")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression with error feedback")
    ap.add_argument("--optimizer", choices=["adamw", "adafactor"],
                    default="adamw")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the host")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default=None,
                    help="weights and activations (default: the config's)")
    ap.add_argument("--adam-eps", type=float, default=OptConfig.eps)
    return ap.parse_args(argv)


class TrainRun(NamedTuple):
    """What :func:`train` leaves: the loss of each step run, each step's
    seconds (host clock, ending when the loss reached the host), the final
    train state and the step function that made it."""
    losses: List[float]
    step_seconds: List[float]
    state: Dict[str, Any]
    step_fn: Callable


def _rank_device(device):
    """This rank's device: ``--device``, or the card of its local rank."""
    if device is None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", "0"))
        return torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device(device)


def train(args: argparse.Namespace) -> TrainRun:
    """The training run :func:`run` makes, from parsed arguments.  On the
    ranks of a group (one already joined, or started here from
    ``torch.distributed.run``'s environment) every rank calls it and
    returns its own shards of the state."""
    started = False
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        dist.init_process_group("gloo")
        started = True
    try:
        return _train(args)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args: argparse.Namespace) -> TrainRun:
    multi = dist.is_initialized()
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.model_axis > 1 and not multi:
        raise ValueError(
            f"--model-axis {args.model_axis} needs a group of ranks: run "
            f"under torch.distributed.run, or join one first "
            f"(launch.mesh.init_group)")
    cfg = cfg.replace(microbatch=args.microbatch)
    if args.dtype is not None:
        cfg = cfg.replace(dtype=args.dtype, param_dtype=args.dtype)
    device = _rank_device(args.device)
    mesh = make_train_mesh(args.model_axis, device) if multi else None
    lead = mesh is None or mesh.rank == 0
    if lead and (cfg.embeds_input or cfg.enc_dec):
        print(f"note: {args.arch} uses a stub frontend; training on "
              f"synthetic tokens routed through the stub inputs")
    model = build_model(cfg, device, trainable=True)
    opt = make_optimizer(OptConfig(
        lr=args.lr, total_steps=args.steps, eps=args.adam_eps,
        warmup_steps=min(20, args.steps // 5),
        state_dtype=cfg.opt_state_dtype, kind=args.optimizer))
    compress = make_compressor() if args.compress else None
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    n_data = 1 if mesh is None else mesh.shape["data"]
    corpus = SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, hosts=n_data,
        host_id=0 if mesh is None else mesh.coords["data"]))

    state = init_train_state(model, opt, torch.Generator(
        device=device).manual_seed(args.seed), mesh)
    specs = None if mesh is None else state_specs(state, state["params"])
    start_step = 0
    if args.ckpt_dir and args.resume:
        ls = latest_step(args.ckpt_dir)
        if ls is not None:
            _load_into(state, restore_checkpoint(args.ckpt_dir, ls, state,
                                                 device, mesh, specs))
            start_step = ls
            if lead:
                print(f"resumed from step {ls}")

    step_fn = make_train_step(model, opt, compress=compress)
    pf = Prefetcher(corpus, start_step=start_step)
    losses: List[float] = []
    seconds: List[float] = []
    t0 = time.time()
    try:
        for i in range(start_step, args.steps):
            step_idx, host_batch = next(pf)
            if step_idx != i:
                raise RuntimeError(f"prefetcher gave step {step_idx}, "
                                   f"expected {i}")
            t1 = time.perf_counter()
            batch = make_model_batch(cfg, host_batch, device, mesh)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            seconds.append(time.perf_counter() - t1)
            losses.append(loss)
            if lead and (i % args.log_every == 0 or i == args.steps - 1):
                print(f"step {i:5d}  loss {loss:8.4f}  "
                      f"lr {float(metrics['lr']):.2e}  {time.time() - t0:6.1f}s"
                      f"  ({shape.tokens / seconds[-1]:.0f} tok/s)",
                      flush=True)
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, i + 1, state, mesh=mesh,
                                specs=specs)
    finally:
        pf.close()
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, state, mesh=mesh,
                        specs=specs)
    return TrainRun(losses, seconds, state, step_fn)


def run(argv=None) -> List[float]:
    """Train as the command line says; returns the loss of each step run."""
    return train(parse_args(argv)).losses


@torch.no_grad()
def _load_into(state: Any, restored: Any) -> None:
    """Copy a restored state's tensors into ``state``'s, in place (the
    parameters stay the model's own)."""
    if isinstance(state, dict):
        for k, v in state.items():
            if torch.is_tensor(v):
                v.copy_(restored[k])
            else:
                _load_into(v, restored[k])
    else:
        raise TypeError(f"unexpected train state node {type(state)}")


def make_model_batch(cfg: ModelConfig, host_batch: Dict[str, np.ndarray],
                     device: torch.device, mesh=None
                     ) -> Dict[str, torch.Tensor]:
    """The pipeline's numpy batch (this rank's part over ``mesh``) as
    tensors on ``device``, in each family's input layout, with the
    reference's stub frontends: for the encoder-decoder, ``frames`` ``[B,
    enc_frames, D]`` bf16 N(0, 1) from a ``torch.Generator`` seeded 7 (the
    same frames every step, as the reference folds the same key), drawn
    for the global batch and cut to this rank's rows as ``batch_spec``
    cuts ``frames``, so a data rank reads the rows a one-rank run gives
    it; for a model fed
    embeddings, ``embeds`` = the tokens' rows of a ``[vocab, D]`` bf16
    N(0, 1) table from a generator seeded 11, and with M-RoPE the ids
    ``0 .. S-1`` on all three streams.  The generators are torch's on
    ``device``, so the numbers are not ``jax.random``'s: the layouts,
    shapes, dtypes and distributions are the reference's, the values
    not."""
    check_supported(cfg)
    tokens, labels = (torch.from_numpy(host_batch[k]).to(device)
                      for k in ("tokens", "labels"))
    b, s = tokens.shape
    if cfg.enc_dec:
        n = 1 if mesh is None else mesh.axis_size(mesh_axes(mesh)[0])
        gen = torch.Generator(device=device).manual_seed(7)
        frames = torch.randn((b * n, cfg.enc_frames, cfg.d_model),
                             generator=gen, device=device,
                             dtype=torch.bfloat16)
        if mesh is not None:
            frames = shard(frames, batch_spec("frames", tuple(frames.shape),
                                              mesh), mesh)
        return {"frames": frames, "tokens": tokens, "labels": labels}
    if cfg.embeds_input:
        gen = torch.Generator(device=device).manual_seed(11)
        table = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                            device=device, dtype=torch.bfloat16)
        batch = {"embeds": table[tokens.long()], "labels": labels}
        if cfg.rope == "mrope":
            batch["positions"] = torch.arange(
                s, dtype=torch.int32, device=device).expand(3, b, s)
        return batch
    return {"tokens": tokens, "labels": labels}


if __name__ == "__main__":
    run()
