"""End-to-end training launcher on one device; the JAX package's
``repro.launch.train``.

Runs any ``--arch`` the port builds (full or reduced config) with the
training path: microbatch accumulation, AdamW/Adafactor,
checkpoint/resume, optional int8 gradient compression, and the
deterministic data pipeline.  It runs on the CUDA card unless
``--device`` names another device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt --resume \\
        --device cpu

Training over the ranks of a ``torch.distributed`` group (``--model-axis``
above 1; the reference's ``train/sharding.py``) is not ported yet
(ROADMAP item 14).
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, List, NamedTuple

import numpy as np
import torch

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
from ..train.step import init_train_state, make_train_step

__all__ = ["ARCHS", "get_config", "get_reduced", "latest_step",
           "restore_checkpoint", "save_checkpoint", "DataConfig",
           "Prefetcher", "SyntheticCorpus", "ShapeConfig", "build_model",
           "OptConfig", "make_optimizer", "make_compressor",
           "init_train_state", "make_train_step", "parse_args", "train",
           "run", "make_model_batch", "TrainRun"]


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
    return ap.parse_args(argv)


class TrainRun(NamedTuple):
    """What :func:`train` leaves: the loss of each step run, each step's
    seconds (host clock, ending when the loss reached the host), the final
    train state and the step function that made it."""
    losses: List[float]
    step_seconds: List[float]
    state: Dict[str, Any]
    step_fn: Callable


def train(args: argparse.Namespace) -> TrainRun:
    """The training run :func:`run` makes, from parsed arguments."""
    if args.model_axis > 1:
        raise NotImplementedError(
            "--model-axis above 1: training over a torch.distributed group "
            "(the reference's train/sharding.py) is not ported yet (ROADMAP "
            "item 14)")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = cfg.replace(microbatch=args.microbatch)
    device = resolve_device(args.device)
    model = build_model(cfg, device, trainable=True)
    opt = make_optimizer(OptConfig(
        lr=args.lr, total_steps=args.steps,
        warmup_steps=min(20, args.steps // 5),
        state_dtype=cfg.opt_state_dtype, kind=args.optimizer))
    compress = make_compressor() if args.compress else None
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch,
                                        seed=args.seed))

    state = init_train_state(model, opt, torch.Generator(
        device=device).manual_seed(args.seed))
    start_step = 0
    if args.ckpt_dir and args.resume:
        ls = latest_step(args.ckpt_dir)
        if ls is not None:
            _load_into(state, restore_checkpoint(args.ckpt_dir, ls, state,
                                                 device))
            start_step = ls
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
            batch = make_model_batch(cfg, host_batch, device)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            seconds.append(time.perf_counter() - t1)
            losses.append(loss)
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"step {i:5d}  loss {loss:8.4f}  "
                      f"lr {float(metrics['lr']):.2e}  {time.time() - t0:6.1f}s"
                      f"  ({shape.tokens / seconds[-1]:.0f} tok/s)",
                      flush=True)
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, i + 1, state)
    finally:
        pf.close()
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, state)
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
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """The pipeline's numpy batch as tensors on ``device``.  Stub
    frontends (embedding inputs, the encoder-decoder) are not ported
    (ROADMAP item 14)."""
    check_supported(cfg)
    return {k: torch.from_numpy(host_batch[k]).to(device)
            for k in ("tokens", "labels")}


if __name__ == "__main__":
    run()
