"""End-to-end driver of the PyTorch port: train a ~100M-parameter dense LM
for a few hundred steps on one device, with the training path —
microbatch gradient accumulation, AdamW with warmup+cosine, the
deterministic data pipeline with prefetch, and atomic checkpoint/resume;
the JAX package's ``examples/train_100m.py``.

Fault tolerance demo: the run checkpoints every ``--ckpt-every`` steps; kill
it at any point and re-run with the same command — it resumes from the last
checkpoint (the data pipeline is keyed by step, so the token stream continues
exactly where it left off).

Run (the CUDA card):  python examples/train_100m_torch.py --steps 300
Quick, on the host:   python examples/train_100m_torch.py --steps 30 --tiny \
                          --device cpu
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import register_config          # noqa: E402
from repro_torch.launch import train as train_launcher   # noqa: E402
from repro_torch.models.config import ModelConfig        # noqa: E402


def config_100m() -> ModelConfig:
    # ~110M params: granite/llama-style dense decoder
    return ModelConfig(
        name="demo-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32768,
        block="attn", mlp="swiglu", rope="rope",
        attn_chunk=256, remat=False, scan_layers=True)


def config_tiny() -> ModelConfig:
    return config_100m().replace(name="demo-tiny", n_layers=2, d_model=128,
                                 n_heads=4, n_kv_heads=2, d_ff=512,
                                 vocab=2048)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--ckpt-dir",
                    default=str(ROOT / "build" / "train_100m_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--tiny", action="store_true",
                    help="2-layer stand-in for a fast smoke run")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the host")
    args = ap.parse_args()

    cfg = config_tiny() if args.tiny else config_100m()
    print(f"model: {cfg.name}, {cfg.param_count() / 1e6:.1f}M params")

    # reuse the launcher end-to-end (this is the public API)
    register_config(cfg.name, cfg)
    argv = ["--arch", cfg.name, "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--microbatch", str(args.microbatch),
            "--ckpt-dir", args.ckpt_dir, "--ckpt-every", str(args.ckpt_every),
            "--resume"]
    if args.device is not None:
        argv += ["--device", args.device]
    losses = train_launcher.run(argv)
    if losses:
        k = max(1, len(losses) // 10)
        first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
        print(f"\nloss: first-{k}-avg {first:.3f} -> last-{k}-avg {last:.3f}")
        if not last < first:
            sys.exit("loss did not decrease")
        print("training makes progress — loss decreased.")


if __name__ == "__main__":
    main()
