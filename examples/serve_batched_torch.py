"""Serve a model with batched requests on the PyTorch port: prefill + decode.

The port's counterpart of ``examples/serve_batched.py``: a batch of prompts
is prefilled once (writing the KV cache), then tokens are decoded step by
step with greedy sampling against the preallocated, fixed-shape cache.  On
the CUDA card (the default) the model is the architecture at its published
full size with random weights; on the CPU it is the reduced config, as the
JAX example runs it.

Run:  python examples/serve_batched_torch.py [arch] [n_new_tokens]
                                             [--device cpu|cuda]
      default: qwen2.5-3b, 24 new tokens, batch of 4 requests, the card.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.device import resolve_device, synchronize
from repro_torch.models.model import build_model


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="qwen2.5-3b")
    ap.add_argument("n_new", nargs="?", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="cpu, cuda or cuda:N (default: the CUDA card)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    arch, n_new = args.arch, args.n_new
    cfg = get_reduced(arch) if dev.type == "cpu" else get_config(arch)
    if cfg.enc_dec or cfg.embeds_input:
        print(f"{arch} needs a frontend stub; use a decoder-only arch")
        return
    model = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))

    batch_size, prompt_len, max_len = 4, 16, 16 + n_new
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (batch_size, prompt_len),
                           dtype=np.int32)

    # ---- prefill all requests at once, into the max-length cache --------
    cache = model.init_cache(batch_size, max_len)
    t0 = time.perf_counter()
    logits, cache = model.prefill(
        {"tokens": torch.from_numpy(prompts).to(dev)}, cache)
    synchronize(dev)
    t_prefill = time.perf_counter() - t0
    print(f"prefill: {batch_size} requests x {prompt_len} tokens "
          f"in {t_prefill * 1e3:.0f} ms")

    # ---- decode loop (greedy) -------------------------------------------
    tok = logits.argmax(dim=-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(n_new - 1):
        logits, cache = model.decode_step(cache, {"token": tok,
                                                  "pos": prompt_len + i})
        tok = logits.argmax(dim=-1)[:, None]
        out.append(tok)
    synchronize(dev)
    t_decode = time.perf_counter() - t0
    toks_per_s = batch_size * (n_new - 1) / t_decode
    print(f"decode: {n_new - 1} steps x {batch_size} requests in "
          f"{t_decode * 1e3:.0f} ms  ({toks_per_s:.0f} tok/s batched)")

    gen = torch.cat(out, dim=1).cpu().numpy()
    for b in range(batch_size):
        print(f"request {b}: prompt={prompts[b, :6].tolist()}... "
              f"generated={gen[b, :10].tolist()}...")
    assert gen.shape == (batch_size, n_new)
    print(f"OK — batched serving path works end-to-end on {dev}.")


if __name__ == "__main__":
    main()
