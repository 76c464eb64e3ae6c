"""RWKV6-1.6B's training trajectory at its full width, its depth cut, in
both packages on the CPU: a script, not a test (a step takes tens of
seconds here).

    PYTHONPATH=src python tests/rwkv_trajectory_full_width.py \\
        [--layers 2] [--dtype bfloat16|float32] [--seq 512] [--threads 4]

It trains RWKV6-1.6B's published configuration (d_model 2,048, 32 heads
of 64, d_ff 7,168, vocab 65,536) with 2 (``--layers``) of its 24 layers
for 6 AdamW steps at the launcher's settings (lr 3e-4, ``warmup_steps =
min(20, 6 // 5) = 1``), batch 4 of corpus seed 0, from the JAX package's
``LM.init`` (key 0) carried across by ``params_from_jax``, and prints each
package's losses step by step and their largest relative difference.  Phase 20 (d) of
``chip_smoke.py`` trains all 24 layers on the card at 4 x 2,048 in bf16;
this asks whether a jump at step 1 is the reference's own.
"""

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticCorpus as JCorpus  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus  # noqa
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCH, STEPS, BATCH, SEED = "rwkv6-1.6b", 6, 4, 0
OPT = dict(lr=3e-4, warmup_steps=min(20, STEPS // 5), total_steps=STEPS)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    kw = dict(n_layers=args.layers, dtype=args.dtype,
              param_dtype=args.dtype)
    jcfg = jconfigs.get_config(ARCH).replace(**kw)
    cfg = configs.get_config(ARCH).replace(**kw)
    data = dict(vocab=cfg.vocab, seq_len=args.seq, global_batch=BATCH,
                seed=SEED)

    t0 = time.perf_counter()
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    jopt = jadamw.make_optimizer(jadamw.OptConfig(
        state_dtype=jcfg.opt_state_dtype, **OPT))
    state = {"params": params, "opt": jopt.init(params)}
    fn = jax.jit(jstep.make_train_step(jmodel, jopt))
    corpus = JCorpus(JDataConfig(**data))
    want = []
    for i in range(STEPS):
        state, metrics = fn(state, {k: jnp.asarray(v)
                                    for k, v in corpus.batch(i).items()})
        want.append(float(metrics["loss"]))
    print(f"JAX package ({time.perf_counter() - t0:.0f} s): {want}",
          flush=True)
    del state, fn

    t0 = time.perf_counter()
    model = build_model(cfg, "cpu", trainable=True)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg))
    del params
    opt = adamw.make_optimizer(adamw.OptConfig(
        state_dtype=cfg.opt_state_dtype, **OPT))
    weights = dict(model.named_parameters())
    tstate = {"params": weights, "opt": opt.init(weights)}
    step = tstep.make_train_step(model, opt)
    corpus = SyntheticCorpus(DataConfig(**data))
    got = []
    for i in range(STEPS):
        tstate, metrics = step(tstate, {k: torch.from_numpy(v) for k, v
                                        in corpus.batch(i).items()})
        got.append(float(metrics["loss"]))
    print(f"port ({time.perf_counter() - t0:.0f} s): {got}", flush=True)
    rel = np.abs(np.asarray(got) - want) / np.abs(want)
    print(f"{ARCH} at full width, {args.layers} layers, {args.dtype}, "
          f"batch {BATCH} x {args.seq}: largest relative difference "
          f"{rel.max():.3e}; rise at step 1: JAX {want[1] - want[0]:+.4f}, "
          f"port {got[1] - got[0]:+.4f}")


if __name__ == "__main__":
    main()
