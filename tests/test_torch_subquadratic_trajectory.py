"""The trajectory of 6 AdamW steps of the reduced ``rwkv6-1.6b`` in both
packages on the CPU, float32, step by step, at the launcher's settings
(lr 3e-4, ``warmup_steps = min(20, 6 // 5) = 1``, 6 steps in all; batch 4
x 256 of corpus seed 0; ``LM.init`` from key 0, carried across by
``params_from_jax``).

RWKV6-1.6B trained at full size on the card (phase 20 (d)) reads a loss
jump at step 1 (11.58, then 17.94) after the one warm-up step.  This
holds the port's steps to the reference's at the reduced size, where the
JAX package reads 6.0466, 6.0302, 5.9470, 6.0093, 5.9637, 5.9736: no
jump.  ``tests/rwkv_trajectory_full_width.py`` runs the same comparison
at RWKV6-1.6B's full width with 2 layers, as a script.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JSyntheticCorpus
from repro.models.model import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

ARCH = "rwkv6-1.6b"
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=6)
STEPS, BATCH, SEQ, SEED = 6, 4, 256, 0
LOSS_RTOL = 1e-5
# the largest rise from one step to the next in either trajectory: the
# JAX package's rises 0.062 at step 3 (the card's jump at full size was
# 6.36)
MAX_RISE = 0.1


def _jax_losses(params):
    cfg = jconfigs.get_reduced(ARCH).replace(dtype="float32",
                                             param_dtype="float32")
    model = jax_build_model(cfg)
    opt = jadamw.make_optimizer(jadamw.OptConfig(**OPT))
    state = {"params": params, "opt": opt.init(params)}
    fn = jax.jit(jstep.make_train_step(model, opt))
    corpus = JSyntheticCorpus(JDataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                          global_batch=BATCH, seed=SEED))
    losses = []
    for i in range(STEPS):
        state, metrics = fn(state, {k: jnp.asarray(v)
                                    for k, v in corpus.batch(i).items()})
        losses.append(float(metrics["loss"]))
    return losses


def _port_losses(params):
    cfg = configs.get_reduced(ARCH).replace(dtype="float32",
                                            param_dtype="float32")
    model = build_model(cfg, "cpu", trainable=True)
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    opt = adamw.make_optimizer(adamw.OptConfig(**OPT))
    weights = dict(model.named_parameters())
    state = {"params": weights, "opt": opt.init(weights)}
    fn = tstep.make_train_step(model, opt)
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                        global_batch=BATCH, seed=SEED))
    losses = []
    for i in range(STEPS):
        state, metrics = fn(state, {k: torch.from_numpy(v)
                                    for k, v in corpus.batch(i).items()})
        losses.append(float(metrics["loss"]))
    return losses


def test_rwkv_trajectory_matches_jax():
    """The losses step by step within 1e-5 relative, and neither
    trajectory rises by more than ``MAX_RISE`` from one step to the
    next.  Prints both (``pytest -s``)."""
    cfg = jconfigs.get_reduced(ARCH).replace(dtype="float32",
                                             param_dtype="float32")
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    want = _jax_losses(params)
    got = _port_losses(params)
    print(f"reduced {ARCH}, {STEPS} AdamW steps: port {got}, JAX {want}")
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert max(np.diff(want)) < MAX_RISE and max(np.diff(got)) < MAX_RISE
