"""The sub-quadratic blocks at depth: RWKV-6 and Hymba at their published
24 and 32 layers cut to 24, narrowed to ``d_model`` 128 (a reduced width
that the CPU runs in seconds), JAX ``LM.init`` weights carried across.

``forward`` of the first ``S - 1`` tokens against ``forward`` of ``S``
at position ``S - 2`` (the property the prefill and the decode rely on):
the chunk length follows S (64 at 128 tokens; 127 is prime, so 1), so
each length sums in another order.  In float32 the two agree within
1e-3 of the largest logit in both packages (about 1e-4 for Hymba, 1e-5
for RWKV).  In bf16 they do not: the
different roundings grow over the layers, and the JAX LM's own gap is
several % of the largest logit (``pytest -s`` prints it).  The port's bf16
gap is held within 1.5 times the JAX LM's, and the JAX LM's is held above
2e-2, phase 8's prefill bar, which is why ``chip_smoke.py`` phase 20
holds that bar in float32 and reads bf16's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.model import build_model as jax_build_model
from repro_torch import configs
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model

WIDE = {"rwkv6-1.6b": dict(d_model=128, d_ff=256, vocab=512),
        "hymba-1.5b": dict(d_model=128, d_ff=256, vocab=512, n_heads=4,
                           n_kv_heads=2, head_dim=32, ssm_heads=4,
                           n_layers=24)}
S = 128


@functools.lru_cache(maxsize=None)
def _gaps(arch, dtype):
    """(JAX gap, port gap): max |forward(S-1)[S-2] - forward(S)[S-2]| over
    the largest logit at S-2."""
    kw = dict(WIDE[arch], dtype=dtype, param_dtype=dtype)
    jcfg = jconfigs.get_config(arch).replace(**kw)
    cfg = configs.get_config(arch).replace(**kw)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    lm = build_model(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       cfg))
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, S),
                                             dtype=np.int32)
    fwd = jax.jit(jm.forward)
    runs = (lambda t: np.asarray(fwd(params, {"tokens": jnp.asarray(t)})[0],
                                 np.float32),
            lambda t: lm.forward({"tokens": torch.from_numpy(t)}).float()
            .numpy())
    gaps = []
    for run in runs:
        want, got = run(toks)[:, S - 2], run(toks[:, :-1])[:, S - 2]
        gaps.append(float(np.abs(got - want).max() / np.abs(want).max()))
    return tuple(gaps)


@pytest.mark.parametrize("arch", tuple(WIDE))
def test_float32_lengths_agree(arch):
    jax_gap, port_gap = _gaps(arch, "float32")
    assert jax_gap < 1e-3 and port_gap < 1e-3, (jax_gap, port_gap)


@pytest.mark.parametrize("arch", tuple(WIDE))
def test_bf16_length_gap_tracks_jax(arch):
    jax_gap, port_gap = _gaps(arch, "bfloat16")
    print(f"{arch} bf16, forward({S - 1}) against forward({S}) at {S - 2}, "
          f"over the largest logit: JAX {jax_gap:.4f}, port {port_gap:.4f}")
    assert jax_gap > 2e-2
    assert port_gap <= 1.5 * jax_gap
