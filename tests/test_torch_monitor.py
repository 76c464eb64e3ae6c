"""The port's MoE routing monitor (``repro_torch.train.monitor``) against
the JAX package's ``repro.train.monitor``, on the reduced
``qwen3-moe-30b-a3b`` with the JAX package's ``LM.init`` weights carried
across by ``params_from_jax``.

* ``routing_db`` and ``routing_ct`` on the same ``eidx``: the database's
  arrays, the complete ct-table and the stats equal the JAX package's
  (which counts over the dense executor) bit for bit, the port's over
  the sparse one (K1, K2, K3 on the card), and equal a direct numpy
  count (positives by ``bincount``; negatives = tokens in the bucket x
  experts in the group - positives).
* ``routing_trace`` pin: the port's trace is the routing each layer's MoE
  used, equal to the JAX package's routing at the MoE input
  (``rms_norm(x + attention, norm2)``), computed here from JAX functions.
  The JAX package's own ``routing_trace`` differs from it, and equals the
  routing of ``rms_norm`` of the block's input (ROADMAP C).
* The example's ``main()`` on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models.layers import rms_norm as jrms
from repro.models.model import build_model as jax_build_model
from repro.models.transformer import block_apply as jblock_apply
from repro.train import monitor as jmon
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.train import monitor as tmon

ARCH = "qwen3-moe-30b-a3b"
B, S = 4, 64


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = jconfigs.get_reduced(ARCH).replace(dtype="float32",
                                               param_dtype="float32")
    cfg = configs.get_reduced(ARCH).replace(dtype="float32",
                                            param_dtype="float32")
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    lm = build_model(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       cfg))
    return jm, params, lm


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 384, (B, S),
                                                dtype=np.int32)


def _eidx(seed, n_experts=8, k=2):
    """[B, S, K] distinct expert ids a token, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return np.stack([np.stack([rng.choice(n_experts, k, replace=False)
                               for _ in range(S)]) for _ in range(B)]
                    ).astype(np.int32)


def direct_count(eidx, buckets, n_experts, tab):
    """The complete table over (Routed?, bucket, group) counted directly,
    laid out on ``tab``'s axes."""
    tok_b = buckets.reshape(-1)
    exp_g = (np.arange(n_experts) * 4) // n_experts
    pos = np.zeros((4, 4))                                # [group, bucket]
    pairs = np.unique(np.repeat(np.arange(tok_b.size), eidx.shape[-1])
                      * n_experts + eidx.reshape(-1))
    cell = exp_g[pairs % n_experts] * 4 + tok_b[pairs // n_experts]
    pos += np.bincount(cell, minlength=16).reshape(4, 4)
    total = np.outer(np.bincount(exp_g, minlength=4),
                     np.bincount(tok_b, minlength=4))
    full = np.stack([total - pos, pos], axis=-1)          # [group, bucket, R]
    names = [str(v).split("(")[0] for v in tab.vars]
    order = [{"group": 0, "bucket": 1, "Routed?": 2}[n] for n in names]
    return full.transpose(order)


@pytest.mark.parametrize("seed", range(4))
def test_routing_db_and_ct_equal_jax_and_a_direct_count(seed):
    eidx = _eidx(seed)
    buckets = (_tokens(seed) % 4).astype(np.int32)
    jdb = jmon.routing_db(jnp.asarray(eidx), jnp.asarray(buckets), 8)
    db = tmon.routing_db(torch.from_numpy(eidx), torch.from_numpy(buckets),
                         8)
    for name in ("token", "expert"):
        for attr, col in jdb.entities[name].attrs.items():
            assert np.array_equal(db.entities[name].attrs[attr],
                                  np.asarray(col)), (name, attr)
    jrel, rel = jdb.relations["Routed"], db.relations["Routed"]
    assert np.array_equal(rel.src, np.asarray(jrel.src))
    assert np.array_equal(rel.dst, np.asarray(jrel.dst))
    jtab, jstats = jmon.routing_ct(jdb)
    ops.reset_counts()
    tab, stats = tmon.routing_ct(db, device="cpu")
    # the plain versions of what launches K1-K3 on the card
    assert all(ops.PLAIN_CALLS[k] > 0 for k in ("segsum_ones", "segsum_rows",
                                                "mobius"))
    assert [str(v) for v in tab.vars] == [str(v) for v in jtab.vars]
    got = tab.counts.numpy()
    assert got.tobytes() == np.asarray(jtab.counts).tobytes()
    assert stats == jstats
    np.testing.assert_array_equal(got, direct_count(eidx, buckets, 8, tab))
    assert stats["routed_pairs"] == B * S * 2


def _jax_routing(x, p, k, dtype):
    """top_k of the softmax of ``x @ router`` (float32 accumulation)."""
    logits = jnp.einsum("bsd,de->bse", x, p.router.astype(dtype),
                        preferred_element_type=jnp.float32)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1), k)[1])


def _jax_moe_input_routing(jm, params, tokens):
    """Each layer's routing at the MoE input, ``rms_norm(x + attention,
    norm2)``, from the JAX package's functions; and each layer's routing
    of ``rms_norm`` of the block's input."""
    cfg = jm.cfg
    x = jm._embed_in(params, {"tokens": tokens})
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    at_moe, at_input = [], []
    for i in range(cfg.n_layers):
        p = jax.tree.map(lambda a: a[i], params["blocks"])
        at_input.append(_jax_routing(jrms(x, p["norm2"]), p["moe"],
                                     cfg.top_k, x.dtype))
        q, k, v = jattn.qkv_project(p["attn"], jrms(x, p["norm1"]), cfg,
                                    positions)
        ao = jattn.sharded_attention(q, k, v, causal=True,
                                     chunk=cfg.attn_chunk)
        mid = x + jnp.einsum("bsh,hd->bsd", ao.reshape(B, S, -1),
                             p["attn"].wo.astype(x.dtype))
        at_moe.append(_jax_routing(jrms(mid, p["norm2"]).astype(jnp.float32),
                                   p["moe"], cfg.top_k, jnp.float32))
        x, _ = jblock_apply(p, x, cfg, positions)
    return np.stack(at_moe), np.stack(at_input)


def test_routing_trace_is_the_routing_the_moe_used():
    jm, params, lm = _models()
    toks = _tokens(2)
    got = tmon.routing_trace(lm, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, B, S, 2)
    at_moe, at_input = _jax_moe_input_routing(jm, params, jnp.asarray(toks))
    np.testing.assert_array_equal(got.numpy(), at_moe)
    # the JAX package's trace reads the block's input instead
    jtrace = np.asarray(jmon.routing_trace(jm, params,
                                           {"tokens": jnp.asarray(toks)}))
    np.testing.assert_array_equal(jtrace, at_input)
    assert (jtrace != at_moe).mean() > 0.1


def test_example_runs_on_the_host():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "moe_routing_monitor_torch.py"
    spec = importlib.util.spec_from_file_location("moe_monitor_example",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    trace, out = mod.main(["--device", "cpu"])
    cfg = configs.get_reduced(ARCH)
    assert tuple(trace.shape) == (cfg.n_layers, 4, 64, cfg.top_k)
    for layer, (tab, stats) in out.items():
        assert stats["routed_pairs"] == 4 * 64 * cfg.top_k
        assert stats["pairs_total"] == 4 * 64 * cfg.n_experts
        assert float(tab.counts.sum()) == stats["pairs_total"]
