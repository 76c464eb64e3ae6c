"""The port's package surface mirrors the JAX package's: each port
package's ``__all__`` (or, where the reference has none, its public names)
covers the reference's, less the names listed in ``NO_COUNTERPART`` with
their reasons.  The two oracles ``kernels.ref`` gained are held to the
reference's on one input each."""

import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import ref as port_ref

PACKAGES = ("core", "serve", "models", "discover", "obs", "configs",
            "kernels.ref", "launch.mesh", "optim.adamw", "optim.compress",
            "train.step", "train.sharding", "models.pspec",
            "checkpoint.store", "data.pipeline", "launch.train",
            "models.moe", "train.monitor", "models.linear_attn",
            "models.rwkv", "models.ssm", "roofline", "launch.specs")

_PACKS = ("the JAX package's padded input packs have no counterpart: the "
          "port lays a group's edge lists end to end (ROADMAP A)")
_HLO = ("parses XLA's compiled HLO text for collective bytes; the port "
        "compiles no HLO and counts its collectives as they run "
        "(parallel/collectives.STAGED)")
_TPU = "describes a TPU pod (v5e), which the port does not run on"
_MOE_UNUSED = ("imported by the reference's moe.py and not used there; the "
               "port's moe.py does not import it")
_GSPMD = ("the reference's GSPMD layout hint; the port's spmd body gathers "
          "the experts whole and its ep body is explicit")
_TRACE = ("the port's routing_trace reads the routing from the block as it "
          "runs (block_attend), so it normalises nothing itself and needs "
          "no config type")
_ANNOTATE = ("the reference's record_function marks behind an env knob; "
             "the port's discovery records its spans into one tracer while "
             "a torch.profiler session records (obs.profile), on the "
             "trace's clock, so no second span system runs beside it")
NO_COUNTERPART = {
    "core": {"plan_input_arrays": _PACKS},
    "obs": {"annotate": _ANNOTATE},
    "serve": {"plan_input_arrays": _PACKS},
    "roofline": {"parse_collectives": _HLO},
    "launch.mesh": {"make_production_mesh": _TPU, "PEAK_FLOPS_BF16": _TPU,
                    "HBM_BW": _TPU, "ICI_BW": _TPU},
    "models.moe": {"MlpParams": _MOE_UNUSED, "mlp_apply": _MOE_UNUSED,
                   "constrain": _GSPMD},
    "train.monitor": {"rms_norm": _TRACE, "ModelConfig": _TRACE},
}


def surface(mod, package: str) -> set:
    """``__all__``, or the public names the module defines or re-exports
    from its own package (not typing, ``__future__`` or a framework)."""
    names = getattr(mod, "__all__", None)
    if names is not None:
        return set(names)
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and getattr(v, "__module__", package).split(".")[0] == package}


@pytest.mark.parametrize("name", PACKAGES)
def test_port_surface_covers_the_reference(name):
    ref = surface(importlib.import_module(f"repro.{name}"), "repro")
    port = surface(importlib.import_module(f"repro_torch.{name}"),
                   "repro_torch")
    allowed = NO_COUNTERPART.get(name, {})
    assert ref - port - set(allowed) == set()
    # every exception is still a gap, and a gap of the reference's
    assert not set(allowed) & port
    assert set(allowed) <= ref


def test_segment_hist_ref_equals_the_reference():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 9, size=200).astype(np.int32)
    values = rng.integers(0, 5, size=(200, 3)).astype(np.float32)
    got = port_ref.segment_hist_ref(torch.from_numpy(codes),
                                    torch.from_numpy(values), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_ref.segment_hist_ref(jnp.asarray(codes), jnp.asarray(values), 9)))


@pytest.mark.parametrize("causal", (True, False))
def test_flash_attention_ref_equals_the_reference(causal):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 17, 4, 32)).astype(np.float32)
               for _ in range(3))
    got = port_ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal)
    want = jax_ref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                       causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
