"""RWKV's and Hymba's decode over a training mesh ``(1, 4)`` on the CPU,
float32, held to the JAX package's ``make_decode_step(model, mesh)`` and to
one rank of the port: the KV cache's sequence axis over ``model`` and the
recurrent states' heads over ``model`` where they divide it (``wkv`` and
``ssm``; the 5-head Hymba keeps its SSM state whole and decodes it on
every rank).

The module fixture is ``tests/test_torch_subquadratic_mesh.py``'s
``mesh_runs`` for the ``"decode"`` part: a gloo group of 4 spawned ranks
and the JAX reference on four fake devices, on the same perturbed weights.
Each case reads the logits of a decode step at each of 8 positions into a
16-long cache, and of a prefill of 4 tokens followed by decode steps:
against JAX's (which decodes every position) and one rank's at
``rtol=atol=1e-4`` (``tests/test_torch_train_mesh.py``'s bar).
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.models.model import build_model
from repro_torch.train import step as tstep
from tests import torch_mesh_ranks as R
from tests.test_torch_subquadratic_mesh import _port_params, mesh_runs

LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_CASES = sorted(R.SUBQ_DECODE)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(tmp_path_factory.mktemp("subq_mesh_decode"), "decode",
                     (4,))


@functools.lru_cache(maxsize=None)
def _one_rank_decode(name):
    _, variant, prompt = R.SUBQ_DECODE[name]
    model = build_model(R.subq_config(variant), "cpu")
    model.load_state_dict(_port_params(variant))
    toks = torch.from_numpy(R.subq_tokens(name))
    every, after = R.subq_decode_logits(model, toks, prompt,
                                        tstep.make_decode_step(model))
    return every.numpy(), after.numpy()


@pytest.mark.parametrize("name", DECODE_CASES)
def test_mesh_decode_matches_jax(runs, name):
    _, _, prompt = R.SUBQ_DECODE[name]
    got = runs[4][name]
    want = runs["jax"][f"decode/{name}"]
    assert got["every"].shape == want.shape
    np.testing.assert_allclose(got["every"], want, **LOGITS_TOL)
    np.testing.assert_allclose(got["after"], want[:, prompt - 1:],
                               **LOGITS_TOL)


@pytest.mark.parametrize("name", DECODE_CASES)
def test_mesh_decode_matches_one_rank(runs, name):
    got = runs[4][name]
    every, after = _one_rank_decode(name)
    np.testing.assert_allclose(got["every"], every, **LOGITS_TOL)
    np.testing.assert_allclose(got["after"], after, **LOGITS_TOL)
