"""Hymba trained over a training mesh on the CPU, float32: the reduced
``hymba-1.5b`` at ``(2, 2)`` (its SSM and attention on the ``"heads"``
route) and a Hymba of 5 heads at ``(1, 4)`` (its SSM on the ``"chunks"``
route: each rank its chunks of the projections gathered whole, the chunk
states gathered over ``model``; its attention on the sequence route, K6
with ``q_offset``), 2 AdamW steps of 4 x 256, held to one rank of the port
and to the JAX package's mesh run by ``tests/test_torch_subquadratic_
mesh.py``'s bars and fixture helpers.

Also pinned: at ``a_log`` noise 0.5 the JAX package's Hymba gradients are
NaN at S = 256, where the port's stay finite; hence the mesh cases'
smaller ``a_log`` noise (``tests/torch_mesh_ranks.py``'s
``SUBQ_NOISE_A_LOG``).
"""

import jax
import numpy as np
import pytest
import torch

from repro.models.model import build_model as jax_build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from tests import torch_mesh_ranks as R
from tests.test_torch_subquadratic_mesh import (_jax_params, _jcfg,
                                                check_jax, check_moved,
                                                check_one_rank, mesh_runs)

TRAIN_CASES = sorted(R.subq_part("hymba")[0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(tmp_path_factory.mktemp("subq_mesh_hymba"), "hymba",
                     (4,))


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_mesh_steps_match_one_rank(runs, name):
    check_one_rank(runs, name)


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_mesh_steps_match_jax_on_the_mesh(runs, name):
    check_jax(runs, name)


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_the_steps_moved_every_parameter(runs, name):
    check_moved(runs, name)


def test_jax_hymba_gradients_turn_nan_where_the_ports_stay_finite():
    """At ``a_log`` noise 0.5 the JAX package's Hymba gradients are NaN at
    S = 256 (its masked pairs exponentiate positive sums before they are
    selected away: ``src/repro/models/linear_attn.py:104``); the port
    exponentiates them from ``-inf`` and stays finite."""
    variant = "hymba"
    jparams = _jax_params(variant, a_log=0.5)
    batch = R.subq_batches(R.subq_config(variant), 1)[0]
    model = jax_build_model(_jcfg(variant))
    _, jgrads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        jparams, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree.leaves(jgrads))
    lm = build_model(R.subq_config(variant), "cpu", trainable=True)
    lm.load_state_dict(params_from_jax(jparams, R.subq_config(variant)))
    loss, _ = lm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(lm.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
