"""The cell and tooling modules against the JAX package, on the CPU:
``shape_cells`` and ``configs.all_cells``, ``launch/specs.py``'s stand-ins
and concrete batches, and ``roofline.py``; and a tree diff that every
module of the JAX package has a port file, or a recorded reason why not.

* ``shape_cells(arch)`` and ``all_cells()`` equal the reference's.
* For every ``(arch, shape)`` cell, ``train_batch``, ``prefill_batch``
  and ``decode_batch`` (its one-token batch and its cache, ``decode_32k``'s
  included) give ``meta`` tensors of the reference's shapes and dtypes.
* ``concrete=True`` at a small shape: every tensor equals the reference's
  array element for element.
* ``model_flops`` at every cell and ``roofline_terms`` at the reference's
  constants equal the reference's exactly (the same float64 arithmetic).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import roofline as jroofline
from repro.launch import specs as jspecs
from repro.models import config as jconfig
from repro_torch import configs, roofline
from repro_torch.launch import specs
from repro_torch.models import config

ROOT = Path(__file__).resolve().parents[1]
SMALL = config.ShapeConfig("small", 16, 2, "train")
# the reference's modules with no port file, and why
NO_PORT = {
    "compat.py": "JAX version shims (shard_map, set_mesh, AxisType across "
                 "jax releases); the port imports no JAX",
    "hlo_analysis.py": "re-derives FLOPs, bytes and collective traffic from "
                       "XLA's compiled HLO text; the port compiles no HLO "
                       "(it counts its collectives as they run, "
                       "parallel/collectives.STAGED)",
    "launch/dryrun.py": "lowers and compiles every cell with XLA on 512 "
                        "fake TPU devices; the port has no ahead-of-time "
                        "compile to dry-run (its meta stand-ins, "
                        "launch/specs.py, give each cell's shapes)",
}
# the reference's kernel modules and the port files that hold their kernels
RENAMED = {
    "kernels/attention_kernel.py": "kernels/attention.py",
    "kernels/bdeu_kernel.py": "kernels/bdeu.py",
    "kernels/mobius_kernel.py": "kernels/mobius.py",
    "kernels/segsum_kernel.py": "kernels/segsum.py",
    "kernels/hist_kernel.py": "kernels/segsum.py",
}


def _like(t: torch.Tensor, a) -> None:
    """``t`` is a meta tensor of ``a``'s shape and dtype."""
    assert t.device.type == "meta"
    assert tuple(t.shape) == tuple(a.shape)
    assert str(t.dtype)[len("torch."):] == np.dtype(a.dtype).name


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_shape_cells_equal_the_reference(arch):
    assert config.shape_cells(arch) == jconfig.shape_cells(arch)


def test_all_cells_equal_the_reference():
    assert configs.all_cells() == jconfigs.all_cells()
    assert len(configs.all_cells()) == 32


@pytest.mark.parametrize("arch,shape", jconfigs.all_cells())
def test_meta_stand_ins_have_the_references_shapes(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    shp = config.SHAPES[shape]
    for fn in ("train_batch", "prefill_batch"):
        got = getattr(specs, fn)(cfg, shp)
        want = getattr(jspecs, fn)(jcfg, shp)
        assert set(got) == set(want), fn
        for k in want:
            _like(got[k], want[k])
    got_bt, got_cache = specs.decode_batch(cfg, shp)
    want_bt, want_cache = jspecs.decode_batch(jcfg, shp)
    assert set(got_bt) == set(want_bt) and set(got_cache) == set(want_cache)
    for k in want_bt:
        _like(got_bt[k], want_bt[k])
    for k in want_cache:
        _like(got_cache[k], want_cache[k])


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_concrete_batches_equal_the_references(arch):
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    pairs = [(specs.train_batch(cfg, SMALL, True, "cpu"),
              jspecs.train_batch(jcfg, SMALL, True)),
             (specs.prefill_batch(cfg, SMALL, True, "cpu"),
              jspecs.prefill_batch(jcfg, SMALL, True)),
             *zip(specs.decode_batch(cfg, SMALL, True, "cpu"),
                  jspecs.decode_batch(jcfg, SMALL, True))]
    for got, want in pairs:
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.device.type == "cpu"
            w = np.asarray(jax.device_get(want[k]))
            assert str(t.dtype)[len("torch."):] == w.dtype.name, k
            np.testing.assert_array_equal(t.float().numpy(),
                                          w.astype(np.float32), err_msg=k)


@pytest.mark.parametrize("chips", (1, 4, 512))
def test_model_flops_equal_the_references(chips):
    for arch, shape in jconfigs.all_cells():
        got = roofline.model_flops(configs.get_config(arch),
                                   config.SHAPES[shape], chips)
        want = jroofline.model_flops(jconfigs.get_config(arch),
                                     jconfig.SHAPES[shape], chips)
        assert got == want, (arch, shape)


@pytest.mark.parametrize("per_device", (True, False))
def test_roofline_terms_equal_the_references(per_device):
    cost = {"flops": 3.7e15, "bytes accessed": 2.9e12}
    coll = {"all-gather": {"count": 4, "bytes": 1e9, "link_bytes": 1e9},
            "all-reduce": {"count": 2, "bytes": 5e8, "link_bytes": 1e9}}
    for chips in (1, 4):
        for cst, scale in (({}, 1.0), ({"flops": 0.0}, 1e-6),
                           ({"bytes accessed": 0.0}, 1e3)):
            c = {k: v * scale for k, v in {**cost, **cst}.items()}
            kw = dict(per_device_cost=per_device, peak_flops=197e12,
                      hbm_bw=819e9, ici_bw=50e9)
            assert roofline.roofline_terms(c, coll, chips, **kw) == \
                jroofline.roofline_terms(c, coll, chips, **kw)
    h100 = roofline.roofline_terms(cost, coll, 1)
    assert h100["t_compute_s"] == cost["flops"] / 989e12
    assert h100["t_memory_s"] == cost["bytes accessed"] / 3.35e12
    assert h100["t_collective_s"] == 2e9 / 450e9
    assert h100["bottleneck"] == "compute"


def test_every_reference_module_has_a_port_file_or_a_reason():
    """Tree diff: each ``src/repro/**.py`` has its port file at the same
    path under ``src/repro_torch/`` (a kernel module at ``RENAMED``'s),
    but the modules of ``NO_PORT``, each recorded with its reason, which
    have none."""
    ref, port = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    missing = []
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref).as_posix()
        if rel in NO_PORT:
            assert not (port / rel).exists(), f"{rel} has a port file now"
            continue
        if not (port / RENAMED.get(rel, rel)).is_file():
            missing.append(rel)
    assert missing == []
    for rel, why in NO_PORT.items():
        assert (ref / rel).is_file() and len(why) > 40, rel
