"""Planted faulty workers for ``tests/test_torch_distributed.py``: each
patches the port's sharded steps in its own process, then serves rank 0
as a sound worker would (``repro_torch.launch.mesh.serve_main``).  Kept out
of the test module so that a spawned worker imports only the port."""

import torch

from repro_torch.core import distributed
from repro_torch.launch.mesh import serve_main

# the hop and root-combine steps: a worker that skips them adds nothing
COUNTING_STEPS = (distributed._ONES, distributed._ROWS, distributed._KR)


def skipping_worker(rank, world, init_file, backend, device, timeout_s):
    """Joins every collective, but reduces zeros in place of its slice."""
    for op in COUNTING_STEPS:
        inner = distributed._STEPS[op]
        distributed._STEPS[op] = (
            lambda params, xs, dev, inner=inner:
            torch.zeros_like(inner(params, xs, dev)))
    serve_main(rank, world, init_file, backend, device, timeout_s)


def raising_worker(rank, world, init_file, backend, device, timeout_s):
    """Raises in its first counting step, after the scatter."""
    def boom(params, xs, dev):
        raise RuntimeError("planted: a worker failed in its step")
    for op in COUNTING_STEPS:
        distributed._STEPS[op] = boom
    serve_main(rank, world, init_file, backend, device, timeout_s)
