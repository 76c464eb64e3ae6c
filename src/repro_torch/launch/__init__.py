"""Launchers of the PyTorch port: the rank layout (:mod:`.mesh`), the
paper's discovery workload over the ranks of a ``torch.distributed``
group (:mod:`.discover`), training (:mod:`.train`) and each cell's
inputs (:mod:`.specs`)."""

from .mesh import make_local_mesh

__all__ = ["make_local_mesh"]
