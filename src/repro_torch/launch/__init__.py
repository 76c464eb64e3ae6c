"""Launchers of the PyTorch port: the rank layout (:mod:`.mesh`) and the
paper's discovery workload over the ranks of a ``torch.distributed``
group (:mod:`.discover`)."""

from .mesh import make_local_mesh

__all__ = ["make_local_mesh"]
