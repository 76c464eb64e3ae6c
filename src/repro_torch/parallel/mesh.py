"""The training mesh, and the cut of a tensor to a rank's shard.

A :class:`Mesh` is a rank-major ``(data, model)`` layout of ranks, with a
process group for each axis when :func:`repro_torch.launch.mesh
.make_train_mesh` made it, or a layout alone (:func:`abstract_mesh`, the
counterpart of JAX's ``AbstractMesh``).  A spec is what a
``PartitionSpec`` holds: one entry per dim, each a mesh axis name, a tuple
of them, or ``None`` (replicated); :mod:`repro_torch.train.sharding` holds
the rules that give each tensor its spec.

Every rank of an SPMD step holds its shard of each sharded tensor: the
block of the global tensor at its coordinates along the axes of the spec
(:func:`shard`); :func:`unshard` gathers the blocks back (a collective over
the mesh's groups).  A sharded model's parameters carry their ``spec``
and their ``mesh`` (``LM.shard_``), and whatever updates them reads both
from there (:func:`param_layout`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .collectives import all_gather

Spec = Tuple[Any, ...]


class Mesh:
    """A rank-major layout of ``world`` ranks over named axes.

    Args:
        shape: axis name -> size, in mesh order (``{"data": 2, "model":
            2}``).
        rank: this rank's index in the mesh (rank-major: the last axis
            varies fastest).
        groups: axis name -> the process group of the ranks that share
            this rank's coordinates on every other axis; ``None`` for a
            layout alone.
        device: where this rank's shards live.
    """

    def __init__(self, shape: Mapping[str, int], rank: int = 0,
                 groups: Optional[Mapping[str, Any]] = None,
                 device: Optional[torch.device] = None):
        self.shape: Dict[str, int] = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.groups = dict(groups) if groups is not None else None
        self.device = device
        coords, rest = {}, rank
        for name in reversed(self.axis_names):
            coords[name] = rest % self.shape[name]
            rest //= self.shape[name]
        self.coords: Dict[str, int] = {n: coords[n] for n in self.axis_names}

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"groups={'yes' if self.groups else 'no'})")

    def axis_size(self, axes) -> int:
        """The ranks along ``axes`` (a name, a tuple of names, or None)."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            return self.shape[axes]
        return int(np.prod([self.shape[a] for a in axes], dtype=np.int64))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (row-major over a tuple)."""
        if axes is None:
            return 0
        if isinstance(axes, str):
            return self.coords[axes]
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axis: str):
        """The process group along one axis; raises for a layout alone."""
        if self.groups is None:
            raise RuntimeError("this mesh is a layout alone: it holds no "
                               "process groups (make_train_mesh makes one "
                               "that does)")
        return self.groups[axis]


def abstract_mesh(shape: Mapping[str, int]) -> Mesh:
    """A layout of ``shape`` with no groups, seen from rank 0."""
    return Mesh(shape)


def mesh_axes(mesh: Mesh) -> Tuple[Tuple[str, ...], str]:
    """(fsdp_axes, tp_axis) for a mesh."""
    if "pod" in mesh.axis_names:
        return ("pod", "data"), "model"
    return ("data",), "model"


def local_shape(shape: Sequence[int], spec: Optional[Spec],
                mesh: Mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of global ``shape``."""
    if not spec:
        return tuple(shape)
    out = []
    for dim, axes in zip(shape, spec):
        n = mesh.axis_size(axes)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {axes} ({n})")
        out.append(dim // n)
    return tuple(out) + tuple(shape[len(spec):])


def shard(x: torch.Tensor, spec: Optional[Spec], mesh: Mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` (a view where it can
    be; ``x`` itself for a replicated spec)."""
    if not spec:
        return x
    for dim, axes in enumerate(spec):
        n = mesh.axis_size(axes)
        if n > 1:
            size = x.shape[dim] // n
            if size * n != x.shape[dim]:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split over {axes} ({n})")
            x = x.narrow(dim, mesh.axis_index(axes) * size, size)
    return x


def spec_axes(spec: Optional[Spec]) -> Tuple[str, ...]:
    """The mesh axes a spec shards over, in dim order."""
    out = []
    for axes in spec or ():
        if axes is None:
            continue
        out.extend((axes,) if isinstance(axes, str) else axes)
    return tuple(out)


def unshard(x: torch.Tensor, spec: Optional[Spec], mesh: Mesh
            ) -> torch.Tensor:
    """The global tensor from every rank's block ``x`` (an all-gather over
    each sharding axis; every rank of those groups must call it)."""
    if not spec:
        return x
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        for axis in reversed((axes,) if isinstance(axes, str) else axes):
            if mesh.shape[axis] > 1:
                x = all_gather(x, dim, mesh.group(axis))
    return x


def spec_of(p: torch.Tensor) -> Optional[Spec]:
    """The spec a sharded model's parameter carries (``LM.shard_``), or
    ``None``."""
    return getattr(p, "spec", None)


def param_layout(params: Mapping[str, torch.Tensor]
                 ) -> Tuple[Optional[Mesh], Dict[str, Optional[Spec]]]:
    """``(mesh, {name: spec})`` of a dict of parameters: the mesh they are
    sharded over (``None`` for whole tensors) and each one's spec.

    Raises:
        ValueError: a parameter carries a spec and no mesh, some carry a
            mesh and others none, or they carry different meshes: an
            update over such parameters would take per-shard norms and
            statistics, and the ranks would part.
    """
    meshes = [getattr(p, "mesh", None) for p in params.values()]
    specs = {n: spec_of(p) for n, p in params.items()}
    mesh = next((m for m in meshes if m is not None), None)
    if mesh is None:
        if any(s is not None for s in specs.values()):
            raise ValueError("a parameter carries a spec but no mesh: shard "
                             "the model with LM.shard_, which sets both")
        return None, specs
    if any(m is not mesh for m in meshes):
        raise ValueError("the parameters are not all sharded over one mesh")
    return mesh, specs
