"""Brick meshes for the partitioned lattice: the port's counterpart of the
JAX device mesh that ``repro.compat.make_mesh`` builds.

A :class:`BrickMesh` names its axes and their sizes, and ``mesh.shape``
maps a name to its size as a JAX mesh's does, so an engine reads its brick
counts as the reference does (``mesh.shape[axis]``).  Where the bricks
live is the mesh's other half:

* with no process group, every brick lives in this process, on the
  engine's device;
* with a ``torch.distributed`` process group of ``prod(shape)`` ranks,
  each rank holds one brick: the rank's coordinates are its index in the
  row-major order of the axes, as devices fill a JAX mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BrickMesh", "make_mesh"]


@dataclasses.dataclass(frozen=True)
class BrickMesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    group: Optional[object] = None     # a torch.distributed ProcessGroup

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    def coords(self, index: int) -> Dict[str, int]:
        """Axis name -> coordinate of the ``index``-th member (rank) in
        row-major order."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(index,
                                                          self.sizes))))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              group=None) -> BrickMesh:
    """A mesh of ``shape`` named ``axis_names``.  With no ``group`` the
    bricks live in this process, on the engine's device; ``group``, a
    ``torch.distributed`` process group (or
    ``torch.distributed.group.WORLD``) of ``prod(shape)`` ranks, puts one
    brick on each rank."""
    sizes = tuple(int(s) for s in shape)
    names = tuple(str(a) for a in axis_names)
    if len(sizes) != len(names):
        raise ValueError(f"mesh shape {sizes} and axis names {names} differ "
                         f"in length")
    if len(set(names)) != len(names):
        raise ValueError(f"mesh axis names must be distinct, got {names}")
    if any(s < 1 for s in sizes):
        raise ValueError(f"mesh sizes must be >= 1, got {sizes}")
    if group is not None:
        import torch.distributed as dist
        world = dist.get_world_size(group)
        if world != int(np.prod(sizes)):
            raise ValueError(f"a mesh of shape {sizes} needs a process group "
                             f"of {int(np.prod(sizes))} ranks, got {world}")
    return BrickMesh(names, sizes, group)
