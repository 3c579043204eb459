"""Production mesh construction; port of ``repro.launch.mesh``.

Single pod = 16x16 = 256 devices, axes ('data', 'model').
Multi-pod = 2 pods = (2, 16, 16) = 512 devices, axes ('pod', 'data',
'model').  The port builds it as a ``torch.distributed`` ``DeviceMesh``
over the default process group, one device per rank.

A FUNCTION, not a module constant: importing this module touches no
process group.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.device import resolve_device

__all__ = ["make_production_mesh", "make_mesh_shape"]


def make_mesh_shape(multi_pod: bool = False):
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh over the default process group, one rank per
    device of ``device``'s type (CUDA unless ``device="cpu"``); raises
    when the group has fewer ranks than the mesh has devices."""
    import torch.distributed as dist
    dev = resolve_device(device)
    shape, axes = make_mesh_shape(multi_pod)
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {world} — start {n} "
            f"processes (one per device) with torch.distributed "
            f"initialised before building the production mesh")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)
