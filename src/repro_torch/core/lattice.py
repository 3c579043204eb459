"""Structured-lattice problem builder; port of ``repro.core.lattice``.

The 3D EA lattice is stored as six directional weight arrays (one per
neighbor direction) so the update kernels need no index traffic.  The
weights come from the same edge list and seed as the reference, so the
two packages build bit-identical problems.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .coloring import lattice3d_coloring
from .device import resolve_device
from .graph import ea3d_edges

__all__ = ["LatticeProblem", "build_ea3d_lattice"]


@dataclasses.dataclass(frozen=True)
class LatticeProblem:
    L: int                      # active cubic extent
    dims: Tuple[int, int, int]  # padded global dims (X, Y, Z); Z == L
    seed: int
    n_colors: int
    h: torch.Tensor             # (X, Y, Z) f32
    w6: tuple                   # 6 x (X, Y, Z) f32: to -x, +x, -y, +y, -z, +z
    masks: torch.Tensor         # (n_colors, X, Y, Z) int8 update masks
    active: torch.Tensor        # (X, Y, Z) int8

    @property
    def n_active(self) -> int:
        return self.L ** 3

    def to(self, device) -> "LatticeProblem":
        return dataclasses.replace(
            self, h=self.h.to(device), w6=tuple(w.to(device) for w in self.w6),
            masks=self.masks.to(device), active=self.active.to(device))


def build_ea3d_lattice(L: int, seed: int = 0,
                       pad_xy: Optional[Tuple[int, int]] = None,
                       device=None) -> LatticeProblem:
    """EA3D instance as directional weight planes on ``device`` (CUDA
    unless ``device="cpu"`` is given; raises when no CUDA is present)."""
    device = resolve_device(device)
    ei, ej, ew = ea3d_edges(L, seed)
    X, Y = (L, L) if pad_xy is None else pad_xy
    if X < L or Y < L:
        raise ValueError("padding must not shrink the lattice")
    Z = L
    shape = (X, Y, Z)

    def coords(n):
        x, r = np.divmod(n, L * L)
        y, z = np.divmod(r, L)
        return x, y, z

    xi, yi, zi = coords(ei)
    xj, yj, zj = coords(ej)
    w6 = [np.zeros(shape, dtype=np.float32) for _ in range(6)]
    WXM, WXP, WYM, WYP, WZM, WZP = range(6)

    dx, dy = xj - xi, yj - yi
    dz = zj - zi
    # +x edges (i -> j at x+1)
    m = dx == 1
    w6[WXP][xi[m], yi[m], zi[m]] = ew[m]
    w6[WXM][xj[m], yj[m], zj[m]] = ew[m]
    # +y edges
    m = dy == 1
    w6[WYP][xi[m], yi[m], zi[m]] = ew[m]
    w6[WYM][xj[m], yj[m], zj[m]] = ew[m]
    # +z edges including the periodic wrap (dz == -(L-1) means zi == L-1 -> 0)
    m = (dz == 1) | (dz == -(L - 1))
    w6[WZP][xi[m], yi[m], zi[m]] = ew[m]
    w6[WZM][xj[m], yj[m], zj[m]] = ew[m]

    active = np.zeros(shape, dtype=np.int8)
    active[:L, :L, :L] = 1

    col = lattice3d_coloring(L)
    colors = col.colors.reshape(L, L, L)
    masks = np.zeros((col.n_colors,) + shape, dtype=np.int8)
    for c in range(col.n_colors):
        masks[c, :L, :L, :L] = (colors == c).astype(np.int8)

    return LatticeProblem(
        L=L, dims=shape, seed=seed, n_colors=col.n_colors,
        h=torch.zeros(shape, dtype=torch.float32, device=device),
        w6=tuple(torch.from_numpy(w).to(device) for w in w6),
        masks=torch.from_numpy(masks).to(device),
        active=torch.from_numpy(active).to(device),
    )
