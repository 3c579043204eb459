"""Proper colourings for chromatic Gibbs phases (host numpy); port of the
lattice part of ``repro.core.coloring``."""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["Coloring", "lattice3d_coloring"]


class Coloring:
    """Color assignment + per-color index groups (numpy, host side)."""

    def __init__(self, colors: np.ndarray):
        self.colors = np.asarray(colors, dtype=np.int32)
        self.n_colors = int(self.colors.max()) + 1 if len(self.colors) else 0
        self.groups: List[np.ndarray] = [
            np.nonzero(self.colors == c)[0].astype(np.int32)
            for c in range(self.n_colors)
        ]

    def __repr__(self):
        sizes = [len(g) for g in self.groups]
        return f"Coloring(n_colors={self.n_colors}, sizes={sizes})"


def lattice3d_coloring(L: int, periodic_z: bool = True) -> Coloring:
    """Proper coloring of the L^3 lattice (open x/y, optionally periodic z).

    Even L: the 2-color checkerboard.  Odd L with periodic z: the z-cycle
    is odd, so a third color takes the seam — even-(x+y) sites of the
    plane z = L-1 and odd-(x+y) sites of the plane z = 0 — and every other
    site keeps its (x+y+z) parity color."""
    xs, ys, zs = np.meshgrid(np.arange(L), np.arange(L), np.arange(L), indexing="ij")
    par = (xs + ys + zs) % 2
    colors = par.astype(np.int32)
    if periodic_z and L % 2 == 1 and L > 2:
        xyp = (xs + ys) % 2
        seam = zs == L - 1
        base = zs == 0
        colors = np.where(seam & (xyp == 0), 2, colors)
        colors = np.where(base & (xyp == 1), 2, colors)
    return Coloring(colors.ravel())
