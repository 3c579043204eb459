"""Proper colourings for chromatic Gibbs phases (host numpy); port of the
lattice part of ``repro.core.coloring``."""

from __future__ import annotations

from typing import List

import numpy as np

from .device import as_numpy

__all__ = ["Coloring", "greedy_coloring", "color_groups",
           "lattice3d_coloring", "validate_coloring"]


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


def greedy_coloring(idx, w) -> Coloring:
    """Largest-degree-first greedy coloring of an ELL graph (a pure-Python
    loop over the nodes, as the reference's: minutes at 10^6 nodes)."""
    idx = as_numpy(idx)
    w = as_numpy(w)
    n = idx.shape[0]
    deg = (w != 0).sum(axis=1)
    order = np.argsort(-deg, kind="stable")
    colors = np.full(n, -1, dtype=np.int32)
    valid = w != 0
    for i in order:
        nbr_colors = colors[idx[i][valid[i]]]
        used = set(int(c) for c in nbr_colors if c >= 0)
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return Coloring(colors)


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


def validate_coloring(idx, w, colors) -> bool:
    idx = as_numpy(idx)
    w = as_numpy(w)
    colors = np.asarray(colors)
    n, dmax = idx.shape
    src = np.repeat(np.arange(n), dmax)
    dst = idx.ravel()
    mask = w.ravel() != 0
    return bool(np.all(colors[src[mask]] != colors[dst[mask]]))


def color_groups(colors: np.ndarray) -> List[np.ndarray]:
    return Coloring(colors).groups
