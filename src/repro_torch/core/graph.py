"""EA3D edge list (host numpy); port of the lattice part of
``repro.core.graph``."""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["ea3d_edges"]


def _lattice_id(x, y, z, L):
    return (x * L + y) * L + z


def ea3d_edges(L: int, seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Edge list of the 3D EA spin glass per the paper's Methods:
    J_ij in {+-1} i.i.d. uniform on nearest-neighbor edges of an L^3 cubic
    lattice, periodic boundary in z, open boundaries in x and y."""
    rng = np.random.default_rng(seed)
    xs, ys, zs = np.meshgrid(np.arange(L), np.arange(L), np.arange(L), indexing="ij")
    xs, ys, zs = xs.ravel(), ys.ravel(), zs.ravel()

    ei, ej = [], []
    # +x (open)
    m = xs < L - 1
    ei.append(_lattice_id(xs[m], ys[m], zs[m], L))
    ej.append(_lattice_id(xs[m] + 1, ys[m], zs[m], L))
    # +y (open)
    m = ys < L - 1
    ei.append(_lattice_id(xs[m], ys[m], zs[m], L))
    ej.append(_lattice_id(xs[m], ys[m] + 1, zs[m], L))
    # +z (periodic); for L == 2 the wrap edge duplicates the open edge - skip wrap then
    if L > 2:
        ei.append(_lattice_id(xs, ys, zs, L))
        ej.append(_lattice_id(xs, ys, (zs + 1) % L, L))
    else:
        m = zs < L - 1
        ei.append(_lattice_id(xs[m], ys[m], zs[m], L))
        ej.append(_lattice_id(xs[m], ys[m], zs[m] + 1, L))

    ei = np.concatenate(ei)
    ej = np.concatenate(ej)
    ew = rng.choice(np.array([-1.0, 1.0], dtype=np.float32), size=len(ei))
    return ei, ej, ew
