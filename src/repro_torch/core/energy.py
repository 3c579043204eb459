"""Ising energy, residual energy, local fields and cut values; port of
``repro.core.energy``.

Spins are int8 in {-1, +1}, (N,) or with leading batch axes (..., N);
every function returns one value per leading index.  On +-J couplings
every partial sum is an integer below 2^24, so the f32 results are exact
in any summation order.
"""

from __future__ import annotations

import torch

from .graph import IsingGraph

__all__ = ["local_fields", "energy", "residual_energy", "cut_value"]


def _neighbors(g: IsingGraph, m: torch.Tensor) -> torch.Tensor:
    """(..., N, D) neighbor spins as the couplings' dtype."""
    nbr = m.index_select(-1, g.idx.reshape(-1).long())
    return nbr.reshape(*m.shape[:-1], *g.idx.shape).to(g.w.dtype)


def local_fields(g: IsingGraph, m: torch.Tensor) -> torch.Tensor:
    """h_i + sum_j J_ij m_j for all nodes (before beta)."""
    return g.h + (g.w * _neighbors(g, m)).sum(-1)


def energy(g: IsingGraph, m: torch.Tensor) -> torch.Tensor:
    """E(m) = -sum_{i<j} J_ij m_i m_j - sum_i h_i m_i."""
    mf = m.to(g.w.dtype)
    pair = (mf[..., None] * g.w * _neighbors(g, m)).sum((-2, -1))
    return -0.5 * pair - (g.h * mf).sum(-1)


def residual_energy(E, E_ground, n: int):
    """rho_E = (E - E_ground) / N  (paper Eq. S.1)."""
    return (E - E_ground) / n


def cut_value(g: IsingGraph, m: torch.Tensor) -> torch.Tensor:
    """Max-Cut value of the bipartition encoded by spins m, on the graph's
    stored weights: cut = sum_{(i,j): m_i != m_j} w_ij."""
    mf = m.to(g.w.dtype)
    # (1 - m_i m_j)/2 is 1 across the cut, 0 inside a side; halve the
    # double count
    disagree = (1.0 - mf[..., None] * _neighbors(g, m)) * 0.5
    return 0.5 * (g.w * disagree).sum((-2, -1))
