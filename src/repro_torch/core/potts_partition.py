"""Topology-aware Potts partitioning (paper Supplementary S5); port of
``repro.core.potts_partition`` (host numpy, the same operations).

Minimizes  H_Potts(s) = sum_edges |J_ij| * kappa(|s_i - s_j|)
                        + lam * sum_q (n_q - N/K)^2          (Eq. S.7)

with the distance kernel kappa(0)=0, kappa(1)=delta_near, kappa(>=2)=delta_far
(Eq. S.8).  Minimization is batched Metropolis annealing in numpy (the
objective only runs at setup time).  Because the kernel penalizes cluster-index
distance, the resulting partition is naturally ordered along a chain: the
canonical ordering (or its reverse) already minimizes the comm cost (Fig. S3b).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .device import as_numpy

__all__ = ["potts_partition", "potts_energy"]


def _kappa_table(K: int, delta_near: float, delta_far: float) -> np.ndarray:
    d = np.arange(K)
    return np.where(d == 0, 0.0, np.where(d == 1, delta_near, delta_far))


def potts_energy(idx, w, labels, K, delta_near=1.0, delta_far=8.0,
                 lam: float = 0.0) -> float:
    kap = _kappa_table(K, delta_near, delta_far)
    idx, w = as_numpy(idx), as_numpy(w)
    n, dmax = idx.shape
    nbr_l = labels[idx]                       # (N, D)
    dist = np.abs(labels[:, None] - nbr_l)
    e = 0.5 * (np.abs(w) * kap[dist]).sum()   # halve the double count
    sizes = np.bincount(labels, minlength=K).astype(np.float64)
    e += lam * ((sizes - n / K) ** 2).sum()
    return float(e)


def potts_partition(idx: np.ndarray, w: np.ndarray, K: int,
                    delta_near: float = 1.0, delta_far: float = 8.0,
                    lam: Optional[float] = None,
                    steps: int = 60, frac: float = 0.15,
                    beta0: float = 0.2, beta1: float = 4.0,
                    seed: int = 0,
                    init: Optional[np.ndarray] = None) -> np.ndarray:
    """Anneal the Potts objective; returns labels in [0, K).

    ``frac`` of nodes propose a move per step (batched Metropolis; cluster
    sizes refresh after each batch, a standard approximation).  Proposals are
    chain-local (l +- 1) half the time and uniform otherwise.
    """
    idx, w = as_numpy(idx), as_numpy(w)
    n, dmax = idx.shape
    rng = np.random.default_rng(seed)
    kap = _kappa_table(K, delta_near, delta_far)
    absw = np.abs(w)
    if lam is None:
        # a 5% imbalance of one cluster should cost about one cut edge per node
        lam = delta_near * dmax / (2.0 * (0.05 * n / K) ** 2 + 1e-9)

    labels = (np.arange(n) * K // n).astype(np.int64) if init is None \
        else np.asarray(init, dtype=np.int64).copy()
    target = n / K

    betas = np.geomspace(beta0, beta1, steps)
    quench = np.full(max(steps // 3, 10), np.inf)           # greedy finish
    for beta in np.concatenate([betas, quench]):
        sel = rng.random(n) < frac
        ids = np.nonzero(sel)[0]
        if len(ids) == 0:
            continue
        cur = labels[ids]
        step_dir = rng.integers(0, 2, size=len(ids)) * 2 - 1
        local = np.clip(cur + step_dir, 0, K - 1)
        uniform = rng.integers(0, K, size=len(ids))
        prop = np.where(rng.random(len(ids)) < 0.5, local, uniform)

        nbr_l = labels[idx[ids]]                            # (B, D)
        e_cur = (absw[ids] * kap[np.abs(cur[:, None] - nbr_l)]).sum(axis=1)
        e_prop = (absw[ids] * kap[np.abs(prop[:, None] - nbr_l)]).sum(axis=1)
        sizes = np.bincount(labels, minlength=K).astype(np.float64)
        d_bal = lam * (2.0 * (sizes[prop] - sizes[cur]) + 2.0)
        d_bal = np.where(prop == cur, 0.0, d_bal)
        dE = (e_prop - e_cur) + d_bal
        if np.isinf(beta):
            acc = dE < 0
        else:
            acc = rng.random(len(ids)) < np.exp(-beta * np.clip(dE, -50, 50))
        labels[ids[acc]] = prop[acc]
    return labels.astype(np.int32)
