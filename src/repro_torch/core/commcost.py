"""Communication-cost metric and the conservative clocking bound (paper S4).

Given a partition and a physical interconnect topology:

  b_ab : boundary p-bits cluster a must ship to cluster b
  d_ab : hop distance between the devices hosting a and b
  P_ab : data pins of the narrowest link on the a->b route

  C_tot = sum_{a<b} b_ab * d_ab / P_ab          (Eq. S.2)
  C_max = max_{a<b} b_ab * d_ab / P_ab          (Eq. S.3)
  f_p-bit <= f_comm / (2 * N_color * C_max)     (Eq. 2 / S.6)
  eta_threshold = 2 * N_color * C_max

Port of ``repro.core.commcost`` (host numpy, the same operations); the
ELL arrays may be given as numpy arrays or tensors.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

import numpy as np

from .device import as_numpy

__all__ = ["boundary_matrix", "ChainTopology", "RingTopology", "CommCost",
           "comm_cost", "eta_threshold", "best_chain_permutation",
           "cut_distance_histogram"]


def boundary_matrix(idx, w, labels: np.ndarray,
                    K: int) -> np.ndarray:
    """b[a, b] = number of p-bits in cluster a with >=1 cut edge into b."""
    idx, w = as_numpy(idx), as_numpy(w)
    n, dmax = idx.shape
    src = np.repeat(np.arange(n), dmax)
    dst = idx.ravel()
    m = w.ravel() != 0
    la, lb = labels[src[m]], labels[dst[m]]
    cut = la != lb
    # boundary p-bit (node, dest-cluster) pairs, deduplicated
    pairs = np.unique(np.stack([src[m][cut], lb[cut]], axis=1), axis=0)
    b = np.zeros((K, K), dtype=np.int64)
    np.add.at(b, (labels[pairs[:, 0]], pairs[:, 1]), 1)
    return b


@dataclasses.dataclass(frozen=True)
class ChainTopology:
    """K devices in a chain; pins[i] = width of the link between slot i, i+1."""

    pins: Sequence[int]

    @property
    def k(self) -> int:
        return len(self.pins) + 1

    def hop(self, a: int, b: int) -> int:
        return abs(a - b)

    def bottleneck(self, a: int, b: int) -> int:
        lo, hi = min(a, b), max(a, b)
        return int(min(self.pins[lo:hi]))


@dataclasses.dataclass(frozen=True)
class RingTopology:
    """K devices on a bidirectional ring with uniform link width (TPU ICI-like)."""

    k: int
    pins_per_link: int

    def hop(self, a: int, b: int) -> int:
        d = abs(a - b)
        return min(d, self.k - d)

    def bottleneck(self, a: int, b: int) -> int:
        return self.pins_per_link


@dataclasses.dataclass(frozen=True)
class CommCost:
    c_tot: float
    c_max: float
    worst_pair: tuple
    per_pair: dict


def comm_cost(b: np.ndarray, topo, order: Optional[np.ndarray] = None) -> CommCost:
    """Cost of mapping clusters onto physical slots in the given order.

    ``order[a]`` = physical slot of cluster a (identity if None).
    Boundary traffic is duplex; we use b_ab + b_ba per unordered pair as the
    per-pair shipped states (each side needs the other's boundary bits).
    """
    K = b.shape[0]
    order = np.arange(K) if order is None else np.asarray(order)
    c_tot, c_max, worst = 0.0, 0.0, (0, 0)
    per_pair = {}
    for a in range(K):
        for bb in range(a + 1, K):
            states = int(b[a, bb] + b[bb, a])
            if states == 0:
                continue
            sa, sb = int(order[a]), int(order[bb])
            d = topo.hop(sa, sb)
            p = topo.bottleneck(sa, sb)
            c = states * d / p
            per_pair[(a, bb)] = c
            c_tot += c
            if c > c_max:
                c_max, worst = c, (a, bb)
    return CommCost(c_tot=c_tot, c_max=c_max, worst_pair=worst, per_pair=per_pair)


def eta_threshold(n_color: int, c_max: float) -> float:
    """Eq. 2: the ratio above which the distributed machine matches monolithic."""
    return 2.0 * n_color * c_max


def best_chain_permutation(b: np.ndarray, topo: ChainTopology,
                           objective: str = "c_tot"):
    """Search slot orderings (exhaustive K<=8, else greedy adjacent swaps)."""
    K = b.shape[0]

    def score(order):
        c = comm_cost(b, topo, order)
        return c.c_tot if objective == "c_tot" else c.c_max

    if K <= 8:
        best, best_s = None, np.inf
        for perm in itertools.permutations(range(K)):
            if perm[0] > perm[-1]:
                continue  # skip reversals
            s = score(np.asarray(perm))
            if s < best_s:
                best, best_s = np.asarray(perm), s
        return best, best_s
    order = np.arange(K)
    best_s = score(order)
    improved = True
    while improved:
        improved = False
        for i in range(K - 1):
            trial = order.copy()
            trial[i], trial[i + 1] = trial[i + 1], trial[i]
            s = score(trial)
            if s < best_s:
                order, best_s, improved = trial, s, True
    return order, best_s


def cut_distance_histogram(idx, w, labels: np.ndarray,
                           order: Optional[np.ndarray] = None,
                           K: Optional[int] = None) -> np.ndarray:
    """Fraction of cut edges at each hop distance on a chain (paper Fig. S5)."""
    idx, w = as_numpy(idx), as_numpy(w)
    n, dmax = idx.shape
    K = int(labels.max()) + 1 if K is None else K
    order = np.arange(K) if order is None else np.asarray(order)
    src = np.repeat(np.arange(n), dmax)
    dst = idx.ravel()
    m = (w.ravel() != 0) & (src < dst)
    la, lb = labels[src[m]], labels[dst[m]]
    cut = la != lb
    d = np.abs(order[la[cut]] - order[lb[cut]])
    hist = np.bincount(d, minlength=K)[1:]  # distances 1..K-1
    total = hist.sum()
    return hist / max(total, 1)
