"""Balanced graph partitioning: lattice slabs/bricks + general greedy/refined.

Port of ``repro.core.partition`` (host numpy, the reference's operations,
so the same seeds give the same labels).  The paper uses METIS (DSIM-2)
and a topology-aware Potts objective (DSIM-1, see
:mod:`repro_torch.core.potts_partition`); the greedy multi-source BFS +
boundary refinement below plays METIS's role.  ``greedy_partition`` and
``refine_partition`` are pure-Python loops over the nodes: minutes at
10^6 nodes, where a lattice takes :func:`brick_partition` or
:func:`slab_partition` labels instead.  ELL arrays may be given as numpy
arrays or tensors.
"""

from __future__ import annotations

import numpy as np

from .device import as_numpy

__all__ = ["slab_partition", "brick_partition", "greedy_partition",
           "refine_partition", "cut_edges", "partition_sizes"]


def slab_partition(L: int, K: int, axis: int = 0) -> np.ndarray:
    """Split an L^3 lattice into K contiguous slabs along one axis (chain map)."""
    xs, ys, zs = np.meshgrid(np.arange(L), np.arange(L), np.arange(L), indexing="ij")
    coord = (xs, ys, zs)[axis].ravel()
    return (coord * K // L).astype(np.int32)


def brick_partition(dims, bricks) -> np.ndarray:
    """Split an (Lx, Ly, Lz) lattice into a (kx, ky, kz) grid of bricks.

    Brick id is linearized in the same (x-major) order as the mesh axes, so a
    (pod, data, model) mesh maps onto (kx, ky, kz) bricks directly.
    """
    (Lx, Ly, Lz), (kx, ky, kz) = dims, bricks
    xs, ys, zs = np.meshgrid(np.arange(Lx), np.arange(Ly), np.arange(Lz),
                             indexing="ij")
    bx = xs.ravel() * kx // Lx
    by = ys.ravel() * ky // Ly
    bz = zs.ravel() * kz // Lz
    return ((bx * ky + by) * kz + bz).astype(np.int32)


def partition_sizes(labels: np.ndarray, K: int) -> np.ndarray:
    return np.bincount(labels, minlength=K)


def cut_edges(idx, w, labels: np.ndarray) -> int:
    """Number of undirected cut edges."""
    idx, w = as_numpy(idx), as_numpy(w)
    n, d = idx.shape
    src = np.repeat(np.arange(n), d)
    dst = idx.ravel()
    m = (w.ravel() != 0) & (src < dst)
    return int((labels[src[m]] != labels[dst[m]]).sum())


def greedy_partition(idx, w, K: int, seed: int = 0) -> np.ndarray:
    """Balanced multi-source BFS growth (METIS stand-in)."""
    idx, w = as_numpy(idx), as_numpy(w)
    n, dmax = idx.shape
    rng = np.random.default_rng(seed)
    valid = w != 0
    labels = np.full(n, -1, dtype=np.int32)

    # spread seeds: start random, then greedily pick far nodes by BFS level
    seeds = [int(rng.integers(n))]
    dist = _bfs_dist(idx, valid, seeds[0])
    for _ in range(K - 1):
        cand = int(np.argmax(np.where(labels == -1, dist, -1)))
        seeds.append(cand)
        dist = np.minimum(dist, _bfs_dist(idx, valid, cand))
    frontiers = []
    for k, s in enumerate(seeds):
        labels[s] = k
        frontiers.append([s])

    sizes = np.ones(K, dtype=np.int64)
    target = n / K
    assigned = K
    while assigned < n:
        k = int(np.argmin(sizes))
        # expand the smallest partition by one BFS layer (or steal a random node)
        new_frontier = []
        grew = False
        for u in frontiers[k]:
            for t in range(dmax):
                if not valid[u, t]:
                    continue
                v = int(idx[u, t])
                if labels[v] == -1:
                    labels[v] = k
                    sizes[k] += 1
                    assigned += 1
                    new_frontier.append(v)
                    grew = True
                    if sizes[k] >= target + 1:
                        break
            if sizes[k] >= target + 1:
                break
        frontiers[k] = new_frontier + [u for u in frontiers[k] if _has_free(idx, valid, labels, u)]
        if not grew:
            free = np.nonzero(labels == -1)[0]
            v = int(free[rng.integers(len(free))])
            labels[v] = k
            sizes[k] += 1
            assigned += 1
            frontiers[k].append(v)
    return labels


def _has_free(idx, valid, labels, u) -> bool:
    nb = idx[u][valid[u]]
    return bool(np.any(labels[nb] == -1))


def _bfs_dist(idx, valid, source) -> np.ndarray:
    n = idx.shape[0]
    dist = np.full(n, np.iinfo(np.int32).max, dtype=np.int64)
    dist[source] = 0
    frontier = [source]
    d = 0
    while frontier:
        d += 1
        nxt = []
        for u in frontier:
            for v in idx[u][valid[u]]:
                v = int(v)
                if dist[v] > d:
                    dist[v] = d
                    nxt.append(v)
        frontier = nxt
    return dist


def refine_partition(idx, w, labels: np.ndarray, K: int,
                     passes: int = 3, balance_tol: float = 0.05) -> np.ndarray:
    """Boundary-flip refinement: move nodes to the majority neighbor partition
    when it reduces cut size and keeps balance within ``balance_tol``."""
    idx, w = as_numpy(idx), as_numpy(w)
    n, dmax = idx.shape
    labels = labels.copy()
    valid = w != 0
    lo = (1 - balance_tol) * n / K
    for _ in range(passes):
        moved = 0
        sizes = np.bincount(labels, minlength=K).astype(np.int64)
        for u in range(n):
            lu = labels[u]
            if sizes[lu] <= lo:
                continue
            nb = idx[u][valid[u]]
            if len(nb) == 0:
                continue
            nl = labels[nb]
            counts = np.bincount(nl, minlength=K)
            best = int(np.argmax(counts))
            if best != lu and counts[best] > counts[lu]:
                labels[u] = best
                sizes[lu] -= 1
                sizes[best] += 1
                moved += 1
        if moved == 0:
            break
    return labels
