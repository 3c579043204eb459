"""Sparse Ising graphs and their instance builders; port of
``repro.core.graph``.

The on-device format is ELL (padded neighbor lists): ``idx[i, d]`` is the
d-th neighbor of node i and ``w[i, d]`` the coupling; padding entries
point at node 0 with weight 0, so a gather and weighted sum is always
valid.  Edge lists are built on the host in numpy with the reference's
operations (same seeds, same arrays); the graph's tensors then live on an
explicit device (CUDA unless ``device="cpu"``).

Energies follow the Ising convention  E(m) = -sum_{i<j} J_ij m_i m_j -
sum_i h_i m_i  with m_i in {-1, +1}.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .device import as_numpy, resolve_device

__all__ = ["IsingGraph", "from_edges", "ea3d", "ea3d_edges",
           "toroidal_grid", "random_regular", "edges_from_ell"]


@dataclasses.dataclass(frozen=True)
class IsingGraph:
    """Padded-neighbor-list (ELL) sparse Ising graph on one device."""

    idx: torch.Tensor  # (N, D) int32 neighbor indices (padded with 0)
    w: torch.Tensor    # (N, D) float32 coupling weights (padded with 0.0)
    h: torch.Tensor    # (N,)  float32 biases
    meta: dict = dataclasses.field(default_factory=dict, hash=False,
                                   compare=False)

    @property
    def n(self) -> int:
        return int(self.idx.shape[0])

    @property
    def max_degree(self) -> int:
        return int(self.idx.shape[1])

    @property
    def num_edges(self) -> int:
        # each undirected edge appears twice in the ELL rows
        return int((self.w != 0).sum()) // 2

    @property
    def device(self) -> torch.device:
        return self.idx.device

    def to(self, device) -> "IsingGraph":
        device = torch.device(device)
        if self.idx.device == device:
            return self
        return IsingGraph(idx=self.idx.to(device), w=self.w.to(device),
                          h=self.h.to(device), meta=self.meta)

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(idx, w, h) as numpy arrays."""
        return as_numpy(self.idx), as_numpy(self.w), as_numpy(self.h)


def from_edges(n: int, ei, ej, ew, h=None, meta: Optional[dict] = None,
               device=None) -> IsingGraph:
    """Build an ELL graph from an undirected edge list (each edge listed
    once), on ``device``."""
    ei = np.asarray(ei, dtype=np.int64)
    ej = np.asarray(ej, dtype=np.int64)
    ew = np.asarray(ew, dtype=np.float32)
    if not (len(ei) == len(ej) == len(ew)):
        raise ValueError("edge arrays must have equal length")
    if len(ei) and (ei.max() >= n or ej.max() >= n or ei.min() < 0 or
                    ej.min() < 0):
        raise ValueError("edge endpoint out of range")
    if np.any(ei == ej):
        raise ValueError("self loops are not allowed in an Ising graph")
    dev = resolve_device(device)

    # symmetric incidence
    src = np.concatenate([ei, ej])
    dst = np.concatenate([ej, ei])
    wgt = np.concatenate([ew, ew])

    deg = np.bincount(src, minlength=n)
    dmax = max(int(deg.max()) if len(src) else 1, 1)

    order = np.argsort(src, kind="stable")
    src, dst, wgt = src[order], dst[order], wgt[order]
    # slot position of each incidence within its row
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    slot = np.arange(len(src)) - starts[src]

    idx = np.zeros((n, dmax), dtype=np.int32)
    w = np.zeros((n, dmax), dtype=np.float32)
    idx[src, slot] = dst
    w[src, slot] = wgt

    hh = np.zeros(n, dtype=np.float32) if h is None else \
        np.asarray(as_numpy(h), dtype=np.float32)
    if hh.shape != (n,):
        raise ValueError("bias vector has wrong shape")
    return IsingGraph(idx=torch.from_numpy(idx).to(dev),
                      w=torch.from_numpy(w).to(dev),
                      h=torch.from_numpy(hh).to(dev), meta=dict(meta or {}))


# ---------------------------------------------------------------------------
# 3D Edwards-Anderson spin glasses
# ---------------------------------------------------------------------------

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


def ea3d(L: int, seed: int = 0, device=None) -> IsingGraph:
    """3D Edwards-Anderson spin glass instance (see :func:`ea3d_edges`)."""
    ei, ej, ew = ea3d_edges(L, seed)
    return from_edges(L ** 3, ei, ej, ew,
                      meta={"kind": "ea3d", "L": L, "seed": seed},
                      device=device)


# ---------------------------------------------------------------------------
# Other instance families
# ---------------------------------------------------------------------------

def toroidal_grid(rows: int, cols: int, seed: int = 0, weights: str = "pm1",
                  device=None) -> IsingGraph:
    """Toroidal 2D grid with random +-1 weights (the Gset G81 family shape)."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    xs, ys = xs.ravel(), ys.ravel()
    nid = xs * cols + ys
    ei = np.concatenate([nid, nid])
    ej = np.concatenate([((xs + 1) % rows) * cols + ys,
                         xs * cols + (ys + 1) % cols])
    if weights == "pm1":
        ew = rng.choice(np.array([-1.0, 1.0], dtype=np.float32), size=len(ei))
    else:
        ew = np.ones(len(ei), dtype=np.float32)
    return from_edges(rows * cols, ei, ej, ew,
                      meta={"kind": "toroidal", "rows": rows, "cols": cols,
                            "seed": seed}, device=device)


def random_regular(n: int, d: int, seed: int = 0, device=None) -> IsingGraph:
    """Random d-regular graph, +-1 weights: the configuration model with
    self-loops and multi-edges repaired by random 2-swaps."""
    if (n * d) % 2 != 0:
        raise ValueError("n*d must be even")
    rng = np.random.default_rng(seed)
    for _ in range(50):
        stubs = np.repeat(np.arange(n), d)
        rng.shuffle(stubs)
        ei, ej = stubs[0::2].copy(), stubs[1::2].copy()
        ok = True
        for _ in range(50 * n):
            bad = np.nonzero(ei == ej)[0]
            if len(bad) == 0:
                key = np.minimum(ei, ej).astype(np.int64) * n + \
                    np.maximum(ei, ej)
                order = np.argsort(key)
                dup = np.nonzero(np.diff(key[order]) == 0)[0]
                if len(dup) == 0:
                    break
                bad = order[dup]
            # 2-swap each offending edge with a random partner edge
            partners = rng.integers(0, len(ei), size=len(bad))
            ej[bad], ej[partners] = ej[partners].copy(), ej[bad].copy()
        else:
            ok = False
        if not ok:
            continue
        key = np.minimum(ei, ej).astype(np.int64) * n + np.maximum(ei, ej)
        if np.any(ei == ej) or len(np.unique(key)) != len(key):
            continue
        ew = rng.choice(np.array([-1.0, 1.0], dtype=np.float32), size=len(ei))
        return from_edges(n, ei, ej, ew,
                          meta={"kind": "random_regular", "d": d,
                                "seed": seed}, device=device)
    raise RuntimeError("failed to sample a simple random regular graph")


def edges_from_ell(g: IsingGraph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Recover the unique undirected edge list (i < j) from an ELL graph."""
    idx, w, _ = g.to_numpy()
    n, d = idx.shape
    src = np.repeat(np.arange(n), d)
    dst = idx.ravel()
    wgt = w.ravel()
    m = (wgt != 0) & (src < dst)
    return src[m], dst[m], wgt[m]
