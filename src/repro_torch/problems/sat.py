"""Random 3SAT -> invertible-logic Ising encoding with copy-gate
sparsification (paper Sec. S12).

Each clause (l1 v l2 v l3) becomes an invertible OR gate chain:
  y = OR(l1, l2)   (one auxiliary p-bit per clause)
  OR(y, l3) clamped TRUE (output substituted as a constant).

The OR gate Hamiltonian (De Morgan dual of the standard invertible AND,
Camsari et al., PRX 7, 031014):  J_AB=-1, J_AC=2, J_BC=2, h=(-1,-1,+2);
ground states are exactly the rows of the OR truth table.

High-degree variables are split into copy chains (J_copy ferromagnetic) so
that graph degree stays bounded — the paper's copy-gate sparsification that
keeps the graph sparse and colorable.  Decoding takes the majority vote over
the copies of each variable (Fig. S14).  Port of ``repro.problems.sat``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.device import as_numpy
from repro_torch.core.graph import IsingGraph, from_edges

__all__ = ["random_3sat", "SatEncoding", "encode_3sat", "decode_assignment",
           "count_satisfied"]


def random_3sat(n_vars: int, n_clauses: int, seed: int = 0) -> np.ndarray:
    """Uniform random 3SAT (CNFgen-style): (m, 3) signed 1-based literals."""
    rng = np.random.default_rng(seed)
    clauses = np.empty((n_clauses, 3), dtype=np.int64)
    for i in range(n_clauses):
        vs = rng.choice(n_vars, size=3, replace=False) + 1
        signs = rng.choice([-1, 1], size=3)
        clauses[i] = vs * signs
    return clauses


@dataclasses.dataclass(frozen=True)
class SatEncoding:
    graph: IsingGraph
    n_vars: int
    clauses: np.ndarray
    copies_of: List[np.ndarray]   # per variable: spin indices of its copies
    n_aux: int


def encode_3sat(clauses: np.ndarray, n_vars: int,
                max_fanout: int = 6, j_copy: float = 2.0,
                device=None) -> SatEncoding:
    """Build the sparse Ising graph for a 3SAT formula, on ``device``."""
    m = len(clauses)
    # fanout per variable = number of clause slots it occupies
    occ = np.zeros(n_vars, dtype=np.int64)
    for c in clauses:
        for lit in c:
            occ[abs(lit) - 1] += 1

    copies_of: List[np.ndarray] = []
    next_id = 0
    for v in range(n_vars):
        k = max(1, int(np.ceil(occ[v] / max_fanout)))
        copies_of.append(np.arange(next_id, next_id + k))
        next_id += k
    aux0 = next_id                      # clause aux spins start here
    n_spins = next_id + m

    J: Dict[Tuple[int, int], float] = {}
    h = np.zeros(n_spins, dtype=np.float64)

    def addJ(a: int, b: int, val: float):
        if a == b:
            raise ValueError("self coupling")
        key = (min(a, b), max(a, b))
        J[key] = J.get(key, 0.0) + val

    # copy chains (rings for k > 2 improve robustness of majority decoding)
    for v in range(n_vars):
        cps = copies_of[v]
        for i in range(len(cps) - 1):
            addJ(int(cps[i]), int(cps[i + 1]), j_copy)
        if len(cps) > 2:
            addJ(int(cps[0]), int(cps[-1]), j_copy)

    # round-robin slot assignment over copies
    slot_ptr = np.zeros(n_vars, dtype=np.int64)

    def spin_of(lit: int) -> Tuple[int, int]:
        v = abs(lit) - 1
        cps = copies_of[v]
        s = int(cps[slot_ptr[v] % len(cps)])
        slot_ptr[v] += 1
        return s, (1 if lit > 0 else -1)

    for ci, (l1, l2, l3) in enumerate(clauses):
        a, sa = spin_of(int(l1))
        b, sb = spin_of(int(l2))
        y = aux0 + ci
        # OR(a, b) = y   [J_AB=-1, J_AC=2, J_BC=2, h=(-1,-1,2)] with literal signs
        addJ(a, b, -1.0 * sa * sb)
        addJ(a, y, 2.0 * sa)
        addJ(b, y, 2.0 * sb)
        h[a] += -1.0 * sa
        h[b] += -1.0 * sb
        h[y] += 2.0
        # OR(y, l3) clamped TRUE: substitute C=+1 into the OR gate
        cthree, sc = spin_of(int(l3))
        addJ(y, cthree, -1.0 * sc)
        h[y] += -1.0 + 2.0
        h[cthree] += -1.0 * sc + 2.0 * sc

    keys = np.asarray(list(J.keys()), dtype=np.int64).reshape(-1, 2)
    vals = np.asarray([J[tuple(k)] for k in keys], dtype=np.float32)
    nz = vals != 0
    g = from_edges(n_spins, keys[nz, 0], keys[nz, 1], vals[nz],
                   h=h.astype(np.float32),
                   meta={"kind": "3sat", "n_vars": n_vars, "m": m},
                   device=device)
    return SatEncoding(graph=g, n_vars=n_vars, clauses=np.asarray(clauses),
                       copies_of=copies_of, n_aux=m)


def decode_assignment(enc: SatEncoding, m_spins: np.ndarray) -> np.ndarray:
    """Majority vote over copies -> boolean assignment (+-1 per variable)."""
    m_spins = as_numpy(m_spins)
    out = np.empty(enc.n_vars, dtype=np.int8)
    for v in range(enc.n_vars):
        s = m_spins[enc.copies_of[v]].sum()
        out[v] = 1 if s >= 0 else -1
    return out


def count_satisfied(clauses: np.ndarray, assign_pm1: np.ndarray) -> int:
    """Number of satisfied clauses for a +-1 assignment (index = var - 1)."""
    lit_vals = np.sign(clauses) * assign_pm1[np.abs(clauses) - 1]
    return int((lit_vals > 0).any(axis=1).sum())
