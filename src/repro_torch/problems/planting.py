"""Planted Ising instances with ground states known by construction
(paper Sec. S11; frustrated-loop planting in the style of Hen et al.).

Construction: sample random simple cycles on a host graph; every cycle gets
ferromagnetic couplings (+1) except one antiferromagnetic (-1) edge.  Each
loop's minimum energy is -(len-2), achieved by the all-up state, so the sum
Hamiltonian has E_ground = -sum_l (len_l - 2), also achieved by all-up:
E(s) = sum_l E_l(s) >= sum_l min_s E_l = E(all-up).  A random gauge
sigma in {+-1}^N then hides the planted state: J_ij -> J_ij sigma_i sigma_j,
ground state sigma with the same energy.  Port of
``repro.problems.planting``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core.graph import IsingGraph, from_edges

__all__ = ["PlantedInstance", "plant_frustrated_loops"]


@dataclasses.dataclass(frozen=True)
class PlantedInstance:
    graph: IsingGraph
    ground_state: np.ndarray   # sigma, a ground state by construction
    ground_energy: float


def _random_cycle(adj: List[np.ndarray], rng, max_len: int) -> List[int]:
    """Random walk until it self-intersects; return the cycle found."""
    for _ in range(50):
        start = int(rng.integers(len(adj)))
        path = [start]
        seen = {start: 0}
        for _ in range(max_len):
            nbrs = adj[path[-1]]
            if len(nbrs) == 0:
                break
            nxt = int(nbrs[rng.integers(len(nbrs))])
            if len(path) > 1 and nxt == path[-2]:
                continue  # no immediate backtrack
            if nxt in seen:
                cyc = path[seen[nxt]:]
                if len(cyc) >= 3:
                    return cyc
                break
            seen[nxt] = len(path)
            path.append(nxt)
    return []


def plant_frustrated_loops(host: IsingGraph, n_loops: int,
                           max_len: int = 12, seed: int = 0,
                           device=None) -> PlantedInstance:
    """Plant on the host graph's topology (its weights are ignored); the
    planted graph lives on ``device``, the host graph's unless given."""
    rng = np.random.default_rng(seed)
    idx, w, _ = host.to_numpy()
    n = idx.shape[0]
    adj = [idx[i][w[i] != 0] for i in range(n)]

    Jmap = {}
    ground = 0.0
    loops = 0
    attempts = 0
    while loops < n_loops and attempts < 20 * n_loops:
        attempts += 1
        cyc = _random_cycle(adj, rng, max_len)
        if not cyc:
            continue
        L = len(cyc)
        afm = int(rng.integers(L))
        for t in range(L):
            a, b = cyc[t], cyc[(t + 1) % L]
            key = (min(a, b), max(a, b))
            Jmap[key] = Jmap.get(key, 0.0) + (-1.0 if t == afm else 1.0)
        ground += -(L - 2)
        loops += 1
    if loops == 0:
        raise RuntimeError("failed to sample any cycle on the host graph")

    keys = np.asarray(list(Jmap.keys()), dtype=np.int64).reshape(-1, 2)
    vals = np.asarray([Jmap[tuple(k)] for k in keys], dtype=np.float32)
    nz = vals != 0
    sigma = rng.choice(np.array([-1, 1], dtype=np.int8), size=n)
    gauged = vals[nz] * sigma[keys[nz, 0]] * sigma[keys[nz, 1]]
    g = from_edges(n, keys[nz, 0], keys[nz, 1], gauged,
                   meta={"kind": "planted", "loops": loops, "seed": seed},
                   device=host.device if device is None else device)
    return PlantedInstance(graph=g, ground_state=sigma, ground_energy=ground)
