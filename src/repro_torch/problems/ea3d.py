"""EA spin-glass instance sets and putative-ground-energy bookkeeping.

Paper Methods: exact grounds are unknown at scale; the putative ground of an
instance is the minimum energy observed across all platforms and timing
settings, established from reference runs at least 10x longer than the
analysis window (prevents artificial late-time bending of the power law).
Port of ``repro.problems.ea3d``; the grounds come from the port's
:class:`~repro_torch.core.gibbs.GibbsEngine` (its default philox stream
is not the reference's, so a store filled by one package is a start for
the other, not its copy).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from repro_torch.core.annealing import ea_schedule
from repro_torch.core.coloring import lattice3d_coloring
from repro_torch.core.gibbs import GibbsEngine
from repro_torch.core.graph import IsingGraph, ea3d

__all__ = ["instance_set", "GroundStore", "establish_grounds"]


def instance_set(L: int, n_instances: int = 10, seed0: int = 100,
                 device=None) -> List[IsingGraph]:
    """The paper's 10-disorder-instance protocol."""
    return [ea3d(L, seed=seed0 + i, device=device)
            for i in range(n_instances)]


class GroundStore:
    """JSON-backed map (L, seed) -> best known energy, min-merged on update."""

    def __init__(self, path: str):
        self.path = path
        self._d: Dict[str, float] = {}
        if os.path.exists(path):
            with open(path) as f:
                self._d = json.load(f)

    @staticmethod
    def key(L: int, seed: int) -> str:
        return f"ea3d_L{L}_s{seed}"

    def get(self, L: int, seed: int) -> Optional[float]:
        return self._d.get(self.key(L, seed))

    def update(self, L: int, seed: int, energy: float) -> float:
        k = self.key(L, seed)
        cur = self._d.get(k, float("inf"))
        if energy < cur:
            self._d[k] = float(energy)
            self._save()
        return self._d[k]

    def _save(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._d, f, indent=0, sort_keys=True)
        os.replace(tmp, self.path)


def establish_grounds(graphs: List[IsingGraph], store: GroundStore,
                      sweeps: int, runs: int = 2, seed0: int = 0,
                      device=None) -> List[float]:
    """Long annealing runs to (re)establish putative grounds; returns them
    (on ``device``, CUDA unless ``device="cpu"``)."""
    out = []
    for g in graphs:
        L, seed = g.meta["L"], g.meta["seed"]
        eng = GibbsEngine(g, lattice3d_coloring(L), device=device)
        sch = ea_schedule(sweeps)
        best = store.get(L, seed)
        best = float("inf") if best is None else best
        for r in range(runs):
            st = eng.init_state(seed=seed0 + 7919 * r)
            st, (Etr, _) = eng.run_dense(st, sch.beta_array())
            best = min(best, float(Etr.min()))
        out.append(store.update(L, seed, best))
    return out
