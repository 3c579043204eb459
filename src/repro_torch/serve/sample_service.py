"""Annealing-as-a-service over the unified engine layer; port of
``repro.serve.sample_service``.

The serving story for the sampling side of the machine: a service owns a
problem instance, builds any registry backend once (compiled chunk runners
are cached inside the engine), and then serves anneal requests — each
request runs R independent replica chains in one batched call and returns
per-replica energies, the best configuration, and the exact flip count.
Engines are built on the card unless the service is given
``device="cpu"``.

This is the synchronous one-call facade (and the one-job-at-a-time
baseline in benchmarks/serve_load.py); the async multi-tenant front door —
job queue, replica packing, engine pool, streaming — is
:class:`repro_torch.serve.SampleServer`.

  svc = SampleService(graph=g, coloring=col)
  out = svc.submit(engine="dsim", sweeps=2048, replicas=8, seed=3)
  out["best_energy"], out["energies"], out["flips"]
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.annealing import Schedule, ea_schedule
from repro_torch.core.device import as_numpy
from repro_torch.engines import make_engine
from repro_torch.obs.trace import device_sync

__all__ = ["SampleService"]


class SampleService:
    """One problem instance, every backend, batched replica anneals."""

    def __init__(self, graph=None, coloring=None, L: Optional[int] = None,
                 seed: int = 0, **engine_kw):
        self.graph = graph
        self.coloring = coloring
        self.L = L
        self.seed = seed
        self.engine_kw = engine_kw
        self._handles: Dict[tuple, object] = {}

    def _handle(self, engine: str, replicas: int):
        key = (engine, replicas)
        if key not in self._handles:
            kw = dict(self.engine_kw)
            if engine == "lattice":
                self._handles[key] = make_engine(
                    engine, L=self.L, seed=self.seed, replicas=replicas, **kw)
            else:
                self._handles[key] = make_engine(
                    engine, self.graph, coloring=self.coloring,
                    replicas=replicas, **kw)
        return self._handles[key]

    def submit(self, engine: str = "gibbs", sweeps: int = 1024,
               replicas: int = 1, seed: int = 0,
               schedule: Optional[Schedule] = None,
               record_points: Optional[Sequence[int]] = None,
               sync_every=1) -> dict:
        """Run one annealing job; returns a plain-dict result payload.

        Cold submissions warm the engine *outside* the timed region (one
        throwaway execution per distinct chunk length: the kernels built
        and launched once), so ``flips_per_s`` always reports warm
        throughput; the timed region ends with a device synchronise.
        """
        cold = (engine, replicas) not in self._handles
        h = self._handle(engine, replicas)
        sch = schedule if schedule is not None else ea_schedule(sweeps)
        pts = list(record_points) if record_points is not None else [sweeps]
        if cold:
            h.start_recorded(h.init_state(seed=seed), sch, pts,
                             sync_every=sync_every).warm()
        t0 = time.perf_counter()
        st = h.init_state(seed=seed)
        st, rec = h.run_recorded(st, sch, pts, sync_every=sync_every)
        device_sync(st)
        wall = time.perf_counter() - t0
        energies = as_numpy(rec.energies)            # (P, R)
        finals = energies[-1]
        best = int(np.argmin(finals))
        spins = as_numpy(h.global_spins(st))
        return {
            "engine": engine,
            "replicas": replicas,
            "times": np.asarray(rec.times),
            "energies": energies,
            "best_energy": float(finals[best]),
            "best_replica": best,
            "best_spins": spins[best],
            "flips": rec.flips,
            "wall_s": wall,
            # first use happens in the pre-timed warm pass, so flips_per_s
            # is warm throughput even when cold_start is True
            "cold_start": cold,
            "flips_per_s": rec.flips / max(wall, 1e-9),
        }
