"""Measured-η probe: a one-partition ``dsim_dist`` run with an EtaMeter.

Port of ``benchmarks/common.py::eta_probe``.  The engine holds its one
partition in this process (the port's ``dsim_dist`` needs no mesh for
that), on the CUDA device unless ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np

from ..core import commcost
from ..core.annealing import constant_schedule
from ..core.coloring import lattice3d_coloring
from ..core.device import resolve_device
from ..core.graph import ea3d
from ..core.partition import slab_partition
from .timing import EtaMeter

__all__ = ["eta_probe"]


def eta_probe(L: int = 5, sweeps: int = 64, sync_every: int = 8,
              replicas: int = 32, precision: str = "bitplane",
              device=None) -> dict:
    """Measured η = f_comm/f_pbit, f_comm and f_pbit of a K=1
    ``dsim_dist`` engine on ``ea3d(L, seed=0)``.

    The meter times every recorded chunk (the cursor's chunk hook) and
    the engine's ``boundary_exchange_fn`` alone.  The K=1 probe has no
    cut of its own (its c_max would be 0 and the margin undefined), so the
    threshold is that of the 2-way slab cut of the same graph on a
    unit-pin ring: the margin a 2-way machine would have at these rates.
    """
    from ..engines import make_engine

    device = resolve_device(device)
    g = ea3d(L, seed=0, device=device)
    col = lattice3d_coloring(L)
    h = make_engine("dsim_dist", g, coloring=col, K=1,
                    labels=np.zeros(g.n, np.int32), rng="lfsr",
                    precision=precision, replicas=replicas, device=device)
    b = commcost.boundary_matrix(g.idx, g.w, slab_partition(L, 2), 2)
    cc = commcost.comm_cost(b, commcost.RingTopology(k=2, pins_per_link=1))
    meter = EtaMeter(n_color=len(h.eng.p.color_slots), c_max=cc.c_max,
                     sync_every=sync_every)
    sch = constant_schedule(3.0, 8 * sweeps)
    pts = [sweeps // 2, sweeps]
    h.run_recorded(h.init_state(seed=0), sch, pts,
                   sync_every=sync_every)        # warm the chunk sizes
    live = h.init_state(seed=0)
    meter.measure_exchange(lambda: h.eng.boundary_exchange_fn()(live))
    cur = h.start_recorded(h.init_state(seed=0), sch, pts,
                           sync_every=sync_every)
    meter.attach(cur)
    while not cur.done:
        cur.advance(1)
    rep = meter.report()
    rep["probe"] = {"engine": "dsim_dist", "K": 1, "L": L, "N": g.n,
                    "precision": precision, "replicas": replicas,
                    "threshold_partition": "reference 2-way slab cut, "
                                           "unit-pin ring (K=1 probe has "
                                           "no cut of its own)",
                    "c_max_ref": float(cc.c_max)}
    return rep
