"""Quickstart on the PyTorch/CUDA port: sample a 3D Edwards-Anderson spin
glass with the p-computer.

The port of ``examples/quickstart.py``: the same instance, engines and
printed lines, through ``repro_torch.engines.make_engine`` on the card:
the monolithic chromatic Gibbs engine, the partitioned DSIM at several
boundary-exchange frequencies (the eta-staleness effect), the lattice
engine running a batch of replica anneals at f32, int8 and bit-plane
precision (the hand-written sweep and energy kernels), and lane-packed
APT+ICM (the ELL word gather-count kernel).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.core.analysis import eta_from_sync
from repro_torch.core.annealing import ea_schedule
from repro_torch.core.apt_icm import APTICM
from repro_torch.core.coloring import lattice3d_coloring
from repro_torch.core.commcost import (ChainTopology, boundary_matrix,
                                       comm_cost, eta_threshold)
from repro_torch.core.device import resolve_device
from repro_torch.core.dsim import build_partitioned
from repro_torch.core.graph import ea3d
from repro_torch.core.partition import slab_partition
from repro_torch.engines import make_engine


def lattice_run(L, budget, device, **kw):
    """One lattice anneal of the walkthrough: (handle, record, final
    per-replica energies, seconds)."""
    eng = make_engine("lattice", L=L, seed=0, device=device, **kw)
    st = eng.init_state(seed=0)
    t0 = time.perf_counter()
    st, rec = eng.run_recorded(st, ea_schedule(budget), [budget],
                               sync_every=8)
    Es = rec.energies[-1].cpu().numpy()   # the host read ends the run
    return eng, rec, Es, time.perf_counter() - t0


def apt_run(L, sweeps, device):
    """The walkthrough's lane-packed APT+ICM on ``ea3d(L)``: (APTICM,
    final state, best energy)."""
    g = ea3d(L, seed=0, device=device)
    col = lattice3d_coloring(L)
    betas = np.geomspace(0.3, 3.0, 64)         # 2 chains x 64 temps = 128 lanes
    apt = APTICM(g, col, betas, chains=2, rng="lfsr", packed=True,
                 device=device)
    st, _ = apt.run(apt.init_state(seed=0), sweeps, icm_every=10,
                    record_every=20)
    return apt, st, apt.best_config(st)[1]


def run(device="cuda", L=10, K=4, budget=2048, R=4, apt_L=6,
        apt_sweeps=60):
    """The reference's walkthrough on ``device``; returns what it printed
    (energies, flips) and each lattice run's seconds."""
    device = resolve_device(device)
    out = {}
    print(f"EA spin glass L={L} (N={L**3}), {K}-FPGA-style chain, "
          f"{budget} sweeps\n")
    g = ea3d(L, seed=0, device=device)
    col = lattice3d_coloring(L)
    print(f"coloring: {col.n_colors} colors (paper: 2 for even L, 3 odd)")
    out["n_colors"] = col.n_colors

    # monolithic reference through the registry
    eng = make_engine("gibbs", g, coloring=col, rng="philox", device=device)
    st = eng.init_state(seed=0)
    st, rec = eng.run_recorded(st, ea_schedule(budget), [budget])
    print(f"monolithic  : E = {float(rec.energies[-1, 0]):9.1f}   "
          f"({rec.flips:,} flips)")
    out["monolithic"] = float(rec.energies[-1, 0])

    # the design rule (Eq. 2) for this partition on a chain
    labels = slab_partition(L, K)
    b = boundary_matrix(g.idx, g.w, labels, K)
    cm = comm_cost(b, ChainTopology(pins=[32] * (K - 1))).c_max
    thr = eta_threshold(col.n_colors, cm)
    print(f"\ncomm-cost model: C_max = {cm:.1f}, "
          f"eta threshold = 2*N_color*C_max = {thr:.0f}\n")
    out["c_max"], out["eta_threshold"] = float(cm), float(thr)

    prob = build_partitioned(g, col, labels, K)   # once, shared by all syncs
    out["dsim"] = {}
    for sync in ["phase", 1, 16, 128, None]:
        eng = make_engine("dsim", prob, rng="lfsr", device=device)
        st = eng.init_state(seed=0)
        st, rec = eng.run_recorded(st, ea_schedule(budget), [budget],
                                   sync_every=sync)
        eta = eta_from_sync(sync, col.n_colors, cm)
        tag = {"phase": "exact (per-phase exchange)",
               None: "disconnected links"}.get(sync, f"exchange every {sync}")
        print(f"DSIM S={str(sync):>5} : E = {float(rec.energies[-1, 0]):9.1f}   "
              f"eta ~ {eta:8.1f}   [{tag}]")
        out["dsim"][str(sync)] = float(rec.energies[-1, 0])

    # the production path: fused multi-phase kernel, R independent replicas
    eng, rec, Es, sec = lattice_run(L, budget, device, replicas=R)
    print(f"\nlattice x{R} replicas (fused kernel): "
          f"best E = {Es.min():9.1f}, per-replica {np.round(Es, 1)}")
    out["f32"] = {"energies": Es.tolist(), "flips": rec.flips,
                  "seconds": sec}

    # the fixed-point pipeline: int8 couplings, integer fields,
    # LUT-threshold accepts
    eng, rec, Es, sec = lattice_run(L, budget, device, replicas=R,
                                    precision="int8")
    print(f"lattice x{R} replicas (int8 pipeline, {eng.kernel_path}): "
          f"best E = {Es.min():9.1f}, per-replica {np.round(Es, 1)}")
    out["int8"] = {"energies": Es.tolist(), "flips": rec.flips,
                   "seconds": sec,
                   "updates_per_s": L ** 3 * R * budget / sec}

    # the bit-plane form of the same pipeline: 32 replicas in the bit
    # lanes of one uint32 word plane (multi-spin coding)
    eng, rec, Es, sec = lattice_run(L, budget, device, replicas=32,
                                    precision="bitplane")
    print(f"lattice x32 lanes (bit-plane words, {eng.kernel_path}): "
          f"best E = {Es.min():9.1f} ({rec.flips:,} lane-flips)")
    out["bitplane"] = {"energies": Es.tolist(), "best": float(Es.min()),
                       "flips": rec.flips, "seconds": sec,
                       "lane_updates_per_s": L ** 3 * 32 * budget / sec}

    # lane-packed APT+ICM: 2 chains x 64 temperatures = 128 lanes across
    # 4 stacked word planes; swaps are lane permutations
    apt, stp, e_best = apt_run(apt_L, apt_sweeps, device)
    print(f"\nAPT+ICM packed (L={apt_L}, {apt.L} lanes / {apt.words} words): "
          f"best E = {e_best:9.1f}, "
          f"{int(stp.swaps)} swaps (lane permutations), "
          f"{int(stp.icms)} cluster moves")
    out["apt"] = {"best": e_best, "swaps": int(stp.swaps),
                  "icms": int(stp.icms)}

    print("\nStale boundaries trade solution quality for throughput —")
    print("the single ratio eta governs it (benchmarks/fig2, fig3).")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    out = run(args.device)
    return out


if __name__ == "__main__":
    main()
