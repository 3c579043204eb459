"""Eta sweep with the CMFT twin on the PyTorch/CUDA port.

The port of ``examples/eta_sweep.py``: the partitioned DSIM and the
parallel cluster-mean-field model on the same instance, partition and
schedule across staleness settings, on the card; fits kappa_f for both
and prints the paired table (the paper's Fig. 3 protocol, S3.2).

  PYTHONPATH=src python examples/torch_eta_sweep.py [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.core.analysis import fit_kappa
from repro_torch.core.annealing import ea_schedule
from repro_torch.core.coloring import lattice3d_coloring
from repro_torch.core.device import resolve_device
from repro_torch.core.dsim import DSIMEngine, build_partitioned
from repro_torch.core.gibbs import GibbsEngine
from repro_torch.core.graph import ea3d
from repro_torch.core.partition import slab_partition


def trace(eng_fn, g, Eg, sch, pts, sync, runs=3):
    """Mean residual-energy trace; returns (record times, rho).

    The DSIM engines quantize record points to multiples of S (collapsing
    duplicates), so the fit uses the times they recorded at, returned in
    the RunRecord; the monolithic engine records at ``pts`` verbatim and
    returns the energy trace directly."""
    rhos, times = [], np.asarray(pts)
    for r in range(runs):
        eng = eng_fn()
        st = eng.init_state(seed=r)
        st, out = eng.run_recorded(st, sch, pts, sync_every=sync) \
            if sync != "mono" else eng.run_recorded(st, sch, pts)
        if hasattr(out, "energies"):
            times, Es = np.asarray(out.times), out.energies.cpu().numpy()
        else:
            Es = out.cpu().numpy()
        rhos.append((Es - Eg) / g.n)
    return times, np.mean(rhos, axis=0)


def run(device="cuda", L=8, K=4, budget=4096, runs=3, S=(1, 8, 64, 256)):
    """The reference's sweep on ``device``; returns the putative ground
    energy, kappa per row and the seconds of the DSIM/CMFT traces."""
    device = resolve_device(device)
    g = ea3d(L, seed=42, device=device)
    col = lattice3d_coloring(L)
    prob = build_partitioned(g, col, slab_partition(L, K), K)
    sch = ea_schedule(budget)
    pts = sorted(set(np.geomspace(4, budget, 14).astype(int)))

    # putative ground (longer run, paper protocol)
    ref = GibbsEngine(g, col, device=device)
    st = ref.init_state(seed=0)
    st, (Etr, _) = ref.run_dense(st, ea_schedule(4 * budget).beta_array())
    Eg = float(Etr.min())
    print(f"L={L} K={K}, putative ground {Eg:.0f}\n")
    print(f"{'S':>6s} {'kappa_DSIM':>11s} {'kappa_CMFT':>11s}")

    ts, rho = trace(lambda: GibbsEngine(g, col, device=device), g, Eg, sch,
                    pts, "mono", runs)
    k_mono = fit_kappa(ts, rho, window=(8, budget)).kappa
    print(f"{'mono':>6s} {k_mono:11.3f} {'—':>11s}")

    kappa, t0 = {}, time.perf_counter()
    for s in S:
        ks = {}
        for mode in ("dsim", "cmft"):
            ts, rho = trace(lambda: DSIMEngine(prob, rng="lfsr", mode=mode,
                                               device=device),
                            g, Eg, sch, pts, s, runs)
            ks[mode] = fit_kappa(ts, rho, window=(8, budget)).kappa
        kappa[s] = ks
        print(f"{s:6d} {ks['dsim']:11.3f} {ks['cmft']:11.3f}")
    seconds = time.perf_counter() - t0

    print("\nBoth columns degrade together as S grows (eta shrinks):")
    print("staleness is a property of partitioned stochastic dynamics, so")
    print("CMFT predicts the hardware exponent before any hardware exists.")
    updates = g.n * budget * runs * 2 * len(S)
    return {"ground": Eg, "kappa_mono": k_mono, "kappa": kappa,
            "seconds": seconds, "updates_per_s": updates / seconds}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    out = run(args.device)
    return out


if __name__ == "__main__":
    main()
