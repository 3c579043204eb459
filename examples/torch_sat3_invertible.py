"""3SAT via invertible-logic Ising encoding on the PyTorch/CUDA port.

The port of ``examples/sat3_invertible.py`` (paper Sec. S12): a random
3SAT instance near the satisfiability transition, encoded with OR-gate
invertible logic and copy-gate sparsification, annealed with the paper's
s{4}{3} fixed point on the partitioned DSIM on the card, and decoded by
majority vote over variable copies.

  PYTHONPATH=src python examples/torch_sat3_invertible.py [--vars 80] [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.core.annealing import sat_schedule
from repro_torch.core.coloring import greedy_coloring
from repro_torch.core.device import resolve_device
from repro_torch.core.dsim import DSIMEngine, build_partitioned
from repro_torch.core.partition import greedy_partition
from repro_torch.core.pbit import S43
from repro_torch.problems.sat import (count_satisfied, decode_assignment,
                                      encode_3sat, random_3sat)


def run(device="cuda", n_vars=80, alpha=4.26, sweeps=4000, partitions=4):
    """The reference's run on ``device``; returns the satisfied count at
    each point, the best, and the annealing's seconds."""
    device = resolve_device(device)
    m_cl = int(round(n_vars * alpha))
    clauses = random_3sat(n_vars, m_cl, seed=426)
    enc = encode_3sat(clauses, n_vars, device=device)
    g = enc.graph
    col = greedy_coloring(g.idx, g.w)
    print(f"3SAT n={n_vars} m={m_cl} (alpha={alpha}) -> "
          f"{g.n} p-bits after copy-gate sparsification, "
          f"{col.n_colors} colors")

    K = partitions
    labels = greedy_partition(g.idx, g.w, K, seed=0)
    prob = build_partitioned(g, col, labels, K)
    eng = DSIMEngine(prob, rng="lfsr", fmt=S43, device=device)
    pts = sorted(set(np.geomspace(64, sweeps, 6).astype(int)))
    best, counts, seconds, updates = 0, {}, 0.0, 0
    for p in pts:
        # fresh run to each point so every trace gets the correct
        # annealing-schedule prefix (geometric points: ~2x total work)
        st = eng.init_state(seed=0)
        t0 = time.perf_counter()
        st, _ = eng.run_recorded(st, sat_schedule(p), [p], sync_every=4)
        spins = eng.global_spins(st).cpu().numpy()
        seconds += time.perf_counter() - t0
        updates += g.n * int(p)
        assign = decode_assignment(enc, spins)
        ns = count_satisfied(clauses, assign)
        best = max(best, ns)
        counts[int(p)] = ns
        print(f"  sweeps {p:6d}: satisfied {ns}/{m_cl} "
              f"({100 * ns / m_cl:.2f}%)")
    print(f"\nbest: {best}/{m_cl} = {100 * best / m_cl:.2f}% "
          f"(paper at 250k p-bits: 99.74%)")
    return {"clauses": m_cl, "n": g.n, "n_colors": col.n_colors,
            "satisfied": counts, "best": best, "seconds": seconds,
            "updates_per_s": updates / seconds}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vars", type=int, default=80)
    ap.add_argument("--alpha", type=float, default=4.26)
    ap.add_argument("--sweeps", type=int, default=4000)
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    out = run(args.device, n_vars=args.vars, alpha=args.alpha,
              sweeps=args.sweeps, partitions=args.partitions)
    return out


if __name__ == "__main__":
    main()
