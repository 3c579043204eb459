"""Max-Cut with adaptive parallel tempering + isoenergetic cluster moves,
on the PyTorch/CUDA port.

The port of ``examples/maxcut_gset.py``: the paper's G81 protocol (Sec.
S9) at reduced size, on the card: a toroidal +-1 grid, APT preprocessing
for the temperature ladder, APT+ICM search, the best-cut distribution
over trials, and the hex-encoded verification string.

  PYTHONPATH=src python examples/torch_maxcut_gset.py [--rows 10 --cols 16] [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.core.apt_icm import APTICM, adapt_ladder
from repro_torch.core.coloring import greedy_coloring
from repro_torch.core.device import resolve_device
from repro_torch.problems.maxcut import (cut_of, gset_like_toroidal,
                                         maxcut_to_ising, spins_to_hex)


def run(device="cuda", rows=10, cols=16, sweeps=1500, trials=5,
        temps=8, pilot_sweeps=80):
    """The reference's run on ``device``; returns the cuts, the best, the
    hex line and the APT runs' seconds."""
    device = resolve_device(device)
    g = gset_like_toroidal(rows, cols, seed=81, device=device)
    gi = maxcut_to_ising(g)
    col = greedy_coloring(gi.idx, gi.w)
    print(f"toroidal grid {rows}x{cols} (n={g.n}), "
          f"{col.n_colors} colors")

    betas = adapt_ladder(gi, col, 1.0, 6.0, temps,
                         pilot_sweeps=pilot_sweeps, device=device)
    print("adaptive ladder:", np.round(betas, 2))

    cuts, best_m, seconds = [], None, 0.0
    for t in range(trials):
        apt = APTICM(gi, col, betas, chains=2, device=device)
        st = apt.init_state(seed=t)
        t0 = time.perf_counter()
        st, _ = apt.run(st, sweeps, icm_every=10, record_every=sweeps)
        m, E = apt.best_config(st)
        seconds += time.perf_counter() - t0
        c = cut_of(g, m)
        cuts.append(c)
        if c == max(cuts):
            best_m = m
        print(f"trial {t}: cut = {c:.0f}  (E = {E:.0f}, "
              f"{int(st.swaps)} swaps, {int(st.icms)} cluster moves)")

    best = max(cuts)
    hexline = spins_to_hex(best_m)[:120] + "..."
    print(f"\nbest cut {best:.0f}; found in "
          f"{100 * np.mean(np.asarray(cuts) == best):.0f}% of trials")
    print("verification hex (paper S9 format):")
    print(hexline)
    updates = g.n * 2 * len(betas) * sweeps * trials
    return {"n": g.n, "betas": np.asarray(betas).tolist(), "cuts": cuts,
            "best": best, "hex": hexline, "seconds": seconds,
            "updates_per_s": updates / seconds}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10)
    ap.add_argument("--cols", type=int, default=16)
    ap.add_argument("--sweeps", type=int, default=1500)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    out = run(args.device, rows=args.rows, cols=args.cols,
              sweeps=args.sweeps, trials=args.trials)
    return out


if __name__ == "__main__":
    main()
