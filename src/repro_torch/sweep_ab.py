#!/usr/bin/env python3
"""Time two checkouts of the PyTorch/CUDA port on one card, in turns.

    python3 src/repro_torch/sweep_ab.py --base DIR [--out FILE]

DIR is the root of another checkout (for example a ``git archive`` of the
parent commit unpacked into a directory that ``.gitignore`` lists).  Each
turn is a fresh process that imports ``repro_torch`` from one checkout,
builds its kernels there and measures, at L=100 on the EA3D instance:

- one call of the bit-plane sweep (R=64 lanes, 8 sweeps), of the f32
  sweep (R=4, 8 sweeps, with and without s{4}{1}) and of the int8 sweep
  (R=4, 8 sweeps), ms per call by CUDA events over 20 calls after 2 warm
  ones;
- one call of the public single phases, f32 ``pbit_brick_update`` and
  int8 ``pbit_brick_update_int`` (R=4, color 0, one launch each): host
  bound, so the least of 9 blocks of 200 calls, each timed by CUDA
  events;
- one call of the energy ``brick_energy`` on int8 spins at R=4 and R=64,
  and the bit-plane engine's readout ``LatticeDSIM.energy`` of a state at
  R=64 (exchange and energy, as at each record point), ms per call by
  CUDA events over 50 calls after 2 warm ones;
- the main path through ``make_engine("lattice", ...)``: 256 sweeps of
  ``ea_schedule(256)``, record points 16/64/128/256, ``sync_every=8``, wall
  seconds to a device synchronise, best of 8 after one warm run (the
  per-phase path is host-bound and swings from run to run); at
  bit-plane R=64, f32 R=4 (with and without s{4}{1}), int8 R=4 and the
  per-phase dispatch (int8 ``fused=False`` and f32 ``kernel_bx=25``) R=4.

The turns run base, change, change, base, so a drift of the card shows as
a difference between the two turns of one checkout.  Prints one JSON line
per turn and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

L = 100
SWEEPS = 256
POINTS = [16, 64, 128, 256]
SYNC = 8
# timed main-path runs per configuration and turn, after one warm run
MAIN_RUNS = 8


def worker(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import make_engine
    from repro_torch.core.annealing import (beta_row_indices, beta_table,
                                            ea_schedule)
    from repro_torch.core.bits import u32_from_numpy
    from repro_torch.core.packing import pack_lanes
    from repro_torch.core.pbit import threshold_lut
    from repro_torch.kernels.lattice_energy import brick_energy
    from repro_torch.kernels.pbit_bitplane import pbit_bitplane_sweep
    from repro_torch.kernels.pbit_lattice import (halo_shapes,
                                                  pbit_brick_sweep,
                                                  pbit_brick_sweep_int,
                                                  pbit_brick_update,
                                                  pbit_brick_update_int)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)

    def ms_per_call(fn, reps=20):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def spins(R):
        return torch.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                           size=(R, L, L, L))).to(dev)

    def states(R):
        return u32_from_numpy(rng.integers(1, 2 ** 32, size=(R, L, L, L),
                                           dtype=np.uint32), dev)

    out = {"root": str(root)}
    betas = ea_schedule(SWEEPS).beta_array()
    table = beta_table(betas)
    eng = make_engine("lattice", L=L, seed=0, replicas=64,
                      precision="bitplane").eng
    lut = u32_from_numpy(threshold_lut(table, eng.q_scale, eng.f_max), dev)
    hw = tuple(u32_from_numpy(rng.integers(0, 2 ** 32, size=sh,
                                           dtype=np.uint32), dev)
               for sh in halo_shapes(2, L, L, L))
    rows = torch.from_numpy(beta_row_indices(betas[:SYNC], table)).to(dev)
    bp = (pack_lanes(spins(64)), states(64), rows, eng.masks_w,
          eng.signs6_w, eng.nz6_w, eng.base_w, hw, lut)
    out["bitplane_call_ms"] = ms_per_call(lambda: pbit_bitplane_sweep(*bp))
    p = eng.p
    halos = tuple(torch.from_numpy(rng.choice(
        np.array([-1, 1], np.int8), size=sh)).to(dev)
        for sh in halo_shapes(4, L, L, L))
    f32 = (spins(4), states(4), torch.from_numpy(
        np.ascontiguousarray(betas[:SYNC], np.float32)).to(dev), p.masks,
        p.h, p.w6, halos)
    out["f32_call_ms"] = ms_per_call(lambda: pbit_brick_sweep(*f32))
    out["f32_s41_call_ms"] = ms_per_call(
        lambda: pbit_brick_sweep(*f32, fmt=repro_torch.S41))
    e8 = make_engine("lattice", L=L, seed=0, replicas=4,
                     precision="int8").eng
    lut8 = u32_from_numpy(threshold_lut(table, e8.q_scale, e8.f_max), dev)
    int8 = (f32[0], f32[1], rows, p.masks, e8.h_q, e8.w6_q, halos, lut8)
    out["int8_call_ms"] = ms_per_call(lambda: pbit_brick_sweep_int(*int8))
    phase = f32[:2] + (0.5, p.masks[0], p.h, p.w6, halos)
    out["f32_phase_call_ms"] = min(ms_per_call(
        lambda: pbit_brick_update(*phase), reps=200) for _ in range(9))
    phase8 = f32[:2] + (int(rows[0]), p.masks[0], e8.h_q, e8.w6_q, halos,
                        lut8)
    out["int8_phase_call_ms"] = min(ms_per_call(
        lambda: pbit_brick_update_int(*phase8), reps=200) for _ in range(9))
    for R in (4, 64):
        halos_r = tuple(torch.from_numpy(rng.choice(
            np.array([-1, 1], np.int8), size=sh)).to(dev)
            for sh in halo_shapes(R, L, L, L))
        energy = (spins(R), p.active, p.h, p.w6, halos_r)
        out[f"energy_R{R}_call_ms"] = ms_per_call(
            lambda: brick_energy(*energy), reps=50)
    bp_state = eng.init_state(seed=0)
    out["bitplane_readout_ms"] = ms_per_call(lambda: eng.energy(bp_state),
                                             reps=50)

    for label, kw in (("bitplane R=64", dict(precision="bitplane",
                                             replicas=64)),
                      ("f32 R=4", dict(replicas=4)),
                      ("f32 s41 R=4", dict(replicas=4, fmt=repro_torch.S41)),
                      ("int8 R=4", dict(precision="int8", replicas=4)),
                      ("int8 per-phase R=4", dict(precision="int8",
                                                  replicas=4, fused=False)),
                      ("f32 per-phase bx R=4", dict(replicas=4,
                                                    kernel_bx=25))):
        h = make_engine("lattice", L=L, seed=0, **kw)
        init = h.init_state(seed=0)
        walls = []
        for _ in range(1 + MAIN_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h.run_recorded(init, ea_schedule(SWEEPS), POINTS,
                           sync_every=SYNC)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[f"main {label} s"] = min(walls[1:])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, help="root of the other checkout")
    ap.add_argument("--out", type=Path, help="also write the turns here")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve())), flush=True)
        return 0
    if args.base is None:
        ap.error("--base is required")
    import torch
    if not torch.cuda.is_available():
        print("sweep_ab: no CUDA device", file=sys.stderr)
        return 1
    change = Path(__file__).resolve().parents[2]
    turns = []
    for root in (args.base.resolve(), change, change, args.base.resolve()):
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(root)], capture_output=True, text=True, check=False)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        turn = json.loads(res.stdout.strip().splitlines()[-1])
        turn["turn"] = "base" if root != change else "change"
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "turns": turns},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
