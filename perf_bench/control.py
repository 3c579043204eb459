"""The control of a cell's check: the plain reference put in the program's
place and computed one precision lower than the configuration states (its
threshold LUT in float32 instead of float64), judged by the run's own
check (``Run.check``, the same numbers and limits).  A sound check reads
it as not correct.  Run on the card at the cell's own size:

    python3 perf_bench/control.py --workload <name> --seeds 1 2 3

It prints, per seed, the LUT entries that differ and the numbers compared
beside their limits, and exits nonzero where the control reads correct.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def control(spec: dict, seed: int, device) -> tuple:
    """(the checks of run seed ``seed`` with the control in the program's
    place, over the jobs a run checks, and the LUT entries that differ)."""
    from perf_bench import harness as H
    cfg, tr = spec["config"], spec["traffic"]
    ref = H.reference(cfg, spec["root"])
    args = (int(cfg["L"]), seed, cfg["format"], device)
    low = ref.Machine(*args, lut_dtype=np.float32)
    plan = (tr["beta_levels"], int(tr["sweeps"]))
    lut_differ = int((low.lut(*plan)[1] != ref.Machine(*args).lut(*plan)[1])
                     .sum())
    run = H.Run(spec, seed, 0.0, False, device=device, log=lambda *a: None)
    jobs = range(int(tr["checked_jobs"]))
    return run.check([(job, None) for job in jobs], len(jobs),
                     program=low), lut_differ


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    import torch
    from perf_bench.harness import card_line, load_spec, passes
    spec = load_spec(a.workload)
    dev = torch.device("cuda", 0)
    print(f"card: {card_line()}", flush=True)
    failed_all = True
    for seed in a.seeds:
        t0 = time.perf_counter()
        checks, lut_differ = control(spec, seed, dev)
        caught = not passes(checks)
        failed_all &= caught
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control_reads_incorrect": caught,
                          "lut_entries_differ": lut_differ,
                          **{k: c["value"] for k, c in checks.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    root = Path(__file__).resolve().parents[1]
    sys.path[:] = [str(root), str(root / "src")] + [
        q for q in sys.path if Path(q or ".").resolve() != root / "perf_bench"]
    sys.exit(main())
