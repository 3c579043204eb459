"""What every adapter shares: a job's hand-over, run and answers through
the port's registry handle, with the traffic mix's schedule."""

from __future__ import annotations

import torch

from repro_torch.core.annealing import Schedule


class System:
    """The system under test behind ``self.handle`` (set by a subclass,
    which also gives ``program_state``, ``keep`` and ``lattice_form``);
    ``lanes`` chains of ``words`` spin word planes over ``dims``."""

    def __init__(self, config: dict, traffic: dict):
        if traffic["precision"] != "bitplane":
            raise ValueError(f"the harness runs the bit-plane path, not "
                             f"{traffic['precision']!r}")
        self.precision = traffic["precision"]
        self.L = int(config["L"])
        self.dims = (self.L,) * 3
        self.lanes = int(traffic["replicas"])
        self.words = -(-self.lanes // 32)
        self.sync_every = int(traffic["sync_every"])
        self.plans = {}
        for key, sweeps, points in (
                ("job", traffic["sweeps"], traffic["record_points"]),
                ("warm", traffic["warm_sweeps"], [traffic["warm_sweeps"]])):
            self.plans[key] = (Schedule(traffic["beta_levels"], sweeps),
                               [int(p) for p in points])

    def start(self, state):
        """The hand-over: the engine's entry for a global-shape state."""
        return self.handle.eng.shard_state(state)

    def run(self, state, plan: str = "job"):
        """The anneal of a job (``plan`` "job") or of the warm-up, which
        runs the same chunks and record points over fewer sweeps."""
        schedule, points = self.plans[plan]
        return self.handle.run_recorded(state, schedule, points,
                                        sync_every=self.sync_every)

    @staticmethod
    def answers(state, rec) -> dict:
        """What a job returns to its user's host: the record points, their
        energies (P, R) and the per-lane flips (R,)."""
        return {"times": [int(t) for t in rec.times],
                "energies": rec.energies.cpu(),
                "flips": state.flips.cpu().to(torch.int64)}
