"""The one traffic generator: the initial state of each job, drawn on the
device from (run seed, job index), and the seeded choice of the jobs and
lanes whose answers the reference checks.

A job is one anneal that a user of the sampler submits: a fresh initial
state run over a schedule.  Its state is drawn in the lattice layout, the
reference's: W spin word planes (W, X, Y, Z) int32, bit b of plane w the
spin of lane 32 w + b (1 for +1), uniform; and R lanes of nonzero
xorshift32 states (R, X, Y, Z) int32 views of uint32 values.  The same
(seed, job) gives the same tensors on the same device.
"""

from __future__ import annotations

import numpy as np
import torch


def job_seed(seed: int, job: int) -> int:
    """A 63-bit generator seed of (run seed, job index); the warm-up job
    has index -1."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(job) + 1])
    return int(ss.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)


def draw(seed: int, job: int, words: int, lanes: int, dims, device):
    """(spin words (W, X, Y, Z), states (R, X, Y, Z)), int32 on ``device``,
    from one generator seeded by :func:`job_seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(job_seed(seed, job))
    lo, hi = -2 ** 31, 2 ** 31
    w = torch.randint(lo, hi, (words, *dims), generator=gen,
                      dtype=torch.int32, device=device)
    s = torch.randint(lo, hi, (lanes, *dims), generator=gen,
                      dtype=torch.int32, device=device)
    # xorshift32 has the zero state as a fixed point: no lane starts there
    s = torch.where(s == 0, torch.ones_like(s), s)
    return w, s


def lane_sample(seed: int, lanes: int, per_word: int) -> list:
    """The lanes the reference checks: ``per_word`` of each word plane's
    lanes (32 a plane), drawn from the run seed, in increasing order, so
    that every word plane is checked whatever the seed."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 11])
    out = []
    for lo in range(0, int(lanes), 32):
        n = min(32, int(lanes) - lo)
        out += [lo + int(b) for b in rng.choice(n, min(n, int(per_word)),
                                                replace=False)]
    return sorted(out)


class Reservoir:
    """A uniform sample of ``k`` jobs from all the jobs of a window,
    without knowing their number beforehand (reservoir sampling, drawn
    from the run seed)."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 7])
        self.kept = {}            # slot -> (job index, payload)
        self.seen = 0

    def offer(self, job: int, payload):
        """Offer the jobs in order; ``payload()`` is called for a job that
        enters the sample, and its result kept."""
        i = self.seen
        self.seen += 1
        slot = i if i < self.k else int(self.rng.integers(0, i + 1))
        if slot < self.k:
            self.kept[slot] = (job, payload())

    def items(self):
        return sorted(self.kept.values(), key=lambda jp: jp[0])
