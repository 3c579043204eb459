"""Job model for the async sampling server; port of ``repro.serve.jobs``.

A *job* is one annealing request: problem + engine + schedule + R replica
chains + seed.  Jobs move QUEUED -> RUNNING -> {DONE, FAILED, CANCELLED};
while RUNNING they accumulate a streamed partial trace (energies at record
points, best-so-far configuration, exact flips) that ``SampleServer.poll``
exposes mid-anneal.

Two requests are *pack-compatible* — runnable as replica slices of one
batched engine call — iff their :func:`pack_key` matches: same problem
fingerprint, engine, precision, boundary-exchange period, and beta
staircase.  The fingerprints below make that check O(1) at schedule time.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.device import as_numpy

__all__ = ["JobStatus", "JobSpec", "Job", "pack_key",
           "problem_fingerprint", "schedule_fingerprint"]


class JobStatus(str, enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"

    @property
    def terminal(self) -> bool:
        return self in (JobStatus.DONE, JobStatus.FAILED,
                        JobStatus.CANCELLED)


def problem_fingerprint(graph=None, L: Optional[int] = None,
                        seed: int = 0) -> str:
    """Content hash of a problem instance.

    Graphs hash their ELL arrays (topology + couplings + fields, on any
    device), so two services holding bitwise-equal instances agree, the
    reference's too; lattices are generated from (L, seed) and hash that
    recipe.
    """
    h = hashlib.sha1()
    if graph is not None:
        for arr in (graph.idx, graph.w, graph.h):
            a = as_numpy(arr)
            h.update(str(a.shape).encode())
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())
        return "g:" + h.hexdigest()[:16]
    if L is None:
        raise ValueError("problem needs graph= or L=")
    return f"lat:L={int(L)}:seed={int(seed)}"


def schedule_fingerprint(schedule) -> str:
    """Content hash of a beta staircase (dense per-sweep array)."""
    a = np.asarray(schedule.beta_array())
    h = hashlib.sha1()
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """What the caller asked for (immutable once admitted)."""

    problem: str                     # registered problem name
    engine: str = "gibbs"
    sweeps: int = 1024
    replicas: int = 1
    seed: int = 0
    precision: str = "f32"
    sync_every: Any = 1              # int S | 'phase' | None
    record_points: Optional[Tuple[int, ...]] = None
    priority: int = 0                # higher runs sooner
    schedule: Any = None             # explicit Schedule; None -> ea_schedule
    # fault-tolerance policy (None -> the server's defaults)
    max_retries: Optional[int] = None    # transient-failure retry budget
    deadline_s: Optional[float] = None   # wall budget from submit; enforced
    #                                      between chunks (DeadlineExceeded)
    checkpoint_every: Optional[int] = None  # sweeps between spool snapshots
    # mesh degraded-mode policy: None | "fail_fast" | "stale_hold[:N]" |
    # "freeze_boundary" (core.degrade.DegradePolicy.parse vocabulary);
    # only meaningful for the mesh engines (dsim_dist / lattice)
    degrade_policy: Optional[str] = None


def pack_key(spec: JobSpec, problem_fp: str, schedule_fp: str) -> tuple:
    """Compatibility class for replica packing: jobs with equal keys can
    share one batched engine call (each job owns a replica slice)."""
    return (problem_fp, spec.engine, spec.precision, str(spec.sync_every),
            schedule_fp, str(spec.degrade_policy))


class Job:
    """Runtime record: spec + status + streamed partial results.

    All mutation happens under the server's lock; ``poll_snapshot`` hands
    out copies so callers never alias live buffers.
    """

    def __init__(self, job_id: str, seq: int, spec: JobSpec,
                 problem_fp: str, schedule, schedule_fp: str,
                 submitted_at: float):
        self.id = job_id
        self.seq = seq               # admission order (FIFO tie-break)
        self.spec = spec
        self.problem_fp = problem_fp
        self.schedule = schedule
        self.schedule_fp = schedule_fp
        self.pack_key = pack_key(spec, problem_fp, schedule_fp)
        self.status = JobStatus.QUEUED
        self.cancel_requested = False
        self.error: Optional[str] = None
        # fault-tolerance runtime
        self.attempts: int = 0       # batch starts this job participated in
        self.retries: int = 0        # transient-failure retries consumed
        self.bisect_runs: int = 0    # quarantine re-runs (not retries)
        self.pack_group: Optional[tuple] = None  # bisect/recover pinning:
        #   jobs only pack with equal groups (None packs freely)
        self.next_eligible_at: float = 0.0       # retry backoff gate
        self.resume_ck: Any = None   # checkpoint record to resume from
        self.resume_ck_digest: Optional[str] = None  # its spool address
        self.resumed_sweeps: int = 0     # sweeps recovered via checkpoints
        self.restarted_sweeps: int = 0   # sweeps re-executed from scratch
        # timestamps (time.perf_counter clock)
        self.submitted_at = submitted_at
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        # streamed partials
        self.times: List[int] = []
        self.energy_rows: List[np.ndarray] = []   # each (r,) at a point
        self.best_energy: float = float("inf")
        self.best_replica: int = -1
        self.best_spins: Optional[np.ndarray] = None
        self.flips: int = 0
        self.sweeps_done: int = 0
        self.total_sweeps: int = int(spec.sweeps)
        self.device_s: float = 0.0   # replica-share of batch device time
        # batching facts (filled when the batch starts)
        self.packed_with: int = 0
        self.pool_hit: Optional[bool] = None
        # degraded-mode provenance (mesh engines with a degrade policy:
        # the health monitor's report at batch end)
        self.degrade: Optional[Dict[str, Any]] = None

    # -- streaming updates (caller holds the server lock) ----------------------

    def observe(self, t: int, energies_r: np.ndarray,
                spins_r: Optional[np.ndarray]):
        """Fold in one record point: (r,) energies and, when the point is
        the cursor's current state, the (r, N) spins for best-so-far."""
        self.times.append(int(t))
        row = np.asarray(energies_r, np.float64).copy()
        self.energy_rows.append(row)
        i = int(np.argmin(row))
        if float(row[i]) < self.best_energy and spins_r is not None:
            self.best_energy = float(row[i])
            self.best_replica = i
            self.best_spins = np.asarray(spins_r[i]).copy()

    def reset_partials(self):
        """Drop streamed partials for a from-scratch re-run (retry or
        bisect without a usable checkpoint); the discarded progress is
        accounted in ``restarted_sweeps``."""
        self.restarted_sweeps += self.sweeps_done
        self.times = []
        self.energy_rows = []
        self.best_energy = float("inf")
        self.best_replica = -1
        self.best_spins = None
        self.flips = 0
        self.sweeps_done = 0
        self.device_s = 0.0

    # -- views ----------------------------------------------------------------

    def energies(self) -> np.ndarray:
        if not self.energy_rows:
            return np.zeros((0, self.spec.replicas))
        return np.stack(self.energy_rows)

    def poll_snapshot(self) -> Dict[str, Any]:
        out = {
            "job_id": self.id,
            "problem": self.spec.problem,
            "engine": self.spec.engine,
            "precision": self.spec.precision,
            "replicas": self.spec.replicas,
            "priority": self.spec.priority,
            "status": self.status.value,
            "sweeps_done": self.sweeps_done,
            "total_sweeps": self.total_sweeps,
            "times": np.asarray(self.times, np.int64),
            "energies": self.energies(),
            "best_energy": self.best_energy,
            "best_replica": self.best_replica,
            "best_spins": None if self.best_spins is None
            else self.best_spins.copy(),
            "flips": self.flips,
            "packed_with": self.packed_with,
            "pool_hit": self.pool_hit,
            "error": self.error,
            "retries": self.retries,
            "bisect_runs": self.bisect_runs,
            "resumed_sweeps": self.resumed_sweeps,
            "restarted_sweeps": self.restarted_sweeps,
            "degrade": None if self.degrade is None else dict(self.degrade),
        }
        return out

    def result_payload(self) -> Dict[str, Any]:
        """Final payload (terminal jobs); extends the poll snapshot with
        latency accounting in the SampleService key vocabulary."""
        out = self.poll_snapshot()
        queue_s = ((self.started_at or self.finished_at or self.submitted_at)
                   - self.submitted_at)
        wall_s = 0.0
        if self.finished_at is not None and self.started_at is not None:
            wall_s = self.finished_at - self.started_at
        total_s = ((self.finished_at or self.submitted_at)
                   - self.submitted_at)
        out.update({
            "queue_s": queue_s,
            "wall_s": wall_s,            # running wall (excludes queueing)
            # executed-replica share of batch device time (tenant shares
            # sum to the batch total), so flips / device_s reads as the
            # machine-level flip rate observed while this job ran
            "device_s": self.device_s,
            "total_s": total_s,
            "cold_start": (None if self.pool_hit is None
                           else not self.pool_hit),
            "flips_per_s": self.flips / max(self.device_s, 1e-9),
        })
        return out
