"""Replica-packing scheduler; port of ``repro.serve.scheduler`` (host
code, the same).

The machine's unit of parallelism is the replica axis R: every engine runs
R independent chains per batched call at marginal cost far below R separate
calls (one dispatch, one compiled runner, vectorized sweeps).  The
scheduler exploits that for multi-tenancy — compatible concurrent requests
(equal :func:`repro_torch.serve.jobs.pack_key`: problem, engine, precision,
exchange period, beta staircase) coalesce into ONE batched call, each job
owning a contiguous replica slice, so eight R=2 requests for a hot problem
cost one R=16 anneal instead of eight dispatch+record loops.

Packed batch sizes are padded up to a power of two by default: the pad
replicas are throwaway chains (their results are sliced off), but the pool
then serves *any* pack composition summing into the same bucket from one
compiled handle — a 3+2 pack and a 4+1 pack both run the R=8 executable.

Priorities order batch formation (strict: a batch is led by the
highest-priority queued job, filled only with compatible jobs); FIFO
within a priority level.  `dsim_dist` runs one tenant per batched call
(its handle exposes no per-replica seed lists), so it is never packed
(batches of one).

Bit-plane jobs (``precision="bitplane"``) batch in *lane* units: the
engine packs replicas into the bit lanes of W = ceil(R/32) stacked uint32
word planes, so a batch totals up to ``MAX_LANE_WORDS * 32`` chains and
the executed width clamps up to a *word multiple* (instead of a power of
two — an R=33 pack runs the W=2 64-lane executable, an R=65 pack the W=3
96-lane one, not R=128's pow2).  Every pack composition landing in the
same word bucket reuses ONE compiled executable — the engine loops a
one-word kernel over the word axis — and pad lanes are throwaway chains
exactly like pow2 pad replicas.  The precision is already part of
:func:`repro_torch.serve.jobs.pack_key`, so bit-plane jobs never coalesce with
int8/f32 jobs.  The word clamp also applies to ``dsim_dist`` bit-plane
jobs (one tenant per batch, but the executed width still pads to a full
word): the mesh engine's int8/bitplane lanes are *prefix-stable* — lane r
depends on spawn_seeds(seed)[r] alone — so pad lanes never perturb the
tenant's chains.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, List, Optional, Sequence, Tuple

from repro_torch.engines.base import MAX_LANE_WORDS, lanes_of

from .jobs import Job

__all__ = ["Batch", "ReplicaPackingScheduler", "PACKABLE_ENGINES",
           "ceil_pow2"]

# engines whose init_state takes per-replica seeds (see registry handles'
# ``supports_packing``); dsim_dist runs one tenant per call
PACKABLE_ENGINES = frozenset({"gibbs", "dsim", "lattice"})


def ceil_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


@dataclasses.dataclass
class Batch:
    """One batched engine call serving len(jobs) tenants.

    ``slices[i]`` is job i's [start, stop) replica range inside the packed
    state; ``r_exec`` (>= sum of job replicas) is the executed batch width
    after power-of-two padding.  The server attaches the live handle /
    cursor when the batch starts.
    """

    jobs: List[Job]
    key: tuple
    r_exec: int
    slices: List[Tuple[int, int]]
    seq: int                          # min job seq (FIFO tie-break)
    priority: int                     # max job priority

    # runtime (attached by the server)
    handle: Any = None
    cursor: Any = None
    pool_hit: Optional[bool] = None
    started_at: Optional[float] = None
    warm_s: float = 0.0
    device_s: float = 0.0
    points_seen: int = 0
    own_points: Any = None            # job id -> the points THAT job gets
    # fault tolerance (attached by the server)
    pool_key: Any = None              # engine-pool key (watchdog/breaker)
    chunks_done: int = 0              # chunk index for fault-site matching
    resume_ck: Any = None             # checkpoint record to restore at start
    ck: Any = None                    # latest checkpoint record (in-memory)
    ck_digest: Optional[str] = None   # its spool address (if spooled)
    ck_token: Any = None              # checkpoint lineage id
    last_ck_sweep: int = 0            # sweeps_done at the last checkpoint
    degrade_harvested: bool = False   # health report copied to tenants once

    @property
    def started(self) -> bool:
        return self.cursor is not None

    def relayout(self, pad_pow2: bool, cap: Optional[int] = None,
                 lanes: int = 1):
        """Compute slices / executed width / rank over the batch's jobs
        (called once at formation; batches never shrink — cancelled
        tenants keep their slice and are simply not harvested).  Padding
        never pushes the executed width past ``cap`` — near the cap the
        batch just runs unpadded.  ``lanes > 1`` (the bit-plane word
        width) clamps the executed width up to a lane multiple *instead
        of* a power of two — the word bucket W = r_exec/32 keys the
        compiled executable, so R=33 runs the W=2 (64-lane) binary and
        R=65 runs W=3 (96 lanes) rather than pow2's 128.  Under a
        sub-word cap the pow2 pad is the fallback."""
        self.slices, pos = [], 0
        for j in self.jobs:
            self.slices.append((pos, pos + j.spec.replicas))
            pos += j.spec.replicas
        self.r_exec = pos
        if lanes > 1:
            lane_r = ((pos + lanes - 1) // lanes) * lanes
            if cap is None or lane_r <= cap:
                self.r_exec = lane_r
            elif pad_pow2 and ceil_pow2(pos) <= cap:
                self.r_exec = ceil_pow2(pos)
        elif pad_pow2 and (cap is None or ceil_pow2(pos) <= cap):
            self.r_exec = ceil_pow2(pos)
        self.seq = min(j.seq for j in self.jobs)
        self.priority = max(j.spec.priority for j in self.jobs)


class ReplicaPackingScheduler:
    """Forms batches from the queued-job set; see the module docstring."""

    def __init__(self, max_replicas_per_call: int = 64, pack: bool = True,
                 pad_pow2: bool = True, metrics=None):
        if max_replicas_per_call < 1:
            raise ValueError("max_replicas_per_call must be >= 1")
        self.max_replicas_per_call = int(max_replicas_per_call)
        self.pack = bool(pack)
        self.pad_pow2 = bool(pad_pow2)
        # counters (monotone; read via stats()) — the server's pump and
        # stats threads hit these concurrently, so they get their own lock
        self._lock = threading.Lock()
        self.batches_formed = 0       # guarded_by: _lock
        self.jobs_batched = 0         # guarded_by: _lock
        self.jobs_packed = 0          # guarded_by: _lock
        self.padding_replicas = 0     # guarded_by: _lock
        # optional obs.MetricsRegistry: executed pack widths and the
        # padding waste (throwaway replicas) per formed batch
        self._h_width = self._m_padding = None
        if metrics is not None:
            self._h_width = metrics.histogram(
                "sched_pack_width_replicas", "executed batch width r_exec",
                buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
            self._m_padding = metrics.counter(
                "sched_padding_replicas_total",
                "throwaway pad replicas executed (r_exec - packed)")

    def replica_budget(self, precision: str) -> int:
        """Per-batch (and per-job admission) chain cap: the per-call cap,
        additionally clamped to the lane fabric's capacity for bit-plane
        jobs (the engine cannot stack more than ``MAX_LANE_WORDS`` uint32
        word planes).  The server's ``submit`` validates against this same
        number, so admission never accepts a job the scheduler can't
        batch."""
        lanes = lanes_of(precision)
        if lanes > 1:
            return min(self.max_replicas_per_call, MAX_LANE_WORDS * lanes)
        return self.max_replicas_per_call

    def r_exec_for(self, engine: str, replicas: int,
                   precision: str = "f32") -> int:
        """Executed batch width for a pack totalling ``replicas`` chains —
        the pool-key bucketing ``prewarm`` must agree with.  Clamped like
        :meth:`Batch.relayout`: never padded past the per-call cap; lane
        (word-multiple) clamping replaces the pow2 pad for bit-plane
        jobs, with pow2 as the sub-word-cap fallback."""
        r = int(replicas)
        lanes = lanes_of(precision)
        if lanes > 1:
            lane_r = ((r + lanes - 1) // lanes) * lanes
            if lane_r <= self.max_replicas_per_call:
                return lane_r
            if self.pad_pow2 and engine in PACKABLE_ENGINES \
                    and ceil_pow2(r) <= self.max_replicas_per_call:
                return ceil_pow2(r)
            return r
        if self.pad_pow2 and engine in PACKABLE_ENGINES \
                and ceil_pow2(r) <= self.max_replicas_per_call:
            r = ceil_pow2(r)
        return r

    def next_batch(self, queued: Sequence[Job]) -> Optional[Batch]:
        """The single next batch to run, or None.

        Led by the highest-priority (then oldest) queued job; greedily
        filled with pack-compatible queued jobs in the same order while the
        replica budget holds.  Exactly the jobs it absorbs should be
        removed from the queue by the caller.
        """
        order = sorted(queued, key=lambda j: (-j.spec.priority, j.seq))
        if not order:
            return None
        lead = order[0]
        group = [lead]
        total = lead.spec.replicas
        budget = self.replica_budget(lead.spec.precision)
        if self.pack and lead.spec.engine in PACKABLE_ENGINES:
            for j in order[1:]:
                if j.pack_key != lead.pack_key:
                    continue
                # quarantine/bisect pinning: a re-run cohort (same
                # pack_group token) only packs with itself, so poison
                # isolation controls exactly which jobs share a call
                if j.pack_group != lead.pack_group:
                    continue
                if total + j.spec.replicas > budget:
                    continue
                group.append(j)
                total += j.spec.replicas
        b = Batch(jobs=group, key=lead.pack_key, r_exec=0, slices=[],
                  seq=0, priority=0)
        # non-packable engines derive all replica streams from one seed, so
        # pad replicas would perturb the tenant's chains — never pad them
        b.relayout(self.pad_pow2 and lead.spec.engine in PACKABLE_ENGINES,
                   cap=self.max_replicas_per_call,
                   lanes=lanes_of(lead.spec.precision))
        pad = b.r_exec - total
        with self._lock:
            self.batches_formed += 1
            self.jobs_batched += len(group)
            if len(group) > 1:
                self.jobs_packed += len(group)
            self.padding_replicas += pad
        if self._h_width is not None:
            self._h_width.observe(b.r_exec)
            self._m_padding.inc(pad)
        return b

    def stats(self) -> dict:
        with self._lock:
            return {"max_replicas_per_call": self.max_replicas_per_call,
                    "pack": self.pack, "pad_pow2": self.pad_pow2,
                    "batches_formed": self.batches_formed,
                    "jobs_batched": self.jobs_batched,
                    "jobs_packed": self.jobs_packed,
                    "padding_replicas": self.padding_replicas}
