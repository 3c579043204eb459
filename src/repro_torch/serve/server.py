"""Async sampling server: job queue, packing scheduler, engine pool,
streaming results; port of ``repro.serve.server``.

Engines are built through ``repro_torch.engines.make_engine`` on the
server's device: the card unless ``SampleServer(device="cpu")``, and
without CUDA the constructor raises.  Nothing falls back: a job whose
kernels fail to build or launch fails (``faults.classify_error`` calls
that permanent).

``SampleServer`` turns the engine layer into a multi-tenant service:

- **submit / poll / result / cancel** — anneal requests become jobs with
  priorities and admission control (a bounded queue rejects overload with
  :class:`QueueFull` instead of buffering unboundedly).
- **replica packing** — compatible concurrent jobs (same problem, engine,
  precision, exchange period, beta staircase) coalesce into one batched
  engine call along the replica axis R; each tenant owns a replica slice,
  and because packed replicas are seeded per-job, a job's trajectory is
  bitwise independent of its batch-mates.
- **engine pool** — built handles live in an LRU keyed by problem
  fingerprint (+ engine/precision/packed width), so hot problems never
  rebuild; ``prewarm`` moves cold starts (the kernels built and launched
  once) off the serving path entirely.
- **streaming** — jobs advance through the bounded chunks of the shared
  recording driver (``RecordedCursor``); ``poll`` returns the partial
  energy trace, best-so-far spins, and *exact* per-job flip counts
  mid-anneal, and the server can preempt a long batch between chunks when
  higher-priority work arrives.

Fault tolerance (see serve/faults.py for the taxonomy and DESIGN.md for
the state machine): a batched call that throws is **quarantined and
bisected** — innocent tenants re-run and complete, only the culprit
fails; transient failures retry with exponential backoff + jitter under
a per-job ``max_retries``; jobs past ``checkpoint_every`` sweeps snapshot
their cursor into a spool directory between chunks, so retries resume
from the checkpoint instead of sweep 0 and :meth:`SampleServer.recover`
re-admits in-flight jobs after a process crash (bitwise-identical
continuation); ``deadline_s`` is enforced between chunks; a watchdog
marks the engine-pool key of a stalled chunk suspect; and the pool's
circuit breaker stops a key that keeps failing to compile from stalling
the serving loop.  All of it is drivable deterministically through
``SampleServer(fault_plan=...)``.

Driving: ``pump()`` runs one chunk of the best batch (deterministic,
test-friendly); ``start()`` runs the same loop on a background thread.

  srv = SampleServer()
  srv.register_problem("ea8", graph=g, coloring=col)
  jid = srv.submit("ea8", engine="dsim", sweeps=2048, replicas=4)
  srv.poll(jid)["sweeps_done"]      # streams while annealing
  srv.result(jid)["best_energy"]
"""

from __future__ import annotations

import copy
import hashlib
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.annealing import ea_schedule
from repro_torch.core.degrade import DegradePolicy
from repro_torch.core.device import as_numpy, resolve_device
from repro_torch.engines import make_engine
from repro_torch.engines.base import (LANE_WIDTH, MAX_LANE_WORDS,
                                      check_precision, lanes_of,
                                      quantize_record_points, spawn_seeds)
from repro_torch.obs import MetricsRegistry, Tracer

from .faults import (FaultPlan, StateCorruption, classify_error,
                     compute_backoff)
from .jobs import Job, JobSpec, JobStatus, problem_fingerprint, \
    schedule_fingerprint
from .pool import EnginePool
from .scheduler import Batch, ReplicaPackingScheduler
from .spool import CheckpointSpool

__all__ = ["SampleServer", "QueueFull"]

_FILLER_SEED = 1_000_003      # namespace for pad-replica seed spawning


def _hashable_kw(kw: Dict[str, Any]) -> tuple:
    """Engine kwargs as a hashable pool-key component.  Graph-registered
    problems carry arrays (``labels`` partitions, meshes) in their
    ``engine_kw``; a raw ``tuple(sorted(kw.items()))`` made the pool key
    unhashable, so every mesh-engine job died at the cache probe.  Arrays
    and tensors key by content digest (same partition -> same engine,
    regardless of identity or device); anything else non-primitive keys by
    ``repr``."""
    items = []
    for k, v in sorted(kw.items()):
        if isinstance(v, (np.ndarray, torch.Tensor)) \
                or hasattr(v, "__array__"):
            a = as_numpy(v)
            v = ("ndarray", a.dtype.str, a.shape,
                 hashlib.sha1(a.tobytes()).hexdigest())
        elif not isinstance(v, (int, float, str, bool, bytes, frozenset,
                                tuple, type(None))):
            v = ("repr", repr(v))
        items.append((k, v))
    return tuple(items)


class QueueFull(RuntimeError):
    """Admission control: the bounded job queue rejected a submission."""


class _Problem:
    def __init__(self, name, graph, coloring, L, seed, engine_kw):
        self.name = name
        self.graph = graph
        self.coloring = coloring
        self.L = L
        self.seed = seed
        self.engine_kw = dict(engine_kw)
        self.fingerprint = problem_fingerprint(graph=graph, L=L, seed=seed)


class SampleServer:
    """Multi-tenant annealing server over the unified engine layer."""

    # lifecycle/fault counters live on the metrics registry (one counter
    # family each); attribute reads (`srv.failed`) resolve through
    # __getattr__ so the pre-telemetry surface is unchanged
    _COUNTERS = {
        "submitted": ("serve_jobs_submitted_total", "jobs admitted"),
        "completed": ("serve_jobs_completed_total", "jobs finished DONE"),
        "failed": ("serve_jobs_failed_total", "jobs finished FAILED"),
        "cancelled": ("serve_jobs_cancelled_total",
                      "jobs finished CANCELLED"),
        "rejected": ("serve_jobs_rejected_total",
                     "submissions bounced by admission control"),
        "engine_calls": ("serve_engine_calls_total",
                         "batched anneal launches (cursors built)"),
        "preemptions": ("serve_preemptions_total",
                        "batches parked by higher-priority work"),
        "retries": ("serve_retries_total",
                    "transient-failure retries granted"),
        "quarantined_batches": ("serve_quarantined_batches_total",
                                "multi-job batches sent to bisection"),
        "bisect_requeues": ("serve_bisect_requeues_total",
                            "jobs re-queued by quarantine splits"),
        "deadline_failures": ("serve_deadline_failures_total",
                              "jobs failed by wall-budget expiry"),
        "stuck_chunks": ("serve_stuck_chunks_total", "watchdog firings"),
        "corrupted_chunks": ("serve_corrupted_chunks_total",
                             "integrity-guard firings"),
        "checkpoints_written": ("serve_checkpoints_written_total",
                                "cursor snapshots spooled"),
        "checkpoints_resumed": ("serve_checkpoints_resumed_total",
                                "batches restored from a checkpoint"),
        "recovered_jobs": ("serve_recovered_jobs_total",
                           "jobs re-admitted by recover()"),
        "exchange_integrity_failures": (
            "serve_exchange_integrity_failures_total",
            "corrupted/out-of-order boundary exchanges detected (and "
            "NOT ingested) by the mesh engines' integrity layer"),
        "stale_exchanges": ("serve_stale_exchanges_total",
                            "boundary exchanges held at last-known-good "
                            "ghosts under a degrade policy"),
        "mesh_resyncs": ("serve_mesh_resyncs_total",
                         "quarantined meshes resynced to ground truth"),
    }

    def __init__(self, *, pool_capacity: int = 8, max_queue_depth: int = 128,
                 max_replicas_per_call: int = 64, pack: bool = True,
                 pad_pow2: bool = True, stream_chunks: int = 8,
                 warm_compile: bool = True, retain_jobs: int = 4096,
                 fault_plan: Optional[FaultPlan] = None,
                 spool_dir: Optional[str] = None,
                 spool_max_bytes: int = 256 * 1024 * 1024,
                 checkpoint_every: Optional[int] = None,
                 max_retries: int = 2, max_bisect_calls: int = 16,
                 retry_backoff_s: float = 0.0,
                 retry_backoff_cap_s: float = 5.0,
                 retry_jitter: float = 0.5,
                 chunk_timeout_s: Optional[float] = None,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None, device=None):
        """``device`` — where engines are built: the current CUDA device
        by default (raising when there is none), or ``"cpu"`` for the
        plain PyTorch versions.

        Fault-tolerance knobs (the rest as before):

        ``fault_plan`` — a :class:`repro_torch.serve.faults.FaultPlan` injected
        at engine-pool builds, between-chunk pump steps, and the cursor's
        per-chunk boundary hook (deterministic chaos for tests/benches).
        ``spool_dir`` — enable chunk-granular checkpointing into this
        directory (content-addressed, size-capped by ``spool_max_bytes``);
        ``checkpoint_every`` is the default sweep interval between
        snapshots (per-job ``JobSpec.checkpoint_every`` overrides; either
        must be set for checkpoints to be taken).  ``max_retries`` bounds
        per-job transient-failure retries (spec override), paced by
        ``retry_backoff_s`` * 2**k with ``retry_jitter`` (0.0 = retry
        immediately — deterministic tests).  ``max_bisect_calls`` bounds
        the extra engine calls poison-batch isolation may spend re-running
        quarantined jobs.  ``chunk_timeout_s`` arms the stuck-chunk
        watchdog (the batch's pool key is marked suspect).  The breaker
        knobs pass through to :class:`EnginePool`.

        ``metrics`` / ``tracer`` — the server's telemetry fabric
        (``repro_torch.obs``); fresh instances are created when omitted, so
        :meth:`metrics_snapshot` / :meth:`render_metrics` always work.
        """
        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        self.pool = EnginePool(pool_capacity,
                               breaker_threshold=breaker_threshold,
                               breaker_cooldown_s=breaker_cooldown_s,
                               metrics=self.metrics)
        self.scheduler = ReplicaPackingScheduler(
            max_replicas_per_call=max_replicas_per_call, pack=pack,
            pad_pow2=pad_pow2, metrics=self.metrics)
        self.max_queue_depth = int(max_queue_depth)
        self.stream_chunks = max(int(stream_chunks), 1)
        self.warm_compile = bool(warm_compile)
        # terminal results are retained for the most recent `retain_jobs`
        # jobs (bounded memory on a long-lived server); older ids 404
        self.retain_jobs = max(int(retain_jobs), 1)
        self._terminal_order: deque = deque()

        self.fault_plan = fault_plan
        self.spool = None if spool_dir is None else \
            CheckpointSpool(spool_dir, max_bytes=spool_max_bytes)
        self.checkpoint_every = None if checkpoint_every is None \
            else max(int(checkpoint_every), 1)
        self.max_retries = max(int(max_retries), 0)
        self.max_bisect_calls = max(int(max_bisect_calls), 0)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_cap_s = float(retry_backoff_cap_s)
        self.retry_jitter = float(retry_jitter)
        self.chunk_timeout_s = None if chunk_timeout_s is None \
            else float(chunk_timeout_s)

        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)  # lock_alias: _lock
        self._pump_lock = threading.Lock()
        self._problems: Dict[str, _Problem] = {}    # guarded_by: _lock
        self._jobs: Dict[str, Job] = {}             # guarded_by: _lock
        self._queue: List[Job] = []                 # guarded_by: _lock
        self._batches: List[Batch] = []             # guarded_by: _lock
        self._current: Optional[Batch] = None       # guarded_by: _lock
        self._next_seq = 0                          # guarded_by: _lock
        self._group_seq = 0                         # guarded_by: _lock
        self._bisect_left = self.max_bisect_calls   # guarded_by: _lock
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        # register-time bit-plane prewarm threads (join to block on warmth)
        self.prewarm_threads: List[threading.Thread] = []
        # lifecycle + fault-tolerance counters: registry families keyed
        # by their legacy attribute names (stats() and `srv.<name>` read
        # through them)
        self._counter_fams = {
            attr: self.metrics.counter(name, help)
            for attr, (name, help) in self._COUNTERS.items()}
        # latency/goodput distributions and instantaneous gauges
        self._h_queue_wait = self.metrics.histogram(
            "serve_queue_wait_seconds", "submit -> first batch start")
        self._h_pump = self.metrics.histogram(
            "serve_pump_chunk_seconds", "one cursor chunk in the pump")
        self._h_job_total = self.metrics.histogram(
            "serve_job_total_seconds", "submit -> DONE wall time")
        self._h_goodput = self.metrics.histogram(
            "serve_job_flips_per_s", "per-DONE-job device flip rate",
            buckets=tuple(10.0 ** e for e in range(3, 13)))
        self._g_queue = self.metrics.gauge(
            "serve_queue_depth", "jobs waiting for a batch")
        self._g_inflight = self.metrics.gauge(
            "serve_inflight_batches", "batches started and unfinished")
        self._g_flips = self.metrics.gauge(
            "engine_flips_per_s", "last observed per-engine-path flip rate")

    def _count(self, attr: str, n: int = 1) -> None:
        """Bump a lifecycle counter (a registry family; see _COUNTERS)."""
        self._counter_fams[attr].inc(n)

    def __getattr__(self, name: str):
        # legacy counter attributes (srv.failed, srv.retries, ...) read
        # the registry; only consulted when normal lookup misses
        fams = self.__dict__.get("_counter_fams")
        if fams is not None and name in fams:
            return int(fams[name].value)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    # -- problems --------------------------------------------------------------

    def register_problem(self, name: str, *, graph=None, coloring=None,
                         L: Optional[int] = None, seed: int = 0,
                         prewarm_bitplane: bool = False,
                         prewarm_words: int = 1,
                         **engine_kw) -> str:
        """Register a problem instance under ``name``; returns its content
        fingerprint (the packing/pool identity).

        ``prewarm_bitplane=True`` builds and warms the bit-plane engine of
        ``prewarm_words`` stacked word planes (the
        W = prewarm_words, R = 32*W bucket) on a daemon thread at register
        time: the scheduler clamps executed widths up to a word multiple,
        so every bit-plane pack composition totalling at most ``32 *
        prewarm_words`` chains buckets to that single key and sees zero
        cold starts (e.g. ``prewarm_words=2`` prewarms the W=2 engine that
        R=33 and R=64 submissions share).
        Lattice-registered problems prewarm the lattice engine;
        graph-registered problems the mesh engine (which must be buildable
        on this host's device count — pass K/labels in ``engine_kw`` as
        needed).  The prewarm thread is appended to
        :attr:`prewarm_threads` (join it to block on warmth).
        """
        if (graph is None) == (L is None):
            raise ValueError("register exactly one of graph= or L=")
        words = int(prewarm_words)
        if not 1 <= words <= MAX_LANE_WORDS:
            raise ValueError(f"prewarm_words must be in "
                             f"[1, {MAX_LANE_WORDS}], got {prewarm_words}")
        p = _Problem(name, graph, coloring, L, seed, engine_kw)
        with self._lock:
            self._problems[name] = p
        if prewarm_bitplane:
            engine = "lattice" if L is not None else "dsim_dist"
            self.prewarm_threads.append(
                self.prewarm(name, engine=engine,
                             replicas=LANE_WIDTH * words,
                             precision="bitplane"))
        return p.fingerprint

    # -- submission ------------------------------------------------------------

    def submit(self, problem: str, *, engine: str = "gibbs",
               sweeps: int = 1024, replicas: int = 1, seed: int = 0,
               precision: str = "f32", sync_every=1,
               record_points: Optional[Sequence[int]] = None,
               priority: int = 0, schedule=None,
               max_retries: Optional[int] = None,
               deadline_s: Optional[float] = None,
               checkpoint_every: Optional[int] = None,
               degrade_policy: Optional[str] = None) -> str:
        """Admit one annealing job; returns its job id (non-blocking).

        ``max_retries`` / ``deadline_s`` / ``checkpoint_every`` override
        the server-level fault-tolerance defaults for this job alone
        (deadline is wall time from submission, enforced between chunks).

        ``degrade_policy`` arms the mesh engines' boundary-integrity
        layer: ``"fail_fast"`` | ``"stale_hold[:N]"`` |
        ``"freeze_boundary"`` (see :class:`repro_torch.core.degrade
        .DegradePolicy`).  Mesh engines (dsim_dist / lattice) only, and
        the job's ``sync_every`` must be an integer (one checked
        exchange per S sweeps).  The health monitor's end-of-run report
        lands in the job's ``degrade`` result field.
        """
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
        if max_retries is not None and max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if checkpoint_every is not None and checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}")
        with self._lock:
            if problem not in self._problems:
                raise ValueError(f"unknown problem {problem!r}")
            prob = self._problems[problem]
        if engine == "lattice" and prob.L is None:
            raise ValueError("lattice engine needs an L=-registered problem")
        if engine != "lattice" and prob.graph is None:
            raise ValueError(f"{engine!r} engine needs a graph-registered "
                             "problem")
        # same guard the registry applies, surfaced at admission so an
        # unsupported (engine, precision) pair is a clear submit error,
        # not a failed job (let alone a downstream shape error)
        check_precision(engine, precision)
        if degrade_policy is not None:
            DegradePolicy.parse(degrade_policy)   # vocabulary check
            if engine not in ("dsim_dist", "lattice"):
                raise ValueError(
                    "degrade_policy applies to the mesh engines "
                    f"(dsim_dist, lattice), not {engine!r}")
            if sync_every in ("phase", None):
                raise ValueError(
                    "degrade_policy needs an integer sync_every (one "
                    f"checked exchange per S sweeps), got {sync_every!r}")
        r_cap = self.scheduler.replica_budget(precision)
        if replicas < 1 or replicas > r_cap:
            raise ValueError(
                f"replicas must be in [1, {r_cap}]"
                + (" (bit-plane jobs pack into the 32 lanes of each of up "
                   f"to {MAX_LANE_WORDS} stacked uint32 word planes, "
                   "bounded by the per-call budget)"
                   if lanes_of(precision) > 1 else ""))
        if sync_every not in ("phase", None) and int(sync_every) < 1:
            raise ValueError(f"sync_every must be >= 1, 'phase', or None; "
                             f"got {sync_every!r}")
        sched = schedule if schedule is not None else ea_schedule(int(sweeps))
        sweeps = int(sched.total_sweeps)
        if sync_every not in ("phase", None) and int(sync_every) > sweeps:
            raise ValueError(
                f"sync_every={sync_every} exceeds the {sweeps}-sweep "
                "schedule (no record point is reachable)")
        if record_points is not None:
            record_points = tuple(int(p) for p in record_points)
            if any(p > sweeps for p in record_points):
                raise ValueError("record point beyond the schedule")
        spec = JobSpec(problem=problem, engine=engine, sweeps=sweeps,
                       replicas=int(replicas), seed=int(seed),
                       precision=precision, sync_every=sync_every,
                       record_points=record_points, priority=int(priority),
                       schedule=schedule, max_retries=max_retries,
                       deadline_s=deadline_s,
                       checkpoint_every=checkpoint_every,
                       degrade_policy=degrade_policy)
        with self._lock:
            if len(self._queue) >= self.max_queue_depth:
                self._count("rejected")
                raise QueueFull(
                    f"queue depth {len(self._queue)} at limit "
                    f"{self.max_queue_depth}")
            seq = self._next_seq
            self._next_seq += 1
            job = Job(f"job-{seq:06d}", seq, spec, prob.fingerprint, sched,
                      schedule_fingerprint(sched), time.perf_counter())
            self._jobs[job.id] = job
            self._queue.append(job)
            self._count("submitted")
            self._cv.notify_all()
        return job.id

    # -- queries ---------------------------------------------------------------

    def _job(self, job_id: str) -> Job:  # lock_held: _lock
        try:
            return self._jobs[job_id]
        except KeyError:
            raise KeyError(f"unknown job {job_id!r}") from None

    def poll(self, job_id: str) -> dict:
        """Snapshot of a job (streams partial results while RUNNING)."""
        with self._lock:
            return self._job(job_id).poll_snapshot()

    def result(self, job_id: str, timeout: Optional[float] = None,
               cancel_on_timeout: bool = False) -> dict:
        """Final payload; drives the server inline when no background
        thread is running, else blocks.  ``timeout`` bounds the wait
        either way (inline pumping checks the deadline between chunks).
        If the serving thread is stopped mid-wait, the caller takes over
        pumping instead of hanging.

        On timeout a :class:`TimeoutError` is raised.  By default the job
        itself is untouched — it stays QUEUED/RUNNING and keeps consuming
        device time, and a later ``result`` call can still collect it.
        ``cancel_on_timeout=True`` additionally cancels the job before
        raising (queued jobs stop immediately, running jobs at the next
        chunk boundary), so an abandoned wait does not strand work."""
        deadline = None if timeout is None else time.perf_counter() + timeout

        def _timed_out():
            if cancel_on_timeout:
                self.cancel(job_id)
            return TimeoutError(f"{job_id} not finished in {timeout}s")

        with self._lock:
            job = self._job(job_id)
            threaded = self._thread is not None
        if threaded:
            with self._cv:
                ok = self._cv.wait_for(
                    lambda: job.status.terminal or self._thread is None,
                    timeout=timeout)
            if not ok:
                raise _timed_out()
        while not job.status.terminal:
            if deadline is not None and time.perf_counter() > deadline:
                raise _timed_out()
            if not self.pump():
                with self._lock:     # a concurrent pumper may have just
                    if job.status.terminal:      # finished it
                        break
                raise RuntimeError(
                    f"{job_id} is {job.status.value} but the server has "
                    "no runnable work")
        with self._lock:
            return job.result_payload()

    def cancel(self, job_id: str) -> bool:
        """Cancel a job; queued jobs stop immediately, running jobs at the
        next chunk boundary (partial results are kept).  False if the job
        already reached a terminal state."""
        with self._lock:
            job = self._job(job_id)
            if job.status.terminal:
                return False
            job.cancel_requested = True
            if job.status is JobStatus.QUEUED and job in self._queue:
                self._queue.remove(job)
                self._finalize(job, JobStatus.CANCELLED)
            return True

    # -- the serving loop ------------------------------------------------------

    def pump(self) -> bool:
        """One scheduling step: pick the best batch (forming it from the
        queue if the queue outranks every started batch) and advance it by
        one bounded chunk.  Returns False when there is nothing to run.

        When every queued job is parked behind a retry-backoff gate, the
        step waits briefly (bounded, outside all locks) and returns True —
        work still exists, it just isn't eligible yet, so ``drain`` keeps
        driving instead of bailing out early."""
        with self._pump_lock:
            with self._lock:
                batch = self._choose_batch()
                if batch is None and self._queue:
                    # all queued jobs are backing off: wait out (a slice
                    # of) the soonest gate, then report runnable work
                    wait = min(j.next_eligible_at for j in self._queue) \
                        - time.perf_counter()
                    backoff_wait = min(max(wait, 0.0), 0.02)
                else:
                    backoff_wait = None
            if backoff_wait is not None:
                if backoff_wait > 0:
                    time.sleep(backoff_wait)
                return True
            if batch is None:
                return False
            try:
                if not batch.started:
                    self._start_batch(batch)
                self._advance_batch(batch)
            except Exception as e:        # noqa: BLE001 — isolate tenants
                self._handle_batch_failure(batch, e)
            return True

    def drain(self):
        """Run until every admitted job is terminal."""
        while self.pump():
            pass
        return self

    def start(self):
        """Serve on a background daemon thread (submit stays non-blocking)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop = False
            self._thread = threading.Thread(target=self._serve_loop,
                                            daemon=True,
                                            name="sample-server")
        self._thread.start()
        return self

    def stop(self):
        with self._lock:
            self._stop = True
            self._cv.notify_all()
            t, self._thread = self._thread, None
        if t is not None:
            t.join()
        return self

    def _serve_loop(self):
        while True:
            with self._lock:
                if self._stop:
                    return
            if not self.pump():
                with self._cv:
                    if self._stop:
                        return
                    self._cv.wait(timeout=0.02)

    # -- internals -------------------------------------------------------------

    @staticmethod
    def _rank(b: Batch):
        return (b.priority, -b.seq)

    def _expired(self, job: Job, now: float) -> bool:
        return (job.spec.deadline_s is not None
                and now - job.submitted_at > job.spec.deadline_s)

    def _expire_queued_deadlines(self, now: float):  # lock_held: _lock
        """Under the lock: fail queued jobs whose wall budget ran out
        while waiting (running jobs are checked between chunks)."""
        for j in [j for j in self._queue if self._expired(j, now)]:
            self._queue.remove(j)
            self._fail_deadline(j)

    def _fail_deadline(self, job: Job):  # lock_held: _lock
        """Under the lock: fail one job with a DeadlineExceeded error."""
        job.error = (f"DeadlineExceeded: {job.spec.deadline_s}s wall "
                     f"budget exhausted at {job.sweeps_done}/"
                     f"{job.total_sweeps} sweeps")
        self._count("deadline_failures")
        self._finalize(job, JobStatus.FAILED)

    def _drop_spooled(self, batch: Batch):
        """Forget the batch's spooled checkpoint (it reached a terminal
        state; the record would otherwise be re-admitted by recover())."""
        if batch.ck_digest is not None and self.spool is not None:
            self.spool.remove(batch.ck_digest)
        batch.ck_digest = None

    def _ck_every(self, batch: Batch) -> Optional[int]:
        """Effective checkpoint interval for a batch: the tightest of the
        tenants' ``spec.checkpoint_every`` (falling back to the server
        default per tenant); None disables checkpointing."""
        vals = [j.spec.checkpoint_every if j.spec.checkpoint_every
                is not None else self.checkpoint_every for j in batch.jobs]
        vals = [v for v in vals if v is not None]
        return min(vals) if vals else None

    def _choose_batch(self) -> Optional[Batch]:  # lock_held: _lock
        """Under the lock: highest-(priority, FIFO) among started batches
        and the would-be batch led by the best *eligible* queued job
        (jobs inside a retry-backoff window are invisible this step)."""
        now = time.perf_counter()
        self._expire_queued_deadlines(now)
        eligible = [j for j in self._queue if j.next_eligible_at <= now]
        best_started = max(self._batches, key=self._rank, default=None)
        lead = max(eligible,
                   key=lambda j: (j.spec.priority, -j.seq), default=None)
        batch = best_started
        if lead is not None and (
                best_started is None or
                (lead.spec.priority, -lead.seq) > self._rank(best_started)):
            batch = self.scheduler.next_batch(eligible)
            for j in batch.jobs:
                self._queue.remove(j)
            self._batches.append(batch)
        if batch is None:
            return None
        if (self._current is not None and self._current is not batch
                and self._current in self._batches
                and batch.priority > self._current.priority):
            self._count("preemptions")  # higher-priority work parked a batch
        self._current = batch
        return batch

    def _engine_key_builder(self, prob: _Problem, spec: JobSpec, r_exec: int):
        # a degrade policy builds a *different* engine (the checked
        # exchange with the health carry), so it is part of the pool
        # identity — a degraded job never reuses (or poisons) the clean
        # engine of its policy-free twin
        key = (prob.fingerprint, spec.engine, spec.precision, r_exec,
               str(spec.degrade_policy), _hashable_kw(prob.engine_kw))

        def builder():
            if self.fault_plan is not None:
                # raised inside the builder so the pool's breaker and
                # failed_builds accounting see injected build faults
                # exactly like real compile failures
                self.fault_plan.apply("build", key=key)
            kw = dict(prob.engine_kw)
            kw.setdefault("device", self.device)
            if spec.degrade_policy is not None:
                kw["degrade"] = spec.degrade_policy
            if spec.engine == "lattice":
                return make_engine("lattice", L=prob.L, seed=prob.seed,
                                   replicas=r_exec,
                                   precision=spec.precision, **kw)
            kw.setdefault("coloring", prob.coloring)
            if spec.engine in ("dsim", "dsim_dist"):
                return make_engine(spec.engine, prob.graph, replicas=r_exec,
                                   precision=spec.precision, **kw)
            # gibbs (f32-only, enforced at submit)
            return make_engine(spec.engine, prob.graph, replicas=r_exec,
                               **kw)

        return key, builder

    def _stream_points(self, sweeps: int) -> set:
        """Stream points bound chunk sizes, so polls see fresh data and
        preemption is never more than one stream interval away."""
        every = max(sweeps // self.stream_chunks, 1)
        return set(range(every, sweeps + 1, every)) | {sweeps}

    def _record_points(self, spec_points, sweeps: int) -> List[int]:
        """Union of tenant-requested points and stream points."""
        pts = self._stream_points(sweeps)
        for p in spec_points:
            pts |= set(p if p is not None else (sweeps,))
        return sorted(pts)

    def _start_batch(self, batch: Batch):
        lead = batch.jobs[0].spec
        # registry read under the lock — register_problem can run
        # concurrently with the pump (the rest of batch start-up touches
        # only the batch, which no other thread owns yet)
        with self._lock:
            prob = self._problems[lead.problem]
        key, builder = self._engine_key_builder(prob, lead, batch.r_exec)
        batch.pool_key = key
        handle, hit = self.pool.get(key, builder)
        if handle.supports_packing:
            seeds: List[int] = []
            for j in batch.jobs:
                seeds += spawn_seeds(j.spec.seed, j.spec.replicas)
            pad = batch.r_exec - len(seeds)
            if pad:
                seeds += spawn_seeds(_FILLER_SEED + batch.seq, pad)
            state = handle.init_state_packed(seeds)
        else:
            state = handle.init_state(seed=lead.seed)
        sweeps = batch.jobs[0].total_sweeps
        eng = getattr(handle, "eng", None)
        if lead.degrade_policy is not None \
                and getattr(eng, "health", None) is not None:
            # engine-boundary fault site: turn the plan's
            # exchange_corrupt/exchange_drop rules into one code per
            # checked exchange and arm them on the engine — injection
            # happens on the device-side wire, upstream of the
            # integrity layer, not in the cursor hook
            codes = None if self.fault_plan is None else \
                self.fault_plan.exchange_codes(
                    max(sweeps // int(lead.sync_every), 1))
            eng.set_exchange_faults(codes)
        pts = self._record_points([j.spec.record_points for j in batch.jobs],
                                  sweeps)
        cursor = handle.start_recorded(state, batch.jobs[0].schedule, pts,
                                       sync_every=lead.sync_every)
        # a tenant's trace must not depend on its batch-mates: each job
        # harvests only its own requested points plus the shared stream
        # points, quantized with the quantum the cursor ACTUALLY applied
        # (cursor.S — gibbs has no boundaries and records at S=1 whatever
        # sync_every says)
        stream = self._stream_points(sweeps)
        batch.own_points = {
            j.id: set(quantize_record_points(
                sorted(stream | set(j.spec.record_points or ())), cursor.S,
                limit=sweeps))
            for j in batch.jobs}
        if self.fault_plan is not None:
            # boundary-exchange fault site: the hook fires inside
            # RecordedCursor.advance at the top of every plan chunk, with
            # the raw cursor (state is a plain attribute there, so
            # "corrupt" rules can scramble it in place)
            plan = self.fault_plan
            ids = tuple(j.id for j in batch.jobs) \
                + tuple(j.spec.seed for j in batch.jobs)

            def _exchange_hook(c):
                plan.apply("exchange", cursor=c, index=c._i, jobs=ids,
                           key=key)
            cursor.fault_hook = _exchange_hook
        if self.warm_compile and not hit:
            # cold handle: first launches land before the timed region (a
            # pool hit is already warm — re-warming would re-execute every
            # distinct chunk length for nothing).  warm() leaves the state
            # and a degraded engine's health monitor as they were, so
            # warming before a checkpoint restore is safe.
            t0 = time.perf_counter()
            cursor.warm()
            batch.warm_s = time.perf_counter() - t0
        self._try_resume(batch, cursor)
        batch.handle, batch.cursor, batch.pool_hit = handle, cursor, hit
        batch.started_at = time.perf_counter()
        with self._lock:
            self._count("engine_calls")
            for j in batch.jobs:
                if j.status.terminal:
                    continue   # recovered batches can carry finished slots
                j.attempts += 1
                j.status = JobStatus.RUNNING
                if j.started_at is None:   # retries keep first-start time
                    j.started_at = batch.started_at
                    self._h_queue_wait.labels(engine=lead.engine).observe(
                        batch.started_at - j.submitted_at)
                j.packed_with = len(batch.jobs) - 1
                j.pool_hit = hit

    def _try_resume(self, batch: Batch, cursor) -> bool:
        """Restore the batch's cursor (and the tenants' partial traces)
        from a checkpoint record when one is attached and its layout —
        job ids, replica slices, executed width — matches this batch
        exactly.  Any mismatch falls back to a from-scratch run (partials
        reset); the per-job seeding then still reproduces the no-fault
        trajectory bitwise."""
        ck = batch.resume_ck
        if ck is None and len(batch.jobs) == 1 \
                and batch.jobs[0].resume_ck is not None:
            ck = batch.jobs[0].resume_ck
            batch.ck_digest = batch.jobs[0].resume_ck_digest
        if ck is None:
            return False
        lay = ck["layout"]
        matches = (list(lay["job_ids"]) == [j.id for j in batch.jobs]
                   and [tuple(s) for s in lay["slices"]]
                   == [tuple(s) for s in batch.slices]
                   and int(lay["r_exec"]) == int(batch.r_exec))
        restored = False
        if matches:
            try:
                cursor.restore_checkpoint(ck["cursor"])
                restored = True
            except ValueError:
                restored = False
        with self._lock:
            for j, part in zip(batch.jobs, ck["jobs"]):
                if j.status.terminal:
                    continue
                j.resume_ck = None
                j.resume_ck_digest = None
                if not restored:
                    j.reset_partials()
                    continue
                p = part["partials"]
                j.times = [int(t) for t in p["times"]]
                j.energy_rows = [np.asarray(r).copy()
                                 for r in p["energy_rows"]]
                j.best_energy = float(p["best_energy"])
                j.best_replica = int(p["best_replica"])
                j.best_spins = None if p["best_spins"] is None \
                    else np.asarray(p["best_spins"]).copy()
                j.flips = int(p["flips"])
                j.sweeps_done = int(p["sweeps_done"])
                j.device_s = float(p["device_s"])
                j.resumed_sweeps += int(p["sweeps_done"])
            if restored:
                batch.ck = ck
                batch.ck_token = tuple(ck["token"])
                batch.points_seen = cursor.points_recorded
                batch.last_ck_sweep = int(cursor.sweeps_done)
                self._count("checkpoints_resumed")
            else:
                batch.ck = None
                if batch.ck_digest is not None and self.spool is not None:
                    self.spool.remove(batch.ck_digest)
                batch.ck_digest = None
        batch.resume_ck = None
        return restored

    def _harvest_degrade(self, batch: Batch):  # lock_held: _lock
        """Under the lock, at batch retirement: copy the mesh health
        monitor's report into every degraded tenant's ``degrade`` result
        field and roll its totals into the server counter families."""
        eng = getattr(getattr(batch, "handle", None), "eng", None)
        health = getattr(eng, "health", None)
        if health is None or batch.degrade_harvested:
            return
        batch.degrade_harvested = True
        rep = health.report()
        for j in batch.jobs:
            if j.spec.degrade_policy is not None:
                j.degrade = dict(rep)
        self._count("exchange_integrity_failures", int(rep["detections"]))
        self._count("stale_exchanges", int(rep["stale_exchanges"]))
        self._count("mesh_resyncs", int(rep["resyncs"]))

    def _advance_batch(self, batch: Batch):
        cur = batch.cursor
        chunk_idx = batch.chunks_done
        lead_engine = batch.jobs[0].spec.engine
        t0 = time.perf_counter()
        with self.tracer.span("pump.chunk", batch=batch.seq,
                              chunk=chunk_idx, engine=lead_engine,
                              jobs=len(batch.jobs)):
            if self.fault_plan is not None:
                # "chunk" fault site; "hang" rules sleep inside the timed
                # window so the stuck-chunk watchdog below sees them
                self.fault_plan.apply(
                    "chunk", cursor=cur, index=chunk_idx,
                    jobs=tuple(j.id for j in batch.jobs)
                    + tuple(j.spec.seed for j in batch.jobs),
                    key=batch.pool_key)
            cur.advance(1)
        dt = time.perf_counter() - t0
        batch.device_s += dt
        batch.chunks_done += 1
        self._h_pump.labels(engine=lead_engine).observe(dt)
        if self.chunk_timeout_s is not None and dt > self.chunk_timeout_s:
            # watchdog: the chunk stalled far past budget — flag this
            # key's executable for operators (sticky in pool.stats())
            self.pool.mark_suspect(
                batch.pool_key,
                f"chunk {chunk_idx} took {dt:.3f}s "
                f"(chunk_timeout_s={self.chunk_timeout_s})")
            with self._lock:
                self._count("stuck_chunks")
        now = time.perf_counter()
        if cur.points_recorded == batch.points_seen and not cur.done:
            # mid-gap chunk (max_chunk split): nothing recorded, so skip
            # the flip-settling host sync and trace restack — just keep
            # progress/cancellation/deadlines current
            with self._lock:
                alive = False
                for j, (a, b) in zip(batch.jobs, batch.slices):
                    if j.status is not JobStatus.RUNNING:
                        continue
                    j.sweeps_done = cur.sweeps_done
                    j.device_s = batch.device_s * (b - a) / \
                        max(batch.r_exec, 1)
                    if j.cancel_requested:
                        self._finalize(j, JobStatus.CANCELLED)
                    elif self._expired(j, now):
                        self._fail_deadline(j)
                    else:
                        alive = True
                if not alive:
                    self._harvest_degrade(batch)
                    if batch in self._batches:
                        self._batches.remove(batch)
                    if self._current is batch:
                        self._current = None
                    self._drop_spooled(batch)
            return
        t0 = time.perf_counter()
        rec = cur.record()
        fpr = cur.flips_per_replica()
        batch.device_s += time.perf_counter() - t0
        energies = as_numpy(rec.energies) if len(rec.times) else None
        new = range(batch.points_seen, len(rec.times))
        if energies is not None and len(rec.times) > batch.points_seen \
                and not np.isfinite(energies[batch.points_seen:]).all():
            # integrity guard: garbage state (a corrupting node, an
            # overflowed kernel) shows up as non-finite energies; fail the
            # chunk as transient so the retry path restores the last
            # pre-corruption checkpoint instead of streaming junk
            with self._lock:
                self._count("corrupted_chunks")
            raise StateCorruption(
                f"non-finite energies recorded at chunk {chunk_idx} "
                f"(pool key {batch.pool_key!r}) — sampler state is "
                "corrupt")
        # spins snapshots are only consistent with a row recorded at the
        # cursor's *current* state (chunks end on record points).  The
        # device sync + (R, N) transfer happens OUTSIDE the server lock —
        # job partials are only ever mutated by the (single) pump holder,
        # so the improvement pre-check is race-free — keeping submit/poll
        # latency independent of problem size.
        spins_fresh = (len(rec.times) > 0
                       and int(rec.times[-1]) == cur.sweeps_done)
        spins = None
        if spins_fresh:
            last = len(rec.times) - 1
            improved = any(
                j.status is JobStatus.RUNNING
                and float(energies[last, a:b].min()) < j.best_energy
                for j, (a, b) in zip(batch.jobs, batch.slices))
            if improved:
                spins = as_numpy(batch.handle.global_spins(cur.state))
        with self._lock:
            for i in new:
                t = int(rec.times[i])
                want_spins = (spins is not None and i == len(rec.times) - 1)
                for j, (a, b) in zip(batch.jobs, batch.slices):
                    if j.status is not JobStatus.RUNNING or \
                            t not in batch.own_points[j.id]:
                        continue
                    j.observe(t, energies[i, a:b],
                              spins[a:b] if want_spins else None)
            for j, (a, b) in zip(batch.jobs, batch.slices):
                if j.status is not JobStatus.RUNNING:
                    continue
                j.flips = int(fpr[a:b].sum())
                j.sweeps_done = cur.sweeps_done
                # device time attributed by executed replica share (tenant
                # shares sum to the batch total); flips_per_s is then the
                # machine-level flip rate observed while this job ran
                j.device_s = batch.device_s * (b - a) / max(batch.r_exec, 1)
                if j.cancel_requested:
                    self._finalize(j, JobStatus.CANCELLED)
                elif not cur.done and self._expired(j, now):
                    # between-chunk deadline enforcement: only this
                    # tenant fails; packmates keep their slices and run on
                    self._fail_deadline(j)
            alive = [j for j in batch.jobs
                     if j.status is JobStatus.RUNNING]
            batch.points_seen = len(rec.times)
            if cur.done or not alive:
                self._harvest_degrade(batch)
                for j in alive:
                    self._finalize(j, JobStatus.DONE)
                if batch in self._batches:
                    self._batches.remove(batch)
                if self._current is batch:
                    self._current = None
                self._drop_spooled(batch)
                return
        # chunk-granular checkpointing: once a tenant's checkpoint
        # interval has elapsed, snapshot the cursor + partial traces so
        # retries and post-crash recovery resume from here, not sweep 0
        ck_every = self._ck_every(batch)
        if ck_every is not None \
                and cur.sweeps_done - batch.last_ck_sweep >= ck_every \
                and any(j.status is JobStatus.RUNNING for j in batch.jobs):
            self._write_checkpoint(batch)

    def _write_checkpoint(self, batch: Batch):
        """Snapshot the batch — cursor (device state pulled to host) plus
        every tenant's partial trace and spec — as one picklable record;
        spool it (content-addressed, superseding the batch's previous
        record) when a spool is configured.  The record alone is enough
        to rebuild the jobs in a fresh process (:meth:`recover`)."""
        cur = batch.cursor
        ck_cursor = cur.checkpoint()     # device sync happens outside lock
        with self._lock:
            jobs_part = []
            for j in batch.jobs:
                jobs_part.append({
                    "id": j.id, "seq": j.seq, "spec": j.spec,
                    "schedule": j.schedule, "schedule_fp": j.schedule_fp,
                    "status": j.status.value,
                    "partials": {
                        "times": list(j.times),
                        "energy_rows": [r.copy() for r in j.energy_rows],
                        "best_energy": j.best_energy,
                        "best_replica": j.best_replica,
                        "best_spins": None if j.best_spins is None
                        else j.best_spins.copy(),
                        "flips": j.flips,
                        "sweeps_done": j.sweeps_done,
                        "device_s": j.device_s,
                        "retries": j.retries,
                        "resumed_sweeps": j.resumed_sweeps,
                        "restarted_sweeps": j.restarted_sweeps,
                    }})
            record = {
                "format": 1,
                "token": ("batch",) + tuple(j.id for j in batch.jobs),
                "sweeps_done": int(cur.sweeps_done),
                "problem": batch.jobs[0].spec.problem,
                "problem_fp": batch.jobs[0].problem_fp,
                "jobs": jobs_part,
                "layout": {"job_ids": [j.id for j in batch.jobs],
                           "slices": [tuple(s) for s in batch.slices],
                           "r_exec": int(batch.r_exec)},
                "cursor": ck_cursor,
            }
            batch.ck = record
            batch.ck_token = record["token"]
            batch.last_ck_sweep = int(cur.sweeps_done)
            self._count("checkpoints_written")
        if self.spool is not None:
            batch.ck_digest = self.spool.put(record,
                                             replaces=batch.ck_digest)

    def _handle_batch_failure(self, batch: Batch, err: Exception):
        """Recovery policy for a batch whose start/advance threw.

        Multi-tenant batches are quarantined and *bisected*: the live
        jobs re-run in two halves (pinned to fresh pack groups so the
        scheduler keeps each cohort together), repeatedly isolating the
        poison job, which alone ends FAILED — bounded by
        ``max_bisect_calls`` extra engine calls.  A solo transient
        failure retries under the job's ``max_retries`` with seeded
        exponential backoff, resuming from the batch's checkpoint when
        its layout still matches; anything else fails the job."""
        kind = classify_error(err)
        now = time.perf_counter()
        with self._lock:
            # a degraded mesh that escalated (fail_fast detection,
            # stale_hold budget blown) still reports: harvest before the
            # retry machinery tears the batch down, so the detections
            # that caused this failure are counted and visible
            self._harvest_degrade(batch)
            if batch in self._batches:
                self._batches.remove(batch)
            if self._current is batch:
                self._current = None
            live = [j for j in batch.jobs if not j.status.terminal]
            if not live:
                self._drop_spooled(batch)
                return
            if len(live) > 1:
                # a multi-tenant failure cannot be attributed, whatever
                # its kind — bisect (budget permitting) until the culprit
                # is alone, THEN apply transient/permanent retry policy
                if self._bisect_left >= 2:
                    self._bisect_left -= 2
                    self._count("quarantined_batches")
                    half = (len(live) + 1) // 2
                    for part in (live[:half], live[half:]):
                        group = ("bisect", self._group_seq)
                        self._group_seq += 1
                        for j in part:
                            j.pack_group = group
                            j.bisect_runs += 1
                            j.reset_partials()
                            j.resume_ck = None
                            j.resume_ck_digest = None
                            j.status = JobStatus.QUEUED
                            j.next_eligible_at = now + compute_backoff(
                                j.bisect_runs - 1,
                                base=self.retry_backoff_s,
                                cap=self.retry_backoff_cap_s,
                                jitter=self.retry_jitter,
                                seed=j.spec.seed)
                            self._queue.append(j)
                    self._count("bisect_requeues", len(live))
                    self._drop_spooled(batch)
                    self._cv.notify_all()
                    return
                self._fail_batch(batch, err)
                return
            j = live[0]
            budget = j.spec.max_retries if j.spec.max_retries is not None \
                else self.max_retries
            if kind == "transient" and j.retries < budget:
                j.retries += 1
                self._count("retries")
                if batch.ck is not None:
                    # resume the retry from the last good checkpoint; pin
                    # the job solo so the next batch's layout matches
                    j.resume_ck = batch.ck
                    j.resume_ck_digest = batch.ck_digest
                    batch.ck_digest = None
                else:
                    j.reset_partials()
                j.pack_group = ("retry", self._group_seq)
                self._group_seq += 1
                j.status = JobStatus.QUEUED
                j.next_eligible_at = now + compute_backoff(
                    j.retries - 1, base=self.retry_backoff_s,
                    cap=self.retry_backoff_cap_s,
                    jitter=self.retry_jitter, seed=j.spec.seed)
                self._queue.append(j)
                self._drop_spooled(batch)
                self._cv.notify_all()
                return
            self._fail_batch(batch, err)

    def _fail_batch(self, batch: Batch, err: Exception):
        with self._lock:
            self._harvest_degrade(batch)
            for j in batch.jobs:
                if not j.status.terminal:
                    j.error = f"{type(err).__name__}: {err}"
                    self._finalize(j, JobStatus.FAILED)
            if batch in self._batches:
                self._batches.remove(batch)
            if self._current is batch:
                self._current = None
            self._drop_spooled(batch)

    def _finalize(self, job: Job, status: JobStatus):  # lock_held: _lock
        job.status = status
        job.finished_at = time.perf_counter()
        if job.resume_ck_digest is not None and self.spool is not None:
            # a queued retry that died before running again (deadline,
            # cancel) still owns a spool record — release it
            self.spool.remove(job.resume_ck_digest)
        job.resume_ck = None
        job.resume_ck_digest = None
        if status is JobStatus.DONE:
            self._count("completed")
            eng = job.spec.engine
            self._h_job_total.labels(engine=eng).observe(
                job.finished_at - job.submitted_at)
            if job.device_s > 0 and job.flips:
                rate = job.flips / job.device_s
                self._h_goodput.labels(engine=eng).observe(rate)
                self._g_flips.labels(
                    engine=eng, precision=job.spec.precision).set(rate)
        elif status is JobStatus.FAILED:
            self._count("failed")
        else:
            self._count("cancelled")
        self._terminal_order.append(job.id)
        while len(self._terminal_order) > self.retain_jobs:
            self._jobs.pop(self._terminal_order.popleft(), None)
        self._cv.notify_all()

    # -- crash recovery --------------------------------------------------------

    def recover(self, spool_dir: Optional[str] = None) -> List[str]:
        """Re-admit the in-flight jobs a crashed process left spooled.

        Reads every readable checkpoint record in the spool (``spool_dir``
        overrides the server's own; a server built without a spool adopts
        it), keeps the newest record per batch lineage (max
        ``sweeps_done``), and rebuilds each batch exactly as checkpointed:
        same job ids/specs/partial traces, same replica layout, cursor
        restored on first pump.  The continuation is bitwise-identical to
        the uninterrupted run.  Requires every referenced problem to be
        re-registered first with a *matching* content fingerprint —
        a missing or mismatched problem raises RuntimeError (resuming a
        checkpoint into different couplings would be silent garbage).

        Returns the ids of the re-admitted (non-terminal) jobs; records
        whose tenants all reached terminal states are dropped.  Safe to
        call more than once (already-known job ids are skipped).
        """
        if spool_dir is not None and self.spool is None:
            self.spool = CheckpointSpool(spool_dir)
        spool = self.spool if spool_dir is None \
            else CheckpointSpool(spool_dir)
        if spool is None:
            raise RuntimeError("recover() needs a spool: pass spool_dir= "
                               "or build the server with one")
        best: Dict[tuple, tuple] = {}
        for digest, rec in spool.records():
            tok = tuple(rec.get("token", ()))
            if not tok:
                continue
            prev = best.get(tok)
            if prev is None or int(rec["sweeps_done"]) > prev[0]:
                best[tok] = (int(rec["sweeps_done"]), digest, rec)
        readmitted: List[str] = []
        now = time.perf_counter()
        with self._lock:
            for tok in sorted(best):
                _, digest, rec = best[tok]
                name = rec["problem"]
                prob = self._problems.get(name)
                if prob is None:
                    raise RuntimeError(
                        f"recover: checkpoint {tok!r} references problem "
                        f"{name!r}, which is not registered — re-register "
                        "it before recovering")
                if prob.fingerprint != rec["problem_fp"]:
                    raise RuntimeError(
                        f"recover: problem {name!r} fingerprint "
                        f"{prob.fingerprint} does not match the "
                        f"checkpoint's {rec['problem_fp']} — refusing to "
                        "resume into a different instance")
                if any(part["id"] in self._jobs for part in rec["jobs"]):
                    continue         # this lineage is already re-admitted
                jobs, live = [], []
                for part in rec["jobs"]:
                    j = Job(part["id"], int(part["seq"]), part["spec"],
                            rec["problem_fp"], part["schedule"],
                            part["schedule_fp"], now)
                    p = part["partials"]
                    j.times = [int(t) for t in p["times"]]
                    j.energy_rows = [np.asarray(r).copy()
                                     for r in p["energy_rows"]]
                    j.best_energy = float(p["best_energy"])
                    j.best_replica = int(p["best_replica"])
                    j.best_spins = None if p["best_spins"] is None \
                        else np.asarray(p["best_spins"]).copy()
                    j.flips = int(p["flips"])
                    j.sweeps_done = int(p["sweeps_done"])
                    j.device_s = float(p["device_s"])
                    j.retries = int(p["retries"])
                    j.resumed_sweeps = int(p["resumed_sweeps"])
                    j.restarted_sweeps = int(p["restarted_sweeps"])
                    st = JobStatus(part["status"])
                    self._jobs[j.id] = j
                    self._next_seq = max(self._next_seq, j.seq + 1)
                    jobs.append(j)
                    if st.terminal:
                        # finished before the crash: keep it queryable,
                        # hold its slice in the layout, don't re-run it
                        j.status = st
                        self._terminal_order.append(j.id)
                    else:
                        live.append(j)
                if not live:
                    for j in jobs:
                        self._jobs.pop(j.id, None)
                    spool.remove(digest)
                    continue
                lay = rec["layout"]
                batch = Batch(jobs=jobs, key=jobs[0].pack_key,
                              r_exec=int(lay["r_exec"]),
                              slices=[tuple(s) for s in lay["slices"]],
                              seq=min(j.seq for j in jobs),
                              priority=max(j.spec.priority for j in jobs))
                batch.resume_ck = rec
                batch.ck_digest = digest if spool is self.spool else None
                batch.ck_token = tok
                batch.last_ck_sweep = int(rec["sweeps_done"])
                self._batches.append(batch)
                self._count("submitted", len(live))
                self._count("recovered_jobs", len(live))
                readmitted += [j.id for j in live]
            self._cv.notify_all()
        return readmitted

    # -- warmup / stats --------------------------------------------------------

    def prewarm(self, problem: str, *, engine: str = "gibbs",
                replicas: int = 1, precision: str = "f32", sweeps: int = 1024,
                sync_every=1, schedule=None,
                wait: bool = False) -> threading.Thread:
        """Build and warm the engine a future submit will need, on a daemon
        thread — the cold start (the kernels built and launched once)
        never touches the serving path.
        ``replicas`` is bucketed exactly like the scheduler would."""
        with self._lock:
            prob = self._problems[problem]
        spec = JobSpec(problem=problem, engine=engine, sweeps=int(sweeps),
                       replicas=int(replicas), precision=precision,
                       sync_every=sync_every, schedule=schedule)
        r_exec = self.scheduler.r_exec_for(engine, replicas, precision)
        key, builder = self._engine_key_builder(prob, spec, r_exec)
        sched = schedule if schedule is not None else ea_schedule(int(sweeps))
        pts = self._record_points([None], int(sched.total_sweeps))

        def warm(handle):
            st = handle.init_state(seed=0)
            handle.start_recorded(st, sched, pts,
                                  sync_every=sync_every).warm()

        t = self.pool.prewarm_async(key, builder, warm)
        if wait:
            t.join()
            if t.error is not None:  # surface what a fire-and-forget hides
                raise t.error
        return t

    def _refresh_gauges(self) -> None:  # lock_held: _lock
        """Under the lock: push instantaneous state into the gauges so a
        snapshot/exposition read is current."""
        self._g_queue.set(len(self._queue))
        self._g_inflight.set(len(self._batches))

    def stats(self) -> dict:
        """Consistent, deep-copied snapshot — counters are the registry's
        view, nested component dicts are taken under each component's own
        lock and copied, so mutating the result can never corrupt server
        state (and the server never mutates the caller's copy)."""
        # component snapshots first (each under its owner's lock; their
        # counters only mutate under self._lock, so ordering is benign)
        pool = self.pool.stats()
        scheduler = self.scheduler.stats()
        spool = None if self.spool is None else self.spool.stats()
        # FaultPlan.fired takes the plan's own lock (no torn reads while
        # a pump thread is appending events)
        fired = 0 if self.fault_plan is None else self.fault_plan.fired
        with self._lock:
            self._refresh_gauges()
            out = {attr: int(fam.value)
                   for attr, fam in self._counter_fams.items()}
            out.update(
                queue_depth=len(self._queue),
                inflight_batches=len(self._batches),
                bisect_calls_left=self._bisect_left,
                faults_injected=fired,
                spool=spool, pool=pool, scheduler=scheduler)
        return copy.deepcopy(out)

    def metrics_snapshot(self) -> dict:
        """JSON-able dump of every metric family (see obs.MetricsRegistry)."""
        with self._lock:
            self._refresh_gauges()
        return self.metrics.snapshot()

    def render_metrics(self) -> str:
        """Prometheus text exposition of the server's registry."""
        with self._lock:
            self._refresh_gauges()
        return self.metrics.render_text()
