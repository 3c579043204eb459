"""Serving layer; port of ``repro.serve``'s sampling half.

- :class:`SampleServer` (server.py) — async job queue with priorities and
  admission control, replica-packing scheduler, LRU engine pool, and
  streaming per-chunk results, on the card unless ``device="cpu"``.
- :class:`SampleService` (sample_service.py) — the synchronous one-call
  facade.
- faults.py / spool.py — the deterministic fault-injection harness, the
  serving failure taxonomy, and the checkpoint spool behind
  ``SampleServer.recover``.

The reference's LM token steps (``serve_step.py``) are not ported here.
"""

from .faults import (DeadlineExceeded, FaultPlan, FaultRule,
                     InjectedFault, PermanentFault, StateCorruption,
                     TransientFault, classify_error, compute_backoff)
from .jobs import Job, JobSpec, JobStatus
from .pool import CircuitOpen, EnginePool
from .sample_service import SampleService
from .scheduler import Batch, ReplicaPackingScheduler
from .server import QueueFull, SampleServer
from .spool import CheckpointSpool

__all__ = ["SampleServer", "SampleService", "QueueFull", "EnginePool",
           "ReplicaPackingScheduler", "Batch", "Job", "JobSpec",
           "JobStatus", "FaultPlan", "FaultRule", "InjectedFault",
           "TransientFault", "PermanentFault", "StateCorruption",
           "DeadlineExceeded", "CircuitOpen", "CheckpointSpool",
           "classify_error", "compute_backoff"]
