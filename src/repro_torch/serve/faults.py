"""Deterministic fault injection and the serving failure taxonomy; port of
``repro.serve.faults``.

The paper's machine is a network of 28 FPGAs: any node can stall, drop a
boundary exchange, or hand back garbage, and the million-p-bit sampler
must keep producing valid Gibbs statistics around it.  The serving stack
therefore carries real recovery machinery (retry/backoff, poison-batch
bisection, checkpoint resume, deadlines, a circuit breaker) — and none of
it is trustworthy unless it can be *driven* deterministically.  This
module is that driver:

- **Failure taxonomy** — :class:`TransientFault` / :class:`PermanentFault`
  (injected), :class:`StateCorruption` (re-exported from
  ``core.degrade``: the server's integrity guard or a mesh engine's
  boundary-integrity layer tripped), and :func:`classify_error`, the one
  place that decides transient-vs-permanent for retry policy.  A hand
  kernel that fails to build or launch, and a CUDA error, are permanent:
  a retry would re-raise them, or run on a broken context.
- **:class:`FaultPlan`** — a seeded, replayable list of
  :class:`FaultRule`\\ s that raise, hang, or corrupt at chosen sites:
  ``"build"`` (engine-pool compiles), ``"chunk"`` (between-chunk pump
  steps, matchable by chunk index and job id), and ``"exchange"`` (the
  cursor's per-chunk boundary hook inside ``RecordedCursor.advance``).
  Wired through ``SampleServer(fault_plan=...)``; every recovery path in
  tests is exercised by a plan, never by sleeps-and-hope chaos.
- **Engine-boundary sites** — ``"exchange_corrupt"`` / ``"exchange_drop"``
  rules damage the *wire itself*, inside the chunk on the device, not the
  pump:
  :meth:`FaultPlan.exchange_codes` compiles them into a per-exchange code
  array the mesh engines consume via ``set_exchange_faults`` — the
  degraded-mode integrity layer (``core.degrade``) must detect every one.
- **:func:`compute_backoff`** — pure, seeded exponential backoff with
  jitter, so retry pacing is unit-testable arithmetic.

Determinism contract: rules fire on exact matches (site / index / job /
key); probabilistic rules (``rate < 1``) draw from the plan's own seeded
generator in call order, so two identical runs of the same plan make
identical decisions, and :meth:`FaultPlan.replay` hands back a fresh
plan with the same seed and un-spent rule budgets.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import dataclasses

import numpy as np
import torch

from repro_torch.kernels._build import KernelError

__all__ = ["InjectedFault", "TransientFault", "PermanentFault",
           "StateCorruption", "DeadlineExceeded", "FaultRule", "FaultPlan",
           "classify_error", "compute_backoff", "corrupt_pytree"]


class InjectedFault(RuntimeError):
    """Base class for faults raised by a :class:`FaultPlan`."""


class TransientFault(InjectedFault):
    """Injected fault the retry policy should treat as retryable."""


class PermanentFault(InjectedFault):
    """Injected fault that must fail the job (no retry)."""


# StateCorruption moved to core.degrade (the mesh integrity layer raises it
# inside the engines); re-exported here so serve-layer callers and the
# transient classification below keep one exception identity.
from repro_torch.core.degrade import StateCorruption  # noqa: E402


class DeadlineExceeded(RuntimeError):
    """A job blew its ``deadline_s`` budget (enforced between chunks)."""


# -- transient / permanent classification -------------------------------------

# Exceptions whose cause plausibly goes away on retry: injected transients,
# corrupted state (a checkpoint restore repairs it), infra-ish errors, and
# the pool's fast-fail while a build circuit is cooling down.
_TRANSIENT = (TransientFault, StateCorruption, TimeoutError,
              ConnectionError, InterruptedError)
# Exceptions that are deterministic properties of the request or the code:
# retrying re-raises them identically.
_PERMANENT = (PermanentFault, ValueError, TypeError, KeyError,
              NotImplementedError, AssertionError, AttributeError)


def _is_cuda_error(err: BaseException) -> bool:
    """A CUDA runtime error surfaced by PyTorch (``torch.AcceleratorError``
    where this version has it, else a RuntimeError naming the CUDA
    error), out-of-memory excepted: the context is broken or the launch
    itself is wrong, and a retry does not repair either."""
    acc = getattr(torch, "AcceleratorError", None)
    if acc is not None and isinstance(err, acc):
        return True
    return isinstance(err, RuntimeError) and "CUDA error" in str(err)


def classify_error(err: BaseException) -> str:
    """``"transient"`` or ``"permanent"`` — the retry-policy split.

    Device errors: a hand kernel that failed to build or launch
    (:class:`repro_torch.kernels._build.KernelError`) and a CUDA runtime
    error are permanent (retrying re-raises them, or runs on a broken
    context); device out-of-memory (``torch.cuda.OutOfMemoryError``,
    under co-tenancy) is worth a bounded retry (transient).  Where the
    reference splits jaxlib's ``XlaRuntimeError`` on its status code,
    these are the port's counterparts.

    Unknown exception types classify transient: on a serving tier a
    bounded retry of an unrecognized failure is cheaper than wrongly
    failing a tenant, and ``max_retries`` bounds the waste.  (The pool's
    ``CircuitOpen`` classifies transient via its ``TimeoutError`` base.)
    """
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return "transient"
    if isinstance(err, KernelError) or _is_cuda_error(err):
        return "permanent"
    if isinstance(err, _PERMANENT):
        return "permanent"
    if isinstance(err, _TRANSIENT):
        return "transient"
    return "transient"


def compute_backoff(retries: int, *, base: float = 0.05, cap: float = 5.0,
                    jitter: float = 0.5, seed: int = 0) -> float:
    """Deterministic exponential backoff with seeded jitter.

    Retry k (0-based) waits ``min(cap, base * 2**k) * (1 + jitter * u)``
    with ``u = U[0, 1)`` drawn from a generator seeded by (seed, k) — the
    same (job, attempt) always gets the same delay, but distinct jobs
    decorrelate (no thundering-herd resubmission).  ``base = 0`` disables
    waiting entirely (immediate retry), which tests use for determinism.
    """
    if base <= 0.0:
        return 0.0
    delay = min(float(cap), float(base) * (2.0 ** max(int(retries), 0)))
    if jitter > 0.0:
        u = np.random.default_rng((int(seed) & 0x7FFFFFFF,
                                   max(int(retries), 0))).random()
        delay *= 1.0 + float(jitter) * u
    return delay


def _corrupt(x):
    """One leaf: floats NaN, bools inverted, integers XORed with
    0x55555555 masked to their dtype's positive range (uint32 through
    its int32 view)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))
    if not isinstance(x, torch.Tensor):
        return x
    if x.is_floating_point():
        return torch.full_like(x, float("nan"))
    if x.dtype == torch.bool:
        return ~x
    if x.dtype == torch.uint32:
        return (x.view(torch.int32) ^ 0x55555555).view(torch.uint32)
    info = torch.iinfo(x.dtype)
    return x ^ (0x55555555 & info.max)


def corrupt_pytree(state):
    """Deterministically corrupt every tensor leaf of a state (walked
    through dataclasses, tuples, lists and dicts).

    Float leaves become NaN (the server's integrity guard catches those as
    non-finite energies); integer/bool leaves are bit-scrambled.  Used by
    ``action="corrupt"`` rules to emulate a node handing back garbage."""
    if isinstance(state, (torch.Tensor, np.ndarray)):
        return _corrupt(state)
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return dataclasses.replace(state, **{
            f.name: corrupt_pytree(getattr(state, f.name))
            for f in dataclasses.fields(state)})
    if isinstance(state, (tuple, list)):
        return type(state)(corrupt_pytree(v) for v in state)
    if isinstance(state, dict):
        return {k: corrupt_pytree(v) for k, v in state.items()}
    return state


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One injection rule; all given coordinates must match for it to fire.

    site:   "build" | "chunk" | "exchange" — host-side injection — or the
            engine-boundary sites "exchange_corrupt" | "exchange_drop",
            which damage the wire *inside* the chunk (compiled into
            a code array by :meth:`FaultPlan.exchange_codes`; ``index``
            selects an exact exchange seq, ``rate`` a Bernoulli fraction).
    action: "raise" (default) | "hang" (sleep ``hang_s`` inside the timed
            chunk window — the watchdog's prey) | "corrupt" (scramble the
            cursor state via :func:`corrupt_pytree`).
    kind:   "transient" | "permanent" — which exception a raise throws.
    index:  fire only at this exact chunk/attempt index (None = any).
    after:  fire only at index >= after (None = any).
    job:    fire only when this job id (or seed) is in the batch.
    key:    fire only when ``repr(pool key)`` contains this substring.
    rate:   firing probability when matched (seeded; 1.0 = always).
    times:  total firing budget (None = unlimited; ignored by the
            engine-boundary sites, whose whole schedule is precompiled).
    """

    site: str
    action: str = "raise"
    kind: str = "transient"
    index: Optional[int] = None
    after: Optional[int] = None
    job: Any = None
    key: Any = None
    rate: float = 1.0
    times: Optional[int] = 1
    hang_s: float = 0.05

    ENGINE_SITES = ("exchange_corrupt", "exchange_drop")

    def __post_init__(self):
        if self.site not in ("build", "chunk", "exchange") + \
                self.ENGINE_SITES:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.action not in ("raise", "hang", "corrupt"):
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.kind not in ("transient", "permanent"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """A seeded, replayable sequence of fault injections.

    ``fire`` finds the first matching rule with budget left (consuming one
    firing and, for ``rate < 1`` rules, one draw from the seeded
    generator); ``apply`` additionally *performs* the action.  The plan
    records every firing in :attr:`events` for test assertions, and is
    thread-safe (prewarm threads and the pump share it).
    """

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0):
        self.rules: List[FaultRule] = list(rules)
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._remaining = [r.times for r in self.rules]
        self.events: List[Tuple] = []
        self._lock = threading.Lock()

    def replay(self) -> "FaultPlan":
        """A fresh plan with the same rules, seed, and full budgets —
        re-running an identical workload makes identical decisions."""
        return FaultPlan(self.rules, seed=self.seed)

    def fire(self, site: str, *, index: Optional[int] = None,
             jobs: Sequence[Any] = (), key: Any = None
             ) -> Optional[FaultRule]:
        """The first matching rule (its budget consumed), or None."""
        with self._lock:
            jobs = tuple(jobs)
            for ri, r in enumerate(self.rules):
                if r.site != site:
                    continue
                if r.index is not None and index != r.index:
                    continue
                if r.after is not None and (index is None
                                            or index < r.after):
                    continue
                if r.job is not None and r.job not in jobs:
                    continue
                if r.key is not None and (key is None
                                          or str(r.key) not in repr(key)):
                    continue
                if self._remaining[ri] is not None \
                        and self._remaining[ri] <= 0:
                    continue
                if r.rate < 1.0 and self._rng.random() >= r.rate:
                    continue
                if self._remaining[ri] is not None:
                    self._remaining[ri] -= 1
                self.events.append((site, index, r.action, r.kind))
                return r
        return None

    def apply(self, site: str, cursor=None, *, index: Optional[int] = None,
              jobs: Sequence[Any] = (), key: Any = None
              ) -> Optional[FaultRule]:
        """Fire and perform: raise / hang / corrupt.  Returns the rule
        that fired (for "hang"/"corrupt") or None."""
        r = self.fire(site, index=index, jobs=jobs, key=key)
        if r is None:
            return None
        if r.action == "hang":
            time.sleep(r.hang_s)
            return r
        if r.action == "corrupt":
            if cursor is not None:
                cursor.state = corrupt_pytree(cursor.state)
            return r
        exc = TransientFault if r.kind == "transient" else PermanentFault
        raise exc(f"injected {r.kind} fault at {site}"
                  f"[{'any' if index is None else index}]")

    def exchange_codes(self, total: int) -> Optional[np.ndarray]:
        """Compile the engine-boundary rules into a per-exchange code array.

        Returns ``codes`` (total,) int32 with 0 = deliver, 1 = drop,
        2 = corrupt — indexed by the engine's traced exchange sequence
        number and consumed via ``engine.set_exchange_faults`` — or None
        when the plan has no ``exchange_corrupt``/``exchange_drop`` rules.

        Deterministic by construction: rate-based rules draw a Bernoulli
        mask from a generator seeded by (plan seed, site) — independent of
        host call order and identical on :meth:`replay` — and exact-index
        rules pin single exchanges.  ``times`` budgets don't apply: the
        whole schedule is compiled up front, not fired one event at a
        time.  Corrupt wins where rules overlap (damage beats absence).
        """
        total = int(total)
        codes = np.zeros(total, np.int32)
        hit = False
        for code, site in ((1, "exchange_drop"), (2, "exchange_corrupt")):
            for r in self.rules:
                if r.site != site:
                    continue
                hit = True
                if r.index is not None:
                    if 0 <= int(r.index) < total:
                        codes[int(r.index)] = code
                    continue
                lo = int(r.after) if r.after is not None else 0
                if r.rate >= 1.0:
                    codes[lo:] = code
                else:
                    rng = np.random.default_rng((self.seed & 0x7FFFFFFF,
                                                 code, lo))
                    mask = rng.random(total) < float(r.rate)
                    mask[:lo] = False
                    codes[mask] = code
        return codes if hit else None

    @property
    def fired(self) -> int:
        # under the plan's lock: a reader (server stats) must not see a
        # torn view while a pump thread is appending events
        with self._lock:
            return len(self.events)
