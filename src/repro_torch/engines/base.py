"""Precision table, chunk planning, and the shared recording driver.

Port of ``repro.engines.base``.  The device's flip counters are int32
modular odometers; the driver reads them once per chunk, takes the delta
mod 2**32, and accumulates the exact total in a host Python int.
``chunk_plan(max_chunk=...)`` bounds the per-chunk delta below 2**31 so
the modular delta is unambiguous.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import (Any, Callable, List, Optional, Protocol, Sequence, Union,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.core.packing import LANE_WIDTH, MAX_LANE_WORDS, lane_words
from repro_torch.obs.trace import region

__all__ = ["Engine", "RunRecord", "SyncSpec", "chunk_plan",
           "run_recorded_driver", "RecordedCursor", "spawn_seeds",
           "stack_states", "flips_chunk_cap", "quantize_record_points",
           "PRECISIONS", "ENGINE_PRECISIONS", "lanes_of", "lane_words",
           "check_precision", "check_lanes", "trace_chunk"]

SyncSpec = Union[int, str, None]

# "f32" the floating reference, "int8" the fixed-point pipeline, "bitplane"
# multi-spin coding over the int8 substrate (32 replica lanes per word).
PRECISIONS = ("f32", "int8", "bitplane")
ENGINE_PRECISIONS = {
    "gibbs": ("f32",),
    "dsim": ("f32", "int8"),
    "dsim_dist": ("f32", "int8", "bitplane"),
    "lattice": ("f32", "int8", "bitplane"),
}


def lanes_of(precision: str) -> int:
    """Replica lanes one engine call packs per word (1 off the bitplane
    path)."""
    return LANE_WIDTH if precision == "bitplane" else 1


def check_lanes(precision: str, replicas: int,
                max_words: int = MAX_LANE_WORDS,
                what: str = "replicas") -> int:
    """Validate ``replicas`` (>= 1; <= ``max_words * 32`` on the bitplane
    path) and return the word count W the state carries (1 off bitplane)."""
    r = int(replicas)
    if r < 1:
        raise ValueError(f"{what} must be >= 1, got {r}")
    if precision != "bitplane":
        return 1
    cap = int(max_words) * LANE_WIDTH
    if r > cap:
        raise ValueError(
            f"precision='bitplane' packs {what} into the bit lanes of up "
            f"to {int(max_words)} stacked uint32 word planes; {what} must "
            f"be in [1, {cap}], got {r}")
    return lane_words(r)


def check_precision(engine: str, precision: str):
    """Raise a clear ValueError for an unknown precision or an (engine,
    precision) pair no backend implements."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; choose from "
                         f"{PRECISIONS}")
    ok = ENGINE_PRECISIONS.get(engine, ("f32",))
    if precision not in ok:
        raise ValueError(
            f"precision={precision!r} is not supported on engine "
            f"{engine!r} (supported: {', '.join(ok)})"
            + ("; bit-plane multi-spin coding is a lattice/dsim_dist path"
               if precision == "bitplane" else ""))


@runtime_checkable
class Engine(Protocol):
    """What every sampling handle exposes to callers.  ``replicas`` (R) is
    fixed at construction; traces are per replica."""

    replicas: int
    n_sites: int

    def init_state(self, seed: int = 0) -> Any:
        """Fresh replicated sampler state (R independent RNG streams)."""

    def run_recorded(self, state, schedule, record_points: Sequence[int],
                     sync_every: SyncSpec = 1):
        """Run to each record point; returns (state, RunRecord)."""

    def energy(self, state) -> torch.Tensor:
        """(R,) true global energies of the current configurations."""

    def global_spins(self, state) -> torch.Tensor:
        """(R, N) spins in the original problem's node order."""

    def lower_chunk(self, iters: int = 2, S: int = 4):
        """Run and record one sampling chunk — dry-run/roofline hook (the
        reference lowers it; eager PyTorch has no program to lower)."""


@dataclasses.dataclass
class RunRecord:
    """Recorded trajectory: unpacks like a ``(times, energies)`` pair;
    ``flips`` is the exact host-side total."""

    times: np.ndarray          # (P,) sweep indices of the record points
    energies: torch.Tensor     # (P,) or (P, R) energies at those points
    flips: int = 0             # exact accepted-flip total (Python int)

    def __iter__(self):
        return iter((self.times, self.energies))

    def __len__(self):
        return 2

    def __getitem__(self, i):
        return (self.times, self.energies)[i]


def chunk_plan(points: Sequence[int],
               max_chunk: Optional[int] = None) -> List[int]:
    """Decompose gaps between record points into power-of-two chunks
    (capped at ``max_chunk``, a power of two) whose cumsum passes through
    every point."""
    if max_chunk is not None:
        if max_chunk < 1 or max_chunk & (max_chunk - 1):
            raise ValueError(f"max_chunk must be a power of two, got {max_chunk}")
    plan: List[int] = []
    prev = 0
    for p in points:
        gap = int(p) - prev
        if gap < 0:
            raise ValueError("record points must be nondecreasing")
        while gap > 0:
            c = 1 << (gap.bit_length() - 1)
            if max_chunk is not None:
                c = min(c, max_chunk)
            plan.append(c)
            gap -= c
        prev = int(p)
    return plan


def flips_chunk_cap(flips_per_sweep: int, sweeps_per_iter: int = 1) -> int:
    """Largest power-of-two iteration chunk whose worst-case flip count
    stays below 2**31 (so int32 deltas are exact)."""
    per_iter = max(int(flips_per_sweep), 1) * max(int(sweeps_per_iter), 1)
    cap = max((1 << 30) // per_iter, 1)
    return 1 << (cap.bit_length() - 1)


def quantize_record_points(record_points: Sequence[int], S: int,
                           limit: Optional[int] = None) -> List[int]:
    """Record points snapped to multiples of the exchange period S, clamped
    to the last reachable boundary ``(limit // S) * S`` when given."""
    pts = set(max(S, int(round(p / S)) * S) for p in record_points)
    if limit is not None:
        last = (int(limit) // S) * S
        if last >= S:
            pts = set(min(p, last) for p in pts)
    return sorted(pts)


def _flips_read(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        # a tensor's read to the host: on the card, a wait for it
        with region("repro_torch.sync.flips_read"):
            value = value.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(value)).astype(np.int64) % (1 << 32)


def _sync(state):
    """Wait for the device work that produced ``state`` (the counterpart
    of ``jax.block_until_ready``): a CUDA synchronise of its device."""
    m = getattr(state, "m", None)
    if isinstance(m, torch.Tensor) and m.is_cuda:
        with region("repro_torch.sync.wait"):
            torch.cuda.synchronize(m.device)


def _device_of(state):
    m = getattr(state, "m", None)
    return m.device if isinstance(m, torch.Tensor) else None


class RecordedCursor:
    """The shared recording loop in resumable form.

    Same chunk plan, record-point quantization and exact modular flip
    accounting as :func:`run_recorded_driver`, advanced one bounded chunk
    at a time (:meth:`advance`); driving it to completion is the one-shot
    driver.  ``flips_vec`` keeps the per-counter (per-replica) totals.
    Each chunk runs in a ``repro_torch.driver.chunk`` span and each record
    point's read in a ``repro_torch.driver.record`` span
    (:func:`repro_torch.obs.trace.region`).
    """

    def __init__(self, *, state, schedule, record_points: Sequence[int],
                 chunk_fn: Callable, record_fn: Callable,
                 sync_every: SyncSpec = 1,
                 flips_of: Optional[Callable] = None,
                 flips_per_sweep: Optional[int] = None,
                 warm_scope: Optional[Callable] = None):
        if len(record_points) == 0:
            raise ValueError("record_points must be non-empty")
        S = 1 if sync_every in ("phase", None) else int(sync_every)
        if S < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every!r}")
        betas = np.asarray(schedule.beta_array())
        if max(int(p) for p in record_points) > len(betas):
            raise ValueError("schedule shorter than last record point")
        pts = quantize_record_points(record_points, S, limit=len(betas))
        if len(betas) < pts[-1]:
            raise ValueError("schedule shorter than last record point")
        max_chunk = None
        if flips_per_sweep is not None:
            max_chunk = flips_chunk_cap(flips_per_sweep, S)
        self.state = state
        self.S = S
        self.total_sweeps = pts[-1]
        self._betas = betas
        self._chunk_fn = chunk_fn
        self._record_fn = record_fn
        self._flips_of = flips_of
        self._flips_per_sweep = flips_per_sweep
        self._plan = chunk_plan([p // S for p in pts], max_chunk=max_chunk)
        self._targets = set(pts)
        self._i = 0                  # next chunk index into the plan
        self._pos = 0                # sweeps completed
        self._out: List[Any] = []
        self._times: List[int] = []
        # a context :meth:`warm` runs its chunks in: a degraded mesh
        # engine's health monitor ignores their exchanges there
        self._warm_scope = warm_scope
        # optional per-chunk boundary hook `(cursor) -> None`, called at
        # the top of every plan chunk (the serving layer's FaultPlan
        # raises, hangs or corrupts the state here)
        self.fault_hook: Optional[Callable] = None
        # optional per-chunk timer `(sweeps, seconds) -> None`; when set,
        # each chunk is bracketed by a device synchronise so asynchronous
        # work is attributed to the chunk that launched it
        self.chunk_timer: Optional[Callable] = None
        # the device counter is read lazily: at record points and just
        # before the worst-case flips since the last read could reach 2**31
        self._prev = _flips_read(flips_of(state)) if flips_of is not None \
            else None
        self._pending = 0            # worst-case flips since `_prev` was read
        self.flips_vec = None if self._prev is None else \
            np.zeros(self._prev.shape, np.int64)
        self._flips_total = 0        # exact host total (Python int)

    _LIMIT = 1 << 31

    @property
    def done(self) -> bool:
        return self._i >= len(self._plan)

    @property
    def sweeps_done(self) -> int:
        return self._pos

    @property
    def points_recorded(self) -> int:
        return len(self._times)

    @property
    def flips(self) -> int:
        """Exact flips up to the last counter read (no device sync)."""
        return self._flips_total

    def _read_flips(self):
        cur = _flips_read(self._flips_of(self.state))
        delta = (cur - self._prev) % (1 << 32)
        self.flips_vec += delta
        self._flips_total += int(delta.sum())
        self._prev = cur
        self._pending = 0

    def _chunk_betas(self, start: int, c: int) -> np.ndarray:
        nsw = c * self.S
        # trailing dims (e.g. a per-replica axis) ride along untouched
        return self._betas[start:start + nsw].reshape(
            (c, self.S) + self._betas.shape[1:])

    def advance(self, max_chunks: int = 1) -> int:
        """Run up to ``max_chunks`` plan chunks; returns how many ran."""
        ran = 0
        while ran < max_chunks and not self.done:
            if self.fault_hook is not None:
                self.fault_hook(self)
            c = self._plan[self._i]
            nsw = c * self.S
            worst = nsw * (self._flips_per_sweep or 0)
            if self._flips_of is not None and self._flips_per_sweep and \
                    self._pending + worst >= self._LIMIT:
                self._read_flips()
            bchunk = self._chunk_betas(self._pos, c)
            timed = self.chunk_timer is not None
            if timed:
                _sync(self.state)
                t0 = time.perf_counter()
            with region("repro_torch.driver.chunk"):
                self.state = self._chunk_fn(self.state, bchunk, c, self.S)
            if timed:
                _sync(self.state)
                self.chunk_timer(nsw, time.perf_counter() - t0)
            self._i += 1
            self._pos += nsw
            self._pending += worst
            ran += 1
            if self._flips_of is not None and self._flips_per_sweep is None:
                self._read_flips()   # unknown bound: stay exact per chunk
            if self._pos in self._targets:
                with region("repro_torch.driver.record"):
                    self._out.append(self._record_fn(self.state))
                self._times.append(self._pos)
                if self._flips_of is not None:
                    self._read_flips()
        return ran

    def run_to_completion(self):
        self.advance(max_chunks=len(self._plan))
        if self._flips_of is not None and self._pending:
            self._read_flips()
        return self

    def record(self) -> RunRecord:
        """Exact snapshot of the trajectory recorded so far (energies an
        empty (0,) tensor before the first record point)."""
        if self._flips_of is not None and self._pending:
            self._read_flips()
        obs = torch.stack(self._out) if self._out else torch.zeros((0,))
        return RunRecord(np.asarray(self._times, np.int64), obs,
                         self._flips_total)

    def warm(self):
        """Execute each distinct chunk length once on the initial state,
        discarding the result (chunk functions are pure), and the record
        observable — first-use costs land outside a timed run."""
        seen = set()
        for c in self._plan[self._i:]:
            if c in seen:
                continue
            seen.add(c)
            with (self._warm_scope() if self._warm_scope is not None
                  else contextlib.nullcontext()):
                _sync(self._chunk_fn(self.state, self._chunk_betas(0, c), c,
                                     self.S))
        if not self.done:
            self._record_fn(self.state)
            _sync(self.state)
        return self

    # -- checkpoint / resume ---------------------------------------------------

    _CK_FORMAT = 1

    def checkpoint(self, snapshot_fn: Optional[Callable] = None) -> dict:
        """Picklable host-side checkpoint of the cursor mid-run (pending
        flip window settled first; state via ``snapshot_fn`` or raw)."""
        if self._flips_of is not None and self._pending:
            self._read_flips()
        snap = self.state if snapshot_fn is None else snapshot_fn(self.state)
        return {
            "format": self._CK_FORMAT,
            "S": self.S,
            "total_sweeps": self.total_sweeps,
            "plan_len": len(self._plan),
            "i": self._i,
            "pos": self._pos,
            "times": list(self._times),
            "out": [o.detach().cpu().numpy() for o in self._out],
            "prev": None if self._prev is None else self._prev.copy(),
            "pending": self._pending,
            "flips_vec": None if self.flips_vec is None
            else self.flips_vec.copy(),
            "flips_total": self._flips_total,
            "state": snap,
        }

    def restore_checkpoint(self, ck: dict,
                           restore_fn: Optional[Callable] = None):
        """Resume a fresh cursor (same schedule, record points and sync
        period — validated) from :meth:`checkpoint` output, bitwise."""
        if ck.get("format") != self._CK_FORMAT:
            raise ValueError(f"unknown checkpoint format "
                             f"{ck.get('format')!r}")
        have = (ck["S"], ck["total_sweeps"], ck["plan_len"])
        want = (self.S, self.total_sweeps, len(self._plan))
        if have != want:
            raise ValueError(
                f"checkpoint plan mismatch: checkpoint has (S, sweeps, "
                f"chunks)={have}, cursor has {want}")
        self.state = ck["state"] if restore_fn is None \
            else restore_fn(ck["state"])
        dev = _device_of(self.state)
        self._i = int(ck["i"])
        self._pos = int(ck["pos"])
        self._times = [int(t) for t in ck["times"]]
        self._out = [torch.as_tensor(o, device=dev) for o in ck["out"]]
        self._prev = None if ck["prev"] is None \
            else np.asarray(ck["prev"]).copy()
        self._pending = int(ck["pending"])
        self.flips_vec = None if ck["flips_vec"] is None \
            else np.asarray(ck["flips_vec"]).copy()
        self._flips_total = int(ck["flips_total"])
        return self


def run_recorded_driver(*, state, schedule, record_points: Sequence[int],
                        chunk_fn: Callable,
                        record_fn: Callable,
                        sync_every: SyncSpec = 1,
                        flips_of: Optional[Callable] = None,
                        flips_per_sweep: Optional[int] = None,
                        warm_scope: Optional[Callable] = None):
    """The shared recording loop (a :class:`RecordedCursor` driven to
    completion).  ``chunk_fn(state, betas_2d, iters, S) -> state`` runs
    ``iters`` iterations of ``S`` sweeps (betas_2d is (iters, S, ...));
    ``record_fn(state)`` is read at each record point.  Returns
    (state, RunRecord)."""
    cur = RecordedCursor(
        state=state, schedule=schedule, record_points=record_points,
        chunk_fn=chunk_fn, record_fn=record_fn, sync_every=sync_every,
        flips_of=flips_of, flips_per_sweep=flips_per_sweep,
        warm_scope=warm_scope)
    cur.run_to_completion()
    return cur.state, cur.record()


def trace_chunk(eng, state, iters: int, S: int, *, sync_every: SyncSpec,
                schedule=None, before: Optional[Callable] = None):
    """Run one chunk of ``iters`` iterations of ``S`` sweeps of engine
    ``eng`` from ``state``, then the same chunk again recorded
    (``analyze/ops_trace.trace_call``); returns its ``ChunkTrace`` (the
    recorded chunk's state is its ``out``).  The chunks are the first of
    ``eng.run_recorded_full``'s cursor over ``schedule`` (default
    ``ea_schedule(iters * S)``), which must plan ``iters`` iterations of
    ``S`` sweeps; both run its betas.  ``before(state)`` runs between
    them."""
    from repro_torch.analyze.ops_trace import trace_call
    from repro_torch.core.annealing import ea_schedule
    sweeps = iters * S
    cur = eng.run_recorded_full(
        state, ea_schedule(sweeps) if schedule is None else schedule,
        [sweeps], sync_every=sync_every, cursor=True)
    if cur.S != S or cur._plan[0] != iters:
        raise ValueError(f"the recorded run's first chunk is {cur._plan[0]} "
                         f"iterations of {cur.S} sweeps, not {iters} of {S}")
    betas = cur._chunk_betas(0, iters)
    state = cur._chunk_fn(state, betas, iters, S)
    if before is not None:
        before(state)
    return trace_call(cur._chunk_fn, state, betas, iters, S,
                      device=eng.device)


def spawn_seeds(seed: int, replicas: int) -> List[int]:
    """R independent 31-bit seeds from one master seed (numpy SeedSequence
    spawning: replica r of (seed, R) equals replica r of (seed, R'))."""
    ss = np.random.SeedSequence(seed)
    return [int(child.generate_state(1)[0] & 0x7FFFFFFF)
            for child in ss.spawn(replicas)]


def stack_states(states: Sequence[Any]):
    """Stack per-replica dataclass states along a new leading replica axis
    (every tensor field; the others must agree and are kept)."""
    first = states[0]
    out = {}
    for f in dataclasses.fields(first):
        vals = [getattr(st, f.name) for st in states]
        out[f.name] = torch.stack(vals) if isinstance(vals[0], torch.Tensor) \
            else vals[0]
    return type(first)(**out)
