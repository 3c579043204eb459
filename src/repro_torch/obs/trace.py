"""Lightweight span tracing with an explicit device-sync boundary; port of
``repro.obs.trace``.

``with tracer.span("pump.chunk", job=jid) as sp: ...`` times a named
region on an injectable monotonic clock and appends the finished span to
a bounded in-memory ring (oldest evicted first).  Spans nest per thread
— the parent id is whatever span is open on the current thread — so a
wave's ``serve_wave.drain`` span owns its per-job children without any
global context plumbing.

CUDA launches are asynchronous: a chunk returns before the device
finishes, so a naive ``perf_counter`` pair around ``chunk_fn`` would
attribute device time to whichever *later* span happens to wait.  A span
therefore carries an explicit sync boundary: ``sp.sync(value)`` stashes a
value (a tensor, or a state holding tensors in dataclasses, tuples,
lists or dicts) and the tracer waits for it *before* taking the end
timestamp, ``torch.cuda.synchronize`` on every CUDA device that holds
one of its tensors (tensors on the CPU are ready when returned), so
device work lands in the span that launched it.  The blocker is
injectable.

:func:`region` is the program's one switch for spans on the profiler's
clock.  While a ``torch.profiler`` is recording it opens a named range
(as ``record_function`` does, at a fraction of its cost): a host event on
the clock of the profiler's device events, so every idle gap of the card
can be set against the program's own spans.  Otherwise it returns one
shared null context, which costs a check of the profiler's state.  The
hot path names its layer boundaries with it (``repro_torch.entry.*``,
``repro_torch.driver.*``, ``repro_torch.engine.exchange``,
``repro_torch.wrapper.pbit_bitplane_sweep``), and every point where the
host waits for the card ``repro_torch.sync.<cause>``; none of them
synchronises.  :class:`Tracer` spans stay off the profiler's timeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional

import torch

__all__ = ["Span", "Tracer", "device_sync", "region"]

# Both are torch's private symbols, resolved so that a torch without them
# still imports: one without the check leaves the spans off, one without
# the fast range falls back to ``record_function``.  Neither changes what
# the program computes, only what a traced run shows and costs.
_profiling = getattr(torch._C._autograd, "_profiler_enabled", None) or \
    (lambda: False)
# the profiler's cheapest named range, a C++ context manager: under the
# profiler ``record_function`` costs several times as much a range and
# gives each range a device-side copy besides
_range = getattr(torch._C._profiler, "_RecordFunctionFast", None) or \
    torch.profiler.record_function
_NULL = contextlib.nullcontext()


def region(name: str):
    """A context naming a span ``name`` on the profiler's timeline: a
    profiler range while a profiler records, else the shared null context.
    It never synchronises."""
    if _profiling():
        return _range(name)
    return _NULL


def _cuda_devices(x, out: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    return out


def device_sync(value: Any) -> None:
    """Wait for the CUDA devices that hold tensors of ``value``."""
    for dev in _cuda_devices(value, set()):
        torch.cuda.synchronize(dev)


class Span:
    """One timed region; exposed to the ``with`` body for attrs/sync."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "thread",
                 "t0", "t1", "_sync")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 thread: str, t0: float, attrs: dict):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.thread = thread
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs = attrs
        self._sync: Any = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def sync(self, value: Any) -> Any:
        """Register a value to wait for before the end timestamp."""
        self._sync = value
        return value

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "thread": self.thread,
                "t0": self.t0, "t1": self.t1,
                "duration_s": self.duration_s, "attrs": dict(self.attrs)}


class Tracer:
    """Bounded span recorder with per-thread nesting.

    ``clock`` must be monotonic (default ``time.perf_counter``);
    ``block`` is called with a span's sync payload before the end stamp
    (default: :func:`device_sync`).
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 capacity: int = 4096,
                 block: Callable[[Any], None] = device_sync):
        self._clock = clock
        self._block = block
        self._ring: deque = deque(maxlen=int(capacity))
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._tls = threading.local()

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, sync: Any = None, **attrs):
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        with self._lock:
            sid = next(self._ids)
        sp = Span(name, sid, parent, threading.current_thread().name,
                  self._clock(), attrs)
        if sync is not None:
            sp._sync = sync
        stack.append(sp)
        try:
            yield sp
        finally:
            if sp._sync is not None:
                self._block(sp._sync)
            sp.t1 = self._clock()
            if stack and stack[-1] is sp:
                stack.pop()
            with self._lock:
                self._ring.append(sp)

    # -- readers --------------------------------------------------------------------

    def spans(self, name: Optional[str] = None) -> List[dict]:
        with self._lock:
            out = [s.to_dict() for s in self._ring]
        if name is not None:
            out = [s for s in out if s["name"] == name]
        return out

    def durations(self, name: str) -> List[float]:
        return [s["duration_s"] for s in self.spans(name)
                if s["duration_s"] is not None]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def export_jsonl(self, path: str) -> int:
        """Append every finished span as one JSON line; returns count."""
        rows = self.spans()
        with open(path, "a") as f:
            for r in rows:
                f.write(json.dumps(r, default=str) + "\n")
        return len(rows)
