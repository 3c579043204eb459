"""LRU pool of built engine handles, with a build circuit breaker; port of
``repro.serve.pool`` (host code, the same).

An engine's first use is the expensive part: its problem constants, index
maps and LUTs land on the device, and the first launch of the process
builds the hand kernels with ``nvcc`` (``kernels/_build.py``).  The pool
keys handles by (problem fingerprint, engine, precision, packed replica
count, engine-kwargs), so a hot problem never rebuilds: the second
request for the same key is a dict hit and runs warm.

Capacity-bounded LRU: the serving layer multiplexes many problems over one
device, and each cached handle pins its problem constants on the device —
eviction drops the coldest key (a later request simply rebuilds).

Builds are per-key single-flight: a second thread asking for a key that is
mid-build waits for the first build instead of compiling twice, and the
pool lock is *not* held during builds, so an async prewarm never blocks
the serving path on a compile.

Failure machinery (a compile that dies must not take the serving path
down with it):

- **Accounting** — every failed build is counted (``failed_builds``) and
  its stringified error kept (``last_error``, also per key), surfaced in
  :meth:`stats`; a fire-and-forget ``prewarm_async`` failure is therefore
  visible even if nobody joins the thread.
- **Circuit breaker** — ``breaker_threshold`` *consecutive* failed builds
  of one key open that key's circuit: further ``get``\\ s fast-fail with
  :class:`CircuitOpen` (no compile attempt, the serving loop is not
  stalled re-dying) until ``breaker_cooldown_s`` has passed, after which
  one caller is let through to probe (half-open); a successful build
  closes the circuit.  The clock is injectable for deterministic tests.
- **Suspect marking** — the serving watchdog calls :meth:`mark_suspect`
  when a chunk ran absurdly long on some key's executable; sticky until
  :meth:`clear_suspect`, surfaced in :meth:`stats` for operators.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["EnginePool", "CircuitOpen"]


class CircuitOpen(TimeoutError):
    """A key's build circuit is open (too many consecutive build
    failures); the pool fast-fails instead of re-attempting the compile.
    Subclasses TimeoutError so the retry policy classifies it transient —
    the cooldown may clear it."""


class EnginePool:
    """Capacity-bounded LRU cache of engine handles with single-flight
    builds and a per-key build circuit breaker; see the module docstring."""

    def __init__(self, capacity: int = 8, *, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 metrics=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        self.capacity = int(capacity)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self._clock = clock
        self._cache: "OrderedDict[tuple, Any]" = OrderedDict()
        self._building: Dict[tuple, threading.Event] = {}
        # per-key breaker record: consecutive fails, last failure time+error
        self._breaker: Dict[tuple, Dict[str, Any]] = {}
        self._suspect: Dict[tuple, str] = {}
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.failed_builds = 0
        self.fast_fails = 0          # gets rejected by an open circuit
        self.last_error: Optional[str] = None
        # optional obs.MetricsRegistry (the server shares its own): build
        # durations, hit/miss counters, and a live circuit-state gauge
        self._m_hits = self._m_misses = self._m_failed = None
        self._h_build = self._g_open = None
        if metrics is not None:
            self._m_hits = metrics.counter(
                "pool_hits_total", "engine-pool cache hits")
            self._m_misses = metrics.counter(
                "pool_misses_total", "engine-pool cache misses (builds)")
            self._m_failed = metrics.counter(
                "pool_failed_builds_total", "engine builds that raised")
            self._h_build = metrics.histogram(
                "pool_build_seconds", "engine build duration on miss")
            self._g_open = metrics.gauge(
                "pool_open_circuits", "keys with an open build circuit")

    def get(self, key: tuple, builder: Callable[[], Any]) -> Tuple[Any, bool]:
        """Return (handle, was_hit); builds via ``builder()`` on miss.

        ``was_hit`` means the handle was already cached *when asked* — a
        caller that waited on another thread's in-flight build gets False,
        because that handle is freshly built and possibly not yet warmed
        (callers use the flag to decide whether to warm-compile).

        Raises :class:`CircuitOpen` without calling ``builder`` when the
        key has failed ``breaker_threshold`` consecutive builds and the
        cooldown has not elapsed.
        """
        waited = False
        while True:
            with self._lock:
                if key in self._cache:
                    self._cache.move_to_end(key)
                    self.hits += 1
                    if self._m_hits is not None:
                        self._m_hits.inc()
                    return self._cache[key], not waited
                br = self._breaker.get(key)
                if br is not None and br["fails"] >= self.breaker_threshold:
                    remaining = self.breaker_cooldown_s - \
                        (self._clock() - br["at"])
                    if remaining > 0:
                        self.fast_fails += 1
                        raise CircuitOpen(
                            f"build circuit open for {key!r}: "
                            f"{br['fails']} consecutive build failures "
                            f"(last: {br['error']}); retrying in "
                            f"{remaining:.1f}s")
                    # cooldown elapsed: fall through half-open — this
                    # caller probes with one build attempt
                ev = self._building.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._building[key] = ev
                    self.misses += 1
                    if self._m_misses is not None:
                        self._m_misses.inc()
                    break            # we build
            waited = True
            ev.wait()                # someone else is building this key
        t_build = time.perf_counter()
        try:
            handle = builder()
        except BaseException as e:
            with self._lock:
                del self._building[key]
                br = self._breaker.setdefault(
                    key, {"fails": 0, "at": 0.0, "error": None})
                br["fails"] += 1
                br["at"] = self._clock()
                br["error"] = f"{type(e).__name__}: {e}"
                self.failed_builds += 1
                self.last_error = br["error"]
                if self._m_failed is not None:
                    self._m_failed.inc()
                if self._g_open is not None:
                    self._g_open.set(self._open_circuits())
            ev.set()
            raise
        if self._h_build is not None:
            self._h_build.observe(time.perf_counter() - t_build)
        with self._lock:
            self._cache[key] = handle
            self._cache.move_to_end(key)
            while len(self._cache) > self.capacity:
                self._cache.popitem(last=False)
                self.evictions += 1
            del self._building[key]
            self._breaker.pop(key, None)   # success closes the circuit
            if self._g_open is not None:
                self._g_open.set(self._open_circuits())
        ev.set()
        return handle, False

    def prewarm_async(self, key: tuple, builder: Callable[[], Any],
                      warm: Callable[[Any], None] = None) -> threading.Thread:
        """Build (and optionally warm-compile) a key on a daemon thread —
        cold-start work fully off the serving path.  Returns the thread;
        a build/warm failure is stashed on it as ``thread.error`` *and*
        counted in the pool's ``failed_builds``/``last_error`` (a warm
        failure too), so a fire-and-forget caller that never joins still
        sees the failure in :meth:`stats`."""
        def _work():
            try:
                handle, hit = self.get(key, builder)
                if warm is not None and not hit:
                    warm(handle)
            except Exception as e:   # noqa: BLE001 — reported via .error
                t.error = e
                with self._lock:
                    # get() already counted a *build* failure; count a
                    # warm/other failure here so nothing is silent
                    err = f"{type(e).__name__}: {e}"
                    if self.last_error != err:
                        self.failed_builds += 1
                        self.last_error = err

        t = threading.Thread(target=_work, daemon=True,
                             name=f"engine-prewarm-{key[0]}")
        t.error = None
        t.start()
        return t

    # -- health ----------------------------------------------------------------

    def mark_suspect(self, key: tuple, reason: str):
        """Flag a key's executable as suspect (watchdog: a chunk stalled
        past its timeout).  Sticky until :meth:`clear_suspect`."""
        with self._lock:
            self._suspect[key] = str(reason)

    def clear_suspect(self, key: tuple) -> bool:
        with self._lock:
            return self._suspect.pop(key, None) is not None

    def suspects(self) -> Dict[tuple, str]:
        with self._lock:
            return dict(self._suspect)

    def breaker_state(self, key: tuple) -> Optional[dict]:
        """The key's breaker record (consecutive fails, last error) or
        None when the circuit is closed and clean."""
        with self._lock:
            br = self._breaker.get(key)
            return None if br is None else dict(br)

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._cache

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)

    def _open_circuits(self) -> int:
        """Under the lock: how many keys currently fast-fail."""
        return sum(
            1 for br in self._breaker.values()
            if br["fails"] >= self.breaker_threshold
            and (self._clock() - br["at"]) < self.breaker_cooldown_s)

    def stats(self) -> dict:
        with self._lock:
            open_keys = self._open_circuits()
            if self._g_open is not None:
                self._g_open.set(open_keys)
            return {"capacity": self.capacity, "size": len(self._cache),
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "failed_builds": self.failed_builds,
                    "fast_fails": self.fast_fails,
                    "last_error": self.last_error,
                    "open_circuits": open_keys,
                    "suspect_keys": len(self._suspect)}
