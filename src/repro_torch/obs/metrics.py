"""Dependency-free metrics registry: counters, gauges, bucket histograms.

Port of ``repro.obs.metrics`` (stdlib only, so the same code).

One :class:`MetricsRegistry` per process (or per server) holds metric
*families*; a family with no labels acts directly as the metric, and
``family.labels(engine="dsim")`` returns (creating on first use) the
labeled child for that label set — the per-engine / per-precision /
per-pool-key breakdown the serving layer wants.

Histograms are fixed-bucket: they store cumulative counts per upper
bound plus a running sum, never individual samples, so p50/p90/p99 are
estimated by linear interpolation inside the owning bucket — O(buckets)
memory regardless of traffic, and every observation is O(log buckets).

Everything is guarded by one registry-level lock (a counter bump is a
single ``dict``-free float add under the lock), so concurrent writers
never lose increments and a reader's :meth:`MetricsRegistry.snapshot` /
:meth:`MetricsRegistry.render_text` is a consistent cut.

Two export surfaces, both pure stdlib:

* :meth:`MetricsRegistry.snapshot` — a JSON-able dict (benchmarks embed
  it into BENCH_*.json records);
* :meth:`MetricsRegistry.render_text` — Prometheus text exposition
  (``# HELP`` / ``# TYPE`` / ``name{label="v"} value`` and the
  ``_bucket``/``_sum``/``_count`` triplet for histograms).
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "DEFAULT_TIME_BUCKETS"]

# Latency-flavored default bounds (seconds): 10 us .. 60 s, roughly
# geometric with a 1-2.5-5 mantissa so percentile interpolation stays
# tight across six decades of chunk/queue/build times.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = tuple(
    m * 10.0 ** e
    for e in range(-5, 2)
    for m in (1.0, 2.5, 5.0)
) + (60.0,)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(items: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    """Monotone float counter (one labeled child of a family)."""

    kind = "counter"

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _render(self):
        return self.value

    def _snap(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Settable instantaneous value."""

    kind = "gauge"

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _render(self):
        return self.value

    def _snap(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Fixed-bucket histogram: cumulative-count exposition, interpolated
    percentiles, no sample storage."""

    kind = "histogram"

    def __init__(self, lock: threading.RLock,
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        bs = tuple(float(b) for b in buckets)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError("buckets must be a non-empty increasing sequence")
        self._lock = lock
        self._bounds = bs                      # finite upper bounds
        self._counts = [0] * (len(bs) + 1)     # +1 for the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Interpolated quantile from bucket counts; NaN when empty.
        Observations beyond the last finite bound clamp to that bound."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return float("nan")
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c > 0:
                if i >= len(self._bounds):       # +Inf bucket
                    return self._bounds[-1]
                lo = self._bounds[i - 1] if i > 0 else 0.0
                hi = self._bounds[i]
                frac = (rank - prev_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self._bounds[-1]

    def _cumulative(self):
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._count
        cum, out = 0, []
        for bound, c in zip(self._bounds, counts):
            cum += c
            out.append((bound, cum))
        return out, n, s

    def _snap(self) -> dict:
        cum, n, s = self._cumulative()
        d = {"count": n, "sum": s,
             "buckets": [[b, c] for b, c in cum] + [["+Inf", n]]}
        if n:
            d.update(p50=self.quantile(0.50), p90=self.quantile(0.90),
                     p99=self.quantile(0.99))
        return d


class _Family:
    """A named metric family: the no-label child plus labeled children."""

    def __init__(self, name: str, help: str, ctor, lock: threading.RLock):
        self.name = name
        self.help = help
        self._ctor = ctor
        self._lock = lock
        self._children: Dict[Tuple[Tuple[str, str], ...], object] = {}
        self.kind = ctor(lock).kind  # probe; cheap

    def labels(self, **labels) -> object:
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._ctor(self._lock)
                self._children[key] = child
            return child

    # the family doubles as its own no-label child
    def _default(self):
        return self.labels()

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    @property
    def value(self) -> float:
        return self._default().value

    @property
    def count(self) -> int:
        return self._default().count

    def quantile(self, q: float) -> float:
        return self._default().quantile(q)

    def series(self):
        with self._lock:
            return list(self._children.items())


class MetricsRegistry:
    """Thread-safe named registry of counter/gauge/histogram families."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, help: str, ctor) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, help, ctor, self._lock)
                self._families[name] = fam
            elif fam._ctor is not ctor and fam.kind != ctor(self._lock).kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}")
            return fam

    def counter(self, name: str, help: str = "") -> _Family:
        return self._family(name, help, Counter)

    def gauge(self, name: str, help: str = "") -> _Family:
        return self._family(name, help, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS) -> _Family:
        bs = tuple(buckets)
        return self._family(name, help,
                            lambda lock: Histogram(lock, buckets=bs))

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    # -- export ---------------------------------------------------------------------

    def snapshot(self) -> dict:
        """Consistent JSON-able dump: {name: {type, help, series: [...]}}."""
        with self._lock:
            fams = list(self._families.values())
        out = {}
        for fam in fams:
            series = []
            for key, child in fam.series():
                entry = {"labels": dict(key)}
                entry.update(child._snap())
                series.append(entry)
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "series": series}
        return out

    def render_text(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        with self._lock:
            fams = list(self._families.values())
        lines = []
        for fam in fams:
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam.series():
                if fam.kind == "histogram":
                    cum, n, s = child._cumulative()
                    for bound, c in cum:
                        le = _fmt_labels(key, f'le="{bound:g}"')
                        lines.append(f"{fam.name}_bucket{le} {c}")
                    inf = _fmt_labels(key, 'le="+Inf"')
                    lines.append(f"{fam.name}_bucket{inf} {n}")
                    lines.append(f"{fam.name}_sum{_fmt_labels(key)} {s:g}")
                    lines.append(f"{fam.name}_count{_fmt_labels(key)} {n}")
                else:
                    v = child._render()
                    v_s = f"{v:g}" if math.isfinite(v) else str(v)
                    lines.append(f"{fam.name}{_fmt_labels(key)} {v_s}")
        return "\n".join(lines) + "\n"
