"""The program's own spans in a :class:`~perf_bench.timeline.Timeline`.

The port names its layer boundaries and its host syncs with profiler
ranges while a profiler records (``repro_torch.obs.trace.region``):
``repro_torch.entry.*``, ``repro_torch.driver.*``,
``repro_torch.engine.exchange``, ``repro_torch.wrapper.pbit_bitplane_sweep``
and ``repro_torch.sync.<cause>``.  They
are host events on the clock of the profiler's device events, so they sit
in ``tl.host`` beside the aten operations.  A program without them (one
older than its spans) leaves nothing here, and each reader then returns
None.  Times are microseconds.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

PREFIX = "repro_torch."


def program_spans(tl) -> Optional[List[Tuple[str, float, float]]]:
    """The program's spans that start inside the traced jobs, by start;
    None where there are none (or no jobs)."""
    if not tl.jobs:
        return None
    out = sorted((h for h in tl.host
                  if h[0].startswith(PREFIX) and tl.in_jobs(h[1])),
                 key=lambda h: h[1])
    return out or None


def named(spans, prefix: str) -> List[Tuple[str, float, float]]:
    """The spans whose name begins with ``repro_torch.<prefix>``."""
    full = PREFIX + prefix
    return [s for s in spans if s[0].startswith(full)]


def union(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint ones by start."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def self_us(span, spans) -> float:
    """A span's duration less the union of the other program spans that
    lie inside it (its children and theirs)."""
    _, a, b = span
    inner = [(s, e) for n, s, e in spans
             if a <= s and e <= b and (n, s, e) != span]
    return (b - a) - sum(e - s for s, e in union(inner))
