"""What a traced stretch of the window leaves to read: the device's
operations and the host's, from ``torch.profiler``, the traced jobs' own
spans, and the kernel calls the program noted, each costed with the frozen
work model.  The per-layer metrics (``metrics/<name>.py``) read a
:class:`Timeline` and nothing else.

Times are microseconds on the profiler's clock.  Device operations are the
kernels, copies and sets the profiler saw on the card; the jobs are the
intervals of the harness's ``perf_bench.job`` spans, and every reading
below is taken inside them.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import List, Optional, Tuple

import numpy as np

from perf_bench import work as W

JOB_SPAN = "perf_bench.job"
SPAN_PREFIX = "perf_bench."
# idle gaps labelled one by one, longest first
LABELLED_GAPS = 400


@dataclasses.dataclass
class Call:
    """Kernel calls the program noted alike: ``count`` calls of kernel
    ``name``, each of ``launches`` launches and of the frozen model's
    ``work``; ``program`` the program's own model of one call, when read."""
    name: str
    launches: int
    count: int
    work: W.Work
    program: Optional[object] = None


@dataclasses.dataclass
class Timeline:
    device: List[Tuple[str, float, float]]    # (name, start, end)
    host: List[Tuple[str, float, float]]
    jobs: List[Tuple[float, float]]
    sweeps: int                               # sweeps the traced jobs ran
    calls: List[Call] = dataclasses.field(default_factory=list)
    _host_np: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                 compare=False)

    def in_jobs(self, start: float) -> bool:
        return any(a <= start < b for a, b in self.jobs)

    def device_ops(self) -> List[Tuple[str, float, float]]:
        """The device operations that start inside a traced job."""
        return [e for e in self.device if self.in_jobs(e[1])]

    @property
    def window_s(self) -> float:
        return sum(b - a for a, b in self.jobs) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        jobs."""
        out = []
        for a, b in self.jobs:
            spans = sorted((max(s, a), min(e, b)) for _, s, e in self.device
                           if s < b and e > a)
            for s, e in spans:
                if out and s <= out[-1][1]:
                    out[-1] = (out[-1][0], max(out[-1][1], e))
                else:
                    out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The intervals of the jobs in which no device operation ran."""
        busy = self.busy_intervals()
        gaps = []
        for a, b in self.jobs:
            t = a
            for s, e in busy:
                if e <= a or s >= b:
                    continue
                if s > t:
                    gaps.append((t, s))
                t = max(t, e)
            if b > t:
                gaps.append((t, b))
        return gaps

    def host_at(self, a: float, b: float) -> str:
        """What the host was doing from a to b: the host operation that
        overlaps the interval most (the shortest of equals), the harness's
        spans aside."""
        names, ov, dur = self._host_arrays(a, b)
        if not len(ov) or ov.max() <= 0:
            return "host: between operations"
        best = np.lexsort((dur, -ov))[0]
        return names[best]

    def _host_arrays(self, a: float, b: float):
        if self._host_np is None:
            keep = [h for h in self.host if not h[0].startswith(SPAN_PREFIX)
                    and not h[0].startswith("ProfilerStep")]
            self._host_np = ([h[0] for h in keep],
                             np.array([h[1] for h in keep], float),
                             np.array([h[2] for h in keep], float))
        names, s, e = self._host_np
        return names, np.minimum(b, e) - np.maximum(a, s), e - s


def kernel_time_us(tl: Timeline, kernel: str) -> Tuple[float, int]:
    """(device microseconds, launches) of the kernels whose name holds
    ``kernel``, inside the jobs."""
    hits = [e - s for name, s, e in tl.device_ops() if kernel in name]
    return sum(hits), len(hits)


def roofline_share(tl: Timeline, note: str, kernel: str) -> Optional[float]:
    """Percent: the frozen model's bound of every call noted as ``note``
    over the device time of the kernel named ``kernel``, both summed over
    the traced jobs; None where either is missing."""
    calls = [c for c in tl.calls if c.name == note]
    t_dev, launches = kernel_time_us(tl, kernel)
    if not calls or not t_dev:
        return None
    t_bound = sum(c.count * W.bound(c.work)[1] for c in calls) * 1e6
    return 100.0 * t_bound / t_dev


def breakdown(tl: Timeline, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by what the host was doing, in seconds, inside the jobs."""
    ops = defaultdict(float)
    for name, s, e in tl.device_ops():
        ops[name[:160]] += (e - s) / 1e6
    gaps = defaultdict(float)
    # the longest gaps by what the host did, the rest together
    ranked = sorted(tl.idle_gaps(), key=lambda g: g[0] - g[1])
    for i, (a, b) in enumerate(ranked):
        label = tl.host_at(a, b)[:160] if i < LABELLED_GAPS \
            else "shorter gaps"
        gaps[label] += (b - a) / 1e6
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": [[k, v] for k, v in order(ops)],
            "idle_gaps": [[k, v] for k, v in order(gaps)]}


# -- reading the profiler ---------------------------------------------------------

def from_profiler(prof, sweeps: int, calls: List[Call]) -> Timeline:
    """A :class:`Timeline` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    device, host, jobs = [], [], []
    for e in prof.events():
        rng = (float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or \
                    e.name.startswith(SPAN_PREFIX):
                continue
            device.append((e.name, *rng))
        elif e.name == JOB_SPAN:
            jobs.append(rng)
        else:
            host.append((e.name, *rng))
    return Timeline(device=device, host=host, jobs=sorted(jobs),
                    sweeps=sweeps, calls=calls)


def _key(v):
    import torch
    if isinstance(v, torch.Tensor):
        return ("tensor", v.data_ptr(), tuple(v.shape), tuple(v.stride()),
                str(v.dtype))
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    return ("object", id(v))


def cost_notes(notes, program_model=None) -> List[Call]:
    """Group the noted calls ``(name, launches, operands)`` that are alike
    (the same shapes, the same tensors) and cost one of each group with the
    frozen model, and with ``program_model(name, operands)`` when given."""
    groups = {}
    for name, launches, operands in notes:
        key = (name, int(launches),
               tuple(sorted((k, _key(v)) for k, v in operands.items())))
        if key in groups:
            groups[key][1] += 1
        else:
            groups[key] = [(name, int(launches), operands), 1]
    calls = []
    for (name, launches, operands), count in groups.values():
        prog = None if program_model is None else \
            program_model(name, dict(operands))
        calls.append(Call(name, launches, count,
                          W.call_work(name, operands), prog))
    return calls
