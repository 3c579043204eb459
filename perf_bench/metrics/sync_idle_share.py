"""sync_idle_share (%): the share of the traced jobs' wall time that the
card spent idle after the waits the program forced.  For each of its
``repro_torch.sync.<cause>`` spans, the time from the return of the
host's wait inside it (``cudaStreamSynchronize`` or
``cudaDeviceSynchronize``) to the host's next call that puts work on the
card (a kernel launch, a copy or a set), or to the job's end: the queue
is empty when a wait returns, so the card idles until then.  A sync span
with no wait inside (a read of a tensor already on the host) adds
nothing.  A part of device_idle_share, from the same profiler run.
Layer: the driver.  Moves updates_per_s.

Every time is the host's, so the reading needs no match of the host's
clock to the card's, which in a traced job of this port drift apart by
about half a millisecond a second.  It leaves out the card's idle time
from its drain to the wait's return."""

import bisect

from perf_bench import spans as P

WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
ENQUEUES = ("cudaLaunch", "cudaMemcpy", "cudaMemset")


def read(tl):
    spans = P.program_spans(tl)
    if spans is None or tl.window_s <= 0:
        return None
    waits = sorted((s, e) for n, s, e in tl.host if n in WAITS)
    wait_starts = [s for s, _ in waits]
    puts = sorted(s for n, s, _ in tl.host if n.startswith(ENQUEUES))
    idle = 0.0
    for _, s, e in P.named(spans, "sync."):
        lo, hi = bisect.bisect_left(wait_starts, s), \
            bisect.bisect_right(wait_starts, e)
        ends = [b for _, b in waits[lo:hi] if b <= e]
        if not ends:
            continue
        back = max(ends)
        end = next(b for a, b in tl.jobs if a <= s < b)
        i = bisect.bisect_left(puts, back)
        idle += min(puts[i] if i < len(puts) else end, end) - back
    return 100.0 * idle / 1e6 / tl.window_s
