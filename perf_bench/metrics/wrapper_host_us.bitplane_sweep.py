"""wrapper_host_us.bitplane_sweep (us/call): the median host time of one
call of kernel #2's wrapper (``kernels/ops.py::pbit_bitplane_sweep_op``
and ``kernels/pbit_bitplane.py``: its checks, the colour layout's cache,
the LFSR columns' permutation there and back, the launches through
ctypes), its ``repro_torch.wrapper.pbit_bitplane_sweep`` spans in the
traced jobs.  Layer: the wrappers.  Moves updates_per_s."""

import statistics

from perf_bench import spans as P

SPAN = "wrapper.pbit_bitplane_sweep"


def read(tl):
    spans = P.program_spans(tl)
    if spans is None:
        return None
    calls = [e - s for n, s, e in spans if n == P.PREFIX + SPAN]
    return statistics.median(calls) if calls else None
