"""Runtime telemetry fabric; port of ``repro.obs``: metrics, tracing and
measured-η timing.

* :mod:`.metrics` — thread-safe :class:`MetricsRegistry` of counters,
  gauges and fixed-bucket histograms with labelled children, JSON
  snapshots and Prometheus text exposition;
* :mod:`.trace` — bounded-ring span :class:`Tracer` with an explicit
  device-sync boundary (``torch.cuda.synchronize``);
* :mod:`.timing` — :class:`EtaMeter`, measured η = f_comm/f_pbit, its
  margin against ``commcost.eta_threshold`` and the degraded-mode
  ``effective_eta``;
* :mod:`.probe` — :func:`eta_probe`, a one-partition ``dsim_dist`` run
  with an EtaMeter attached (the serving dashboard's measured η).
"""

from .metrics import (DEFAULT_TIME_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .timing import EtaMeter, dist_eta_meter, exchanges_per_sweep
from .probe import eta_probe
from .trace import Span, Tracer, device_sync

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "DEFAULT_TIME_BUCKETS",
    "Tracer", "Span", "device_sync",
    "EtaMeter", "dist_eta_meter", "exchanges_per_sweep", "eta_probe",
]
