"""Runtime telemetry; port of ``repro.obs``: so far the measured-η meter
(:mod:`.timing`)."""

from .timing import EtaMeter, dist_eta_meter, exchanges_per_sweep

__all__ = ["EtaMeter", "dist_eta_meter", "exchanges_per_sweep"]
