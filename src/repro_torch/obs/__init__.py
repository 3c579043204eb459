"""Runtime telemetry; port of ``repro.obs``: so far the measured-η meter
(:mod:`.timing`)."""

from .timing import EtaMeter, exchanges_per_sweep

__all__ = ["EtaMeter", "exchanges_per_sweep"]
