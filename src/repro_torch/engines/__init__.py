"""Unified engine layer; port of ``repro.engines``.

Every sampling backend is reached through one protocol (:class:`Engine`)
and one string-keyed factory (:func:`make_engine`), runs R replicas per
call, and records trajectories through one shared chunk-planning driver
(:func:`run_recorded_driver`).
"""

from .base import (Engine, RecordedCursor, RunRecord, chunk_plan,
                   run_recorded_driver, spawn_seeds, stack_states)
from .registry import ENGINE_NAMES, HandleCursor, make_engine

__all__ = ["Engine", "RecordedCursor", "RunRecord", "chunk_plan",
           "run_recorded_driver", "spawn_seeds", "stack_states",
           "ENGINE_NAMES", "HandleCursor", "make_engine"]
