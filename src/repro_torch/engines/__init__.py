from .registry import ENGINE_NAMES, HandleCursor, make_engine

__all__ = ["ENGINE_NAMES", "HandleCursor", "make_engine"]
