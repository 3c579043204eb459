"""PyTorch/CUDA port of the p-bit machine.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core/``, ``kernels/``, ``engines/``, ``obs/``, ``serve/``) and
imports neither JAX nor
``repro``.  Entry points run on a CUDA device unless the caller passes
``device="cpu"`` (the plain PyTorch versions of the kernels, used by the
CPU tests); with no device given and no CUDA present they raise.
"""

from .core.pbit import S41, S43, S46, FixedPoint
from .engines.registry import make_engine

__all__ = ["make_engine", "FixedPoint", "S41", "S43", "S46"]
