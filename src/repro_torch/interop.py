"""Parameters across packages: numpy arrays in, the port's objects out.

The reference's ``LatticeProblem`` / ``LatticeState`` /
``BitplaneLatticeState`` fields, given as numpy arrays, become the port's
problem and states (and back), so both packages can compute the same thing
from the same data.  States cross in the reference's global shapes: a
mesh engine's ``shard_state`` cuts one into its bricks, and a
``BrickState`` of a one-process mesh is joined back.  The dtypes are the reference's: int8 spins, uint32
LFSR states and words, f32 couplings, int32 counters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.lattice import LatticeProblem
from repro_torch.core.lattice_dsim import (BitplaneLatticeState, BrickState,
                                           LatticeState, join_bricks)
from repro_torch.core.snapshot import restore_state, snapshot_state

__all__ = ["problem_from_numpy", "state_from_numpy", "state_to_numpy"]


def problem_from_numpy(*, L, dims, seed, n_colors, h, w6, masks, active,
                       device=None) -> LatticeProblem:
    """The reference ``LatticeProblem``'s fields (arrays as numpy) -> the
    port's problem on ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    as_t = lambda a, dt: torch.from_numpy(np.array(a, dt)).to(dev)  # noqa: E731
    return LatticeProblem(
        L=int(L), dims=tuple(int(d) for d in dims), seed=int(seed),
        n_colors=int(n_colors), h=as_t(h, np.float32),
        w6=tuple(as_t(w, np.float32) for w in w6),
        masks=as_t(masks, np.int8), active=as_t(active, np.int8))


def state_from_numpy(*, m, s, halos, sweep, flips, device=None):
    """A reference state's fields (numpy) -> the port's state on
    ``device``: uint32 words in ``m`` give a ``BitplaneLatticeState``,
    int8 spins a ``LatticeState``."""
    m = np.asarray(m)
    if m.dtype == np.uint32:
        cls = BitplaneLatticeState
    elif m.dtype == np.int8:
        cls = LatticeState
    else:
        raise TypeError(f"m must be int8 spins or uint32 words, got {m.dtype}")
    snap = cls(m=m, s=np.asarray(s, np.uint32),
               halos=tuple(np.asarray(h, m.dtype) for h in halos),
               sweep=np.asarray(sweep, np.int32),
               flips=np.asarray(flips, np.int32))
    return restore_state(snap, resolve_device(device))


def state_to_numpy(state) -> dict:
    """The port's state -> a dict of the reference field names with owned
    numpy arrays (``halos`` a tuple), in the reference's global shapes."""
    if isinstance(state, BrickState):
        state = join_bricks(state)
    snap = snapshot_state(state)
    return {f.name: getattr(snap, f.name) for f in dataclasses.fields(snap)}
