"""Parameters across packages: numpy arrays in, the port's objects out.

The reference's ``IsingGraph``, ``LatticeProblem``, and its ``LatticeState``
/ ``BitplaneLatticeState`` / ``GibbsState`` / ``DSIMState`` fields, given
as numpy arrays, become the port's graph, problem and states (and back),
so both packages can compute the same thing from the same data.  A
``rng="philox"`` state cannot cross: a ``jax.random`` key and a
``torch.Generator`` are different streams.  States cross in the reference's global shapes: a
mesh engine's ``shard_state`` cuts one into its bricks, and a
``BrickState`` of a one-process mesh is joined back (a distributed DSIM
over a process group gives its global state through ``global_state``).  The dtypes are the reference's: int8 spins, uint32
LFSR states and words, f32 couplings, int32 counters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.dsim import DSIMState
from repro_torch.core.gibbs import GibbsState
from repro_torch.core.graph import IsingGraph
from repro_torch.core.lattice import LatticeProblem
from repro_torch.core.lattice_dsim import (BitplaneLatticeState, BrickState,
                                           LatticeState, join_bricks)
from repro_torch.core.snapshot import restore_state, snapshot_state

__all__ = ["graph_from_numpy", "problem_from_numpy", "state_from_numpy",
           "state_to_numpy"]

_PHILOX = ("a rng='philox' state cannot cross between the packages: a "
           "jax.random key and a torch.Generator are different streams; "
           "use rng='lfsr'")


def graph_from_numpy(idx, w, h, meta=None, device=None) -> IsingGraph:
    """The reference ``IsingGraph``'s ELL arrays (numpy) -> the port's
    graph on ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    as_t = lambda a, dt: torch.from_numpy(np.array(a, dt)).to(dev)  # noqa: E731
    return IsingGraph(idx=as_t(idx, np.int32), w=as_t(w, np.float32),
                      h=as_t(h, np.float32), meta=dict(meta or {}))


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


def state_from_numpy(*, device=None, **fields):
    """A reference state's fields (numpy) -> the port's state on
    ``device``.  The field names pick the state: ``m, s, halos, sweep,
    flips`` a lattice state (uint32 words in ``m`` a
    ``BitplaneLatticeState``, int8 spins a ``LatticeState``); ``m, rng, E,
    sweep, flips`` a ``GibbsState``; ``m, ghosts, macc, rng, sweep,
    flips`` a ``DSIMState`` of the stacked or the distributed DSIM (uint32
    words in ``m``: the distributed bit-plane state).  An ``rng`` that is
    not one uint32 LFSR state per spin or lane (a philox key) raises."""
    keys = set(fields)
    m = np.asarray(fields["m"])
    if keys == {"m", "s", "halos", "sweep", "flips"}:
        if m.dtype == np.uint32:
            cls = BitplaneLatticeState
        elif m.dtype == np.int8:
            cls = LatticeState
        else:
            raise TypeError(
                f"m must be int8 spins or uint32 words, got {m.dtype}")
        snap = cls(m=m, s=np.asarray(fields["s"], np.uint32),
                   halos=tuple(np.asarray(h, m.dtype)
                               for h in fields["halos"]),
                   sweep=np.asarray(fields["sweep"], np.int32),
                   flips=np.asarray(fields["flips"], np.int32))
        return restore_state(snap, resolve_device(device))
    # the distributed DSIM's bit-plane state: (K, W, n_max) uint32 words
    # and word ghosts beside (K, R, n_max) LFSR states
    words = m.dtype == np.uint32
    if keys == {"m", "rng", "E", "sweep", "flips"}:
        cls, extra = GibbsState, {"E": np.asarray(fields["E"], np.float32)}
    elif keys == {"m", "ghosts", "macc", "rng", "sweep", "flips"}:
        cls, extra = DSIMState, {
            "ghosts": np.asarray(fields["ghosts"],
                                 np.uint32 if words else np.float32),
            "macc": np.asarray(fields["macc"], np.float32)}
    else:
        raise TypeError(f"no state of the port has the fields {sorted(keys)}")
    rng = np.asarray(fields["rng"])
    one_per_spin = rng.shape == m.shape or (
        words and cls is DSIMState and rng.ndim == m.ndim == 3
        and rng.shape[::2] == m.shape[::2])
    if rng.dtype != np.uint32 or not one_per_spin:
        raise ValueError(_PHILOX)
    snap = cls(m=m if words else np.asarray(m, np.int8), rng=rng,
               sweep=np.asarray(fields["sweep"], np.int32),
               flips=np.asarray(fields["flips"], np.int32), **extra)
    return restore_state(snap, resolve_device(device))


def state_to_numpy(state) -> dict:
    """The port's state -> a dict of the reference field names with owned
    numpy arrays (``halos`` a tuple), in the reference's global shapes."""
    if isinstance(state, (GibbsState, DSIMState)) and \
            state.rng.dtype == torch.uint8:
        raise ValueError(_PHILOX)
    if isinstance(state, BrickState):
        state = join_bricks(state)
    snap = snapshot_state(state)
    return {f.name: getattr(snap, f.name) for f in dataclasses.fields(snap)}
