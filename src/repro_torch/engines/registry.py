"""``make_engine`` for the port; mirrors ``repro.engines.registry``.

The port builds the single-GPU lattice engine at ``precision="f32"`` (the
default), ``"int8"`` and ``"bitplane"``, fused or per phase.  Everything
else the reference's factory offers raises ``NotImplementedError`` naming
the ROADMAP.md item that brings it; nothing is substituted.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.coloring import Coloring
from repro_torch.core.lattice import LatticeProblem, build_ea3d_lattice
from repro_torch.core.lattice_dsim import LatticeDSIM
from repro_torch.core.snapshot import restore_state, snapshot_state
from .base import RunRecord, SyncSpec, check_lanes, check_precision

__all__ = ["ENGINE_NAMES", "make_engine", "HandleCursor"]

ENGINE_NAMES = ("gibbs", "dsim", "dsim_dist", "lattice")


def _as_2d(energies: torch.Tensor) -> torch.Tensor:
    """(P,) single-replica trace -> (P, 1); (P, R) passes through."""
    return energies[:, None] if energies.dim() == 1 else energies


class HandleCursor:
    """Registry-normalized view of a :class:`RecordedCursor`: partial
    records in handle shape (energies (P, R)) and exact per-replica flip
    totals."""

    def __init__(self, cursor, replicas: int, handle=None):
        self._c = cursor
        self.replicas = int(replicas)
        self._handle = handle

    @property
    def state(self):
        return self._c.state

    @state.setter
    def state(self, st):
        self._c.state = st

    @property
    def chunk_timer(self):
        return self._c.chunk_timer

    @chunk_timer.setter
    def chunk_timer(self, fn):
        self._c.chunk_timer = fn

    @property
    def done(self) -> bool:
        return self._c.done

    @property
    def sweeps_done(self) -> int:
        return self._c.sweeps_done

    @property
    def total_sweeps(self) -> int:
        return self._c.total_sweeps

    @property
    def S(self) -> int:
        """The record-point quantum the cursor applied."""
        return self._c.S

    @property
    def points_recorded(self) -> int:
        return self._c.points_recorded

    @property
    def flips(self) -> int:
        return self._c.flips

    def advance(self, max_chunks: int = 1) -> int:
        n = self._c.advance(max_chunks)
        if self._c.done:
            self._c.run_to_completion()    # settles the pending flip window
        return n

    def record(self) -> RunRecord:
        rec = self._c.record()
        e = rec.energies
        if len(rec.times) > 0:
            e = _as_2d(e)
        return RunRecord(rec.times, e, rec.flips)

    def flips_per_replica(self) -> np.ndarray:
        """(R,) exact per-replica flip totals up to the last counter read."""
        vec = self._c.flips_vec
        if vec is None:
            return np.zeros((self.replicas,), np.int64)
        return vec.reshape(self.replicas, -1).sum(axis=1)

    def warm(self):
        self._c.warm()
        return self

    def checkpoint(self) -> dict:
        fn = self._handle.snapshot if self._handle is not None else None
        return self._c.checkpoint(snapshot_fn=fn)

    def restore_checkpoint(self, ck: dict):
        fn = self._handle.restore if self._handle is not None else None
        self._c.restore_checkpoint(ck, restore_fn=fn)
        return self


class _LatticeHandle:
    """The uniform engine surface over :class:`LatticeDSIM`."""

    name = "lattice"

    def __init__(self, eng: LatticeDSIM, replicas: int, n_sites: int):
        self.eng = eng
        self.replicas = int(replicas)
        self.n_sites = int(n_sites)

    @property
    def precision(self) -> str:
        return self.eng.precision

    @property
    def kernel_path(self) -> str:
        return self.eng.kernel_path

    @property
    def fused_requested(self) -> bool:
        return self.eng.fused_requested

    @property
    def fallback_reason(self) -> Optional[str]:
        """Why a fused request runs per phase ("kernel_bx"), or None."""
        return self.eng.fallback_reason

    @property
    def device(self) -> torch.device:
        return self.eng.device

    def init_state(self, seed: int = 0):
        return self.eng.init_state(seed)

    def init_state_packed(self, seeds: Sequence[int]):
        """State whose replica r is seeded by seeds[r] alone."""
        seeds = [int(s) for s in seeds]
        if len(seeds) != self.replicas:
            raise ValueError(
                f"need exactly R={self.replicas} seeds, got {len(seeds)}")
        return self.eng.init_state(seeds=seeds)

    def run_recorded(self, state, schedule, record_points: Sequence[int],
                     sync_every: SyncSpec = 1):
        state, rec = self.eng.run_recorded_full(
            state, schedule, record_points, sync_every=sync_every)
        return state, RunRecord(rec.times, _as_2d(rec.energies), rec.flips)

    def start_recorded(self, state, schedule, record_points: Sequence[int],
                       sync_every: SyncSpec = 1) -> HandleCursor:
        """Begin (not run) a recorded anneal; returns a resumable cursor."""
        cur = self.eng.run_recorded_full(state, schedule, record_points,
                                         sync_every=sync_every, cursor=True)
        return HandleCursor(cur, self.replicas, handle=self)

    def snapshot(self, state):
        """Host-side owned copy of a state (see core.snapshot)."""
        return snapshot_state(state)

    def restore(self, snap):
        """Snapshot -> live state on the engine's device."""
        return self.eng.shard_state(restore_state(snap, self.eng.device))

    def energy(self, state) -> torch.Tensor:
        return torch.atleast_1d(self.eng.energy(state))

    def global_spins(self, state) -> torch.Tensor:
        return torch.atleast_2d(self.eng.global_spins(state))

    def __repr__(self):
        return (f"<engine {self.name!r} n={self.n_sites} "
                f"R={self.replicas} {self.precision} on {self.device}>")


def make_engine(name: str, graph=None, *, coloring: Optional[Coloring] = None,
                replicas: int = 1, rng: str = "philox", fmt=None,
                K: Optional[int] = None, labels=None, mode: str = "dsim",
                mesh=None, axis: str = "data", dim_axes=None,
                lattice: Optional[LatticeProblem] = None,
                L: Optional[int] = None, seed: int = 0,
                impl: str = "auto", bitpack: bool = True,
                fused: bool = True, kernel_bx: Optional[int] = None,
                bitpack_halos: bool = True, precision: str = "f32",
                vmem_budget_bytes: Optional[int] = None,
                degrade=None, device=None):
    """Build a sampling engine by name (the reference's signature plus
    ``device``; CUDA unless ``device="cpu"``, raising without CUDA).

    "lattice" — the brick-partitioned EA3D lattice as ONE brick on one
    GPU: pass ``lattice=`` a LatticeProblem or ``L=`` to build one from
    ``seed``; ``precision`` "f32", "int8" or "bitplane"; ``replicas=R``
    chains per call (bit lanes on the bitplane path); ``fused=False`` or
    ``kernel_bx`` for the per-phase kernels.  ``impl`` "auto" | "cuda" |
    "ref".  ``rng``, ``axis``, ``dim_axes`` and ``bitpack_halos`` do not
    change a one-brick lattice run; ``graph``, ``coloring``, ``K``,
    ``labels``, ``mode`` and ``bitpack`` belong to the other engines.
    """
    if name not in ENGINE_NAMES:
        raise ValueError(f"unknown engine {name!r}; choose from {ENGINE_NAMES}")
    if name != "lattice":
        raise NotImplementedError(
            f"engine {name!r} is not ported yet: ROADMAP.md queue A item 7 "
            f"(off-main-path engines)")
    check_precision(name, precision)
    check_lanes(precision, replicas)
    if degrade is not None:
        raise NotImplementedError(
            "degrade policies come with the degraded mesh: ROADMAP.md "
            "queue A item 9")
    if mesh is not None:
        raise NotImplementedError(
            "a mesh (more than one brick) comes with the multi-GPU lattice: "
            "ROADMAP.md queue A item 5")
    if vmem_budget_bytes is not None:
        raise ValueError(
            "vmem_budget_bytes sizes the TPU kernel's VMEM working set; the "
            "Hopper kernels have no such budget")
    prob = lattice
    if prob is None:
        if L is None:
            raise ValueError("lattice engine needs lattice= or L=")
        prob = build_ea3d_lattice(int(L), seed=seed, device=device)
    eng = LatticeDSIM(prob, fmt=fmt, impl=impl, replicas=replicas,
                      precision=precision, fused=fused, kernel_bx=kernel_bx,
                      device=device)
    return _LatticeHandle(eng, replicas, prob.n_active)
