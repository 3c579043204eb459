"""``make_engine`` for the port; mirrors ``repro.engines.registry``.

The port builds the lattice engine at ``precision="f32"`` (the default),
``"int8"`` and ``"bitplane"``, fused or per phase, as one brick or, with
a mesh, as bricks in one process or one per rank of a process group; the
monolithic Gibbs engine (``"gibbs"``, f32); the partitioned DSIM/CMFT
engine (``"dsim"``, f32 and int8); and the distributed DSIM
(``"dsim_dist"``, f32, int8 and bitplane), one partition per member of a
mesh, every partition in one process or one per rank.  What the
reference's factory offers beyond that (``degrade=``) raises
``NotImplementedError`` naming the ROADMAP.md item that brings it;
nothing is substituted.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.coloring import Coloring, greedy_coloring
from repro_torch.core.dsim import (DSIMEngine, PartitionedProblem,
                                   build_partitioned)
from repro_torch.core.dsim_dist import DistDSIMEngine
from repro_torch.core.gibbs import GibbsEngine
from repro_torch.core.graph import IsingGraph
from repro_torch.core.lattice import LatticeProblem, build_ea3d_lattice
from repro_torch.core.lattice_dsim import LatticeDSIM
from repro_torch.core.partition import greedy_partition
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


class _Handle:
    """The uniform engine surface over one engine instance."""

    name: str = ""

    def __init__(self, eng, replicas: int, n_sites: int):
        self.eng = eng
        self.replicas = int(replicas)
        self.n_sites = int(n_sites)

    @property
    def precision(self) -> str:
        return getattr(self.eng, "precision", "f32")

    @property
    def kernel_path(self) -> Optional[str]:
        """Which lattice dispatch runs ("fused"/"per_phase"); None for
        engines without that split."""
        return getattr(self.eng, "kernel_path", None)

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

    def _recorded(self, state, schedule, record_points, sync_every, cursor):
        return self.eng.run_recorded_full(state, schedule, record_points,
                                          sync_every=sync_every,
                                          cursor=cursor)

    def run_recorded(self, state, schedule, record_points: Sequence[int],
                     sync_every: SyncSpec = 1):
        state, rec = self._recorded(state, schedule, record_points,
                                    sync_every, cursor=False)
        return state, RunRecord(rec.times, _as_2d(rec.energies), rec.flips)

    def start_recorded(self, state, schedule, record_points: Sequence[int],
                       sync_every: SyncSpec = 1) -> HandleCursor:
        """Begin (not run) a recorded anneal; returns a resumable cursor."""
        cur = self._recorded(state, schedule, record_points, sync_every,
                             cursor=True)
        return HandleCursor(cur, self.replicas, handle=self)

    def snapshot(self, state):
        """Host-side owned copy of a state (see core.snapshot)."""
        return snapshot_state(state)

    def restore(self, snap):
        """Snapshot -> live state on the engine's device."""
        return restore_state(snap, self.eng.device)

    def energy(self, state) -> torch.Tensor:
        return torch.atleast_1d(self.eng.energy(state))

    def global_spins(self, state) -> torch.Tensor:
        return torch.atleast_2d(self.eng.global_spins(state))

    def __repr__(self):
        return (f"<engine {self.name!r} n={self.n_sites} "
                f"R={self.replicas} {self.precision} on {self.device}>")


class _BatchedStateHandle(_Handle):
    """gibbs/dsim: the replica axis lives on the state, not the engine;
    R=1 keeps the unbatched state."""

    def init_state(self, seed: int = 0):
        return self.eng.init_state(
            seed, replicas=None if self.replicas == 1 else self.replicas)


class _GibbsHandle(_BatchedStateHandle):
    name = "gibbs"


class _DSIMHandle(_BatchedStateHandle):
    name = "dsim"


class _DistHandle(_Handle):
    """The uniform engine surface over :class:`DistDSIMEngine`; states
    cross snapshots in the reference's global shapes."""

    name = "dsim_dist"
    # the f32 path derives all replica streams jointly from one seed; the
    # int8 and bit-plane paths spawn per-replica streams, but the handle
    # runs one tenant per call, so per-job seed lists are not exposed
    supports_packing = False

    def init_state_packed(self, seeds: Sequence[int]):
        raise NotImplementedError(
            "dsim_dist runs one tenant per batched call (no replica "
            "packing); submit with replicas=R and a single seed instead")

    def snapshot(self, state):
        return snapshot_state(self.eng.global_state(state))

    def restore(self, snap):
        return self.eng.shard_state(restore_state(snap, self.eng.device))


class _LatticeHandle(_Handle):
    """The uniform engine surface over :class:`LatticeDSIM`."""

    name = "lattice"

    @property
    def fused_requested(self) -> bool:
        return self.eng.fused_requested

    @property
    def fallback_reason(self) -> Optional[str]:
        """Why a fused request runs per phase ("kernel_bx"), or None."""
        return self.eng.fallback_reason

    def snapshot(self, state):
        """Host-side owned copy of a state in the reference's global
        shapes (see core.snapshot)."""
        return snapshot_state(self.eng.global_state(state))

    def restore(self, snap):
        """Snapshot -> live state on the engine's device (cut into bricks
        on a mesh)."""
        return self.eng.shard_state(restore_state(snap, self.eng.device))


def _default_coloring(g: IsingGraph, coloring: Optional[Coloring]) -> Coloring:
    if coloring is not None:
        return coloring
    return greedy_coloring(g.idx, g.w)


def _default_partitioned(graph, coloring, K, labels) -> PartitionedProblem:
    if isinstance(graph, PartitionedProblem):
        return graph
    if not isinstance(graph, IsingGraph):
        raise ValueError("dsim engine needs an IsingGraph or a "
                         "PartitionedProblem")
    col = _default_coloring(graph, coloring)
    K = 4 if K is None else int(K)
    if labels is None:
        labels = greedy_partition(graph.idx, graph.w, K, seed=0)
    return build_partitioned(graph, col, np.asarray(labels, np.int32), K)


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

    "gibbs" — monolithic chromatic Gibbs over ``graph`` (an
    :class:`IsingGraph`; ``coloring`` defaults to the greedy one), f32,
    ``rng`` "philox" or "lfsr", ``fmt`` the activation format.
    "dsim" — the partitioned sampler over ``graph`` (or a prebuilt
    :class:`PartitionedProblem`): ``K`` partitions (default 4) cut by
    ``labels`` (default ``greedy_partition(..., seed=0)``), ``mode``
    "dsim" or "cmft", ``precision`` "f32" or "int8" (lfsr, dsim mode);
    ``run_recorded``'s ``sync_every`` sets the staleness.
    "dsim_dist" — the same problem and semantics, one partition per
    member of ``mesh`` along ``axis`` (its size must be K): with no
    ``mesh`` all K partitions in this process on one device (the
    reference instead demands K JAX devices), or one per rank of the
    process group of a ``make_mesh((K,), ("data",), group=...)`` mesh;
    ``precision`` "f32", "int8" or "bitplane" (lfsr, dsim mode; 32 lanes
    per word), ``bitpack`` the f32 boundary's 1-bit wire.
    "lattice" — the brick-partitioned EA3D lattice: pass ``lattice=`` a
    LatticeProblem or ``L=`` to build one from ``seed``; ``precision``
    "f32", "int8" or "bitplane"; ``fused=False`` or ``kernel_bx`` for the
    per-phase kernels.  With no ``mesh`` it is one brick on one GPU; a
    ``mesh`` from ``repro_torch.core.mesh.make_mesh`` with ``dim_axes``
    (the mesh axis, or None, of x, y and z) cuts it into bricks, all on
    one device or one per rank of the mesh's process group, with
    ``bitpack_halos`` the reference's 1-bit halo wire.  ``impl`` "auto" |
    "cuda" | "ref".

    ``replicas=R`` makes every handle run R independent chains per call.
    """
    if name not in ENGINE_NAMES:
        raise ValueError(f"unknown engine {name!r}; choose from {ENGINE_NAMES}")
    if replicas < 1:
        raise ValueError("replicas must be >= 1")
    check_precision(name, precision)
    check_lanes(precision, replicas)
    if degrade is not None:
        if name not in ("dsim_dist", "lattice"):
            raise ValueError(
                f"degrade policies apply to the mesh engines "
                f"(dsim_dist, lattice), not {name!r}")
        # dsim_dist's constructor raises the reference's own ValueErrors
        # first, then this
        if name == "lattice":
            raise NotImplementedError(
                "degrade policies come with the degraded mesh: ROADMAP.md "
                "queue A item 9")

    if name == "gibbs":
        if not isinstance(graph, IsingGraph):
            raise ValueError("gibbs engine needs an IsingGraph")
        eng = GibbsEngine(graph, _default_coloring(graph, coloring),
                          rng=rng, fmt=fmt, device=device)
        return _GibbsHandle(eng, replicas, graph.n)

    if name == "dsim":
        prob = _default_partitioned(graph, coloring, K, labels)
        eng = DSIMEngine(prob, rng=rng, fmt=fmt, mode=mode,
                         precision=precision, device=device)
        return _DSIMHandle(eng, replicas, prob.n)

    if name == "dsim_dist":
        prob = _default_partitioned(graph, coloring, K, labels)
        eng = DistDSIMEngine(prob, mesh=mesh, axis=axis, rng=rng, fmt=fmt,
                             mode=mode, bitpack=bitpack, replicas=replicas,
                             precision=precision, degrade=degrade,
                             device=device)
        return _DistHandle(eng, replicas, prob.n)

    # name == "lattice"
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
                      device=device, mesh=mesh, dim_axes=dim_axes,
                      bitpack_halos=bitpack_halos)
    return _LatticeHandle(eng, replicas, prob.n_active)
