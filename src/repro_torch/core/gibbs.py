"""Monolithic chromatic Gibbs sampler — the paper's unpartitioned baseline
and its GPU reference; port of ``repro.core.gibbs``.

One sweep updates all N p-bits once, colour group by colour group.  A
colour phase is a handful of PyTorch operations on the device: one gather
of the group's ELL neighbors (:func:`color_fields`), the LFSR step of the
group's states, the accept, and one ``index_copy_`` of the new spins.  The
energy is tracked incrementally: a group's members are mutually
non-adjacent, so per-spin deltas ``-(m_new - m_old) * field`` sum exactly
on +-J couplings.

``rng="lfsr"`` is the hardware's xorshift32, one state per p-bit, held to
the reference bitwise; ``rng="philox"`` draws from one ``torch.Generator``
per replica (:func:`repro_torch.core.pbit.philox_init`), held to it only
statistically.

Replicas: ``init_state(..., replicas=R)`` returns a state whose fields
carry a leading R axis (per-replica RNG streams from spawned seeds);
unbatched states (no R axis) are kept as the reference keeps them.  The
engine computes every state as a batch, the unbatched one as R=1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .annealing import ArraySchedule
from .bits import i64_to_u32, u32_from_numpy, u32_to_i64
from .coloring import Coloring
from .device import resolve_device
from .energy import energy as direct_energy
from .graph import IsingGraph
from .pbit import (FixedPoint, flips_publish, lfsr_init, lfsr_next,
                   lfsr_uniform, pbit_update, philox_init, philox_load,
                   philox_save, philox_uniform)
from repro_torch.engines.base import (RecordedCursor, chunk_plan,
                                      run_recorded_driver, spawn_seeds,
                                      stack_states)

__all__ = ["GibbsEngine", "GibbsState", "chunk_plan", "color_fields",
           "init_spins"]


@dataclasses.dataclass
class GibbsState:
    m: torch.Tensor       # (N,) int8 spins — or (R, N) batched
    rng: torch.Tensor     # lfsr: (N,) uint32 states; philox: (G,) uint8
                          # generator state bytes on the CPU
    E: torch.Tensor       # () f32, incrementally tracked energy
    sweep: torch.Tensor   # () int32
    flips: torch.Tensor   # () int32 uint32-modular odometer; the recording
                          # driver keeps the exact total on the host


def init_spins(seed: int, shape) -> np.ndarray:
    """Random +-1 int8 spins from a numpy generator seeded with ``seed``.
    The reference draws them with ``jax.random``, which PyTorch cannot
    reproduce; pass ``m0`` for equal starts."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([-1, 1], np.int8), size=shape)


def color_fields(m: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 h: torch.Tensor) -> torch.Tensor:
    """Local fields of one colour group: m (R, N) spins, idx/w (nc, D) the
    group's ELL rows, h (nc,); returns (R, nc) f32."""
    R = m.shape[0]
    nbr = m.index_select(1, idx.reshape(-1)).reshape(R, *idx.shape)
    return h + (w * nbr.to(w.dtype)).sum(-1)


class GibbsEngine:
    """Coloured Gibbs sampler over an ELL Ising graph, on ``device`` (CUDA
    unless ``device="cpu"``)."""

    def __init__(self, g: IsingGraph, coloring: Coloring,
                 rng: str = "philox", fmt: Optional[FixedPoint] = None,
                 device=None):
        if rng not in ("philox", "lfsr"):
            raise ValueError(f"unknown rng {rng!r}")
        self.device = resolve_device(device)
        self.g = g.to(self.device)
        self.coloring = coloring
        self.rng_kind = rng
        self.fmt = fmt
        self.n = self.g.n
        # per-colour static gathers
        self._nodes = [torch.from_numpy(grp.astype(np.int64)).to(self.device)
                       for grp in coloring.groups]
        self._idx = [self.g.idx.index_select(0, nd).long()
                     for nd in self._nodes]
        self._w = [self.g.w.index_select(0, nd) for nd in self._nodes]
        self._h = [self.g.h.index_select(0, nd) for nd in self._nodes]

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int = 0, m0: Optional[np.ndarray] = None,
                   replicas: Optional[int] = None,
                   seeds: Optional[Sequence[int]] = None) -> GibbsState:
        """Fresh state; ``replicas=R`` stacks R chains seeded by
        ``spawn_seeds(seed, R)``, ``seeds=[...]`` one chain per explicit
        seed (replica r's trajectory depends only on seeds[r]).  Without
        ``m0`` the spins are :func:`init_spins` of the chain's seed."""
        if seeds is not None:
            return stack_states([self.init_state(int(s), m0=m0)
                                 for s in seeds])
        if replicas is not None:
            return stack_states([self.init_state(s, m0=m0)
                                 for s in spawn_seeds(seed, replicas)])
        dev = self.device
        m = init_spins(seed, self.n) if m0 is None else \
            np.asarray(m0, dtype=np.int8)
        m = torch.from_numpy(np.array(m, np.int8)).to(dev)
        rng = philox_init(seed, dev) if self.rng_kind == "philox" else \
            u32_from_numpy(lfsr_init(self.n, seed), dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return GibbsState(m=m, rng=rng, E=direct_energy(self.g, m),
                          sweep=zero, flips=zero.clone())

    @staticmethod
    def is_batched(state: GibbsState) -> bool:
        return state.m.dim() == 2

    # -- sweeps ----------------------------------------------------------------

    def _phase(self, c: int, m, s, gens, beta):
        """Update colour group c of every replica in place (m (R, N) int8;
        s (R, N) int64-carried LFSR states or None; ``beta`` a float or an
        (R, 1) tensor); returns (dE, flips), each (R,)."""
        nodes = self._nodes[c]
        field = color_fields(m, self._idx[c], self._w[c], self._h[c])
        if gens is None:
            sc = lfsr_next(s.index_select(1, nodes))
            r = lfsr_uniform(sc)
            s.index_copy_(1, nodes, sc)
        else:
            r = philox_uniform(gens, field.shape[1:], self.device)
        old = m.index_select(1, nodes)
        new = pbit_update(field, beta, r, self.fmt)
        dE = -((new - old).to(torch.float32) * field).sum(-1)
        flips = (new != old).sum(-1)
        m.index_copy_(1, nodes, new)
        return dE, flips

    def _run(self, state: GibbsState, betas: np.ndarray, trace: bool = False):
        """``len(betas)`` sweeps; ``betas`` (T,) or (T, R) f32.  Returns the
        new state, and with ``trace`` the (T, R) energies and flips after
        each sweep."""
        batched = self.is_batched(state)
        lift = (lambda t: t) if batched else (lambda t: t[None])
        m = lift(state.m).clone()
        lfsr = self.rng_kind == "lfsr"
        s = u32_to_i64(lift(state.rng)) if lfsr else None
        gens = None if lfsr else philox_load(lift(state.rng), self.device)
        E = lift(state.E)
        R = m.shape[0]
        betas = np.asarray(betas, np.float32)
        per_rep = betas.ndim == 2
        if per_rep:
            if betas.shape[1] != R:
                raise ValueError(f"per-replica betas must be (T, R={R})")
            bt = torch.from_numpy(np.ascontiguousarray(betas)).to(
                self.device)[..., None]
        flips = torch.zeros(R, dtype=torch.int64, device=self.device)
        Es, fs = [], []
        for t in range(betas.shape[0]):
            beta = bt[t] if per_rep else float(betas[t])
            f_sweep = torch.zeros_like(flips)
            for c in range(len(self._nodes)):
                dE, f = self._phase(c, m, s, gens, beta)
                E = E + dE
                f_sweep = f_sweep + f
            flips = flips + f_sweep
            if trace:
                Es.append(E)
                fs.append(f_sweep.to(torch.int32))
        drop = (lambda t: t) if batched else (lambda t: t[0])
        T = betas.shape[0]
        st = GibbsState(
            m=drop(m),
            rng=drop(i64_to_u32(s) if lfsr else philox_save(gens)),
            E=drop(E), sweep=state.sweep + T,
            flips=flips_publish(state.flips, drop(flips)))
        if not trace:
            return st
        Es = torch.stack(Es) if Es else E.new_zeros((0, R))
        fs = torch.stack(fs) if fs else flips.new_zeros((0, R), torch.int32)
        if not batched:
            Es, fs = Es[:, 0], fs[:, 0]
        return st, (Es, fs)

    def sweep(self, state: GibbsState, beta) -> GibbsState:
        """One sweep at ``beta`` (a scalar, or (R,) per replica)."""
        b = np.asarray(beta, np.float32)
        return self._run(state, b[None] if b.ndim else b.reshape(1))

    def run_dense(self, state: GibbsState, betas: np.ndarray):
        """Run len(betas) sweeps; returns (state, (per-sweep energies,
        per-sweep flip counts)), with a trailing replica axis when the
        state is batched."""
        return self._run(state, betas, trace=True)

    def run_recorded_full(self, state: GibbsState, schedule,
                          record_points: Sequence[int], sync_every=1,
                          betas_R: Optional[np.ndarray] = None,
                          cursor: bool = False):
        """Shared-driver runner; returns (state, RunRecord), or the
        resumable :class:`RecordedCursor` with ``cursor=True``.  The
        record-point observable is the tracked energy.  ``sync_every`` is
        accepted and ignored (no boundaries); ``betas_R`` (T, R) gives
        each replica its own staircase."""
        batched = self.is_batched(state)
        if betas_R is not None and not batched:
            raise ValueError("per-replica betas need a batched state")
        sched = schedule if betas_R is None else \
            ArraySchedule(np.asarray(betas_R, np.float32))

        def chunk(st, betas2d, iters, S):
            return self._run(st, betas2d.reshape((iters * S,) +
                                                 betas2d.shape[2:]))

        R = state.m.shape[0] if batched else 1
        kw = dict(
            state=state, schedule=sched, record_points=record_points,
            chunk_fn=chunk, record_fn=lambda st: st.E, sync_every=1,
            flips_of=lambda st: st.flips, flips_per_sweep=self.n * R)
        if cursor:
            return RecordedCursor(**kw)
        return run_recorded_driver(**kw)

    def run_recorded(self, state: GibbsState, schedule,
                     record_points: Sequence[int]):
        """Run to each record point; returns (state, E at the points)."""
        state, rec = self.run_recorded_full(state, schedule, record_points)
        return state, rec.energies

    # -- observables -----------------------------------------------------------

    def energy(self, state: GibbsState) -> torch.Tensor:
        """The energy of the spins, computed afresh (not the tracked E; the
        reference's ``direct_energy``)."""
        return direct_energy(self.g, state.m)

    direct_energy = energy   # the reference's name

    def global_spins(self, state: GibbsState) -> torch.Tensor:
        return state.m
