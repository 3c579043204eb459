"""Distributed Sparse Ising Machine — partitioned Gibbs sampling with
shadow weights and tunably stale 1-bit boundary exchange (the paper's
core); port of ``repro.core.dsim`` (its stacked single-device backend).

Construction (host side, numpy, the reference's operations): the graph is
partitioned into K clusters; cut-edge weights are duplicated on both
sides (*shadow weights*), so each cluster evaluates every local field from
cluster-local memory.  The only cross-cluster quantity is the boundary
p-bit *state*, refreshed every ``sync_every = S`` sweeps:

  mode='dsim' : ghosts get the instantaneous boundary states (hardware).
  mode='cmft' : ghosts get the mean over the last S sweeps (parallel
                cluster mean-field theory, Supplementary S3).

``sync_every``: ``"phase"`` refreshes before every colour phase (exactly
the monolithic chromatic dynamics), S >= 1 every S sweeps (eta ~ 1/S),
``None`` never (the paper's disconnected-links control, S7).

All K partitions ride one device, stacked on a leading axis (and the
replicas on one before it).  A colour phase is a handful of PyTorch
operations: one gather of the partitions' local spins and ghosts at the
colour's ELL rows, the LFSR step, the accept, one ``scatter_``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .annealing import ArraySchedule, beta_row_indices, beta_table
from .bits import i64_to_u32, u32_from_numpy, u32_to_i64
from .coloring import Coloring
from .device import as_numpy, resolve_device
from .energy import energy as direct_energy
from .gibbs import init_spins
from .graph import IsingGraph
from .pbit import (FixedPoint, bitplane_planes, field_bound, flips_publish,
                   lfsr_init, lfsr_next, lfsr_uniform, lut_accept,
                   philox_init, philox_load, philox_save, philox_uniform,
                   quantize, quantize_couplings, threshold_lut_cached)
from repro_torch.engines.base import (RecordedCursor, run_recorded_driver,
                                      spawn_seeds, stack_states)
from repro_torch.kernels.bitplane_phase import PhaseSites, phase_sites

__all__ = ["PartitionedProblem", "build_partitioned", "ColorPhases",
           "DSIMEngine", "DSIMState"]

SyncSpec = Union[int, str, None]

_TENSORS = ("local_idx", "local_w", "local_h", "valid", "ghost_src",
            "global_ids", "bnd_slots", "bnd_mask", "ghost_src_packed")


@dataclasses.dataclass(frozen=True)
class PartitionedProblem:
    """Partitioned graph with shadow weights and ghost slots, on one
    device."""

    K: int
    n: int                        # global number of p-bits
    n_max: int                    # local slots per partition (padded)
    g_max: int                    # ghost slots per partition (padded)
    local_idx: torch.Tensor       # (K, n_max, D) int32 into [0, n_max + g_max)
    local_w: torch.Tensor         # (K, n_max, D) f32 (shadow weights included)
    local_h: torch.Tensor         # (K, n_max) f32
    valid: torch.Tensor           # (K, n_max) bool
    ghost_src: torch.Tensor       # (K, g_max) int32 flat into K * n_max
    global_ids: torch.Tensor      # (K, n_max) int32, padding -> n (dump slot)
    color_slots: tuple            # per color: (K, nc_max) int32 local slots
    color_mask: tuple             # per color: (K, nc_max) bool
    # boundary packing (for the distributed backend): slots each partition
    # must publish, and ghost_src re-indexed into the packed boundary pool
    bnd_slots: torch.Tensor       # (K, b_max) int32 local slots (pad 0)
    bnd_mask: torch.Tensor        # (K, b_max) bool
    ghost_src_packed: torch.Tensor  # (K, g_max) int32 flat into K * b_max
    labels: np.ndarray = dataclasses.field(compare=False)  # (N,) labels
    graph: IsingGraph = dataclasses.field(compare=False)

    @property
    def b_max(self) -> int:
        return int(self.bnd_slots.shape[1])

    @property
    def device(self) -> torch.device:
        return self.local_idx.device

    def to(self, device) -> "PartitionedProblem":
        device = torch.device(device)
        if self.device == device:
            return self
        moved = {f: getattr(self, f).to(device) for f in _TENSORS}
        return dataclasses.replace(
            self, **moved,
            color_slots=tuple(t.to(device) for t in self.color_slots),
            color_mask=tuple(t.to(device) for t in self.color_mask),
            graph=self.graph.to(device))


def build_partitioned(g: IsingGraph, coloring: Coloring, labels, K: int,
                      device=None) -> PartitionedProblem:
    """The partitioned problem of ``g`` cut by ``labels`` (N,) into K
    clusters, on ``device`` (the graph's unless given)."""
    idx, w, h = g.to_numpy()
    colors = coloring.colors
    n, dmax = idx.shape
    labels = np.asarray(as_numpy(labels), dtype=np.int32)
    if labels.shape != (n,):
        raise ValueError("labels shape mismatch")
    dev = g.device if device is None else resolve_device(device)

    locals_ = [np.nonzero(labels == k)[0] for k in range(K)]
    n_max = max(max(len(loc) for loc in locals_), 1)
    slot_of = np.zeros(n, dtype=np.int64)
    for k in range(K):
        slot_of[locals_[k]] = np.arange(len(locals_[k]))

    ghosts, g_sizes = [], []
    for k in range(K):
        rows = idx[locals_[k]]
        msk = w[locals_[k]] != 0
        nb = rows[msk]
        ext = np.unique(nb[labels[nb] != k])
        ghosts.append(ext)
        g_sizes.append(len(ext))
    g_max = max(max(g_sizes), 1)

    local_idx = np.zeros((K, n_max, dmax), dtype=np.int32)
    local_w = np.zeros((K, n_max, dmax), dtype=np.float32)
    local_h = np.zeros((K, n_max), dtype=np.float32)
    valid = np.zeros((K, n_max), dtype=bool)
    ghost_src = np.zeros((K, g_max), dtype=np.int32)
    global_ids = np.full((K, n_max), n, dtype=np.int32)

    for k in range(K):
        loc = locals_[k]
        nk = len(loc)
        valid[k, :nk] = True
        global_ids[k, :nk] = loc
        local_h[k, :nk] = h[loc]
        rows = idx[loc]                       # (nk, D)
        ww = w[loc]
        local_w[k, :nk] = ww
        ext = ghosts[k]
        # map neighbor ids: local -> slot, external -> n_max + ghost position
        is_ext = (labels[rows] != k) & (ww != 0)
        mapped = np.where(ww != 0, slot_of[rows], 0)
        if len(ext):
            gpos = np.searchsorted(ext, rows)
            gpos = np.clip(gpos, 0, len(ext) - 1)
            mapped = np.where(is_ext, n_max + gpos, mapped)
        local_idx[k, :nk] = mapped
        if len(ext):
            ghost_src[k, :len(ext)] = labels[ext] * n_max + slot_of[ext]

    # per-color slot lists
    color_slots, color_mask = [], []
    for c in range(coloring.n_colors):
        sizes = [int((colors[locals_[k]] == c).sum()) for k in range(K)]
        nc_max = max(max(sizes), 1)
        cs = np.zeros((K, nc_max), dtype=np.int32)
        cm = np.zeros((K, nc_max), dtype=bool)
        for k in range(K):
            sel = np.nonzero(colors[locals_[k]] == c)[0]
            cs[k, :len(sel)] = sel
            cm[k, :len(sel)] = True
        color_slots.append(cs)
        color_mask.append(cm)

    # boundary publication lists: slots of k referenced by any other partition
    referenced = np.zeros((K, n_max), dtype=bool)
    for k in range(K):
        ext = ghosts[k]
        referenced[labels[ext], slot_of[ext]] = True
    b_sizes = [int(referenced[k].sum()) for k in range(K)]
    b_max = max(max(b_sizes), 1)
    bnd_slots = np.zeros((K, b_max), dtype=np.int32)
    bnd_mask = np.zeros((K, b_max), dtype=bool)
    packed_pos = np.full((K, n_max), -1, dtype=np.int64)  # slot -> packed col
    for k in range(K):
        sl = np.nonzero(referenced[k])[0]
        bnd_slots[k, :len(sl)] = sl
        bnd_mask[k, :len(sl)] = True
        packed_pos[k, sl] = np.arange(len(sl))
    gk = ghost_src // n_max
    gs = ghost_src % n_max
    ghost_src_packed = (gk * b_max + packed_pos[gk, gs]).astype(np.int32)
    ghost_src_packed = np.where(ghost_src_packed < 0, 0, ghost_src_packed)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return PartitionedProblem(
        K=K, n=n, n_max=n_max, g_max=g_max,
        local_idx=t(local_idx), local_w=t(local_w), local_h=t(local_h),
        valid=t(valid), ghost_src=t(ghost_src), global_ids=t(global_ids),
        color_slots=tuple(t(a) for a in color_slots),
        color_mask=tuple(t(a) for a in color_mask),
        bnd_slots=t(bnd_slots), bnd_mask=t(bnd_mask),
        ghost_src_packed=t(ghost_src_packed),
        labels=labels, graph=g.to(dev))


@dataclasses.dataclass
class DSIMState:
    m: torch.Tensor       # (K, n_max) int8 local spins — (R, K, n_max) batched
    ghosts: torch.Tensor  # (K, g_max) f32 (instantaneous +-1 or CMFT means)
    macc: torch.Tensor    # (K, n_max) f32 window accumulator (CMFT)
    rng: torch.Tensor     # (K, n_max) uint32 LFSR states | (G,) uint8
                          # generator state bytes on the CPU (philox)
    sweep: torch.Tensor   # () int32
    flips: torch.Tensor   # () int32 uint32-modular odometer


@dataclasses.dataclass
class _Color:
    """One colour's constants for the partitions an engine holds, shaped to
    broadcast over the replica (or word-plane) axis of its layout: (1, K,
    nc) for the stacked engine's (R, K, n_max), (Kl, 1, nc) for the
    distributed one's (Kl, R, n_max)."""

    slots: torch.Tensor    # int64 local slots
    mask: torch.Tensor     # bool
    lost: Optional[torch.Tensor]  # bool: updates padding undoes
    nbr: Optional[torch.Tensor] = None  # (.., nc * D) int64 into n_max + g_max
    h: Optional[torch.Tensor] = None    # f32, or int32 on the int8 path
    w: Optional[torch.Tensor] = None    # (.., nc, D) f32 | int32
    # the bit-plane path: the fused colour phase's (Kl, nc) entries
    sites: Optional[PhaseSites] = None


class ColorPhases:
    """The colour phases both partitioned engines run: :class:`DSIMEngine`
    (every partition in one (R, K, n_max) stack) and :class:`repro_torch.
    core.dsim_dist.DistDSIMEngine` ((K, R, n_max), or one partition per
    rank).  ``_LANE_AXIS`` names the replica axis of the layout; an
    engine sets ``p``, ``device``, ``precision``, ``mode``, ``rng_kind``,
    ``fmt`` and ``_held`` (the partitions it holds), ``_graph`` (the
    whole graph on its device, which ``energy`` reads), and gives
    ``_exchange`` (boundary values -> ghosts in their dtype), ``_chunk``,
    ``global_spins`` and ``_lanes`` (the replica count of a state).

    A colour's padded slot entries point at slot 0 of their partition.
    The reference writes its phase's new spins with one scatter whose
    later (padding) entries rewrite slot 0's old spin, so where a
    partition has fewer sites of a colour than the widest, its slot 0
    keeps its spin in that colour's phase (its flip still counted), and
    its LFSR state steps once more in the phases of the colours it is not
    in.  The port writes the same values, one value per duplicate index
    (ROADMAP.md §C)."""

    _LANE_AXIS = 0
    health = None         # a degraded mesh engine's health monitor

    def _init_colors(self):
        """The colours' constants; on the fixed-point paths first the int8
        couplings (one per-problem scale), the field bound, and on the
        bit-plane path the sign / nonzero word planes per direction and
        the lane-independent LUT-column base.  All of them are built over
        every partition where the problem lies, so the scale and bound are
        global, and only the held partitions' rows reach the engine's
        device (:meth:`_color`)."""
        p = self.p
        home = p.device
        h_src, w_src, bp = p.local_h, p.local_w, None
        if self.precision != "f32":
            h_q, (w_q,), self.q_scale = quantize_couplings(p.local_h,
                                                           (p.local_w,))
            w_dirs = tuple(w_q[..., d] for d in range(w_q.shape[-1]))
            self.f_max = field_bound(h_q, w_dirs)
            self._lut_cache = {}
            h_src = torch.from_numpy(h_q.astype(np.int32)).to(home)
            w_src = torch.from_numpy(w_q.astype(np.int32)).to(home)
            if self.precision == "bitplane":
                # validates |w_q| <= 1
                signs, nz, base, _ = bitplane_planes(h_q, w_dirs)
                bp = (u32_from_numpy(np.stack(signs, -1), home),
                      u32_from_numpy(np.stack(nz, -1), home),
                      torch.from_numpy(base.astype(np.int64)).to(home))
        self._colors = [self._color(c, h_src, w_src, bp)
                        for c in range(len(p.color_slots))]

    def _color(self, c: int, h_src, w_src, bp) -> _Color:
        p, held, dev = self.p, self._held, self.device
        slots = p.color_slots[c].long()                       # (K, nc)
        mask = p.color_mask[c]
        K, nc = slots.shape
        rows = torch.arange(K, device=slots.device)[:, None]
        local = p.local_idx[rows, slots]                      # (K, nc, D)
        padded = ~mask.all(1, keepdim=True)
        lost = ((slots == 0) & mask & padded)[held].to(dev)

        def mine(t):    # the held partitions' rows, on the engine's device
            return t[held].to(dev)

        def lane(t):
            return mine(t).unsqueeze(self._LANE_AXIS)
        col = _Color(slots=lane(slots), mask=lane(mask),
                     lost=lost.unsqueeze(self._LANE_AXIS)
                     if bool(lost.any()) else None)
        if self.precision == "bitplane":
            signs, nz, base = bp

            def at(w):      # uint32 has no indexing on CUDA: int32 views
                return mine(w.view(torch.int32)[rows, slots]) \
                    .contiguous().view(torch.uint32)
            col.sites = phase_sites(
                mine(slots), mine(mask), None if col.lost is None else lost,
                mine(local), at(signs), at(nz), mine(base[rows, slots]))
        else:
            col.nbr = lane(local.reshape(K, -1).long())
            col.h = lane(h_src[rows, slots])
            col.w = lane(w_src[rows, slots])
        return col

    def _lut_for(self, table: np.ndarray) -> torch.Tensor:
        return threshold_lut_cached(self._lut_cache, table, self.q_scale,
                                    self.f_max, fmt=self.fmt,
                                    device=self.device)

    def _refresh(self, m) -> torch.Tensor:
        """Instantaneous boundary states -> ghosts: f32 +-1, or the words
        on the bit-plane path."""
        g = self._exchange(m)
        return g if self.precision == "bitplane" else g.to(torch.float32)

    # -- one colour phase ----------------------------------------------------------

    def _field(self, col: _Color, m, ghosts) -> torch.Tensor:
        """Fields of one colour, m's shape with nc sites: one gather over
        [local spins | ghosts] of every held partition (int32 on the int8
        path, where the ghosts are instantaneous +-1 states; f32
        otherwise)."""
        acc = col.w.dtype
        mext = torch.cat([m.to(acc), ghosts.to(acc)], dim=2)
        A, B = int(mext.shape[0]), int(mext.shape[1])
        nbr = torch.gather(mext, 2, col.nbr.expand(A, B, -1))
        return col.h + (col.w * nbr.reshape(
            A, B, int(col.slots.shape[-1]), -1)).sum(-1)

    def _phase(self, col: _Color, m, ghosts, s, gens, beta, thr):
        """Update one colour of every held partition and replica in place:
        m int8 spins, ghosts f32, s int64-carried LFSR states (or None, and
        ``gens`` the philox streams in the layout's order), all in the
        engine's layout.  ``beta`` a float (f32 path) or None with ``thr``
        the LUT row (int8 path).  Returns the flips (R,)."""
        field = self._field(col, m, ghosts)
        idx = col.slots.expand(field.shape)
        if gens is None:
            sc = lfsr_next(torch.gather(s, 2, idx))
            # padded entries step slot 0's state too, to the same value
            s.scatter_(2, idx, sc)
        else:
            r = philox_uniform(gens, tuple(field.shape[self._LANE_AXIS + 1:]),
                               self.device).reshape(field.shape)
        old = torch.gather(m, 2, idx)
        if thr is not None:
            new = lut_accept(thr, field, self.f_max, sc >> 8)
        else:
            if gens is None:
                r = lfsr_uniform(sc)
            new = torch.tanh(quantize(beta * field, self.fmt)) + r >= 0
        new = torch.where(new, 1, -1).to(torch.int8)
        new = torch.where(col.mask, new, old)
        flips = (new != old).sum((1 - self._LANE_AXIS, 2))
        if col.lost is not None:
            new = torch.where(col.lost, old, new)
        m.scatter_(2, idx, new)
        return flips

    # -- runners -------------------------------------------------------------------

    def _iteration(self, m, ghosts, macc, s, gens, sched_S, sync: SyncSpec,
                   S_t, lut, exchange=None):
        """S sweeps then one boundary exchange (or one per phase, or
        none); ``sched_S`` the S betas or LUT rows; ``exchange(m, ghosts)
        -> ghosts`` replaces the end-of-iteration exchange (the checked
        one of a degraded mesh).  Updates m, s and gens in place; returns
        (ghosts, macc, flips)."""
        word = self.precision == "bitplane"
        cmft = self.mode == "cmft"
        flips = None
        for b in sched_S:
            thr = None if lut is None or word else lut[int(b)]
            beta = None if lut is not None else float(b)
            for col in self._colors:
                if sync == "phase":
                    ghosts = self._refresh(m)
                if word:
                    flips = self._phase_w(col, m, ghosts, s, lut, int(b),
                                          flips)
                    continue
                f = self._phase(col, m, ghosts, s, gens, beta, thr)
                flips = f if flips is None else flips + f
            if cmft:
                # dsim mode never reads the window accumulator
                macc = macc + m.to(torch.float32)
        if exchange is not None:
            ghosts = exchange(m, ghosts)
        elif sync not in ("phase", None):
            ghosts = self._exchange(macc / S_t) if cmft else self._refresh(m)
        if cmft:
            macc = torch.zeros_like(macc)
        return ghosts, macc, flips

    def _sweeps(self, m, ghosts, macc, rng, sched2d: np.ndarray,
                sync: SyncSpec, lut, exchange=None):
        """``iters`` iterations of S sweeps on the engine's layout (m
        updated in place); sched2d (iters, S) f32 betas or int32 LUT rows
        (with ``lut`` the threshold table).  Returns (m, ghosts, macc,
        rng, flips (R,) int64)."""
        lfsr = self.rng_kind == "lfsr"
        s = u32_to_i64(rng) if lfsr else None
        gens = None if lfsr else philox_load(rng.reshape(-1, rng.shape[-1]),
                                             self.device)
        thr = None if lut is None else u32_to_i64(lut)
        iters, S = sched2d.shape
        S_t = torch.full((), float(S), dtype=torch.float32,
                         device=self.device)
        flips = torch.zeros(int(rng.shape[self._LANE_AXIS]),
                            dtype=torch.int64, device=self.device)
        for it in range(iters):
            ghosts, macc, f = self._iteration(m, ghosts, macc, s, gens,
                                              sched2d[it], sync, S_t, thr,
                                              exchange)
            flips = flips + f
        rng = i64_to_u32(s) if lfsr else philox_save(gens).reshape(rng.shape)
        return m, ghosts, macc, rng, flips

    def run_recorded_full(self, state: DSIMState, schedule,
                          record_points: Sequence[int],
                          sync_every: SyncSpec = 1, cursor: bool = False):
        """Shared-driver runner; returns (state, RunRecord), or the
        resumable :class:`RecordedCursor` with ``cursor=True``.  Record
        points are quantized to multiples of S."""
        sync = sync_every if sync_every in ("phase", None) else int(sync_every)
        if self.health is not None:
            if sync in ("phase", None):
                raise ValueError("degrade policies need an integer "
                                 "sync_every (one checked exchange per S "
                                 "sweeps)")
            self.health.reset()
        lut = None
        if self.precision != "f32":
            # the staircase becomes LUT row indices (beta is in the table)
            beta_arr = np.asarray(schedule.beta_array(), np.float32)
            table = beta_table(beta_arr)
            lut = self._lut_for(table)
            schedule = ArraySchedule(beta_row_indices(beta_arr, table))

        def chunk(st, sched2d, iters, S):
            return self._chunk(st, np.asarray(sched2d), sync, lut)

        kw = dict(
            state=state, schedule=schedule, record_points=record_points,
            chunk_fn=chunk, record_fn=self.energy, sync_every=sync_every,
            flips_of=lambda st: st.flips,
            flips_per_sweep=self.p.n * self._lanes(state),
            warm_scope=None if self.health is None else self.health.quiet)
        if cursor:
            return RecordedCursor(**kw)
        return run_recorded_driver(**kw)

    def run_recorded(self, state: DSIMState, schedule,
                     record_points: Sequence[int],
                     sync_every: SyncSpec = 1):
        """Run to each record point; returns (state, RunRecord)."""
        return self.run_recorded_full(state, schedule, record_points,
                                      sync_every=sync_every)

    def energy(self, state: DSIMState) -> torch.Tensor:
        """True global energies of the current configuration, (R,) or ()."""
        return direct_energy(self._graph, self.global_spins(state))


class DSIMEngine(ColorPhases):
    """Partitioned chromatic Gibbs sampler, every partition on one device
    (CUDA unless ``device="cpu"``), the state stacked (R, K, n_max).

    ``precision="int8"`` runs the hardware's fixed-point pipeline: local
    couplings and biases quantized to int8 at init (one per-problem
    scale), int32 fields, and the accept one compare of the raw 24-bit
    LFSR draw against a per-(beta, field) threshold LUT
    (:func:`repro_torch.core.pbit.lut_accept`); staircases become LUT
    row indices.  Requires ``rng='lfsr'`` and ``mode='dsim'``; ``fmt``
    folds into the LUT."""

    def __init__(self, prob: PartitionedProblem, rng: str = "philox",
                 fmt: Optional[FixedPoint] = None, mode: str = "dsim",
                 precision: str = "f32", device=None):
        if mode not in ("dsim", "cmft"):
            raise ValueError(f"unknown mode {mode!r}")
        if rng not in ("philox", "lfsr"):
            raise ValueError(f"unknown rng {rng!r}")
        if precision not in ("f32", "int8"):
            raise ValueError(f"unknown precision {precision!r}")
        if precision == "int8" and (rng != "lfsr" or mode != "dsim"):
            # the fixed-point path is the hardware pipeline: per-p-bit LFSRs
            # (the LUT thresholds the raw 24-bit draw) and instantaneous +-1
            # ghosts (cmft's fractional window-means don't fit integer fields)
            raise ValueError("precision='int8' needs rng='lfsr', mode='dsim'")
        self.device = resolve_device(device)
        self.p = p = prob.to(self.device)
        self.rng_kind = rng
        self.fmt = fmt
        self.mode = mode
        self.precision = precision
        self.n_sites = p.n
        self._held = slice(0, p.K)
        self._init_colors()
        self._ghost_src = p.ghost_src.reshape(-1).long()
        self._global_ids = p.global_ids.reshape(-1).long()
        self._graph = p.graph

    # -- state -----------------------------------------------------------------

    def init_state(self, seed: int = 0, m0: Optional[np.ndarray] = None,
                   replicas: Optional[int] = None,
                   seeds: Optional[Sequence[int]] = None) -> DSIMState:
        """Fresh state; ``replicas=R`` stacks R chains seeded by
        ``spawn_seeds(seed, R)``, ``seeds=[...]`` one chain per explicit
        seed.  Without ``m0`` the (n,) spins are
        :func:`repro_torch.core.gibbs.init_spins` of the chain's seed;
        padding slots hold +1, as the reference's from an ``m0``."""
        if seeds is not None:
            return stack_states([self.init_state(int(s), m0=m0)
                                 for s in seeds])
        if replicas is not None:
            return stack_states([self.init_state(s, m0=m0)
                                 for s in spawn_seeds(seed, replicas)])
        p, dev = self.p, self.device
        mg = init_spins(seed, p.n) if m0 is None else \
            np.asarray(as_numpy(m0), dtype=np.int8)
        m = np.ones((p.K, p.n_max), dtype=np.int8)
        gid = as_numpy(p.global_ids)
        ok = gid < p.n
        m[ok] = mg[gid[ok]]
        m = torch.from_numpy(m).to(dev)
        rng = philox_init(seed, dev) if self.rng_kind == "philox" else \
            u32_from_numpy(lfsr_init(p.K * p.n_max, seed).reshape(
                p.K, p.n_max), dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return DSIMState(m=m, ghosts=self._refresh(m[None])[0],
                         macc=torch.zeros((p.K, p.n_max), dtype=torch.float32,
                                          device=dev),
                         rng=rng, sweep=zero, flips=zero.clone())

    @staticmethod
    def is_batched(state: DSIMState) -> bool:
        return state.m.dim() == 3

    def _lanes(self, state: DSIMState) -> int:
        return int(state.m.shape[0]) if self.is_batched(state) else 1

    def _exchange(self, x) -> torch.Tensor:
        """Boundary values (R, K, n_max) -> ghost slots (R, K, g_max) in
        x's dtype: instantaneous spins (DSIM) or window means (CMFT)."""
        R = x.shape[0]
        return x.reshape(R, -1).index_select(1, self._ghost_src).reshape(
            R, self.p.K, self.p.g_max)

    def _chunk(self, state: DSIMState, sched2d: np.ndarray, sync: SyncSpec,
               lut=None) -> DSIMState:
        """``iters`` iterations of S sweeps; sched2d (iters, S) f32 betas
        or int32 LUT rows (with ``lut`` the threshold table)."""
        batched = self.is_batched(state)
        lift = (lambda t: t) if batched else (lambda t: t[None])
        drop = (lambda t: t) if batched else (lambda t: t[0])
        m, ghosts, macc, rng, flips = self._sweeps(
            lift(state.m).clone(), lift(state.ghosts), lift(state.macc),
            lift(state.rng), sched2d, sync, lut)
        iters, S = sched2d.shape
        return DSIMState(
            m=drop(m), ghosts=drop(ghosts), macc=drop(macc), rng=drop(rng),
            sweep=state.sweep + iters * S,
            flips=flips_publish(state.flips, drop(flips)))

    # -- observables ----------------------------------------------------------------

    def _scatter_global(self, vals: torch.Tensor, fill) -> torch.Tensor:
        """(..., K, n_max) per-slot values -> (..., n) in node order
        (padding slots land in a dropped dump entry)."""
        lead = vals.shape[:-2]
        buf = torch.full((*lead, self.p.n + 1), fill, dtype=vals.dtype,
                         device=vals.device)
        buf.index_copy_(-1, self._global_ids,
                        vals.reshape(*lead, -1))
        return buf[..., :self.p.n]

    def global_spins(self, state: DSIMState) -> torch.Tensor:
        """(n,) spins in node order, or (R, n) for a batched state."""
        return self._scatter_global(state.m, 1)

    def local_fields_check(self, state: DSIMState) -> torch.Tensor:
        """Global-layout local fields as the partitions see them (tests)."""
        p = self.p
        lead = state.m.shape[:-2]
        mext = torch.cat([state.m.to(torch.float32), state.ghosts], dim=-1)
        flat = mext.reshape(*lead, -1)
        rows = torch.arange(p.K, device=self.device)[:, None, None]
        nbr = flat.index_select(
            -1, (rows * (p.n_max + p.g_max) + p.local_idx.long()).reshape(-1))
        nbr = nbr.reshape(*lead, *p.local_idx.shape)
        f = p.local_h + (p.local_w * nbr).sum(-1)
        return self._scatter_global(f, 0.0)
