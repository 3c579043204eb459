"""Lattice DSIM: the brick-partitioned EA3D lattice on one GPU or one
brick per rank.

Port of ``repro.core.lattice_dsim.LatticeDSIM`` at ``precision="f32"``,
``"int8"`` and ``"bitplane"``.  With no mesh the engine is one brick: its
state holds the whole lattice in the reference's shapes.  With a mesh
(:func:`repro_torch.core.mesh.make_mesh`) and ``dim_axes`` naming the mesh
axis of each lattice dimension, the lattice is cut into bricks
(``core/bricks.py``): all of them in this process on one device, or one
per rank of a ``torch.distributed`` group; the state is then a
:class:`BrickState`, brick-major, and :meth:`LatticeDSIM.global_state` /
:meth:`LatticeDSIM.shard_state` convert to and from the reference's global
shapes.  On a mesh the problem and the initial state are cut where they
were built (the host, as a rule) and only the bricks held here move to the
engine's device, as the reference places each device's shard: a rank
holds its brick's constants, never the whole lattice's.

Each chunk iteration runs ``sync_every`` sweeps of every brick against
its halos held fixed (one fused sweep call per brick, or on the per-phase
path, ``fused=False`` or ``kernel_bx``, one single-phase call per color
and brick), then one halo exchange: x and y are open chains and z is a
periodic ring, so one brick alone sees zero x and y halos and its own
opposite z face, as of the last exchange.  Flips and record-point energies
are summed over the bricks (the reference's ``psum``).

Replicas ride a leading axis R; on the bit-plane path they are the bit
lanes of W = ceil(R / 32) stacked uint32 word planes, lane (w, b)
bit-identical to int8 replica w*32+b.

With ``degrade=`` (a :class:`repro_torch.core.degrade.DegradePolicy` or
its string form) every exchange runs checked (``core/bricks.py``): a face
that fails its header is held at its last good plane, the six faces are
the health monitor's sources, the carry stays on the device through a
chunk and the host reads it once per chunk (:attr:`LatticeDSIM.health`).
:meth:`LatticeDSIM.set_exchange_faults` injects drops and corruptions on
the received planes, :meth:`LatticeDSIM.resync` refreshes every halo.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .annealing import ArraySchedule, beta_row_indices, beta_table
from .bits import i64_to_i32, u32_from_numpy, u32_to_i64
from .bricks import (BrickState, GatherExchange, GroupExchange,
                     brick_coords, cut, join)
from .degrade import (DegradePolicy, MeshHealthMonitor, carry_max,
                      carry_to_device)
from .device import as_numpy, resolve_device
from .lattice import LatticeProblem
from .packing import LANE_WIDTH, pack_lanes, unpack_lanes
from .pbit import (FixedPoint, LUT_SELECT_MAX_WIDTH, bitplane_planes,
                   field_bound, flips_publish, lfsr_init, quantize_couplings,
                   threshold_lut_cached)
from repro_torch.engines.base import (RecordedCursor, check_lanes,
                                      run_recorded_driver, spawn_seeds,
                                      trace_chunk)
from repro_torch.kernels.ops import (brick_energy_op, brick_energy_words_op,
                                     pbit_bitplane_sweep_op,
                                     pbit_sweep_int_op, pbit_sweep_op,
                                     pbit_update_int_op, pbit_update_op,
                                     resolve_impl)
from repro_torch.obs.trace import region

__all__ = ["LatticeDSIM", "LatticeState", "BitplaneLatticeState",
           "BrickState", "join_bricks", "to_device"]


@dataclasses.dataclass
class LatticeState:
    m: torch.Tensor       # (R, X, Y, Z) int8
    s: torch.Tensor       # (R, X, Y, Z) uint32 LFSR states
    halos: tuple          # 6 planes: (R,1,Y,Z) x2, (R,X,1,Z) x2, (R,X,Y,1) x2
    sweep: torch.Tensor   # scalar int32
    flips: torch.Tensor   # (R,) int32 modular odometers

    @property
    def replicas(self) -> int:
        return int(self.m.shape[0])


@dataclasses.dataclass
class BitplaneLatticeState:
    """Multi-spin-coded state: bit b of word plane w of ``m`` is lane
    w*32+b's spin (1 = +1); LFSR columns and flip odometers keep an
    explicit lane axis."""

    m: torch.Tensor       # (W, X, Y, Z) uint32 stacked spin word planes
    s: torch.Tensor       # (R, X, Y, Z) uint32 per-lane LFSR states
    halos: tuple          # 6 word halo planes with a leading W axis
    sweep: torch.Tensor   # scalar int32
    flips: torch.Tensor   # (R,) int32 per-lane modular odometers

    @property
    def replicas(self) -> int:
        return int(self.s.shape[0])


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """Move a tensor, uint32 through its int32 view (every device copies
    that)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(device).view(torch.uint32)
    return t.to(device)


def join_bricks(st: BrickState, coords=None):
    """A :class:`BrickState` holding every brick of its mesh (bricks in
    row-major order, or at ``coords``) -> the reference's global state, a
    ``LatticeState`` or (word planes) ``BitplaneLatticeState``."""
    coords = brick_coords(st.nb) if coords is None else list(coords)
    if len(coords) != int(st.m.shape[0]):
        raise ValueError(f"a state of {int(st.m.shape[0])} bricks cannot "
                         f"be joined into a mesh of {len(coords)}; over a "
                         f"process group use the engine's global_state")
    brick = tuple(int(e) for e in st.m.shape[2:])
    m, s = (join(t, brick, coords, st.nb) for t in (st.m, st.s))
    halos = tuple(join(h, brick, coords, st.nb, d // 2)
                  for d, h in enumerate(st.halos))
    cls = BitplaneLatticeState if st.m.dtype == torch.uint32 \
        else LatticeState
    return cls(m=m, s=s, halos=halos, sweep=st.sweep, flips=st.flips)


def _stack(ts) -> torch.Tensor:
    """Brick results -> one brick-major tensor (a view for one brick)."""
    if len(ts) == 1:
        return ts[0][None]
    if ts[0].dtype == torch.uint32:
        return torch.stack([t.view(torch.int32) for t in ts]).view(
            torch.uint32)
    return torch.stack(ts)


# the fixed-point constants of the int8 and bit-plane paths, each a
# (..., X, Y, Z) tensor or a tuple of them, as the engine and its bricks
# name them
_FIXED = ("h_q", "w6_q", "masks_w", "signs6_w", "nz6_w", "base_w")


@dataclasses.dataclass
class _Brick:
    """One brick's problem constants, cut once at construction."""

    masks: torch.Tensor
    h: torch.Tensor
    w6: tuple
    active: torch.Tensor
    h_q: Optional[torch.Tensor] = None
    w6_q: Optional[tuple] = None
    masks_w: Optional[torch.Tensor] = None
    signs6_w: Optional[tuple] = None
    nz6_w: Optional[tuple] = None
    base_w: Optional[torch.Tensor] = None


class LatticeDSIM:
    """Lattice engine, ``precision`` "f32", "int8" or "bitplane".

    f32 (the reference's default): f32 fields and ``tanh(beta * field) +
    r >= 0``, ``fmt`` rounding the activation.  int8: couplings quantized
    to int8 at init with one per-problem scale, int32 fields, and the
    uint32 LFSR draw compared against a per-(beta, field) threshold LUT;
    staircases become LUT row indices and ``fmt`` folds into the LUT.
    bitplane: the int8 pipeline multi-spin coded.  ``fused=False`` or
    ``kernel_bx`` (the reference's x tile, which forces per-phase) runs
    one single-phase kernel per color instead of the fused sweep, bitwise
    the same; the bit-plane path has only its word sweep.  ``impl`` picks
    the kernels ("auto": CUDA kernels on a CUDA device, plain PyTorch on
    the CPU; "ref" forces the plain versions).

    ``mesh`` and ``dim_axes`` (the mesh axis name, or None, of each of
    x, y, z) partition the lattice into bricks; every extent must divide
    by its brick count.  ``bitpack_halos`` is the reference's 1-bit halo
    wire of the int8 and f32 paths: it ships :func:`pack_pm1` bytes over a
    process group, and in both forms makes the outer x and y faces of an
    axis of several bricks read -1 (``core/bricks.py``).  ``device`` is
    the engine's device (default CUDA), and a one-process mesh's."""

    def __init__(self, prob: LatticeProblem, fmt: Optional[FixedPoint] = None,
                 impl: str = "auto", replicas: int = 1,
                 precision: str = "f32", fused: bool = True,
                 kernel_bx: Optional[int] = None, device=None, mesh=None,
                 dim_axes=None, bitpack_halos: bool = True,
                 degrade=None):
        if precision not in ("f32", "int8", "bitplane"):
            raise ValueError(f"unknown precision {precision!r}")
        if precision == "bitplane" and kernel_bx is not None:
            raise ValueError("kernel_bx (per-phase x-tiling) is not "
                             "available on the bitplane path")
        if mesh is not None and dim_axes is None:
            raise ValueError("pass dim_axes when passing a mesh")
        self.device = resolve_device(device)
        resolve_impl(impl, self.device.type == "cuda")
        # one brick is the whole problem and lives on the engine's device;
        # on a mesh the caller's problem stays where it was built (the
        # reference's ``self.p = prob``) and only the bricks held here move
        self.p = prob.to(self.device) if mesh is None else prob
        self.fmt = fmt
        self.impl = impl
        self.precision = precision
        self.replicas = int(replicas)
        self.words = check_lanes(precision, self.replicas)
        self.n_sites = prob.n_active
        self.kernel_bx = kernel_bx
        self.bitpack_halos = bool(bitpack_halos)
        # the fused-vs-per-phase decision: x-tiling forces per-phase, as in
        # the reference; its VMEM-budget fallback is a TPU fact, not ported
        self.fused_requested = bool(fused)
        self.fallback_reason = None
        self.fused = precision == "bitplane" or bool(fused)
        if self.fused and precision != "bitplane" and kernel_bx is not None:
            self.fused, self.fallback_reason = False, "kernel_bx"
        self._lut_cache = {}
        if precision == "f32":
            self.h_q = self.w6_q = None
            self.q_scale, self.f_max = 1.0, 0
        else:
            self._fixed_point_constants(prob)
        self._partition(mesh, dim_axes)
        # the degraded-mode fabric: the six faces are the sources
        self.degrade = DegradePolicy.parse(degrade)
        self.health = MeshHealthMonitor(self.degrade, 6, kind="faces") \
            if self.degrade is not None else None
        self._fault_codes = None

    def _fixed_point_constants(self, prob: LatticeProblem):
        """Quantized couplings and, on the bit-plane path, its word
        planes and lane-masked color masks, built on the host over the
        whole problem as numpy arrays (the reference's form): one
        per-problem scale and field bound, so every brick reads the same
        LUT.  :meth:`_partition` cuts and places them; with no mesh the
        engine's attributes become its one brick's device tensors."""
        precision = self.precision
        self.h_q, self.w6_q, self.q_scale = quantize_couplings(prob.h,
                                                               prob.w6)
        self.f_max = field_bound(self.h_q, self.w6_q)
        if precision == "bitplane":
            # the word path keeps the reference's LUT-width cap (its accept
            # is the rank-count form on every impl there)
            if 2 * self.f_max + 1 > LUT_SELECT_MAX_WIDTH:
                raise ValueError(
                    f"precision={precision!r} needs a threshold LUT row of "
                    f"<= {LUT_SELECT_MAX_WIDTH} entries (gather-free "
                    f"rank-count accept); this problem quantizes to "
                    f"f_max={self.f_max} (width {2 * self.f_max + 1}).  "
                    f"Use impl='ref' with precision='int8' or coarser "
                    f"couplings.")
            self.signs6_w, self.nz6_w, self.base_w, _ = bitplane_planes(
                self.h_q, self.w6_q)
            # lane-masked color masks: lanes >= R (only ever in the LAST
            # word plane) never update
            W = self.words
            last = self.replicas - (W - 1) * LANE_WIDTH
            lane_masks = np.full((W,), 0xFFFFFFFF, np.uint64)
            lane_masks[-1] = (1 << last) - 1 if last < LANE_WIDTH \
                else 0xFFFFFFFF
            mk = as_numpy(prob.masks)            # (n_colors, X, Y, Z)
            self.masks_w = np.where(
                mk[:, None] != 0,
                lane_masks.astype(np.uint32)[None, :, None, None, None],
                0).astype(np.uint32)

    def _partition(self, mesh, dim_axes):
        """Brick counts and the bricks this process holds, their problem
        constants, and the exchange."""
        self.mesh = mesh
        self.dim_axes = None if mesh is None else tuple(dim_axes)
        self.group = None if mesh is None else mesh.group
        if mesh is None:
            self.nb = (1, 1, 1)
        else:
            if len(self.dim_axes) != 3:
                raise ValueError(f"dim_axes names the mesh axis of x, y and "
                                 f"z, got {dim_axes!r}")
            self.nb = tuple(1 if a is None else int(mesh.shape[a])
                            for a in self.dim_axes)
        for d, (ext, k) in enumerate(zip(self.p.dims, self.nb)):
            if ext % k != 0:
                raise ValueError(f"dim {d} extent {ext} not divisible by "
                                 f"mesh factor {k}")
        self.brick = tuple(e // k for e, k in zip(self.p.dims, self.nb))
        if self.group is None:
            self.coords = brick_coords(self.nb)
        else:
            self.coords = [self._rank_coord(mesh.coords(
                self._group_rank()))]
        self._bricks = [self._brick_consts(c) for c in self.coords]
        if mesh is None:
            # the engine's fixed-point constants are its one brick's, on
            # the device; on a mesh they stay whole numpy arrays on the host
            for f in _FIXED:
                if getattr(self, f, None) is not None:
                    setattr(self, f, getattr(self._bricks[0], f))
        self._exchangers = {}
        self._exchange_only_fn = None

    # -- the partition -----------------------------------------------------

    def _group_rank(self) -> int:
        import torch.distributed as dist
        return dist.get_rank(self.group)

    def _rank_coord(self, mc: dict) -> tuple:
        used = {a for a in self.dim_axes if a is not None}
        idle = [a for a, k in self.mesh.shape.items()
                if a not in used and k > 1]
        if idle:
            raise ValueError(f"over a process group every mesh axis must "
                             f"cut the lattice; {idle} name none of x, y, z")
        return tuple(0 if a is None else mc[a] for a in self.dim_axes)

    def _cut(self, t: torch.Tensor, axis=None) -> torch.Tensor:
        return cut(t, self.brick, self.coords, axis)

    def _brick_consts(self, c) -> _Brick:
        """Brick ``c``'s problem constants on the engine's device: with no
        mesh the problem's own tensors (the brick is the problem), on a
        mesh each (..., X, Y, Z) constant's block, cut where the constant
        lies and then moved."""
        def one(t):
            if isinstance(t, tuple):
                return tuple(one(x) for x in t)
            if isinstance(t, np.ndarray):       # a view, not a copy
                t = torch.from_numpy(t.view(np.int32)).view(torch.uint32) \
                    if t.dtype == np.uint32 else torch.from_numpy(t)
            if self.mesh is not None:
                lead = tuple(t.shape[:-3])
                flat = t.reshape((-1,) + tuple(t.shape[-3:]))
                t = cut(flat, self.brick, [c])[0].reshape(lead + self.brick)
            return to_device(t, self.device)
        p = self.p
        src = dict(masks=p.masks, h=p.h, w6=p.w6, active=p.active)
        src.update({f: getattr(self, f) for f in _FIXED
                    if getattr(self, f, None) is not None})
        return _Brick(**{f: one(t) for f, t in src.items()})

    def _neighbor_ranks(self):
        """(-1 neighbour, +1 neighbour) global ranks along each lattice
        axis: x and y open chains, z a ring; None where there is none."""
        import torch.distributed as dist
        me = self.mesh.coords(self._group_rank())
        peers = []
        for a, name in enumerate(self.dim_axes):
            pair = []
            for step in (-1, 1):
                if name is None or self.nb[a] == 1:
                    pair.append(None)
                    continue
                mc = dict(me)
                mc[name] += step
                if a == 2:
                    mc[name] %= self.nb[a]
                if not 0 <= mc[name] < self.nb[a]:
                    pair.append(None)
                    continue
                r = int(np.ravel_multi_index(
                    [mc[n] for n in self.mesh.axis_names], self.mesh.sizes))
                pair.append(dist.get_global_rank(self.group, r)
                            if self.group is not dist.group.WORLD else r)
            peers.append(tuple(pair))
        return peers

    def _sum_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks of a process-group mesh (the reference's
        ``psum``); identity in one process."""
        if self.group is None:
            return t
        import torch.distributed as dist
        dist.all_reduce(t, group=self.group)
        return t

    def _sum_flips(self, local: torch.Tensor) -> torch.Tensor:
        """A chunk's (R,) flips (int64 in [0, 2^32)) summed over the ranks
        mod 2^32, on the wire as the reference's uint32 ``psum``: 4 bytes
        per replica, through the int32 view (a two's-complement sum wraps
        as the unsigned one does)."""
        if self.group is None:
            return local
        return u32_to_i64(self._sum_ranks(i64_to_i32(local)))

    @property
    def kernel_path(self) -> str:
        """The update dispatch that runs: "fused", "per_phase" or
        "bitplane" (the multi-spin-coded word sweep)."""
        if self.precision == "bitplane":
            return "bitplane"
        return "fused" if self.fused else "per_phase"

    def _lut_for(self, table: np.ndarray) -> torch.Tensor:
        return threshold_lut_cached(self._lut_cache, table, self.q_scale,
                                    self.f_max, fmt=self.fmt,
                                    device=self.device)

    # -- halo plumbing ---------------------------------------------------------

    def _exchanger(self, lead: int, dtype):
        """The exchange of brick-major spins or words (K, lead, bx, by, bz):
        called, it returns a halo buffer whose ``planes`` are the six
        (K, lead, A, B) halo planes and whose ``bricks`` are each brick's
        six (lead, A, B) planes.  Built once per (lead, dtype)."""
        ex = self._exchangers.get((lead, dtype))
        if ex is None:
            fill = -1 if self.bitpack_halos and dtype == torch.int8 else 0
            if self.group is None:
                ex = GatherExchange(self.nb, self.brick, lead, fill, dtype,
                                    self.device)
            else:
                ex = GroupExchange(self.group, self._neighbor_ranks(),
                                   self.brick, lead, self.nb,
                                   self.bitpack_halos, dtype)
            self._exchangers[(lead, dtype)] = ex
        return ex

    @staticmethod
    def _squeeze(halos):
        """Stored (lead, 1, Y, Z)-style planes -> the kernels' (lead, Y, Z)
        views."""
        xlo, xhi, ylo, yhi, zlo, zhi = halos
        return (xlo[:, 0], xhi[:, 0], ylo[:, :, 0], yhi[:, :, 0],
                zlo[..., 0], zhi[..., 0])

    def _state_halos(self, ex, buf) -> tuple:
        """A halo buffer -> the halos in the state's form: brick-major on a
        mesh, (lead, 1, Y, Z)-style planes for one brick."""
        if self.mesh is not None:
            return ex.planes(buf)
        return tuple(h.unsqueeze(d // 2 + 1)
                     for d, h in enumerate(ex.bricks(buf)[0]))

    def _brick_halos(self, halos) -> list:
        """Halos in the state's form -> each brick's six planes as its
        kernels read them."""
        if self.mesh is not None:
            return list(zip(*(h.unbind(0) for h in halos)))
        return [self._squeeze(halos)]

    def _bricks_of(self, t: torch.Tensor) -> torch.Tensor:
        """A state's spins or states as (K, lead, bx, by, bz)."""
        return t if self.mesh is not None else t[None]

    def _exchange(self, m: torch.Tensor):
        """The halos of spins or words ``m`` in the state's form: of one
        brick (lead, X, Y, Z) -> (lead, 1, Y, Z)-style planes; on a mesh
        brick-major."""
        mb = self._bricks_of(m)
        ex = self._exchanger(int(mb.shape[1]), mb.dtype)
        with region("repro_torch.engine.exchange"):
            buf = ex(mb)
        return self._state_halos(ex, buf)

    def _refresh_halos(self, st):
        return dataclasses.replace(st, halos=self._exchange(st.m))

    def boundary_exchange_fn(self):
        """The exchange alone, ``fn(state) -> halos`` on live state: the
        measured-η probe (``obs.EtaMeter.measure_exchange`` times it).
        Cached, and dropped by :meth:`shard_state`."""
        if self._exchange_only_fn is None:
            self._exchange_only_fn = \
                lambda st: self._refresh_halos(st).halos  # noqa: E731
        return self._exchange_only_fn

    # -- state layout ----------------------------------------------------------

    def shard_state(self, st):
        """A state in the reference's global shapes, on any device -> the
        engine's: on its device, and on a mesh cut into the bricks held
        here first, so only those move."""
        self._exchange_only_fn = None
        with region("repro_torch.entry.shard_state"):
            return self._place(st)

    def _place(self, st, pack: bool = False):
        """:meth:`shard_state`'s move; ``pack`` packs a ``LatticeState``'s
        int8 spins into word planes once they are on the device, brick by
        brick on a mesh."""
        mv = lambda t: to_device(t, self.device)  # noqa: E731
        cls = BitplaneLatticeState if pack else type(st)
        if self.mesh is None:
            m = mv(st.m)
            return cls(m=pack_lanes(m) if pack else m, s=mv(st.s),
                       halos=tuple(mv(h) for h in st.halos),
                       sweep=mv(st.sweep), flips=mv(st.flips))
        m = mv(self._cut(st.m))
        if pack:
            m = _stack([pack_lanes(x) for x in m.unbind(0)])
        return BrickState(
            m=m, s=mv(self._cut(st.s)),
            halos=tuple(mv(self._cut(h, d // 2))
                        for d, h in enumerate(st.halos)),
            sweep=mv(st.sweep), flips=mv(st.flips), nb=self.nb)

    def global_state(self, st):
        """The engine's state in the reference's global shapes (a
        ``LatticeState`` or ``BitplaneLatticeState``); over a process
        group every rank calls it and receives the whole lattice."""
        if self.mesh is None:
            return st
        if self.group is None:
            return join_bricks(st, self.coords)
        import torch.distributed as dist
        world = self.mesh.size
        parts = []
        for t in (st.m, st.s) + tuple(st.halos):
            x = t.view(torch.int32) if t.dtype == torch.uint32 else t
            bufs = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(bufs, x.contiguous(), group=self.group)
            y = torch.cat(bufs)
            parts.append(y.view(torch.uint32) if t.dtype == torch.uint32
                         else y)
        whole = BrickState(m=parts[0], s=parts[1], halos=tuple(parts[2:]),
                           sweep=st.sweep, flips=st.flips, nb=self.nb)
        return join_bricks(whole, [self._rank_coord(self.mesh.coords(r))
                                   for r in range(world)])

    def init_state(self, seed: int = 0,
                   seeds: Optional[Sequence[int]] = None):
        """Fresh state; ``seeds=[...]`` (length R) seeds every replica
        explicitly (replica r's trajectory depends only on seeds[r]).
        Spins and LFSR states are drawn for the whole lattice and then cut
        into bricks on the host, so a brick's states are its slice of
        ``lfsr_init(X*Y*Z, seed)`` and only the bricks held here move."""
        X, Y, Z = self.p.dims
        R = self.replicas
        if seeds is not None:
            seeds = [int(s) for s in seeds]
            if len(seeds) != R:
                raise ValueError(f"need exactly R={R} seeds, got {len(seeds)}")
        else:
            seeds = [seed] if R == 1 else spawn_seeds(seed, R)
        ms, ss = [], []
        for sd in seeds:
            rng = np.random.default_rng(sd)
            ms.append(rng.choice(np.array([-1, 1], np.int8), size=(X, Y, Z)))
            ss.append(lfsr_init(X * Y * Z, sd).reshape(X, Y, Z))
        st = LatticeState(m=torch.from_numpy(np.stack(ms)),
                          s=u32_from_numpy(np.stack(ss), "cpu"), halos=(),
                          sweep=torch.zeros((), dtype=torch.int32),
                          flips=torch.zeros((R,), dtype=torch.int32))
        self._exchange_only_fn = None
        st = self._place(st, pack=self.precision == "bitplane")
        # one refreshing exchange so the first sweeps see real halos
        return self._refresh_halos(st)

    # -- runners ---------------------------------------------------------------

    def _sweeps(self, b: _Brick, m, s, sched, halos, lut):
        """S sweeps of every replica of brick ``b`` against fixed halos;
        ``sched`` (S,) or (S, R), f32 betas or int32 LUT rows.  Returns
        (m, s, flips)."""
        if self.precision == "bitplane":
            return pbit_bitplane_sweep_op(
                m, s, sched, b.masks_w, b.signs6_w, b.nz6_w, b.base_w, halos,
                lut, impl=self.impl)
        f32 = self.precision == "f32"
        if self.fused:
            if f32:
                return pbit_sweep_op(m, s, sched, b.masks, b.h, b.w6, halos,
                                     fmt=self.fmt, impl=self.impl)
            return pbit_sweep_int_op(m, s, sched, b.masks, b.h_q, b.w6_q,
                                     halos, lut, impl=self.impl)
        # per-phase dispatch, flips counted per phase (in the phase kernel
        # on CUDA) as the reference's _sweep_phases_block /
        # _sweep_phases_int_block count them
        flips = torch.zeros(self.replicas, dtype=torch.int32,
                            device=self.device)
        for t in range(sched.shape[0]):
            for c in range(self.p.n_colors):
                if f32:
                    m, s = pbit_update_op(
                        m, s, sched[t], b.masks[c], b.h, b.w6, halos,
                        fmt=self.fmt, bx=self.kernel_bx, impl=self.impl,
                        flips=flips)
                else:
                    m, s = pbit_update_int_op(
                        m, s, sched[t], b.masks[c], b.h_q, b.w6_q, halos,
                        lut, bx=self.kernel_bx, impl=self.impl, flips=flips)
        return m, s, flips

    def _chunk(self, st, sched2d, iters: int, S: int, lut):
        """``iters`` iterations of S sweeps of every brick against fixed
        halos, each ended by one exchange; sched2d (iters, S) or
        (iters, S, R) betas (f32) or LUT rows."""
        dtype = np.float32 if self.precision == "f32" else np.int32
        # a blocking copy from pageable memory: the host waits for the card
        with region("repro_torch.sync.schedule_upload"):
            sched = torch.from_numpy(np.ascontiguousarray(sched2d, dtype)).to(
                self.device)
        if not self.fused and sched.dim() == 2:
            # the per-phase kernels take each phase's (R,) betas or rows
            # as they lie: one expand and copy per chunk, none per phase
            sched = sched[..., None].expand(
                *sched.shape, self.replicas).contiguous()
        m = self._bricks_of(st.m)
        ms, ss = list(m.unbind(0)), list(self._bricks_of(st.s).unbind(0))
        hs = self._brick_halos(st.halos)
        ex = self._exchanger(int(m.shape[1]), m.dtype)
        deg = self.health is not None
        if deg:
            buf = ex.buffer(st.halos)
            health = carry_to_device(self.health.carry, len(ms), self.device)
            codes = self._fault_codes
            freeze = self.degrade.mode == "freeze_boundary"
        flips = []
        for it in range(iters):
            outs = [self._sweeps(b, mk, sk, sched[it], hk, lut)
                    for b, mk, sk, hk in zip(self._bricks, ms, ss, hs)]
            ms = [o[0] for o in outs]
            ss = [o[1] for o in outs]
            m = _stack(ms)
            with region("repro_torch.engine.exchange"):
                if deg:
                    buf, health = ex.checked(m, buf, health, codes, freeze)
                else:
                    buf = ex(m)
            hs = ex.bricks(buf)
            flips += [o[2] for o in outs]
        # every (iteration, brick) count of the chunk, summed once, exactly
        local = u32_to_i64(torch.stack(flips)).sum(0)
        m, s = (ms[0], ss[0]) if self.mesh is None else (m, _stack(ss))
        st = dataclasses.replace(
            st, m=m, s=s, halos=self._state_halos(ex, buf),
            sweep=st.sweep + iters * S,
            flips=flips_publish(st.flips, self._sum_flips(local)))
        if deg:
            # one read of the carry per chunk: the worst over the bricks
            # here, then over the ranks (the reference's pmax)
            health = carry_max(health)
            if self.group is not None:
                import torch.distributed as dist
                flat = torch.cat([x.reshape(-1) for x in health[1:]])
                dist.all_reduce(flat, op=dist.ReduceOp.MAX,
                                group=self.group)
                health = (health[0], flat[:6]) + tuple(flat[6:].unbind(0))
            self.health.update(health, exchanges=iters)
        return st

    def set_exchange_faults(self, codes):
        """Schedule exchange faults: ``codes[seq]`` in {0 ok, 1 drop,
        2 corrupt} applied to the received halo planes of global exchange
        ``seq`` of a run (see ``serve.faults.FaultPlan.exchange_codes``);
        ``None`` clears.  Needs a degrade policy: an unchecked engine would
        ingest the damage."""
        if codes is None:
            self._fault_codes = None
            return
        if self.degrade is None:
            raise ValueError("set_exchange_faults needs a degrade policy "
                             "(unchecked engines must not ingest damage)")
        self._fault_codes = torch.from_numpy(
            np.asarray(codes, np.int64)).to(self.device)

    def resync(self, state):
        """Quarantine exit: every halo plane refreshed from the current
        spins, the exchange a run without faults would make here; clears
        the monitor's staleness and freeze."""
        st = self._refresh_halos(state)
        if self.health is not None:
            self.health.on_resync()
        return st

    def run_recorded_full(self, state, schedule,
                          record_points: Sequence[int], sync_every: int = 1,
                          betas_R: Optional[np.ndarray] = None,
                          cursor: bool = False):
        """Shared-driver runner; returns (state, RunRecord), or the
        :class:`RecordedCursor` with ``cursor=True``.  ``betas_R``
        (total_sweeps, R) gives each replica its own staircase (on the
        fixed-point paths a fan of LUT row indices)."""
        if betas_R is not None:
            betas_R = np.asarray(betas_R, np.float32)
            if betas_R.ndim != 2 or betas_R.shape[1] != self.replicas:
                raise ValueError(
                    f"betas_R must be (total_sweeps, R={self.replicas})")
            schedule = ArraySchedule(betas_R)
        beta_arr = np.asarray(schedule.beta_array(), np.float32)
        if self.precision == "f32":
            lut, sched = None, ArraySchedule(beta_arr)
        else:
            table = beta_table(beta_arr)
            lut = self._lut_for(table)
            sched = ArraySchedule(beta_row_indices(beta_arr, table))

        def chunk(st, rows2d, iters, S):
            return self._chunk(st, rows2d, iters, S, lut)

        if self.health is not None:
            self.health.reset()
        kw = dict(
            state=state, schedule=sched, record_points=record_points,
            chunk_fn=chunk, record_fn=self.energy, sync_every=int(sync_every),
            flips_of=lambda st: st.flips,
            flips_per_sweep=self.n_sites * self.replicas,
            warm_scope=None if self.health is None else self.health.quiet)
        if cursor:
            return RecordedCursor(**kw)
        return run_recorded_driver(**kw)

    def run_recorded(self, state, schedule, record_points: Sequence[int],
                     sync_every: int = 1):
        """Run to each record point; returns (state, RunRecord)."""
        return self.run_recorded_full(state, schedule, record_points,
                                      sync_every=sync_every)

    def trace_chunk(self, iters: int = 2, S: int = 4, *, state=None,
                    schedule=None, before=None):
        """Run one sampling chunk of ``iters`` iterations of ``S`` sweeps
        (``sync_every=S``), then the same chunk again recorded: its
        ``ChunkTrace`` (``engines/base.trace_chunk``), the aten ops and
        host syncs, the collectives, the hand-kernel launches with their
        shapes and work, and the wall time, ended by a synchronise on the
        card.  The reference traces the chunk's program instead; eager
        PyTorch has none.  ``state`` defaults to ``init_state(0)``;
        ``schedule`` and ``before`` as ``engines/base.trace_chunk``."""
        return trace_chunk(
            self, self.init_state(seed=0) if state is None else state, iters,
            S, sync_every=S, schedule=schedule, before=before)

    def lower_chunk(self, iters: int = 2, S: int = 4):
        """The reference's dry-run hook lowers one chunk without running
        it.  Eager PyTorch has no program to lower, so this runs the chunk
        and records it: :meth:`trace_chunk` from ``init_state(0)``."""
        return self.trace_chunk(iters, S)

    # -- observables -----------------------------------------------------------

    def energy(self, state) -> torch.Tensor:
        """True energies, one per replica, on the f32 problem, after a
        fresh exchange of the current spins (not ``state.halos``), summed
        over the bricks in their order; on the bit-plane path of its word
        planes, read without unpacking on CUDA (the plain version unpacks
        spins and word halos, as the reference's readout does).  Returns
        (R,), or a scalar when replicas == 1."""
        m = self._bricks_of(state.m)
        ex = self._exchanger(int(m.shape[1]), m.dtype)
        with region("repro_torch.engine.exchange"):
            buf = ex(m)
        e = None
        for b, mk, hk in zip(self._bricks, m.unbind(0), ex.bricks(buf)):
            if self.precision == "bitplane":
                ek = brick_energy_words_op(mk, self.replicas, b.active, b.h,
                                           b.w6, hk, bx=self.kernel_bx,
                                           impl=self.impl)
            else:
                ek = brick_energy_op(mk, b.active, b.h, b.w6, hk,
                                     bx=self.kernel_bx, impl=self.impl)
            e = ek if e is None else e + ek
        e = self._sum_ranks(e)
        return e[0] if self.replicas == 1 else e

    def global_spins(self, state) -> torch.Tensor:
        """(R, L^3) active-site spins in ea3d node order; (L^3,) at R=1."""
        L = self.p.L
        m = self.global_state(state).m
        if self.precision == "bitplane":
            m = unpack_lanes(m, self.replicas)
        spins = m[:, :L, :L, :L].reshape(self.replicas, L ** 3)
        return spins[0] if self.replicas == 1 else spins
