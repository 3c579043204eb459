"""Lattice DSIM on one GPU: one brick, no mesh (the production engine's
single-device form).

Port of ``repro.core.lattice_dsim.LatticeDSIM`` at ``precision="f32"``,
``"int8"`` and ``"bitplane"``.  Each chunk runs ``sync_every`` sweeps
against halos held fixed — one fused sweep call, or on the per-phase path
(``fused=False`` or ``kernel_bx``) one single-phase call per color — then
one halo exchange.  In a single brick the exchange is local: the x and y
halos are zero (open chains) and the z halo is the brick's own opposite
face (the periodic ring of one brick) as of the last exchange — never the
live spins.

Replicas ride a leading axis R; on the bit-plane path they are the bit
lanes of W = ceil(R / 32) stacked uint32 word planes, lane (w, b)
bit-identical to int8 replica w*32+b.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .annealing import ArraySchedule, beta_row_indices, beta_table
from .bits import u32_from_numpy, u32_to_i64, u32_zeros
from .device import resolve_device
from .lattice import LatticeProblem
from .packing import LANE_WIDTH, pack_lanes, unpack_lanes
from .pbit import (FixedPoint, LUT_SELECT_MAX_WIDTH, bitplane_planes,
                   field_bound, flips_publish, lfsr_init, quantize_couplings,
                   threshold_lut_cached)
from repro_torch.engines.base import (RecordedCursor, check_lanes,
                                      run_recorded_driver, spawn_seeds)
from repro_torch.kernels.ops import (brick_energy_op, brick_energy_words_op,
                                     pbit_bitplane_sweep_op,
                                     pbit_sweep_int_op, pbit_sweep_op,
                                     pbit_update_int_op, pbit_update_op,
                                     resolve_impl)

__all__ = ["LatticeDSIM", "LatticeState", "BitplaneLatticeState",
           "to_device"]


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


def _face(m: torch.Tensor, idx: slice) -> torch.Tensor:
    """Contiguous copy of ``m[..., idx]`` (a z face), uint32 via int32."""
    if m.dtype == torch.uint32:
        return m.view(torch.int32)[..., idx].contiguous().view(torch.uint32)
    return m[..., idx].contiguous()


class LatticeDSIM:
    """One-brick lattice engine, ``precision`` "f32", "int8" or
    "bitplane".

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
    the CPU; "ref" forces the plain versions)."""

    def __init__(self, prob: LatticeProblem, fmt: Optional[FixedPoint] = None,
                 impl: str = "auto", replicas: int = 1,
                 precision: str = "f32", fused: bool = True,
                 kernel_bx: Optional[int] = None, device=None):
        if precision not in ("f32", "int8", "bitplane"):
            raise ValueError(f"unknown precision {precision!r}")
        if precision == "bitplane" and kernel_bx is not None:
            raise ValueError("kernel_bx (per-phase x-tiling) is not "
                             "available on the bitplane path")
        self.device = resolve_device(device)
        resolve_impl(impl, self.device.type == "cuda")
        self.p = prob.to(self.device)
        self.fmt = fmt
        self.impl = impl
        self.precision = precision
        self.replicas = int(replicas)
        self.words = check_lanes(precision, self.replicas)
        self.n_sites = prob.n_active
        self.kernel_bx = kernel_bx
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

    def _fixed_point_constants(self, prob: LatticeProblem):
        """Quantized couplings and, on the bit-plane path, its word
        planes and lane-masked color masks."""
        dev, precision = self.device, self.precision
        h_q, w6_q, self.q_scale = quantize_couplings(prob.h, prob.w6)
        self.f_max = field_bound(h_q, w6_q)
        self.h_q = torch.from_numpy(h_q).to(dev)
        self.w6_q = tuple(torch.from_numpy(w).to(dev) for w in w6_q)
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
            signs6, nz6, base, _ = bitplane_planes(h_q, w6_q)
            self.signs6_w = tuple(u32_from_numpy(x, dev) for x in signs6)
            self.nz6_w = tuple(u32_from_numpy(x, dev) for x in nz6)
            self.base_w = torch.from_numpy(base).to(dev)
            # lane-masked color masks: lanes >= R (only ever in the LAST
            # word plane) never update
            W = self.words
            last = self.replicas - (W - 1) * LANE_WIDTH
            lane_masks = np.full((W,), 0xFFFFFFFF, np.uint64)
            lane_masks[-1] = (1 << last) - 1 if last < LANE_WIDTH \
                else 0xFFFFFFFF
            mk = self.p.masks.cpu().numpy()      # (n_colors, X, Y, Z)
            self.masks_w = u32_from_numpy(
                np.where(mk[:, None] != 0,
                         lane_masks.astype(np.uint32)[None, :, None, None,
                                                      None], 0), dev)

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

    def _exchange(self, m: torch.Tensor):
        """The six halo planes of one brick from its spins ``m`` ((R, ...)
        int8 or (W, ...) words): x/y open chains give zero planes, the z
        ring of one brick wraps the brick's own opposite face."""
        lead, X, Y, Z = (int(d) for d in m.shape)
        if m.dtype == torch.uint32:
            zero = lambda sh: u32_zeros(sh, m.device)  # noqa: E731
        else:
            zero = lambda sh: torch.zeros(sh, dtype=m.dtype,  # noqa: E731
                                          device=m.device)
        return (zero((lead, 1, Y, Z)), zero((lead, 1, Y, Z)),
                zero((lead, X, 1, Z)), zero((lead, X, 1, Z)),
                _face(m, slice(Z - 1, Z)), _face(m, slice(0, 1)))

    @staticmethod
    def _squeeze(halos):
        """Stored (lead, 1, Y, Z)-style planes -> the kernels' (lead, Y, Z)
        views."""
        xlo, xhi, ylo, yhi, zlo, zhi = halos
        return (xlo[:, 0], xhi[:, 0], ylo[:, :, 0], yhi[:, :, 0],
                zlo[..., 0], zhi[..., 0])

    def _refresh_halos(self, st):
        return dataclasses.replace(st, halos=self._exchange(st.m))

    def shard_state(self, st):
        """Place every tensor of a state on the engine's device (one brick:
        no sharding beyond that)."""
        return type(st)(
            m=to_device(st.m, self.device), s=to_device(st.s, self.device),
            halos=tuple(to_device(h, self.device) for h in st.halos),
            sweep=to_device(st.sweep, self.device),
            flips=to_device(st.flips, self.device))

    def init_state(self, seed: int = 0,
                   seeds: Optional[Sequence[int]] = None):
        """Fresh state; ``seeds=[...]`` (length R) seeds every replica
        explicitly (replica r's trajectory depends only on seeds[r])."""
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
        dev = self.device
        m = torch.from_numpy(np.stack(ms)).to(dev)
        s = u32_from_numpy(np.stack(ss), dev)
        zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
        flips = torch.zeros((R,), dtype=torch.int32, device=dev)
        if self.precision == "bitplane":
            st = BitplaneLatticeState(m=pack_lanes(m), s=s, halos=(),
                                      sweep=zero(), flips=flips)
        else:
            st = LatticeState(m=m, s=s, halos=(), sweep=zero(), flips=flips)
        # one refreshing exchange so the first sweeps see real halos
        return self._refresh_halos(st)

    # -- runners ---------------------------------------------------------------

    def _sweeps(self, m, s, sched, halos, lut):
        """S sweeps of every replica against fixed halos; ``sched`` (S,)
        or (S, R), f32 betas or int32 LUT rows.  Returns (m, s, flips)."""
        if self.precision == "bitplane":
            return pbit_bitplane_sweep_op(
                m, s, sched, self.masks_w, self.signs6_w, self.nz6_w,
                self.base_w, halos, lut, impl=self.impl)
        f32 = self.precision == "f32"
        if self.fused:
            if f32:
                return pbit_sweep_op(m, s, sched, self.p.masks, self.p.h,
                                     self.p.w6, halos, fmt=self.fmt,
                                     impl=self.impl)
            return pbit_sweep_int_op(m, s, sched, self.p.masks, self.h_q,
                                     self.w6_q, halos, lut, impl=self.impl)
        # per-phase dispatch, flips counted per phase (in the phase kernel
        # on CUDA) as the reference's _sweep_phases_block /
        # _sweep_phases_int_block count them
        flips = torch.zeros(self.replicas, dtype=torch.int32,
                            device=self.device)
        for t in range(sched.shape[0]):
            for c in range(self.p.n_colors):
                if f32:
                    m, s = pbit_update_op(
                        m, s, sched[t], self.p.masks[c], self.p.h, self.p.w6,
                        halos, fmt=self.fmt, bx=self.kernel_bx,
                        impl=self.impl, flips=flips)
                else:
                    m, s = pbit_update_int_op(
                        m, s, sched[t], self.p.masks[c], self.h_q, self.w6_q,
                        halos, lut, bx=self.kernel_bx, impl=self.impl,
                        flips=flips)
        return m, s, flips

    def _chunk(self, st, sched2d, iters: int, S: int, lut):
        """``iters`` iterations of S sweeps against fixed halos, each ended
        by one exchange; sched2d (iters, S) or (iters, S, R) betas (f32)
        or LUT rows."""
        dtype = np.float32 if self.precision == "f32" else np.int32
        sched = torch.from_numpy(np.ascontiguousarray(sched2d, dtype)).to(
            self.device)
        if not self.fused and sched.dim() == 2:
            # the per-phase kernels take each phase's (R,) betas or rows
            # as they lie: one expand and copy per chunk, none per phase
            sched = sched[..., None].expand(
                *sched.shape, self.replicas).contiguous()
        m, s, halos = st.m, st.s, st.halos
        local = torch.zeros(self.replicas, dtype=torch.int64,
                            device=self.device)
        for it in range(iters):
            m, s, f = self._sweeps(m, s, sched[it], self._squeeze(halos), lut)
            halos = self._exchange(m)
            local = local + u32_to_i64(f)
        return type(st)(m=m, s=s, halos=halos, sweep=st.sweep + iters * S,
                        flips=flips_publish(st.flips, local))

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

        kw = dict(
            state=state, schedule=sched, record_points=record_points,
            chunk_fn=chunk, record_fn=self.energy, sync_every=int(sync_every),
            flips_of=lambda st: st.flips,
            flips_per_sweep=self.n_sites * self.replicas)
        if cursor:
            return RecordedCursor(**kw)
        return run_recorded_driver(**kw)

    # -- observables -----------------------------------------------------------

    def _spins(self, state) -> torch.Tensor:
        if self.precision == "bitplane":
            return unpack_lanes(state.m, self.replicas)
        return state.m

    def energy(self, state) -> torch.Tensor:
        """True energies, one per replica, on the f32 problem, after a
        fresh exchange of the current spins (not ``state.halos``); on the
        bit-plane path of its word planes, read without unpacking on CUDA
        (the plain version unpacks spins and word halos, as the
        reference's readout does).  Returns (R,), or a scalar when
        replicas == 1."""
        halos = self._squeeze(self._exchange(state.m))
        consts = (self.p.active, self.p.h, self.p.w6)
        if self.precision == "bitplane":
            e = brick_energy_words_op(state.m, self.replicas, *consts, halos,
                                      bx=self.kernel_bx, impl=self.impl)
        else:
            e = brick_energy_op(state.m, *consts, halos, bx=self.kernel_bx,
                                impl=self.impl)
        return e[0] if self.replicas == 1 else e

    def global_spins(self, state) -> torch.Tensor:
        """(R, L^3) active-site spins in ea3d node order; (L^3,) at R=1."""
        L = self.p.L
        spins = self._spins(state)[:, :L, :L, :L].reshape(self.replicas,
                                                          L ** 3)
        return spins[0] if self.replicas == 1 else spins
