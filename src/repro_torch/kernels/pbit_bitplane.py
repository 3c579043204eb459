"""Wrapper of the multi-spin-coded sweep kernel (``csrc/pbit_bitplane.cu``).

Port of ``repro.kernels.pbit_bitplane.pbit_bitplane_sweep`` and the word
loop of ``repro.kernels.ops.pbit_bitplane_sweep_op``: word planes are
independent replica sets, so one launch per (sweep, color) phase takes
them all, each thread its site's W planes in turn.  On a CPU tensor it
runs the plain version, ``ref.pbit_bitplane_sweep_ref``; a phase too small
to fill the card splits the planes into groups (:func:`plane_groups`).

The kernel works in a color-major layout (see the source's head note):
:func:`color_layout` orders the sites by the phase whose mask holds them
(sites in no mask first), once per mask set.  Its core,
:func:`pbit_bitplane_sweep_cm`, takes and returns the per-lane LFSR
columns as (R, n) in that order, and neither permutes nor copies them: the
lattice engine holds its bit-plane state so on CUDA.  The reference's API,
:func:`pbit_bitplane_sweep`, takes and returns them in the natural (R, X,
Y, Z) layout and permutes them in and out around the core
(:func:`to_color_major`, :func:`from_color_major`; every permutation is
counted as ``_build.launch_counts["pbit_bitplane_sweep:lfsr_permute"]``).
The kernel needs a mask set in which no site is in two phases' masks and
no two neighbors are in one (:func:`check_phase_masks`); every coloring of
the repository is one.  It reads each site's signs, nonzero masks and base
from one packed word (:func:`pack_planes`), so it takes sign and nonzero
planes of all-ones or zero words, as ``core.pbit.bitplane_planes`` makes
them.  Each launch is also counted by where it reads its LUT thresholds:
``pbit_bitplane_sweep:lut_shared`` (a table staged in shared memory) or
``:lut_global``, and those whose grid splits the planes as
``:plane_groups``.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.packing import LANE_WIDTH
from . import _build, ref as _ref
from .pbit_lattice import device_rows, halo_shapes

__all__ = ["pbit_bitplane_sweep", "pbit_bitplane_sweep_cm", "site_phases",
           "check_phase_masks", "ColorOrder", "color_order", "color_layout",
           "pack_planes", "plane_groups", "to_color_major",
           "from_color_major"]


def site_phases(masks_w: torch.Tensor) -> torch.Tensor:
    """(n_colors, X, Y, Z) bool: the sites whose mask word is non-zero in
    some word plane of each phase."""
    return (masks_w.view(torch.int32) != 0).any(dim=1)


def check_phase_masks(masks_w: torch.Tensor):
    """Raise ``ValueError`` unless the lane-masked masks (n_colors, W, X,
    Y, Z) put no site in two phases' masks and no two neighbors of the
    brick in one phase's mask: the color-major kernel decides each site in
    one phase only and updates the spin words in place."""
    cls = site_phases(masks_w)
    if bool((cls.sum(dim=0) > 1).any()):
        raise ValueError("bit-plane sweep on CUDA: a site is in two phases' "
                         "masks; the color-major kernel decides each site "
                         "in one phase (masks must partition the sites)")
    for ax in (1, 2, 3):
        n = cls.shape[ax]
        if n > 1 and bool((cls.narrow(ax, 0, n - 1)
                           & cls.narrow(ax, 1, n - 1)).any()):
            raise ValueError("bit-plane sweep on CUDA: two neighboring "
                             "sites are in one phase's mask; the kernel "
                             "updates spins in place, so each phase's "
                             "mask must be independent (a proper coloring)")


@dataclasses.dataclass(frozen=True)
class ColorOrder:
    """Sites sorted by phase: ``perm[p]`` the natural index of position p,
    ``inv`` its inverse; ``bounds`` (host ints) are the class edges: the
    no-mask class holds positions [bounds[0], bounds[1]) and phase c's
    class [bounds[c + 1], bounds[c + 2]); ``phase`` (n,) int64 the class
    of each position (-1: no mask)."""

    perm: torch.Tensor
    inv: torch.Tensor
    bounds: Tuple[int, ...]
    phase: torch.Tensor


def color_order(masks_w: torch.Tensor) -> ColorOrder:
    """The color-major order of a checked mask set (one host read of the
    class sizes)."""
    cls = site_phases(masks_w).flatten(1)                 # (n_colors, n)
    nc, n = (int(d) for d in cls.shape)
    in_any = cls.any(dim=0)
    phase = torch.where(in_any, cls.to(torch.int8).argmax(dim=0),
                        torch.full((n,), -1, dtype=torch.int64,
                                   device=cls.device))
    perm = torch.sort(phase, stable=True).indices        # -1 sorts first
    counts = torch.bincount(phase + 1, minlength=nc + 1).tolist()
    bounds = [0]
    for c in counts:
        bounds.append(bounds[-1] + int(c))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=perm.device)
    return ColorOrder(perm=perm.to(torch.int32), inv=inv.to(torch.int32),
                      bounds=tuple(bounds), phase=phase[perm])


# The packed read-only word of a site (the kernel's kBaseShift): bit d the
# sign of direction d, bit 6 + d its nonzero mask, bits 12-31 base as a
# signed 20-bit integer, saturated.  Saturation moves no LUT index
# clamp(base + 2c, 0, lw - 1) while lw <= BASE_LIMIT, which the wrapper
# checks.
BASE_SHIFT = 12
BASE_LIMIT = 1 << 19

# The most shared memory a block of the kernel gives its LUT table (the
# entries each lane can reach, 4 B each); above it the launch gathers its
# thresholds from global memory.
LUT_SMEM_BYTES = 16384

# Threads per block of the kernel (kBlock, csrc/common.cuh), and the blocks
# an SM below which a phase splits its word planes over the grid.
_THREADS = 256
SPLIT_BLOCKS_PER_SM = 2


def plane_groups(sites: int, W: int, sms: int) -> int:
    """The groups a phase of ``sites`` positions splits its W word planes
    into, on a card of ``sms`` SMs: 1 (each thread its site's W planes)
    where the phase fills ``SPLIT_BLOCKS_PER_SM`` blocks an SM, else as
    many as bring it nearest that, at most W, each of ceil(W / groups)
    planes and none empty."""
    blocks = -(-int(sites) // _THREADS)
    g = max(1, min(W, SPLIT_BLOCKS_PER_SM * sms // max(blocks, 1)))
    per = -(-W // g)
    return -(-W // per)


def pack_planes(signs6, nz6, base) -> torch.Tensor:
    """(X*Y*Z,) int32: each site's packed word in the natural order.
    Raises ``ValueError`` unless every sign and nonzero word is all-ones or
    zero (the kernel keeps one bit of each)."""
    bits = torch.zeros(base.numel(), dtype=torch.int64, device=base.device)
    for d, plane in enumerate((*signs6, *nz6)):
        w = plane.view(torch.int32).reshape(-1)
        if not bool(((w == 0) | (w == -1)).all()):
            raise ValueError("bit-plane sweep on CUDA: the sign and nonzero "
                             "planes must hold all-ones or zero words, one "
                             "per site and direction (core.pbit."
                             "bitplane_planes)")
        bits |= (w != 0).to(torch.int64) << d
    b = base.reshape(-1).to(torch.int64).clamp(-BASE_LIMIT, BASE_LIMIT - 1)
    return ((b << BASE_SHIFT) | bits).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class _Layout:
    order: ColorOrder
    mask_cm: torch.Tensor     # (W, n) uint32: each position's own mask
    packed: torch.Tensor      # (n,) uint32: pack_planes in color order
    # the LUT indices base + 2c can reach: [idx_lo, idx_hi]
    idx_lo: int
    idx_hi: int


def _build_layout(masks_w, signs6, nz6, base) -> _Layout:
    check_phase_masks(masks_w)
    order = color_order(masks_w)
    nc, W = int(masks_w.shape[0]), int(masks_w.shape[1])
    perm = order.perm
    words = masks_w.view(torch.int32).reshape(nc, W, -1)
    own = words[order.phase.clamp(min=0), :, perm.long()]   # (n, W)
    own = torch.where((order.phase >= 0)[:, None], own, 0)
    packed = pack_planes(signs6, nz6, base)
    wide = packed.to(torch.int64)
    bs = wide >> BASE_SHIFT
    nnz = sum((wide >> (6 + d)) & 1 for d in range(6))
    lo_hi = torch.stack([bs.min(), (bs + 2 * nnz).max()]).tolist()
    return _Layout(order=order,
                   mask_cm=own.t().contiguous().view(torch.uint32),
                   packed=packed.index_select(0, perm).view(torch.uint32),
                   idx_lo=int(lo_hi[0]), idx_hi=int(lo_hi[1]))


# Layouts by mask set, each valid while its masks and planes are the same
# tensors at the same versions, and dropped when its masks tensor is freed:
# an engine passes the same tensors every call (one mask set per brick), so
# each brick's order is built once per engine, however many bricks live.
_LAYOUTS: dict = {}


def color_layout(masks_w, signs6, nz6, base) -> _Layout:
    """The color-major order and read-only planes of a mask set, cached on
    the tensors' identities and versions."""
    src = (masks_w, *signs6, *nz6, base)
    stamp = tuple(t._version for t in src)
    key = id(masks_w)
    hit = _LAYOUTS.get(key)
    if hit is not None:
        refs, old_stamp, lay = hit
        if old_stamp == stamp and all(r() is t for r, t in zip(refs, src)):
            return lay
    lay = _build_layout(masks_w, signs6, nz6, base)
    if hit is None:
        weakref.finalize(masks_w, _LAYOUTS.pop, key, None)
    _LAYOUTS[key] = (tuple(weakref.ref(t) for t in src), stamp, lay)
    return lay


def to_color_major(s: torch.Tensor, order: ColorOrder) -> torch.Tensor:
    """LFSR columns (R, X, Y, Z) uint32 in the natural layout -> (R, n) in
    ``order``: one gather, a new tensor."""
    _build.launch_counts["pbit_bitplane_sweep:lfsr_permute"] += 1
    R, X, Y, Z = (int(d) for d in s.shape)
    return s.view(torch.int32).reshape(R, X * Y * Z).index_select(
        1, order.perm).view(torch.uint32)


def from_color_major(s_cm: torch.Tensor, order: ColorOrder,
                     sites: Tuple[int, int, int]) -> torch.Tensor:
    """Inverse of :func:`to_color_major`: (R, n) columns in ``order`` ->
    (R, *sites) in the natural layout."""
    _build.launch_counts["pbit_bitplane_sweep:lfsr_permute"] += 1
    return s_cm.view(torch.int32).index_select(1, order.inv).view(
        torch.uint32).reshape((int(s_cm.shape[0]),) + tuple(sites))


def pbit_bitplane_sweep(mw, s, rows, masks_w, signs6, nz6, base, halos_w,
                        lut):
    """``len(rows)`` multi-spin-coded sweeps of one brick of W word planes.

    mw (W, X, Y, Z) uint32 words (lane l = word l//32, bit l%32); s
    (R, X, Y, Z) uint32 per-lane LFSR columns, W = ceil(R / 32); rows (S,)
    shared or (S, R) per-lane LUT rows; masks_w (n_colors, W, X, Y, Z)
    lane-masked uint32 color masks; signs6 / nz6 (X, Y, Z) uint32; base
    (X, Y, Z) int32; halos_w six uint32 planes with a leading W axis; lut
    (n_rows, lw) uint32.  Returns (mw, s, flips) with (R,) int32 per-lane
    flips.  Inputs are not modified.  On CUDA the masks must pass
    :func:`check_phase_masks` (else ``ValueError``), and the LFSR columns
    are permuted into the color-major order and back around the kernel.
    """
    if _build.plain_device(mw):
        return _ref.pbit_bitplane_sweep_ref(mw, s, rows, masks_w, signs6,
                                            nz6, base, halos_w, lut)
    return _sweep(mw, s, rows, masks_w, signs6, nz6, base, halos_w, lut,
                  color_major=False)


def pbit_bitplane_sweep_cm(mw, s_cm, rows, masks_w, signs6, nz6, base,
                           halos_w, lut):
    """:func:`pbit_bitplane_sweep` on CUDA tensors with the LFSR columns
    s_cm (R, X*Y*Z) uint32 in the color-major order of
    ``color_layout(masks_w, signs6, nz6, base)``, returned in that order
    in one new tensor: no permutation and no copy of the columns.  Inputs
    are not modified."""
    if _build.plain_device(mw):
        raise ValueError("the color-major bit-plane sweep runs on CUDA "
                         "tensors only; its plain version is "
                         "ops.pbit_bitplane_sweep_cm_op(impl='ref')")
    return _sweep(mw, s_cm, rows, masks_w, signs6, nz6, base, halos_w, lut,
                  color_major=True)


def _sweep(mw, s, rows, masks_w, signs6, nz6, base, halos_w, lut,
           color_major: bool):
    """The launches of both forms: ``s`` (R, n) color-major or (R, X, Y,
    Z) natural, returned in the same form."""
    W, X, Y, Z = (int(d) for d in mw.shape)
    _build.check_sites(X, Y, Z)
    R = int(s.shape[0])
    if (R + LANE_WIDTH - 1) // LANE_WIDTH != W:
        raise ValueError(f"{R} lanes need {(R + 31) // 32} word planes, "
                         f"got {W}")
    dev = mw.device
    n = X * Y * Z
    n_colors = int(masks_w.shape[0])
    n_rows, lw = (int(d) for d in lut.shape)
    u32, i32 = torch.uint32, torch.int32
    _build.require("mw", mw, u32, (W, X, Y, Z), dev)
    _build.require("s", s, u32, (R, n) if color_major else (R, X, Y, Z),
                   dev)
    _build.require("masks_w", masks_w, u32, (n_colors, W, X, Y, Z), dev)
    for d in range(6):
        _build.require(f"signs6[{d}]", signs6[d], u32, (X, Y, Z), dev)
        _build.require(f"nz6[{d}]", nz6[d], u32, (X, Y, Z), dev)
    _build.require("base", base, torch.int32, (X, Y, Z), dev)
    for d, (hh, sh) in enumerate(zip(halos_w, halo_shapes(W, X, Y, Z))):
        _build.require(f"halos_w[{d}]", hh, u32, sh, dev)
    _build.require("lut", lut, u32, (n_rows, lw), dev)
    shared = np.ndim(rows) == 1
    rows = device_rows(rows, R, n_rows, dev)
    S = int(rows.shape[0])
    flips = torch.zeros(R, dtype=torch.int32, device=dev)
    m_out = mw.view(i32).clone().view(u32)
    if S * n_colors == 0:
        return m_out, s.view(i32).clone().view(u32), flips

    if lw > BASE_LIMIT:
        raise ValueError(f"bit-plane sweep on CUDA: LUT rows of {lw} "
                         f"entries; the kernel packs base into 20 bits and "
                         f"takes rows of at most {BASE_LIMIT}")
    lay = color_layout(masks_w, signs6, nz6, base)
    if color_major:
        s_in, s_out = s, torch.empty_like(s)
    else:
        # the gathered columns are this call's own: updated in place
        s_in = s_out = to_color_major(s, lay.order)
    b = lay.order.bounds
    lib = _build.library()
    halop = _build.ptrs6(halos_w)
    # the LUT entries each lane can reach, staged in shared memory where
    # they fit its budget
    span = lay.idx_hi - lay.idx_lo + 1
    span = span if 4 * W * LANE_WIDTH * span <= LUT_SMEM_BYTES else 0
    lut_key = "pbit_bitplane_sweep:" + ("lut_shared" if span else
                                        "lut_global")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launched = 0
    with torch.cuda.device(dev):
        stream = _build.stream_of(mw)
        for t in range(S):
            # sweep 0 reads the input and writes every position of the
            # output once (each lies in one phase's range); later sweeps
            # update the output in place
            src = (s_in if t == 0 else s_out).data_ptr()
            for c in range(n_colors):
                # phase 0 also steps the no-mask class [b[0], b[1])
                lo = b[0] if c == 0 else b[c + 1]
                if b[c + 2] == lo:
                    continue
                groups = plane_groups(b[c + 2] - lo, W, sms)
                err = lib.pbit_bitplane_color_phase(
                    m_out.data_ptr(), src, s_out.data_ptr(),
                    lay.order.perm.data_ptr(), rows.data_ptr() + 4 * t * R,
                    lay.mask_cm.data_ptr(), lay.packed.data_ptr(), halop,
                    lut.data_ptr(), lw, W, R, X, Y, Z, lo, b[c + 2], b[c + 1],
                    c, n_colors, lay.idx_lo, span, groups, flips.data_ptr(),
                    stream)
                _build.check_launch("pbit_bitplane_color_phase", err)
                _build.launch_counts["pbit_bitplane_sweep"] += 1
                _build.launch_counts[lut_key] += 1
                if groups > 1:
                    _build.launch_counts["pbit_bitplane_sweep:plane_groups"] \
                        += 1
                launched += 1
    _build.note_launch("pbit_bitplane_sweep", launched, W=W, R=R, X=X, Y=Y,
                       Z=Z, n_colors=n_colors, S=S, masks=masks_w[:, 0],
                       lut_entries=n_rows * lw,
                       sched_entries=S if shared else S * R)
    if color_major:
        return m_out, s_out, flips
    return m_out, from_color_major(s_out, lay.order, (X, Y, Z)), flips
