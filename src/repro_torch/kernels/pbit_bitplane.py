"""Wrapper of the multi-spin-coded sweep kernel (``csrc/pbit_bitplane.cu``).

Port of ``repro.kernels.pbit_bitplane.pbit_bitplane_sweep`` and the word
loop of ``repro.kernels.ops.pbit_bitplane_sweep_op``: word planes are
independent replica sets, so the W planes are the y axis of one launch
grid per (sweep, color) phase.  On a CPU tensor it runs the plain version,
``ref.pbit_bitplane_sweep_ref``.

The kernel works in a color-major layout (see the source's head note):
:func:`color_layout` orders the sites by the phase whose mask holds them
(sites in no mask first), once per mask set, and the wrapper permutes the
LFSR columns into that order on entry and back on exit.  It needs a mask
set in which no site is in two phases' masks and no two neighbors are in
one (:func:`check_phase_masks`); every coloring of the repository is one.
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

__all__ = ["pbit_bitplane_sweep", "site_phases", "check_phase_masks",
           "ColorOrder", "color_order", "color_layout"]


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


@dataclasses.dataclass(frozen=True)
class _Layout:
    order: ColorOrder
    mask_cm: torch.Tensor     # (W, n) uint32: each position's own mask
    sign_cm: tuple            # six (n,) uint32
    nz_cm: tuple              # six (n,) uint32
    base_cm: torch.Tensor     # (n,) int32


def _permuted(planes, perm) -> tuple:
    """Six (X, Y, Z) uint32 planes gathered into color-major order."""
    return tuple(p.view(torch.int32).reshape(-1).index_select(0, perm)
                 .view(torch.uint32) for p in planes)


def _build_layout(masks_w, signs6, nz6, base) -> _Layout:
    check_phase_masks(masks_w)
    order = color_order(masks_w)
    nc, W = int(masks_w.shape[0]), int(masks_w.shape[1])
    perm = order.perm
    words = masks_w.view(torch.int32).reshape(nc, W, -1)
    own = words[order.phase.clamp(min=0), :, perm.long()]   # (n, W)
    own = torch.where((order.phase >= 0)[:, None], own, 0)
    return _Layout(order=order,
                   mask_cm=own.t().contiguous().view(torch.uint32),
                   sign_cm=_permuted(signs6, perm),
                   nz_cm=_permuted(nz6, perm),
                   base_cm=base.reshape(-1).index_select(0, perm))


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
    :func:`check_phase_masks` (else ``ValueError``).
    """
    if _build.plain_device(mw):
        return _ref.pbit_bitplane_sweep_ref(mw, s, rows, masks_w, signs6,
                                            nz6, base, halos_w, lut)
    W, X, Y, Z = (int(d) for d in mw.shape)
    _build.check_sites(X, Y, Z)
    R = int(s.shape[0])
    if (R + LANE_WIDTH - 1) // LANE_WIDTH != W:
        raise ValueError(f"{R} lanes need {(R + 31) // 32} word planes, "
                         f"got {W}")
    dev = mw.device
    n_colors = int(masks_w.shape[0])
    n_rows, lw = (int(d) for d in lut.shape)
    u32, i32 = torch.uint32, torch.int32
    _build.require("mw", mw, u32, (W, X, Y, Z), dev)
    _build.require("s", s, u32, (R, X, Y, Z), dev)
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

    lay = color_layout(masks_w, signs6, nz6, base)
    n = X * Y * Z
    s_cm = s.view(i32).reshape(R, n).index_select(1, lay.order.perm)
    b = lay.order.bounds
    lib = _build.library()
    signp, nzp = _build.ptrs6(lay.sign_cm), _build.ptrs6(lay.nz_cm)
    halop = _build.ptrs6(halos_w)
    launched = 0
    with torch.cuda.device(dev):
        stream = _build.stream_of(mw)
        for t in range(S):
            for c in range(n_colors):
                # phase 0 also steps the no-mask class [b[0], b[1])
                lo = b[0] if c == 0 else b[c + 1]
                if b[c + 2] == lo:
                    continue
                err = lib.pbit_bitplane_color_phase(
                    m_out.data_ptr(), s_cm.data_ptr(),
                    lay.order.perm.data_ptr(), rows.data_ptr() + 4 * t * R,
                    lay.mask_cm.data_ptr(), signp, nzp,
                    lay.base_cm.data_ptr(), halop, lut.data_ptr(), lw, W, R,
                    X, Y, Z, lo, b[c + 2], b[c + 1], c, n_colors,
                    flips.data_ptr(), stream)
                _build.check_launch("pbit_bitplane_color_phase", err)
                _build.launch_counts["pbit_bitplane_sweep"] += 1
                launched += 1
    _build.note_launch("pbit_bitplane_sweep", launched, W=W, R=R, X=X, Y=Y,
                       Z=Z, n_colors=n_colors, S=S, masks=masks_w[:, 0],
                       lut_entries=n_rows * lw,
                       sched_entries=S if shared else S * R)
    s_out = s_cm.index_select(1, lay.order.inv).view(u32).reshape(
        R, X, Y, Z)
    return m_out, s_out, flips
