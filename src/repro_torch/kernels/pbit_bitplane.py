"""Wrapper of the multi-spin-coded sweep kernel (``csrc/pbit_bitplane.cu``).

Port of ``repro.kernels.pbit_bitplane.pbit_bitplane_sweep`` and the word
loop of ``repro.kernels.ops.pbit_bitplane_sweep_op``: word planes are
independent replica sets, so the W planes are the y axis of one launch
grid per (sweep, color) phase.  On a CPU tensor it runs the plain version,
``ref.pbit_bitplane_sweep_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.core.packing import LANE_WIDTH
from . import _build, ref as _ref
from .pbit_lattice import device_rows, halo_shapes

__all__ = ["pbit_bitplane_sweep"]


def pbit_bitplane_sweep(mw, s, rows, masks_w, signs6, nz6, base, halos_w,
                        lut):
    """``len(rows)`` multi-spin-coded sweeps of one brick of W word planes.

    mw (W, X, Y, Z) uint32 words (lane l = word l//32, bit l%32); s
    (R, X, Y, Z) uint32 per-lane LFSR columns, W = ceil(R / 32); rows (S,)
    shared or (S, R) per-lane LUT rows; masks_w (n_colors, W, X, Y, Z)
    lane-masked uint32 color masks; signs6 / nz6 (X, Y, Z) uint32; base
    (X, Y, Z) int32; halos_w six uint32 planes with a leading W axis; lut
    (n_rows, lw) uint32.  Returns (mw, s, flips) with (R,) int32 per-lane
    flips.  Inputs are not modified.
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
    u32 = torch.uint32
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
    rows = device_rows(rows, R, n_rows, dev)
    S = int(rows.shape[0])

    lib = _build.library()
    as_u32 = lambda t: t.view(u32)  # noqa: E731
    bufs = (as_u32(torch.empty(mw.shape, dtype=torch.int32, device=dev)),
            as_u32(torch.empty(mw.shape, dtype=torch.int32, device=dev)))
    s_out = as_u32(torch.empty(s.shape, dtype=torch.int32, device=dev))
    flips = torch.zeros(R, dtype=torch.int32, device=dev)
    signp, nzp = _build.ptrs6(signs6), _build.ptrs6(nz6)
    halop = _build.ptrs6(halos_w)
    n = X * Y * Z
    src, s_src = mw, s
    with torch.cuda.device(dev):
        stream = _build.stream_of(mw)
        for t in range(S):
            for c in range(n_colors):
                dst = bufs[(t * n_colors + c) % 2]
                err = lib.pbit_bitplane_phase(
                    src.data_ptr(), dst.data_ptr(), s_src.data_ptr(),
                    s_out.data_ptr(), rows.data_ptr() + 4 * t * R,
                    masks_w.data_ptr() + 4 * c * W * n, signp, nzp,
                    base.data_ptr(), halop, lut.data_ptr(), lw, W, R, X, Y,
                    Z, flips.data_ptr(), stream)
                _build.check_launch("pbit_bitplane_phase", err)
                _build.launch_counts["pbit_bitplane_sweep"] += 1
                src, s_src = dst, s_out
    if S * n_colors == 0:
        src = as_u32(mw.view(torch.int32).clone())
        s_out = as_u32(s.view(torch.int32).clone())
    return src, s_out, flips
