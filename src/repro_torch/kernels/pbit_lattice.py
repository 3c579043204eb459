"""Wrapper of the int8 fused lattice sweep kernel (``csrc/pbit_lattice.cu``).

Port of ``repro.kernels.pbit_lattice.pbit_brick_sweep_int``.  On a CUDA
tensor it launches the hand-written kernel once per (sweep, color) phase;
on a CPU tensor it runs the plain version, ``ref.pbit_brick_sweep_int_ref``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, ref as _ref

__all__ = ["pbit_brick_sweep_int", "halo_shapes"]


def halo_shapes(lead: int, X: int, Y: int, Z: int):
    """Shapes of the six squeezed halo planes the kernels read."""
    return [(lead, Y, Z), (lead, Y, Z), (lead, X, Z), (lead, X, Z),
            (lead, X, Y), (lead, X, Y)]


def device_rows(rows, R: int, n_rows: int, device) -> torch.Tensor:
    """LUT rows as a contiguous (S, R) int32 tensor on ``device``; shared
    (S,) rows broadcast to every replica.  Rows given on the host are
    range-checked (a row past the LUT would read out of bounds)."""
    if not (isinstance(rows, torch.Tensor) and rows.is_cuda):
        host = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor)
                          else rows)
        if host.size and (host.min() < 0 or host.max() >= n_rows):
            raise ValueError(f"LUT rows must be in [0, {n_rows}), got "
                             f"[{host.min()}, {host.max()}]")
    rows = torch.as_tensor(rows, dtype=torch.int32, device=device)
    if rows.dim() == 1:
        rows = rows[:, None].expand(rows.shape[0], R)
    if rows.dim() != 2 or rows.shape[1] != R:
        raise ValueError(f"rows must be (S,) or (S, {R}), got "
                         f"{tuple(rows.shape)}")
    return rows.contiguous()


def pbit_brick_sweep_int(m, s, rows, masks, h_q, w6_q, halos, lut):
    """``len(rows)`` fixed-point sweeps of one brick, halos held fixed.

    m (X, Y, Z) int8 or (R, X, Y, Z) for R replicas in one launch per
    phase; s uint32 of the same shape; rows (S,) shared or (S, R) int32
    LUT rows; masks (n_colors, X, Y, Z) int8; h_q and the six w6_q
    (X, Y, Z) int8; halos six int8 planes (leading R when batched);
    lut (n_rows, lw) uint32.  Returns (m, s, flips) with flips int32 —
    (R,) when batched.  Inputs are not modified.
    """
    if _build.plain_device(m):
        return _ref.pbit_brick_sweep_int_ref(m, s, rows, masks, h_q, w6_q,
                                             halos, lut)
    single = m.dim() == 3
    if single:
        m, s = m.unsqueeze(0), s.unsqueeze(0)
        halos = tuple(h.unsqueeze(0) for h in halos)
    R, X, Y, Z = (int(d) for d in m.shape)
    dev = m.device
    _build.check_sites(X, Y, Z)
    n_colors = int(masks.shape[0])
    n_rows, lw = (int(d) for d in lut.shape)
    _build.require("m", m, torch.int8, (R, X, Y, Z), dev)
    _build.require("s", s, torch.uint32, (R, X, Y, Z), dev)
    _build.require("masks", masks, torch.int8, (n_colors, X, Y, Z), dev)
    _build.require("h_q", h_q, torch.int8, (X, Y, Z), dev)
    for d, w in enumerate(w6_q):
        _build.require(f"w6_q[{d}]", w, torch.int8, (X, Y, Z), dev)
    for d, (hh, sh) in enumerate(zip(halos, halo_shapes(R, X, Y, Z))):
        _build.require(f"halos[{d}]", hh, torch.int8, sh, dev)
    _build.require("lut", lut, torch.uint32, (n_rows, lw), dev)
    rows = device_rows(rows, R, n_rows, dev)
    S = int(rows.shape[0])

    lib = _build.library()
    bufs = (torch.empty_like(m), torch.empty_like(m))
    s_out = torch.empty(s.shape, dtype=torch.int32, device=dev).view(
        torch.uint32)
    flips = torch.zeros(R, dtype=torch.int32, device=dev)
    w6p, halop = _build.ptrs6(w6_q), _build.ptrs6(halos)
    n = X * Y * Z
    src, s_src = m, s
    with torch.cuda.device(dev):
        stream = _build.stream_of(m)
        for t in range(S):
            for c in range(n_colors):
                dst = bufs[(t * n_colors + c) % 2]
                err = lib.pbit_sweep_int_phase(
                    src.data_ptr(), dst.data_ptr(), s_src.data_ptr(),
                    s_out.data_ptr(), rows.data_ptr() + 4 * t * R,
                    masks.data_ptr() + c * n, h_q.data_ptr(), w6p, halop,
                    lut.data_ptr(), lw, R, X, Y, Z, flips.data_ptr(), stream)
                _build.check_launch("pbit_sweep_int_phase", err)
                _build.launch_counts["pbit_brick_sweep_int"] += 1
                src, s_src = dst, s_out
    if S * n_colors == 0:
        src, s_out = m.clone(), s.view(torch.int32).clone().view(torch.uint32)
    if single:
        return src[0], s_out[0], flips[0]
    return src, s_out, flips
