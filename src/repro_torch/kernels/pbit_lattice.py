"""Wrappers of the lattice p-bit kernels (``csrc/pbit_lattice.cu``).

Ports of ``repro.kernels.pbit_lattice``: the fused sweeps
``pbit_brick_sweep_int`` (int8) and ``pbit_brick_sweep`` (f32), and the
single color phases ``pbit_brick_update_int`` and ``pbit_brick_update``.
On a CUDA tensor each launches its hand-written kernel (the int8 sweep
once per (sweep, color) phase, the f32 sweep once per call as a persistent
cooperative kernel); on a CPU tensor it runs the plain version of ``ref``.
All take one brick (X, Y, Z) or R replicas (R, X, Y, Z), and do not modify
their inputs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pbit import FixedPoint
from . import _build, ref as _ref

__all__ = ["pbit_brick_sweep_int", "pbit_brick_sweep",
           "pbit_brick_update_int", "pbit_brick_update", "halo_shapes",
           "device_limits", "smem_budget", "lfsr_resident",
           "persistent_mode"]


def halo_shapes(lead: int, X: int, Y: int, Z: int):
    """Shapes of the six squeezed halo planes the kernels read."""
    return [(lead, Y, Z), (lead, Y, Z), (lead, X, Z), (lead, X, Z),
            (lead, X, Y), (lead, X, Y)]


def _per_replica(sched: torch.Tensor, R: int, what: str) -> torch.Tensor:
    """(S,) shared or (S, R) per replica -> contiguous (S, R)."""
    if sched.dim() == 1:
        sched = sched[:, None].expand(sched.shape[0], R)
    if sched.dim() != 2 or sched.shape[1] != R:
        raise ValueError(f"{what} must be (S,) or (S, {R}), got "
                         f"{tuple(sched.shape)}")
    return sched.contiguous()


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
    return _per_replica(rows, R, "rows")


def device_betas(betas, R: int, device) -> torch.Tensor:
    """Betas as a contiguous (S, R) f32 tensor on ``device``; shared (S,)
    betas broadcast to every replica.  There is no LUT to range-check
    against, so the dtype is checked instead: betas are floating point (an
    integer schedule would be LUT rows)."""
    betas = torch.as_tensor(betas)
    if not betas.is_floating_point():
        raise TypeError(f"betas must be floating point, got {betas.dtype}")
    return _per_replica(betas.to(device=device, dtype=torch.float32), R,
                        "betas")


def _one_phase(value) -> torch.Tensor:
    """A per-phase beta or LUT row, one value or (R,), as a one-sweep
    schedule: (1,) or (1, R)."""
    value = torch.as_tensor(value)
    return value.reshape(1) if value.numel() == 1 else value.reshape(1, -1)


def _fmt_args(fmt: Optional[FixedPoint]):
    return (0, 0.0, 0.0, 0.0) if fmt is None else \
        (1, float(fmt.step), float(fmt.lo), float(fmt.hi))


def _checked(m, s, masks, mask_lead, h, w6, halos, cdtype):
    """Replica-batch a brick and check what the kernels read through raw
    pointers: int8 spins, uint32 states, int8 masks, ``cdtype`` constants
    (int8 quantized or f32) and int8 halos."""
    single = m.dim() == 3
    if single:
        m, s = m.unsqueeze(0), s.unsqueeze(0)
        halos = tuple(hh.unsqueeze(0) for hh in halos)
    R, X, Y, Z = (int(d) for d in m.shape)
    dev = m.device
    _build.check_sites(X, Y, Z)
    _build.require("m", m, torch.int8, (R, X, Y, Z), dev)
    _build.require("s", s, torch.uint32, (R, X, Y, Z), dev)
    _build.require("masks", masks, torch.int8, mask_lead + (X, Y, Z), dev)
    _build.require("h", h, cdtype, (X, Y, Z), dev)
    for d, w in enumerate(w6):
        _build.require(f"w6[{d}]", w, cdtype, (X, Y, Z), dev)
    for d, (hh, sh) in enumerate(zip(halos, halo_shapes(R, X, Y, Z))):
        _build.require(f"halos[{d}]", hh, torch.int8, sh, dev)
    return single, m, s, halos


def _new_states(s):
    return torch.empty(s.shape, dtype=torch.int32, device=s.device).view(
        torch.uint32)


def _sweeps(name, launch, m, s, S: int, n_colors: int, single: bool):
    """Launch ``launch(src, dst, s_src, s_out, t, c, flips)`` once per
    (sweep, color) phase, spins ping-ponged between two buffers and the
    LFSR states advanced in place in ``s_out``."""
    R = int(m.shape[0])
    bufs = (torch.empty_like(m), torch.empty_like(m))
    s_out = _new_states(s)
    flips = torch.zeros(R, dtype=torch.int32, device=m.device)
    src, s_src = m, s
    with torch.cuda.device(m.device):
        for t in range(S):
            for c in range(n_colors):
                dst = bufs[(t * n_colors + c) % 2]
                _build.check_launch(name, launch(src, dst, s_src, s_out, t,
                                                 c, flips))
                _build.launch_counts[name] += 1
                src, s_src = dst, s_out
    if S * n_colors == 0:
        src, s_out = m.clone(), s.view(torch.int32).clone().view(torch.uint32)
    if single:
        return src[0], s_out[0], flips[0]
    return src, s_out, flips


def _phase(name, launch, m, s, single: bool):
    """Launch ``launch(m_out, s_out)`` once: one color phase."""
    m_out, s_out = torch.empty_like(m), _new_states(s)
    with torch.cuda.device(m.device):
        _build.check_launch(name, launch(m_out, s_out))
    _build.launch_counts[name] += 1
    return (m_out[0], s_out[0]) if single else (m_out, s_out)


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
    n_colors = int(masks.shape[0])
    single, m, s, halos = _checked(m, s, masks, (n_colors,), h_q, w6_q,
                                   halos, torch.int8)
    R, X, Y, Z = (int(d) for d in m.shape)
    n_rows, lw = (int(d) for d in lut.shape)
    _build.require("lut", lut, torch.uint32, (n_rows, lw), m.device)
    rows = device_rows(rows, R, n_rows, m.device)
    lib = _build.library()
    w6p, halop = _build.ptrs6(w6_q), _build.ptrs6(halos)
    n, stream = X * Y * Z, _build.stream_of(m)

    def launch(src, dst, s_src, s_out, t, c, flips):
        return lib.pbit_sweep_int_phase(
            src.data_ptr(), dst.data_ptr(), s_src.data_ptr(),
            s_out.data_ptr(), rows.data_ptr() + 4 * t * R,
            masks.data_ptr() + c * n, h_q.data_ptr(), w6p, halop,
            lut.data_ptr(), lw, R, X, Y, Z, flips.data_ptr(), stream)
    return _sweeps("pbit_brick_sweep_int", launch, m, s, int(rows.shape[0]),
                   n_colors, single)


@functools.cache
def device_limits(index: int) -> Tuple[int, int]:
    """(SM count, shared memory one block may opt in to) of CUDA device
    ``index``."""
    lib = _build.library()
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(index):
        _build.check_launch("pbit_device_limits",
                            lib.pbit_device_limits(ctypes.addressof(out)))
    return int(out[0]), int(out[1])


def smem_budget(R: int, n: int, sms: int) -> int:
    """Shared memory one block of the persistent f32 sweep needs to hold
    its tile's LFSR states, at one block per SM: the tile (n / sms sites,
    rounded up) times R states of 4 B, plus R flip counters."""
    return 4 * R * (-(-n // sms) + 1)


def lfsr_resident(R: int, n: int, sms: int, smem_per_block: int) -> bool:
    """True where the persistent f32 sweep keeps the LFSR states of R
    replicas of an n-site brick in shared memory, False where it keeps
    them in device memory."""
    return smem_budget(R, n, sms) <= smem_per_block


@functools.cache
def _persistent_config(index: int, resident: bool, R: int, n: int):
    """(grid, tile, smem bytes, blocks per SM) of the persistent sweep."""
    lib = _build.library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(index):
        err = lib.pbit_persistent_config(int(resident), R, n,
                                         ctypes.addressof(out))
    _build.check_launch("pbit_persistent_config", err)
    return tuple(int(v) for v in out)


def persistent_mode(m) -> str:
    """The LFSR mode the persistent f32 sweep takes for spins ``m``
    ((R, X, Y, Z) or one brick) on its CUDA device: "lfsr_smem" or
    "lfsr_global"."""
    R = 1 if m.dim() == 3 else int(m.shape[0])
    n = int(np.prod(m.shape[-3:]))
    sms, smem = device_limits(m.device.index)
    return "lfsr_smem" if lfsr_resident(R, n, sms, smem) else "lfsr_global"


def pbit_brick_sweep(m, s, betas, masks, h, w6, halos,
                     fmt: Optional[FixedPoint] = None):
    """``len(betas)`` f32 sweeps of one brick, halos held fixed.

    As :func:`pbit_brick_sweep_int`, with betas (S,) shared or (S, R)
    floating point (taken as f32) for the LUT rows, h and the six w6
    (X, Y, Z) f32, and ``fmt`` the optional fixed-point format of the
    activation.  Returns (m, s, flips).  On CUDA all S sweeps are one
    persistent cooperative launch (:func:`persistent_mode` says where its
    LFSR states live).
    """
    if _build.plain_device(m):
        return _ref.pbit_brick_sweep_ref(m, s, betas, masks, h, w6, halos,
                                         fmt)
    return _f32_persistent(m, s, betas, masks, h, w6, halos, fmt)


def _f32_persistent(m, s, betas, masks, h, w6, halos, fmt, grid=None):
    """The persistent f32 sweep; ``grid`` overrides the block count of the
    launch shape (a count the card cannot co-schedule fails to launch)."""
    n_colors = int(masks.shape[0])
    single, m, s, halos = _checked(m, s, masks, (n_colors,), h, w6, halos,
                                   torch.float32)
    R, X, Y, Z = (int(d) for d in m.shape)
    betas = device_betas(betas, R, m.device)
    S, n = int(betas.shape[0]), X * Y * Z
    flips = torch.zeros(R, dtype=torch.int32, device=m.device)
    if S * n_colors == 0:
        out = (m.clone(), s.view(torch.int32).clone().view(torch.uint32),
               flips)
        return tuple(x[0] for x in out) if single else out
    mode = persistent_mode(m)
    resident = mode == "lfsr_smem"
    blocks, tile, smem, _ = _persistent_config(m.device.index, resident, R,
                                               n)
    if grid is not None:
        blocks = int(grid)
        tile = -(-n // blocks)
        smem = 4 * R * ((tile if resident else 0) + 1)
    bufs = (torch.empty_like(m), torch.empty_like(m))
    s_out = _new_states(s)
    lists = torch.empty(blocks * n_colors * tile, dtype=torch.int32,
                        device=m.device)
    lib = _build.library()
    with torch.cuda.device(m.device):
        err = lib.pbit_sweep_f32_persistent(
            m.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
            s.data_ptr(), s_out.data_ptr(), betas.data_ptr(),
            masks.data_ptr(), h.data_ptr(), _build.ptrs6(w6),
            _build.ptrs6(halos), *_fmt_args(fmt), S, n_colors, R, X, Y, Z,
            int(resident), blocks, tile, smem, lists.data_ptr(),
            flips.data_ptr(), _build.stream_of(m))
    _build.check_launch("pbit_sweep_f32_persistent", err)
    _build.launch_counts["pbit_brick_sweep"] += 1
    _build.launch_counts[f"pbit_brick_sweep:{mode}"] += 1
    out = (bufs[(S * n_colors - 1) % 2], s_out, flips)
    return tuple(x[0] for x in out) if single else out


def pbit_brick_update_int(m, s, row, parity_mask, h_q, w6_q, halos, lut,
                          bx: Optional[int] = None):
    """One fixed-point color phase of one brick (no flip count).

    ``row`` a LUT row index, or (R,) per replica; ``parity_mask``
    (X, Y, Z) int8, the sites this phase updates; the rest as
    :func:`pbit_brick_sweep_int`.  ``bx`` is the reference's x tile: it
    must divide X (else the reference's ValueError), and changes nothing
    on the card, whose grid tiles the brick anyway — the result equals the
    untiled one.  Returns (m, s).
    """
    _build.check_bx(int(m.shape[-3]), bx)
    if _build.plain_device(m):
        return _ref.pbit_brick_update_int_ref(m, s, row, parity_mask, h_q,
                                              w6_q, halos, lut)
    single, m, s, halos = _checked(m, s, parity_mask, (), h_q, w6_q, halos,
                                   torch.int8)
    R, X, Y, Z = (int(d) for d in m.shape)
    n_rows, lw = (int(d) for d in lut.shape)
    _build.require("lut", lut, torch.uint32, (n_rows, lw), m.device)
    rows = device_rows(_one_phase(row), R, n_rows, m.device)
    lib = _build.library()
    return _phase("pbit_brick_update_int", lambda m_out, s_out:
                  lib.pbit_update_int_phase(
                      m.data_ptr(), m_out.data_ptr(), s.data_ptr(),
                      s_out.data_ptr(), rows.data_ptr(),
                      parity_mask.data_ptr(), h_q.data_ptr(),
                      _build.ptrs6(w6_q), _build.ptrs6(halos),
                      lut.data_ptr(), lw, R, X, Y, Z, _build.stream_of(m)),
                  m, s, single)


def pbit_brick_update(m, s, beta, parity_mask, h, w6, halos,
                      fmt: Optional[FixedPoint] = None,
                      bx: Optional[int] = None):
    """One f32 color phase of one brick (no flip count).

    ``beta`` a scalar, or (R,) per replica, taken as f32; the rest as
    :func:`pbit_brick_sweep` and :func:`pbit_brick_update_int` (``bx``
    validated, the result the untiled one).  Returns (m, s).
    """
    _build.check_bx(int(m.shape[-3]), bx)
    if _build.plain_device(m):
        return _ref.pbit_brick_update_ref(m, s, beta, parity_mask, h, w6,
                                          halos, fmt)
    single, m, s, halos = _checked(m, s, parity_mask, (), h, w6, halos,
                                   torch.float32)
    R, X, Y, Z = (int(d) for d in m.shape)
    betas = device_betas(_one_phase(beta), R, m.device)
    lib = _build.library()
    return _phase("pbit_brick_update", lambda m_out, s_out:
                  lib.pbit_update_f32_phase(
                      m.data_ptr(), m_out.data_ptr(), s.data_ptr(),
                      s_out.data_ptr(), betas.data_ptr(),
                      parity_mask.data_ptr(), h.data_ptr(),
                      _build.ptrs6(w6), _build.ptrs6(halos), *_fmt_args(fmt),
                      R, X, Y, Z, _build.stream_of(m)),
                  m, s, single)
