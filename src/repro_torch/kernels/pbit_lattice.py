"""Wrappers of the lattice p-bit kernels (``csrc/pbit_lattice.cu``).

Ports of ``repro.kernels.pbit_lattice``: the fused sweeps
``pbit_brick_sweep_int`` (int8) and ``pbit_brick_sweep`` (f32), and the
single color phases ``pbit_brick_update_int`` and ``pbit_brick_update``.
On a CUDA tensor each launches its hand-written kernel (both sweeps once
per call as a persistent cooperative kernel, the phases once per call);
on a CPU tensor it runs the plain version of ``ref``.  All take one brick
(X, Y, Z) or R replicas (R, X, Y, Z), and do not modify their inputs.
``launch_update`` / ``launch_update_int`` are the phases' kernels for the
engine's per-phase dispatch, which also counts each replica's flips in
the kernel.
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
           "device_limits", "persistent_smem", "smem_budget",
           "lfsr_resident", "launch_shape", "persistent_mode",
           "phase_width", "launch_update", "launch_update_int"]

# the persistent kernels' kind argument
_KINDS = {"f32": 0, "int8": 1}


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


def _done(single, *out):
    return tuple(x[0] for x in out) if single else out


def _flips_ptr(flips, R: int, device):
    """The kernel's flips pointer: None, or a checked (R,) int32 tensor's."""
    if flips is None:
        return None
    _build.require("flips", flips, torch.int32, (R,), device)
    return flips.data_ptr()


# -- the persistent sweeps ---------------------------------------------------

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


def persistent_smem(R: int, tile: int, resident: bool) -> int:
    """Dynamic shared memory of one block of a persistent sweep: R flip
    counters and, with the LFSR states resident, its tile's R x tile
    states (4 B each)."""
    return 4 * (R + (tile * R if resident else 0))


def smem_budget(R: int, n: int, sms: int) -> int:
    """Shared memory one block of a persistent sweep (int8 or f32) needs
    to hold its tile's LFSR states, at one block per SM: the tile (n / sms
    sites, rounded up) times R states of 4 B, plus R flip counters."""
    return persistent_smem(R, -(-n // sms), True)


def lfsr_resident(R: int, n: int, sms: int, smem_per_block: int) -> bool:
    """True where a persistent sweep keeps the LFSR states of R replicas
    of an n-site brick in shared memory, False where it keeps them in
    device memory."""
    return smem_budget(R, n, sms) <= smem_per_block


def launch_shape(R: int, n: int, resident: bool, sms: int, occupancy):
    """(grid, tile, smem bytes, blocks per SM) of a persistent sweep: the
    most blocks per SM, up to 4, that ``occupancy(smem)`` (blocks of this
    kernel one SM keeps resident with ``smem`` bytes each; 0 where a block
    may not have that much) keeps resident with their tiles' shared
    memory.  Each kernel (precision, LFSR mode) has its own register
    count, so its own answer."""
    for per_sm in (4, 3, 2, 1):
        blocks = per_sm * sms
        tile = -(-n // blocks)
        smem = persistent_smem(R, tile, resident)
        if occupancy(smem) >= per_sm:
            return blocks, tile, smem, per_sm
    raise RuntimeError(f"persistent sweep: not even one block per SM is "
                       f"resident with {smem} B of shared memory (R={R}, "
                       f"{n} sites)")


@functools.cache
def _persistent_config(index: int, kind: str, resident: bool, R: int,
                       n: int):
    """:func:`launch_shape` of the persistent ``kind`` ("f32", "int8")
    sweep on CUDA device ``index``, from the card's occupancy query."""
    lib = _build.library()

    def occupancy(smem: int) -> int:
        out = (ctypes.c_int * 1)()
        with torch.cuda.device(index):
            err = lib.pbit_persistent_occupancy(
                _KINDS[kind], int(resident), smem, ctypes.addressof(out))
        _build.check_launch("pbit_persistent_occupancy", err)
        return int(out[0])
    return launch_shape(R, n, resident, device_limits(index)[0], occupancy)


def persistent_mode(m) -> str:
    """The LFSR mode a persistent sweep (int8 or f32) takes for spins
    ``m`` ((R, X, Y, Z) or one brick) on its CUDA device: "lfsr_smem" or
    "lfsr_global"."""
    R = 1 if m.dim() == 3 else int(m.shape[0])
    n = int(np.prod(m.shape[-3:]))
    sms, smem = device_limits(m.device.index)
    return "lfsr_smem" if lfsr_resident(R, n, sms, smem) else "lfsr_global"


def _persistent(kind, name, entry, launch, m, s, S: int, n_colors: int,
                single: bool, grid):
    """One persistent launch of S sweeps: ``launch(bufs, s_out, resident,
    grid, tile, smem, lists, flips)`` returns the entry's error code.
    ``grid`` overrides the block count of the launch shape (a count the
    card cannot co-schedule fails to launch).  Counts the launch under
    ``name`` and ``name:<LFSR mode>``."""
    R, X, Y, Z = (int(d) for d in m.shape)
    n = X * Y * Z
    flips = torch.zeros(R, dtype=torch.int32, device=m.device)
    if S * n_colors == 0:
        return _done(single, m.clone(),
                     s.view(torch.int32).clone().view(torch.uint32), flips)
    mode = persistent_mode(m)
    resident = mode == "lfsr_smem"
    blocks, tile, smem, _ = _persistent_config(
        m.device.index, kind, resident, R, n)
    if grid is not None:
        blocks = int(grid)
        tile = -(-n // blocks)
        smem = persistent_smem(R, tile, resident)
    bufs = (torch.empty_like(m), torch.empty_like(m))
    s_out = _new_states(s)
    lists = torch.empty(blocks * n_colors * tile, dtype=torch.int32,
                        device=m.device)
    with torch.cuda.device(m.device):
        err = launch(bufs, s_out, int(resident), blocks, tile, smem,
                     lists.data_ptr(), flips.data_ptr())
    _build.check_launch(entry, err)
    _build.launch_counts[name] += 1
    _build.launch_counts[f"{name}:{mode}"] += 1
    return _done(single, bufs[(S * n_colors - 1) % 2], s_out, flips)


def pbit_brick_sweep_int(m, s, rows, masks, h_q, w6_q, halos, lut):
    """``len(rows)`` fixed-point sweeps of one brick, halos held fixed.

    m (X, Y, Z) int8 or (R, X, Y, Z) for R replicas; s uint32 of the same
    shape; rows (S,) shared or (S, R) int32 LUT rows; masks
    (n_colors, X, Y, Z) int8 (any masks: a site may be in several phases'
    masks or none); h_q and the six w6_q (X, Y, Z) int8; halos six int8
    planes (leading R when batched); lut (n_rows, lw) uint32.  Returns
    (m, s, flips) with flips int32 — (R,) when batched.  Inputs are not
    modified.  On CUDA all S sweeps are one persistent cooperative launch
    (:func:`persistent_mode` says where its LFSR states live).
    """
    if _build.plain_device(m):
        return _ref.pbit_brick_sweep_int_ref(m, s, rows, masks, h_q, w6_q,
                                             halos, lut)
    return _int_persistent(m, s, rows, masks, h_q, w6_q, halos, lut)


def _int_persistent(m, s, rows, masks, h_q, w6_q, halos, lut, grid=None):
    """The persistent int8 sweep; ``grid`` as :func:`_persistent`."""
    n_colors = int(masks.shape[0])
    single, m, s, halos = _checked(m, s, masks, (n_colors,), h_q, w6_q,
                                   halos, torch.int8)
    R, X, Y, Z = (int(d) for d in m.shape)
    n_rows, lw = (int(d) for d in lut.shape)
    _build.require("lut", lut, torch.uint32, (n_rows, lw), m.device)
    rows = device_rows(rows, R, n_rows, m.device)
    S = int(rows.shape[0])
    lib = _build.library()

    def launch(bufs, s_out, resident, blocks, tile, smem, lists, flips):
        return lib.pbit_sweep_int_persistent(
            m.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
            s.data_ptr(), s_out.data_ptr(), rows.data_ptr(),
            masks.data_ptr(), h_q.data_ptr(), _build.ptrs6(w6_q),
            _build.ptrs6(halos), lut.data_ptr(), lw, S, n_colors, R, X, Y, Z,
            resident, blocks, tile, smem, lists, flips, _build.stream_of(m))
    return _persistent("int8", "pbit_brick_sweep_int",
                       "pbit_sweep_int_persistent", launch, m, s, S,
                       n_colors, single, grid)


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
    """The persistent f32 sweep; ``grid`` as :func:`_persistent`."""
    n_colors = int(masks.shape[0])
    single, m, s, halos = _checked(m, s, masks, (n_colors,), h, w6, halos,
                                   torch.float32)
    R, X, Y, Z = (int(d) for d in m.shape)
    betas = device_betas(betas, R, m.device)
    S = int(betas.shape[0])
    lib = _build.library()

    def launch(bufs, s_out, resident, blocks, tile, smem, lists, flips):
        return lib.pbit_sweep_f32_persistent(
            m.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
            s.data_ptr(), s_out.data_ptr(), betas.data_ptr(),
            masks.data_ptr(), h.data_ptr(), _build.ptrs6(w6),
            _build.ptrs6(halos), *_fmt_args(fmt), S, n_colors, R, X, Y, Z,
            resident, blocks, tile, smem, lists, flips, _build.stream_of(m))
    return _persistent("f32", "pbit_brick_sweep", "pbit_sweep_f32_persistent",
                       launch, m, s, S, n_colors, single, grid)


# -- the single phases ---------------------------------------------------------

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
    return launch_update_int(m, s, row, parity_mask, h_q, w6_q, halos, lut)


def launch_update_int(m, s, row, parity_mask, h_q, w6_q, halos, lut,
                      flips=None):
    """The int8 phase kernel on CUDA tensors (arguments as
    :func:`pbit_brick_update_int`, ``bx`` checked by the caller); with
    ``flips`` ((R,) int32) each replica's changed sites are added to it
    in place, in the kernel.  Returns (m, s)."""
    single, m, s, halos = _checked(m, s, parity_mask, (), h_q, w6_q, halos,
                                   torch.int8)
    R, X, Y, Z = (int(d) for d in m.shape)
    n_rows, lw = (int(d) for d in lut.shape)
    _build.require("lut", lut, torch.uint32, (n_rows, lw), m.device)
    rows = device_rows(_one_phase(row), R, n_rows, m.device)
    m_out, s_out = torch.empty_like(m), _new_states(s)
    with torch.cuda.device(m.device):
        err = _build.library().pbit_update_int_phase(
            m.data_ptr(), m_out.data_ptr(), s.data_ptr(), s_out.data_ptr(),
            rows.data_ptr(), parity_mask.data_ptr(), h_q.data_ptr(),
            _build.ptrs6(w6_q), _build.ptrs6(halos), lut.data_ptr(), lw, R,
            X, Y, Z, _flips_ptr(flips, R, m.device), _build.stream_of(m))
    _build.check_launch("pbit_update_int_phase", err)
    _build.launch_counts["pbit_brick_update_int"] += 1
    return _done(single, m_out, s_out)


def phase_width(Z: int, wide, narrow) -> int:
    """z-sites per thread of the f32 phase kernel: 4 (one 32-bit word of
    spins per thread) where rows are word-aligned — Z a multiple of 4, the
    data pointers ``wide`` (LFSR states, f32 constants) 16-byte and
    ``narrow`` (spins, mask, halos) 4-byte aligned — else 1 (one site per
    thread)."""
    if Z % 4 == 0 and all(p % 16 == 0 for p in wide) and \
            all(p % 4 == 0 for p in narrow):
        return 4
    return 1


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
    return launch_update(m, s, beta, parity_mask, h, w6, halos, fmt)


def launch_update(m, s, beta, parity_mask, h, w6, halos,
                  fmt: Optional[FixedPoint] = None, flips=None):
    """The f32 phase kernel on CUDA tensors (arguments as
    :func:`pbit_brick_update`, ``bx`` checked by the caller), one thread
    per word of 4 z-sites or per site (:func:`phase_width`, counted as
    ``pbit_brick_update:word`` or ``:site``); ``flips`` as
    :func:`launch_update_int`.  Returns (m, s)."""
    single, m, s, halos = _checked(m, s, parity_mask, (), h, w6, halos,
                                   torch.float32)
    R, X, Y, Z = (int(d) for d in m.shape)
    betas = device_betas(_one_phase(beta), R, m.device)
    m_out, s_out = torch.empty_like(m), _new_states(s)
    width = phase_width(
        Z, [t.data_ptr() for t in (s, s_out, h, *w6)],
        [t.data_ptr() for t in (m, m_out, parity_mask, *halos)])
    with torch.cuda.device(m.device):
        err = _build.library().pbit_update_f32_phase(
            m.data_ptr(), m_out.data_ptr(), s.data_ptr(), s_out.data_ptr(),
            betas.data_ptr(), parity_mask.data_ptr(), h.data_ptr(),
            _build.ptrs6(w6), _build.ptrs6(halos), *_fmt_args(fmt), R, X, Y,
            Z, width, _flips_ptr(flips, R, m.device), _build.stream_of(m))
    _build.check_launch("pbit_update_f32_phase", err)
    _build.launch_counts["pbit_brick_update"] += 1
    _build.launch_counts["pbit_brick_update:" +
                         ("word" if width == 4 else "site")] += 1
    return _done(single, m_out, s_out)
