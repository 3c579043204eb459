"""Wrappers of the brick-energy kernel (``csrc/lattice_energy.cu``).

Port of ``repro.kernels.lattice_energy.brick_energy``, for int8 spins
(:func:`brick_energy`) and for the bit-plane engine's word planes read
without unpacking (:func:`brick_energy_words`; the reference unpacks the
lanes and runs ``brick_energy``).  On a CPU tensor each runs its plain
version, ``ref.brick_energy_ref`` / ``ref.brick_energy_words_ref``.  On
CUDA both launch the same two kernels, which reduce in a fixed order: the
same spins give the same bits on every call, and a word plane's lanes the
bits of the int8 replicas they hold.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.packing import lane_words
from . import _build, ref as _ref
from .pbit_lattice import count_width, halo_shapes, phase_width

__all__ = ["brick_energy", "brick_energy_words"]

# threads per block of the energy kernel (kBlock, csrc/common.cuh)
_THREADS = 256


def brick_energy(m, active, h, w6, halos, bx: Optional[int] = None):
    """Brick Ising energy ``sum active * (-1/2 m sum_d w_d m_d - h m)``.

    m (X, Y, Z) int8 or (R, X, Y, Z); active (X, Y, Z) int8; h and the
    six w6 (X, Y, Z) f32 (the unquantized problem); halos six int8 planes
    (leading R when batched).  ``bx`` is the reference's x tile: it must
    divide X (else the reference's ValueError) and changes no result (the
    grid tiles the brick anyway).  Returns an f32 scalar, or (R,) batched.
    """
    _build.check_bx(int(m.shape[-3]), bx)
    if _build.plain_device(m):
        return _ref.brick_energy_ref(m, active, h, w6, halos)
    single = m.dim() == 3
    if single:
        m = m.unsqueeze(0)
        halos = tuple(hh.unsqueeze(0) for hh in halos)
    width = phase_width(int(m.shape[-1]),
                        [t.data_ptr() for t in (h, *w6)],
                        [t.data_ptr() for t in (m, active, *halos)])
    out = _launch("brick_energy", m, halos, torch.int8, (), int(m.shape[0]),
                  active, h, w6, width)
    return out[0] if single else out


def brick_energy_words(mw, n_lanes: int, active, h, w6, halos_w,
                       bx: Optional[int] = None):
    """Energies of the ``n_lanes`` replicas held in the bit lanes of word
    planes: lane b of plane w is replica w*32+b (bit 1 = +1).

    mw (W, X, Y, Z) uint32 with W = ceil(n_lanes / 32); halos_w six uint32
    word halo planes (W, plane); the rest and ``bx`` as
    :func:`brick_energy`.  Equals :func:`brick_energy` of the unpacked
    spins and halos bitwise (a zero halo word unpacks to -1 spins, as in
    the reference's readout).  Returns (n_lanes,) f32.  On CUDA each word
    of neighbors is loaded once for its 32 lanes (counted also as
    ``brick_energy:bitplane``).
    """
    _build.check_bx(int(mw.shape[-3]), bx)
    if _build.plain_device(mw):
        return _ref.brick_energy_words_ref(mw, n_lanes, active, h, w6,
                                           halos_w)
    W = lane_words(n_lanes)
    width = phase_width(int(mw.shape[-1]),
                        [t.data_ptr() for t in (h, *w6, mw, *halos_w[:4])],
                        [t.data_ptr() for t in (active, *halos_w[4:])])
    out = _launch("brick_energy_words", mw, halos_w, torch.uint32, (W,),
                  int(n_lanes), active, h, w6, width)
    _build.launch_counts["brick_energy:bitplane"] += 1
    return out


def _launch(entry, m, halos, dtype, extra, R, active, h, w6, width):
    """Check ``dtype`` spins ``m`` (lead, X, Y, Z) and halos (lead R, or W
    = ``extra[0]`` word planes) and the constants, then run both passes
    through the C ``entry`` (its arguments after the halos: ``extra``, then
    R, X, Y, Z, ...).  Returns (R,) f32."""
    lead = extra[0] if extra else R
    X, Y, Z = (int(d) for d in m.shape[1:])
    _build.check_sites(X, Y, Z)
    dev = m.device
    _build.require("m", m, dtype, (lead, X, Y, Z), dev)
    _build.require("active", active, torch.int8, (X, Y, Z), dev)
    _build.require("h", h, torch.float32, (X, Y, Z), dev)
    for d, w in enumerate(w6):
        _build.require(f"w6[{d}]", w, torch.float32, (X, Y, Z), dev)
    for d, (hh, sh) in enumerate(zip(halos, halo_shapes(lead, X, Y, Z))):
        _build.require(f"halos[{d}]", hh, dtype, sh, dev)
    blocks = -(-(X * Y * Z // width) // _THREADS)
    partials = torch.empty(blocks * R, dtype=torch.float32, device=dev)
    out = torch.empty(R, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(_build.library(), entry)(
            m.data_ptr(), active.data_ptr(), h.data_ptr(), _build.ptrs6(w6),
            _build.ptrs6(halos), *extra, R, X, Y, Z, width, blocks,
            partials.data_ptr(), out.data_ptr(), _build.stream_of(m))
    _build.check_launch(entry, err)
    count_width("brick_energy", width)
    _build.note_launch("brick_energy", R=R, X=X, Y=Y, Z=Z)
    return out
