"""Wrapper of the brick-energy kernel (``csrc/lattice_energy.cu``).

Port of ``repro.kernels.lattice_energy.brick_energy``.  On a CPU tensor it
runs the plain version, ``ref.brick_energy_ref``.
"""

from __future__ import annotations

import torch

from . import _build, ref as _ref
from .pbit_lattice import halo_shapes

__all__ = ["brick_energy"]


def brick_energy(m, active, h, w6, halos):
    """Brick Ising energy ``sum active * (-1/2 m sum_d w_d m_d - h m)``.

    m (X, Y, Z) int8 or (R, X, Y, Z); active (X, Y, Z) int8; h and the
    six w6 (X, Y, Z) f32 (the unquantized problem); halos six int8 planes
    (leading R when batched).  Returns an f32 scalar, or (R,) batched.
    """
    if _build.plain_device(m):
        return _ref.brick_energy_ref(m, active, h, w6, halos)
    single = m.dim() == 3
    if single:
        m = m.unsqueeze(0)
        halos = tuple(hh.unsqueeze(0) for hh in halos)
    R, X, Y, Z = (int(d) for d in m.shape)
    _build.check_sites(X, Y, Z)
    dev = m.device
    _build.require("m", m, torch.int8, (R, X, Y, Z), dev)
    _build.require("active", active, torch.int8, (X, Y, Z), dev)
    _build.require("h", h, torch.float32, (X, Y, Z), dev)
    for d, w in enumerate(w6):
        _build.require(f"w6[{d}]", w, torch.float32, (X, Y, Z), dev)
    for d, (hh, sh) in enumerate(zip(halos, halo_shapes(R, X, Y, Z))):
        _build.require(f"halos[{d}]", hh, torch.int8, sh, dev)
    out = torch.zeros(R, dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.brick_energy(m.data_ptr(), active.data_ptr(), h.data_ptr(),
                               _build.ptrs6(w6), _build.ptrs6(halos), R, X, Y,
                               Z, out.data_ptr(), _build.stream_of(m))
    _build.check_launch("brick_energy", err)
    _build.launch_counts["brick_energy"] += 1
    return out[0] if single else out
