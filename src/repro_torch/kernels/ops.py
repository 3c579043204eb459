"""Dispatch wrappers for the lattice kernels; port of ``repro.kernels.ops``.

``impl`` selection:
  'cuda' — the hand-written CUDA kernel; raises on a CPU tensor.
  'ref'  — the plain PyTorch version, on whatever device the tensors are
           (the card runs it only when asked, as ``chip_smoke.py``'s
           comparisons do).
  'auto' — 'cuda' for CUDA tensors, 'ref' for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

from . import lattice_energy, pbit_bitplane, pbit_lattice, ref as _ref

__all__ = ["IMPLS", "resolve_impl", "pbit_sweep_int_op",
           "pbit_bitplane_sweep_op", "brick_energy_op"]

IMPLS = ("auto", "cuda", "ref")


def resolve_impl(impl: str, on_cuda: bool) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    if impl == "auto":
        return "cuda" if on_cuda else "ref"
    if impl == "cuda" and not on_cuda:
        raise ValueError("impl='cuda' needs tensors on a CUDA device")
    return impl


def pbit_sweep_int_op(m, s, rows, masks, h_q, w6_q, halos, lut,
                      impl: str = "auto"):
    """Fused fixed-point sweeps: len(rows) full color cycles against fixed
    halos, annealing as LUT row indices.  Returns (m, s, flips)."""
    if resolve_impl(impl, m.is_cuda) == "ref":
        return _ref.pbit_brick_sweep_int_ref(m, s, rows, masks, h_q, w6_q,
                                             halos, lut)
    return pbit_lattice.pbit_brick_sweep_int(m, s, rows, masks, h_q, w6_q,
                                             halos, lut)


def pbit_bitplane_sweep_op(mw, s, rows, masks_w, signs6, nz6, base, halos_w,
                           lut, impl: str = "auto"):
    """Multi-spin-coded sweeps over W stacked word planes (lane l = word
    l//32, bit l%32); ``rows`` (S,) shared or (S, R) per lane.  Returns
    (mw, s, flips:(R,) int32)."""
    if resolve_impl(impl, mw.is_cuda) == "ref":
        return _ref.pbit_bitplane_sweep_ref(mw, s, rows, masks_w, signs6,
                                            nz6, base, halos_w, lut)
    return pbit_bitplane.pbit_bitplane_sweep(mw, s, rows, masks_w, signs6,
                                             nz6, base, halos_w, lut)


def brick_energy_op(m, active, h, w6, halos, bx: Optional[int] = None,
                    impl: str = "auto"):
    """Brick energy; ``bx`` (the reference's x-tiling) is not ported."""
    if bx is not None:
        raise NotImplementedError(
            "bx (x-tiled kernels) comes with the per-phase kernels: "
            "ROADMAP.md queue A, slice 2")
    if resolve_impl(impl, m.is_cuda) == "ref":
        return _ref.brick_energy_ref(m, active, h, w6, halos)
    return lattice_energy.brick_energy(m, active, h, w6, halos)
