"""Dispatch wrappers for the kernels; port of ``repro.kernels.ops``.

``impl`` selection:
  'cuda' — the hand-written CUDA kernel; raises on a CPU tensor.
  'ref'  — the plain PyTorch version, on whatever device the tensors are
           (the card runs it only when asked, as ``chip_smoke.py``'s
           comparisons do).
  'auto' — 'cuda' for CUDA tensors, 'ref' for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.pbit import FixedPoint
from . import _build, bitplane_gather, lattice_energy, pbit_bitplane, \
    pbit_lattice, ref as _ref

__all__ = ["IMPLS", "resolve_impl", "pbit_update_op", "pbit_sweep_op",
           "pbit_update_int_op", "pbit_sweep_int_op",
           "pbit_bitplane_sweep_op", "bitplane_gather_count_op",
           "brick_energy_op", "brick_energy_words_op"]

IMPLS = ("auto", "cuda", "ref")


def resolve_impl(impl: str, on_cuda: bool) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    if impl == "auto":
        return "cuda" if on_cuda else "ref"
    if impl == "cuda" and not on_cuda:
        raise ValueError("impl='cuda' needs tensors on a CUDA device")
    return impl


def pbit_update_op(m, s, beta, parity_mask, h, w6, halos,
                   fmt: Optional[FixedPoint] = None,
                   bx: Optional[int] = None, impl: str = "auto",
                   flips=None):
    """One f32 color phase; ``beta`` scalar or (R,).  ``flips`` is
    port-internal (the engine's per-phase dispatch; the reference has no
    such argument): an (R,) int32 tensor of a replica batch to which each
    replica's changed sites are added in place, inside the kernel on CUDA.
    Returns (m, s)."""
    if resolve_impl(impl, m.is_cuda) == "ref":
        out = _ref.pbit_brick_update_ref(m, s, beta, parity_mask, h, w6,
                                         halos, fmt)
        if flips is not None:
            _ref.add_phase_flips_ref(flips, out[0], m)
        return out
    _build.check_bx(int(m.shape[-3]), bx)
    return pbit_lattice.launch_update(m, s, beta, parity_mask, h, w6, halos,
                                      fmt, flips)


def pbit_sweep_op(m, s, betas, masks, h, w6, halos,
                  fmt: Optional[FixedPoint] = None, impl: str = "auto"):
    """Fused f32 sweeps: len(betas) full color cycles against fixed halos,
    betas (S,) or (S, R).  Returns (m, s, flips)."""
    if resolve_impl(impl, m.is_cuda) == "ref":
        return _ref.pbit_brick_sweep_ref(m, s, betas, masks, h, w6, halos,
                                         fmt)
    return pbit_lattice.pbit_brick_sweep(m, s, betas, masks, h, w6, halos,
                                         fmt=fmt)


def pbit_update_int_op(m, s, row, parity_mask, h_q, w6_q, halos, lut,
                       bx: Optional[int] = None, impl: str = "auto",
                       flips=None):
    """One fixed-point color phase: int8 couplings, int32 fields, LUT
    thresholds (``row``, scalar or (R,), replaces beta); ``flips`` as
    :func:`pbit_update_op`.  Returns (m, s)."""
    if resolve_impl(impl, m.is_cuda) == "ref":
        out = _ref.pbit_brick_update_int_ref(m, s, row, parity_mask, h_q,
                                             w6_q, halos, lut)
        if flips is not None:
            _ref.add_phase_flips_ref(flips, out[0], m)
        return out
    _build.check_bx(int(m.shape[-3]), bx)
    return pbit_lattice.launch_update_int(m, s, row, parity_mask, h_q, w6_q,
                                          halos, lut, flips)


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


def bitplane_gather_count_op(mext_w, idx_c, signs_c, nz_c,
                             impl: str = "auto"):
    """Per-lane +1-contribution bit-slice planes of a gather-graph (ELL)
    site set, for K partitions: mext_w (K, W, n_ext), idx_c / signs_c /
    nz_c (K, nc, D); returns ``ceil(log2(D+1))`` (K, W, nc) planes (at
    K=1 the reference's op)."""
    if resolve_impl(impl, mext_w.is_cuda) == "ref":
        return _ref.bitplane_gather_count_ref(mext_w, idx_c, signs_c, nz_c)
    return bitplane_gather.bitplane_gather_count(mext_w, idx_c, signs_c,
                                                 nz_c)


def brick_energy_op(m, active, h, w6, halos, bx: Optional[int] = None,
                    impl: str = "auto"):
    """Brick energy, (R,) for a replica batch; ``bx`` as the kernels'
    (checked, changes no result)."""
    if resolve_impl(impl, m.is_cuda) == "ref":
        return _ref.brick_energy_ref(m, active, h, w6, halos)
    return lattice_energy.brick_energy(m, active, h, w6, halos, bx=bx)


def brick_energy_words_op(mw, n_lanes: int, active, h, w6, halos_w,
                          bx: Optional[int] = None, impl: str = "auto"):
    """Energies (n_lanes,) of the replicas in the bit lanes of word planes
    ``mw`` with word halos ``halos_w``: "ref" unpacks both and runs
    :func:`brick_energy_op`'s plain version (the reference's bit-plane
    readout); "cuda" reads the words directly."""
    if resolve_impl(impl, mw.is_cuda) == "ref":
        return _ref.brick_energy_words_ref(mw, n_lanes, active, h, w6,
                                           halos_w)
    return lattice_energy.brick_energy_words(mw, n_lanes, active, h, w6,
                                             halos_w, bx=bx)
