"""Dispatch wrappers for the kernels; port of ``repro.kernels.ops``.

``impl`` selection:
  'cuda' — the hand-written CUDA kernel; raises on a CPU tensor.
  'ref'  — the plain PyTorch version, on whatever device the tensors are
           (the card runs it only when asked, as ``chip_smoke.py``'s
           comparisons do).
  'auto' — 'cuda' for CUDA tensors, 'ref' for CPU tensors.

``pbit_bitplane_sweep_op`` and ``pbit_bitplane_sweep_cm_op`` run in the
span ``repro_torch.wrapper.pbit_bitplane_sweep`` (``obs.trace.region``),
the key their kernel notes launches under (``_build.note_launch``), on
either implementation.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.pbit import FixedPoint
from repro_torch.obs.trace import region
from . import _build, bitplane_phase, lattice_energy, pbit_bitplane, \
    pbit_lattice, ref as _ref

__all__ = ["IMPLS", "resolve_impl", "pbit_update_op", "pbit_sweep_op",
           "pbit_update_int_op", "pbit_sweep_int_op",
           "pbit_bitplane_sweep_op", "pbit_bitplane_sweep_cm_op",
           "bitplane_gather_count_op",
           "bitplane_phase_op", "bitplane_phase_apt_op",
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
    with region("repro_torch.wrapper.pbit_bitplane_sweep"):
        if resolve_impl(impl, mw.is_cuda) == "ref":
            return _ref.pbit_bitplane_sweep_ref(mw, s, rows, masks_w, signs6,
                                                nz6, base, halos_w, lut)
        return pbit_bitplane.pbit_bitplane_sweep(mw, s, rows, masks_w,
                                                 signs6, nz6, base, halos_w,
                                                 lut)


def pbit_bitplane_sweep_cm_op(mw, s_cm, rows, masks_w, signs6, nz6, base,
                              halos_w, lut, impl: str = "auto"):
    """:func:`pbit_bitplane_sweep_op` with the LFSR columns ``s_cm`` (R,
    X*Y*Z) in the kernel's color-major order of the mask set
    (``pbit_bitplane.color_layout``), returned in that order: the lattice
    engine's form on CUDA, where nothing is permuted.  Port-internal.
    "ref" permutes them out, runs the plain version and permutes them
    back."""
    with region("repro_torch.wrapper.pbit_bitplane_sweep"):
        if resolve_impl(impl, mw.is_cuda) == "ref":
            order = pbit_bitplane.color_layout(masks_w, signs6, nz6,
                                               base).order
            s = pbit_bitplane.from_color_major(s_cm, order, mw.shape[1:])
            mw, s, flips = _ref.pbit_bitplane_sweep_ref(
                mw, s, rows, masks_w, signs6, nz6, base, halos_w, lut)
            return mw, pbit_bitplane.to_color_major(s, order), flips
        return pbit_bitplane.pbit_bitplane_sweep_cm(mw, s_cm, rows, masks_w,
                                                    signs6, nz6, base,
                                                    halos_w, lut)


def bitplane_gather_count_op(mext_w, idx_c, signs_c, nz_c,
                             impl: str = "auto"):
    """Per-lane +1-contribution bit-slice planes of a gather-graph (ELL)
    site set, for K partitions: mext_w (K, W, n_ext), idx_c / signs_c /
    nz_c (K, nc, D); returns ``ceil(log2(D+1))`` (K, W, nc) planes (at
    K=1 the reference's op).  Every impl runs the plain version on the
    tensors' device: no engine counts alone, the card's engines run B7
    fused into the colour phase (:func:`bitplane_phase_op`)."""
    resolve_impl(impl, mext_w.is_cuda)
    return _ref.bitplane_gather_count_ref(mext_w, idx_c, signs_c, nz_c)


def bitplane_phase_op(mw, ghosts_w, s, sites, lut, row: int, f_max: int,
                      flips, impl: str = "auto"):
    """One bit-plane colour phase of ``dsim_dist``, in place on the words
    ``mw`` (K, W, n_max) (int32 view) and the LFSR states ``s`` (K, R,
    n_max): the gather-count fused with the per-lane tail
    (:func:`repro_torch.kernels.bitplane_phase.bitplane_phase`; ``sites``
    a ``PhaseSites``, ``lut[row]`` the LUT row); each lane's flips are
    added to ``flips`` (R,) int64, which is returned.  Port-internal: the
    reference computes the phase with ``jnp`` around its gather-count."""
    if resolve_impl(impl, mw.is_cuda) == "ref":
        return _ref.bitplane_phase_ref(
            mw, ghosts_w, s, sites.slots, sites.mask, sites.lost, sites.idx,
            sites.signs, sites.nz, sites.base, lut[row], f_max, flips)
    return bitplane_phase.bitplane_phase(mw, ghosts_w, s, sites, lut, row,
                                         f_max, flips)


def bitplane_phase_apt_op(mw, s, sites, thr, f_max: int, E, scale: float,
                          impl: str = "auto"):
    """One colour phase of packed APT+ICM, in place on the words ``mw``
    (W, N), the LFSR states ``s`` (L, N) and the energies ``E`` (L,)
    (:func:`repro_torch.kernels.bitplane_phase.bitplane_phase_apt`; ``thr``
    (L, lw) one LUT row per lane).  Returns ``E``."""
    if resolve_impl(impl, mw.is_cuda) == "ref":
        return _ref.bitplane_phase_apt_ref(
            mw, s, sites.slots[0], sites.idx, sites.signs, sites.nz,
            sites.base[0], thr, f_max, E,
            torch.tensor(scale, dtype=torch.float32, device=E.device))
    return bitplane_phase.bitplane_phase_apt(mw, s, sites, thr, f_max, E,
                                             scale)


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
