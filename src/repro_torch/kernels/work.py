"""The work of each hand kernel per launch: the bytes it must move and the
INT32 and FP32 operations it must do.

One model for every caller: ``launch/roofline.py`` costs the launches of
a recorded chunk with it (the dry run's bound), so a kernel's bound reads
the same work whatever implements it.  Bytes count every input read once and every output
written once; operations count what this call's data needs (the sites a
phase decides, the real entries of a colour, the slots its rows reach),
not the most it could need.  Per replica-site and phase one LFSR step is
6 INT32 operations; a decided replica-site costs 19 INT32 (int8: the
field's 12, index, clamp, LUT load and compare) or 18 FP32 (f32: the
field's 12, the draw's 2, the activation, tanh counted once, the add and
compare); the bit-plane word math 26 per decided word-site and 13 per
decided lane-site; the energy 17 FP32 per replica-site.

Each model takes shapes and the counts that depend on the data; the
helpers below read those counts from the kernels' operands.  A wrapper
notes each launch with ``_build.note_launch`` (shapes and operands), and
:func:`launch_work` costs a note; a kernel with no model raises.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Work", "halo_sites", "sweep_int", "bitplane_sweep", "sweep_f32",
           "energy", "update_int", "update_f32", "colour_phase",
           "decided", "phase_counts", "reached_slots",
           "launch_work", "MODELS"]


@dataclasses.dataclass(frozen=True)
class Work:
    """Bytes moved and INT32 / FP32 operations."""
    bytes: int
    int32: int = 0
    fp32: int = 0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.bytes + o.bytes, self.int32 + o.int32,
                    self.fp32 + o.fp32)


def halo_sites(X: int, Y: int, Z: int) -> int:
    """Sites of a brick's six halo planes."""
    return 2 * (Y * Z + X * Z + X * Y)


def sweep_int(R, X, Y, Z, n_colors, S, decided, lut_entries,
              sched_entries) -> Work:
    """#1, one persistent int8 sweep call of S sweeps: spins and LFSR
    states (5 B per replica-site) read and written, the masks and the
    int8 couplings, the halos, the flips, the LUT and the LUT rows;
    ``decided`` the masked sites over all colours."""
    n = X * Y * Z
    byts = (2 * 5 * R * n + (n_colors + 7) * n + 4 * R
            + R * halo_sites(X, Y, Z) + 4 * lut_entries + 4 * sched_entries)
    return Work(byts, S * R * (6 * n_colors * n + 19 * decided))


def bitplane_sweep(W, R, X, Y, Z, n_colors, S, decided, lut_entries,
                   sched_entries) -> Work:
    """#2, one bit-plane sweep call (S x n_colors colour launches): word
    planes and per-lane LFSR states read and written, the lane-masked
    colour masks, signs, nonzero masks and base (52 B per site), the word
    halos, the flips, the LUT and its rows; ``decided`` the sites in any
    colour's mask."""
    n = X * Y * Z
    byts = (2 * 4 * (W + R) * n + 4 * n_colors * W * n + 52 * n + 4 * R
            + 4 * W * halo_sites(X, Y, Z) + 4 * lut_entries
            + 4 * sched_entries)
    return Work(byts, S * (6 * n_colors * R * n
                           + decided * (26 * W + 13 * R)))


def sweep_f32(R, X, Y, Z, n_colors, S, decided) -> Work:
    """#3, one persistent f32 sweep call of S sweeps: as :func:`sweep_int`
    with f32 couplings (28 B per site) and (S, R) betas."""
    n = X * Y * Z
    byts = (2 * 5 * R * n + (n_colors + 28) * n + R * halo_sites(X, Y, Z)
            + 4 * R + 4 * S * R)
    return Work(byts, S * 6 * n_colors * R * n, S * 18 * R * decided)


def energy(R, X, Y, Z) -> Work:
    """#4, one energy call: the work of R int8 replicas (1 B per
    replica-site) whichever layout holds the spins, the active mask and
    f32 couplings, the halos, R sums."""
    n = X * Y * Z
    return Work(R * n + 29 * n + R * halo_sites(X, Y, Z) + 4 * R, 0,
                17 * R * n)


def update_int(R, X, Y, Z, decided, lut_entries) -> Work:
    """#5, one int8 phase: spins and states read and written, the mask and
    int8 couplings, the halos, the LUT, R rows."""
    n = X * Y * Z
    byts = (2 * 5 * R * n + 8 * n + R * halo_sites(X, Y, Z)
            + 4 * lut_entries + 4 * R)
    return Work(byts, R * (6 * n + 19 * decided))


def update_f32(R, X, Y, Z, decided) -> Work:
    """#6, one f32 phase: as :func:`update_int` with f32 couplings and R
    betas."""
    n = X * Y * Z
    byts = 2 * 5 * R * n + 29 * n + R * halo_sites(X, Y, Z) + 4 * R
    return Work(byts, 6 * R * n, 18 * R * decided)


def _gather_ops(D: int) -> int:
    """Operations of the gather-count per (partition, word, site): the
    XOR and AND of each neighbour plus 2 per slice it ripples through."""
    return sum(2 + 2 * (k - 1).bit_length() for k in range(1, D + 1))


def colour_phase(K, nc, D, W, R, real, keep, owners, reached,
                 lut_bytes) -> Work:
    """B7, one fused colour phase: the LFSR states of every owned slot's R
    lanes as int64, read and written; the own words of real entries read
    and, where not lost (``keep``), written; the neighbour and ghost words
    the rows reach through a nonzero mask, once per word plane; per real
    entry its D indices, signs and masks and its base, per entry its slot
    and flags; the LUT row or rows (``lut_bytes``); the R flip or energy
    sums.  Operations: per real (partition, word, site) the gather-count's,
    per real lane 6 for the LFSR step, 3 per slice to read its count and 5
    for the column, clamp and accept, and per padding owner's lane 6."""
    byts = (16 * R * owners + 4 * W * (real + keep) + 4 * W * reached
            + real * (12 * D + 4) + nc * K * 5 + 16 * R + lut_bytes)
    ops = (real * W * _gather_ops(D) + real * R * (11 + 3 * D.bit_length())
           + (owners - real) * R * 6)
    return Work(byts, ops)


# -- the counts that depend on the data ---------------------------------------

def decided(masks: torch.Tensor) -> int:
    """Sites a mask stack (or one mask) decides: its nonzero entries
    (uint32 lane masks through their int32 view)."""
    if masks.dtype == torch.uint32:
        masks = masks.view(torch.int32)
    return int((masks != 0).sum())


def reached_slots(idx: torch.Tensor, live: torch.Tensor) -> int:
    """Distinct slots per partition that (K, nc, D) rows ``idx`` reach
    where ``live`` (the same shape) holds, summed over the partitions."""
    return sum(int(torch.unique(idx[k][live[k]]).numel())
               for k in range(int(idx.shape[0])))


def phase_counts(sites) -> dict:
    """K, nc, D and the real, kept (not lost), owner entries and reached
    slots of a colour's ``PhaseSites``."""
    fl = sites.flags.cpu().numpy()
    K, nc, D = (int(d) for d in sites.idx.shape)
    live = (sites.nz.view(torch.int32) != 0) & sites.mask[..., None]
    return dict(K=K, nc=nc, D=D, real=int((fl & 1).sum()),
                keep=int(((fl & 1) & ~(fl >> 1) & 1).sum()),
                owners=int(((fl >> 2) & 1).sum()),
                reached=reached_slots(sites.idx, live))


# -- a noted launch -------------------------------------------------------------

def _with_decided(fn, key):
    def model(**kw):
        return fn(decided=decided(kw.pop(key)), **kw)
    return model


def _phase_note(sites, **kw):
    return colour_phase(**phase_counts(sites), **kw)


# each kernel's model as its wrapper notes it: by the key it counts its
# launches under (B7 by its route's), from the operands it notes
MODELS = {
    "pbit_brick_sweep_int": _with_decided(sweep_int, "masks"),
    "pbit_bitplane_sweep": _with_decided(bitplane_sweep, "masks"),
    "pbit_brick_sweep": _with_decided(sweep_f32, "masks"),
    "brick_energy": energy,
    "pbit_brick_update_int": _with_decided(update_int, "masks"),
    "pbit_brick_update": _with_decided(update_f32, "masks"),
    "bitplane_gather_count:phase": _phase_note,
}


def launch_work(name: str, operands: dict) -> Work:
    """The work of one noted call of kernel ``name`` (``operands`` as its
    wrapper noted them); raises for a kernel with no model: a launch is
    never costed at zero."""
    model = MODELS.get(name)
    if model is None:
        raise ValueError(f"no work model for kernel {name!r}: every launch "
                         f"of a recorded chunk must be costed")
    return model(**operands)
