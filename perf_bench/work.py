"""The yardstick of the kernels: the bytes and INT32 / FP32 operations each
hand kernel must do per call, the card's peaks, and the bound they give.

A frozen copy of the port's ``repro_torch.kernels.work`` (the models of
kernels #1-#6 and B7), kept here so that a later change to the program
cannot move what its kernels are measured against.  One change from the
copy: B7's fused colour phase (:func:`colour_phase`) counts each lane's
xorshift32 state at the 4 bytes its data needs, read once and written
once, where the program's model counts the 8-byte carrier the kernel
happens to use.  A change that lowers the operations the algorithm itself
needs (say, bit-sliced LFSRs) is a reason to recount here, in a change to
the benchmark; a change that makes a kernel faster is not.

Bytes count every input read once and every output written once;
operations count what the call's data needs (the sites a phase decides,
the real entries of a colour, the slots its rows reach), not the most it
could need.  Per replica-site and phase one xorshift32 step is 6 INT32
operations; a decided replica-site costs 19 INT32 (int8) or 18 FP32
(f32); the bit-plane word math 26 per decided word-site and 13 per decided
lane-site; the energy 17 FP32 per replica-site.

Each model takes shapes and the counts that depend on the data; the
helpers read those counts from the operands a kernel's wrapper notes
(``repro_torch.kernels._build.note_launch``), under the name it notes.
"""

from __future__ import annotations

import dataclasses

import torch

# One NVIDIA H100 SXM: HBM3 bandwidth from the data sheet; the INT32 and
# FP32 lane operations per SM per clock (no FMA counted: the kernels build
# with --fmad=false) at 132 SMs and the 1980 MHz maximum SM clock.
PEAKS = {
    "bytes": 3.35e12,                      # B/s
    "int32": 132 * 64 * 1.98e9,            # operations/s
    "fp32": 132 * 128 * 1.98e9,            # operations/s
}


@dataclasses.dataclass(frozen=True)
class Work:
    """Bytes moved and INT32 / FP32 operations."""
    bytes: int
    int32: int = 0
    fp32: int = 0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.bytes + o.bytes, self.int32 + o.int32,
                    self.fp32 + o.fp32)

    def __mul__(self, k: int) -> "Work":
        return Work(self.bytes * k, self.int32 * k, self.fp32 * k)


def bound(work: Work, peaks: dict = PEAKS) -> tuple:
    """(what bounds it, seconds, {term: seconds}): the largest of the
    bytes over the bandwidth and each kind of operation over its peak."""
    terms = {"bytes": work.bytes / peaks["bytes"],
             "int32": work.int32 / peaks["int32"],
             "fp32": work.fp32 / peaks["fp32"]}
    by = max(terms, key=terms.get)
    return by, terms[by], terms


def halo_sites(X: int, Y: int, Z: int) -> int:
    """Sites of a brick's six halo planes."""
    return 2 * (Y * Z + X * Z + X * Y)


def sweep_int(R, X, Y, Z, n_colors, S, decided, lut_entries,
              sched_entries) -> Work:
    """#1, one persistent int8 sweep call of S sweeps: spins and states (5 B
    per replica-site) read and written, the masks and int8 couplings, the
    halos, the flips, the LUT and its rows."""
    n = X * Y * Z
    byts = (2 * 5 * R * n + (n_colors + 7) * n + 4 * R
            + R * halo_sites(X, Y, Z) + 4 * lut_entries + 4 * sched_entries)
    return Work(byts, S * R * (6 * n_colors * n + 19 * decided))


def bitplane_sweep(W, R, X, Y, Z, n_colors, S, decided, lut_entries,
                   sched_entries) -> Work:
    """#2, one bit-plane sweep call (S x n_colors colour launches): word
    planes and per-lane states read and written, the lane-masked colour
    masks, signs, nonzero masks and base (52 B per site), the word halos,
    the flips, the LUT and its rows; ``decided`` the sites in any colour's
    mask."""
    n = X * Y * Z
    byts = (2 * 4 * (W + R) * n + 4 * n_colors * W * n + 52 * n + 4 * R
            + 4 * W * halo_sites(X, Y, Z) + 4 * lut_entries
            + 4 * sched_entries)
    return Work(byts, S * (6 * n_colors * R * n
                           + decided * (26 * W + 13 * R)))


def sweep_f32(R, X, Y, Z, n_colors, S, decided) -> Work:
    """#3, one persistent f32 sweep call of S sweeps."""
    n = X * Y * Z
    byts = (2 * 5 * R * n + (n_colors + 28) * n + R * halo_sites(X, Y, Z)
            + 4 * R + 4 * S * R)
    return Work(byts, S * 6 * n_colors * R * n, S * 18 * R * decided)


def energy(R, X, Y, Z) -> Work:
    """#4, one energy call of R replicas."""
    n = X * Y * Z
    return Work(R * n + 29 * n + R * halo_sites(X, Y, Z) + 4 * R, 0,
                17 * R * n)


def update_int(R, X, Y, Z, decided, lut_entries) -> Work:
    """#5, one int8 phase."""
    n = X * Y * Z
    byts = (2 * 5 * R * n + 8 * n + R * halo_sites(X, Y, Z)
            + 4 * lut_entries + 4 * R)
    return Work(byts, R * (6 * n + 19 * decided))


def update_f32(R, X, Y, Z, decided) -> Work:
    """#6, one f32 phase."""
    n = X * Y * Z
    byts = 2 * 5 * R * n + 29 * n + R * halo_sites(X, Y, Z) + 4 * R
    return Work(byts, 6 * R * n, 18 * R * decided)


def _gather_ops(D: int) -> int:
    """Operations of the gather-count per (partition, word, site): the XOR
    and AND of each neighbour plus 2 per slice it ripples through."""
    return sum(2 + 2 * (k - 1).bit_length() for k in range(1, D + 1))


def colour_phase(K, nc, D, W, R, real, keep, owners, reached,
                 lut_bytes) -> Work:
    """B7, one fused colour phase: the xorshift32 state of every owned
    slot's R lanes, 4 B read and 4 B written (the program's model: 16 B,
    its int64 carrier); the own words of real entries read and, where not
    lost (``keep``), written; the neighbour and ghost words the rows reach,
    once per word plane; per real entry its D indices, signs and masks and
    its base, per entry its slot and flags; the LUT row; the R flip sums.
    Operations: per real (partition, word, site) the gather-count's, per
    real lane 6 for the step, 3 per slice to read its count and 5 for the
    column, clamp and accept, and per padding owner's lane 6."""
    byts = (8 * R * owners + 4 * W * (real + keep) + 4 * W * reached
            + real * (12 * D + 4) + nc * K * 5 + 16 * R + lut_bytes)
    ops = (real * W * _gather_ops(D) + real * R * (11 + 3 * D.bit_length())
           + (owners - real) * R * 6)
    return Work(byts, ops)


def gather_count(K, W, nc, D, reached) -> Work:
    """B7's standalone gather-count."""
    byts = 4 * W * reached + 3 * 4 * K * nc * D \
        + 4 * D.bit_length() * K * W * nc
    return Work(byts, K * W * nc * _gather_ops(D))


# -- the counts that depend on the data ---------------------------------------

def decided(masks: torch.Tensor) -> int:
    """Sites a mask stack (or one mask) decides: its nonzero entries."""
    if masks.dtype == torch.uint32:
        masks = masks.view(torch.int32)
    return int((masks != 0).sum())


def reached_slots(idx: torch.Tensor, live: torch.Tensor) -> int:
    """Distinct slots per partition that (K, nc, D) rows ``idx`` reach where
    ``live`` holds, summed over the partitions."""
    return sum(int(torch.unique(idx[k][live[k]]).numel())
               for k in range(int(idx.shape[0])))


def phase_counts(sites) -> dict:
    """K, nc, D and the real, kept, owner entries and reached slots of a
    colour's entries as the fused phase's wrapper notes them (flags: bit 0
    a real site, bit 1 lost, bit 2 its slot's owner)."""
    fl = sites.flags.cpu().numpy()
    K, nc, D = (int(d) for d in sites.idx.shape)
    live = (sites.nz.view(torch.int32) != 0) & sites.mask[..., None]
    return dict(K=K, nc=nc, D=D, real=int((fl & 1).sum()),
                keep=int(((fl & 1) & ~(fl >> 1) & 1).sum()),
                owners=int(((fl >> 2) & 1).sum()),
                reached=reached_slots(sites.idx, live))


def _with_decided(fn, key):
    def model(**kw):
        return fn(decided=decided(kw.pop(key)), **kw)
    return model


def _phase_note(sites, **kw):
    return colour_phase(**phase_counts(sites), **kw)


def _count_note(idx, nz, W):
    K, nc, D = (int(d) for d in idx.shape)
    return gather_count(K, W, nc, D,
                        reached_slots(idx, nz.view(torch.int32) != 0))


# each kernel's model under the name its wrapper notes a call with
MODELS = {
    "pbit_brick_sweep_int": _with_decided(sweep_int, "masks"),
    "pbit_bitplane_sweep": _with_decided(bitplane_sweep, "masks"),
    "pbit_brick_sweep": _with_decided(sweep_f32, "masks"),
    "brick_energy": energy,
    "pbit_brick_update_int": _with_decided(update_int, "masks"),
    "pbit_brick_update": _with_decided(update_f32, "masks"),
    "bitplane_gather_count:phase": _phase_note,
    "bitplane_gather_count:count": _count_note,
}


def call_work(name: str, operands: dict) -> Work:
    """The work of one noted call of kernel ``name``; raises for a kernel
    with no model here."""
    model = MODELS.get(name)
    if model is None:
        raise KeyError(f"no work model for kernel {name!r}")
    return model(**dict(operands))
