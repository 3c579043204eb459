"""Wrapper of the fused bit-plane colour phase (``csrc/bitplane_phase.cu``).

The redesign of B7 (the reference's ``bitplane_gather_count_op``,
``repro/kernels/ops.py:120``, whose plain version
``ref.bitplane_gather_count_ref`` the port's op runs) for this card:
one launch per colour phase that gathers and counts the neighbour words
and runs the per-lane tail (LFSR step, LUT accept, word write, flip count
or energy change) in the same pass.  Two entry points: the distributed
DSIM's (K partitions, one LUT row, padded colour entries, flips) and packed
APT+ICM's (K = 1, one LUT row per lane, energies).  On a CPU tensor each
runs its plain version (``ref.bitplane_phase_ref``,
``ref.bitplane_phase_apt_ref``); on a CUDA tensor it launches the kernel
or raises.  Each launch counts under ``bitplane_gather_count`` and
``bitplane_gather_count:phase``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.device import as_numpy
from repro_torch.core.packing import LANE_WIDTH
from . import _build, ref as _ref

__all__ = ["PhaseSites", "phase_sites", "MASK", "LOST", "OWNER",
           "MAX_DEGREE", "n_slices", "words_per_thread", "bitplane_phase",
           "bitplane_phase_apt"]

MAX_DEGREE = 31     # at most 5 bit-slice planes in the kernel's registers


def n_slices(D: int) -> int:
    """Bit-slice planes of a count of D contributions: ceil(log2(D+1))."""
    return int(D).bit_length()


# flag bits of a colour entry (the kernel's)
MASK, LOST, OWNER = 1, 2, 4
# shared memory a block may take without opting in (the per-lane LUT rows)
_SMEM = 48 * 1024
# blocks per SM below which a thread takes one word of its site
_BLOCKS_PER_SM = 4


@dataclasses.dataclass
class PhaseSites:
    """One colour's entries for the fused phase, K partitions of nc each,
    in the plain version's forms and the kernel's (built once per colour
    by :func:`phase_sites`)."""

    slots: torch.Tensor            # (K, nc) int64 local slots
    mask: torch.Tensor             # (K, nc) bool: real sites
    lost: Optional[torch.Tensor]   # (K, nc) bool: updates padding undoes
    base: torch.Tensor             # (K, nc) int64 LUT-column base
    idx: torch.Tensor              # (K, nc, D) int32 neighbour slots
    signs: torch.Tensor            # (K, nc, D) uint32
    nz: torch.Tensor               # (K, nc, D) uint32
    slots32: torch.Tensor          # (K, nc) int32
    base32: torch.Tensor           # (K, nc) int32
    flags: torch.Tensor            # (K, nc) uint8: MASK | LOST | OWNER
    scratch: Optional[torch.Tensor] = None  # APT's energy sums and ticket
    checked: Optional[tuple] = None         # (device, K) validated for


def phase_sites(slots, mask, lost, idx, signs, nz, base) -> PhaseSites:
    """The :class:`PhaseSites` of one colour: slots (K, nc) (padding
    entries at slot 0 with ``mask`` False), mask and ``lost`` (K, nc) bool
    (``lost`` may be None), idx (K, nc, D) int32, signs and nz (K, nc, D)
    uint32, base (K, nc) integers.  The owner of a slot is its first entry
    in its partition; a real site that is not its slot's owner, or a lost
    entry that is no real site, raises (the kernel's threads would race
    on the slot's LFSR states)."""
    dev = idx.device
    slots = slots.long().contiguous()
    K, nc = (int(d) for d in slots.shape)
    if not 1 <= int(idx.shape[-1]) <= MAX_DEGREE:
        raise ValueError(f"the fused colour phase takes 1 to {MAX_DEGREE} "
                         f"neighbours per site, got D={int(idx.shape[-1])}")
    sl, ms = as_numpy(slots), as_numpy(mask).astype(bool)
    owner = np.zeros((K, nc), bool)
    for k in range(K):
        owner[k, np.unique(sl[k], return_index=True)[1]] = True
    if (ms & ~owner).any():
        raise ValueError("a real colour entry shares its slot with an "
                         "earlier entry of its partition")
    ls = np.zeros((K, nc), bool) if lost is None else \
        as_numpy(lost).astype(bool)
    if (ls & ~ms).any():
        raise ValueError("a lost entry must be a real site")
    flags = np.where(ms, MASK, 0) | np.where(ls, LOST, 0) | \
        np.where(owner, OWNER, 0)
    return PhaseSites(
        slots=slots, mask=mask.bool().contiguous(),
        lost=None if lost is None else lost.bool().contiguous(),
        base=base.long().contiguous(), idx=idx.contiguous(),
        signs=signs.contiguous(), nz=nz.contiguous(),
        slots32=slots.to(torch.int32), base32=base.to(torch.int32)
        .contiguous(), flags=torch.from_numpy(flags.astype(np.uint8)).to(dev))


def words_per_thread(K: int, nc: int, W: int, sms: int) -> int:
    """Words of its site a thread of the dsim_dist phase takes: all W
    where K * ceil(nc / 256) blocks fill ``_BLOCKS_PER_SM`` per SM (the
    per-site constants then read once), else one (W times the blocks)."""
    blocks = K * -(-nc // 256)
    return W if blocks >= _BLOCKS_PER_SM * sms else 1


def _check_sites(sites: PhaseSites, dev, K: int):
    """(nc, D) of ``sites``, whose kernel forms are checked once per
    device (they are constant)."""
    nc, D = int(sites.idx.shape[1]), int(sites.idx.shape[2])
    if sites.checked == (dev, K):
        return nc, D
    for name, t, dt, sh in (
            ("slots32", sites.slots32, torch.int32, (K, nc)),
            ("base32", sites.base32, torch.int32, (K, nc)),
            ("flags", sites.flags, torch.uint8, (K, nc)),
            ("idx", sites.idx, torch.int32, (K, nc, D)),
            ("signs", sites.signs, torch.uint32, (K, nc, D)),
            ("nz", sites.nz, torch.uint32, (K, nc, D))):
        _build.require(name, t, dt, sh, dev)
    sites.checked = (dev, K)
    return nc, D


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _count():
    _build.launch_counts["bitplane_gather_count"] += 1
    _build.launch_counts["bitplane_gather_count:phase"] += 1


def bitplane_phase(mw, ghosts_w, s, sites: PhaseSites, lut, row: int,
                   f_max: int, flips):
    """One colour phase of ``dsim_dist``'s bit-plane path, in place on the
    words ``mw`` (K, W, n_max) (int32 view) and the int64-carried LFSR
    states ``s`` (K, R, n_max), reading the ghost words ``ghosts_w`` (K,
    W, g_max) (int32 view); ``lut`` (rows, 2 f_max + 1) int64 thresholds
    and ``row`` the phase's row; ``flips`` (R,) int64, to which each
    lane's flips are added.  Returns ``flips``."""
    if _build.plain_device(mw):
        return _ref.bitplane_phase_ref(
            mw, ghosts_w, s, sites.slots, sites.mask, sites.lost, sites.idx,
            sites.signs, sites.nz, sites.base, lut[row], f_max, flips)
    K, W, n_max = (int(d) for d in mw.shape)
    R, g_max = int(s.shape[1]), int(ghosts_w.shape[2])
    dev = mw.device
    nc, D = _check_sites(sites, dev, K)
    lw = 2 * int(f_max) + 1
    _build.require("mw", mw, torch.int32, (K, W, n_max), dev)
    _build.require("ghosts_w", ghosts_w, torch.int32, (K, W, g_max), dev)
    _build.require("s", s, torch.int64, (K, R, n_max), dev)
    _build.require("lut", lut, torch.int64, (int(lut.shape[0]), lw), dev)
    _build.require("flips", flips, torch.int64, (R,), dev)
    if W != -(-R // LANE_WIDTH):
        raise ValueError(f"{R} lanes need {-(-R // LANE_WIDTH)} word "
                         f"planes, got W={W}")
    if not 0 <= int(row) < int(lut.shape[0]):
        raise ValueError(f"LUT row {row} outside [0, {int(lut.shape[0])})")
    if K * nc >= 1 << 31 or LANE_WIDTH * n_max >= 1 << 31:
        raise ValueError(f"{K} x {nc} sites of {n_max} slots: the kernel "
                         f"indexes them with int32")
    if nc == 0:
        return flips
    wpt = words_per_thread(K, nc, W, _sms(dev))
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.bitplane_phase_dist(
            mw.data_ptr(), ghosts_w.data_ptr(), s.data_ptr(),
            sites.slots32.data_ptr(), sites.flags.data_ptr(),
            sites.base32.data_ptr(), sites.idx.data_ptr(),
            sites.signs.data_ptr(), sites.nz.data_ptr(),
            lut.data_ptr() + 8 * lw * int(row), lw, int(f_max), K, W, R,
            n_max, g_max, nc, D, wpt, flips.data_ptr(),
            _build.stream_of(mw))
    _build.check_launch("bitplane_phase_dist", err)
    _count()
    _build.note_launch("bitplane_gather_count:phase", sites=sites, W=W, R=R,
                       lut_bytes=8 * lw)
    return flips


def bitplane_phase_apt(mw, s, sites: PhaseSites, thr, f_max: int, E,
                       scale):
    """One colour phase of packed APT+ICM, in place on the words ``mw``
    (W, N) uint32, the int64-carried LFSR states ``s`` (L, N) and the
    energies ``E`` (L,) f32: ``sites`` the colour's nodes (K = 1, every
    entry real), ``thr`` (L, 2 f_max + 1) int64 (lane l's LUT row),
    ``scale`` the f32 coupling scale (a float that f32 holds exactly).
    Returns ``E``."""
    if _build.plain_device(mw):
        return _ref.bitplane_phase_apt_ref(
            mw, s, sites.slots[0], sites.idx, sites.signs, sites.nz,
            sites.base[0], thr, f_max, E,
            torch.tensor(scale, dtype=torch.float32, device=E.device))
    W, n = (int(d) for d in mw.shape)
    L = int(s.shape[0])
    dev = mw.device
    nc, D = _check_sites(sites, dev, 1)
    lw = 2 * int(f_max) + 1
    _build.require("mw", mw, torch.uint32, (W, n), dev)
    _build.require("s", s, torch.int64, (L, n), dev)
    _build.require("thr", thr, torch.int64, (L, lw), dev)
    _build.require("E", E, torch.float32, (L,), dev)
    if W != -(-L // LANE_WIDTH):
        raise ValueError(f"{L} lanes need {-(-L // LANE_WIDTH)} word "
                         f"planes, got W={W}")
    if LANE_WIDTH * n >= 1 << 31:
        raise ValueError(f"{n} nodes: the kernel indexes them with int32")
    if 2 * int(f_max) * nc >= 1 << 24:
        # the plain version sums the integer energy changes in f32: exact
        # only below 2^24, where the kernel's int32 sum equals it
        raise ValueError(f"2 * f_max * nc = {2 * int(f_max) * nc} >= 2^24: "
                         f"the f32 energy sum is no longer exact")
    if 4 * (LANE_WIDTH * lw + LANE_WIDTH) > _SMEM:
        raise ValueError(f"LUT rows of {lw} entries: 32 of them exceed a "
                         f"block's {_SMEM} B of shared memory")
    if nc == 0:
        return E
    if sites.scratch is None or sites.scratch.device != dev or \
            int(sites.scratch.shape[0]) != L + 1:
        sites.scratch = torch.zeros(L + 1, dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.bitplane_phase_apt(
            mw.data_ptr(), s.data_ptr(), sites.slots32.data_ptr(),
            sites.base32.data_ptr(), sites.idx.data_ptr(),
            sites.signs.data_ptr(), sites.nz.data_ptr(), thr.data_ptr(), lw,
            int(f_max), W, L, n, nc, D, sites.scratch.data_ptr(),
            E.data_ptr(), float(np.float32(scale)), _build.stream_of(mw))
    _build.check_launch("bitplane_phase_apt", err)
    _count()
    _build.note_launch("bitplane_gather_count:phase", sites=sites, W=W, R=L,
                       lut_bytes=8 * L * lw + 8 * L)
    return E
