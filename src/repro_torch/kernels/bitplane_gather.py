"""Wrapper of the ELL word gather-count kernel (``csrc/bitplane_gather.cu``).

Port of ``repro.kernels.ops.bitplane_gather_count_op`` (the plain jnp
``bitplane_gather_count_ref``; it has no Pallas original) with a partition
axis: one launch covers the K partitions of a one-process mesh.  On a CPU
tensor it runs the plain version, ``ref.bitplane_gather_count_ref``.
"""

from __future__ import annotations

import torch

from . import _build, ref as _ref

__all__ = ["MAX_DEGREE", "n_slices", "bitplane_gather_count"]

MAX_DEGREE = 31     # at most 5 bit-slice planes in the kernel's registers


def n_slices(D: int) -> int:
    """Bit-slice planes of a count of D contributions: ceil(log2(D+1))."""
    return int(D).bit_length()


def bitplane_gather_count(mext_w, idx_c, signs_c, nz_c):
    """Per-lane +1-contribution counts of one colour's sites as bit-slice
    planes.  mext_w (K, W, n_ext) uint32 word pools; idx_c (K, nc, D)
    int32 slots, each in [0, n_ext) (the kernel does not check them);
    signs_c, nz_c (K, nc, D) uint32.  Returns a list of
    ``ceil(log2(D+1))`` (K, W, nc) uint32 planes."""
    if _build.plain_device(mext_w):
        return _ref.bitplane_gather_count_ref(mext_w, idx_c, signs_c, nz_c)
    K, W, n_ext = (int(d) for d in mext_w.shape)
    nc, D = int(idx_c.shape[1]), int(idx_c.shape[2])
    if not 1 <= D <= MAX_DEGREE:
        raise ValueError(f"bitplane_gather_count takes 1 to {MAX_DEGREE} "
                         f"neighbours per site, got D={D}")
    if K * nc >= 1 << 31:
        raise ValueError(f"{K} x {nc} sites: the kernel counts them with "
                         f"int32")
    dev = mext_w.device
    u32 = torch.uint32
    _build.require("mext_w", mext_w, u32, (K, W, n_ext), dev)
    _build.require("idx_c", idx_c, torch.int32, (K, nc, D), dev)
    _build.require("signs_c", signs_c, u32, (K, nc, D), dev)
    _build.require("nz_c", nz_c, u32, (K, nc, D), dev)
    out = torch.empty((n_slices(D), K, W, nc), dtype=torch.int32,
                      device=dev).view(u32)
    if K * W * nc:
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.bitplane_gather_count(
                mext_w.data_ptr(), idx_c.data_ptr(), signs_c.data_ptr(),
                nz_c.data_ptr(), out.data_ptr(), K, W, n_ext, nc, D,
                _build.stream_of(mext_w))
        _build.check_launch("bitplane_gather_count", err)
        _build.launch_counts["bitplane_gather_count"] += 1
    return list(out.unbind(0))
