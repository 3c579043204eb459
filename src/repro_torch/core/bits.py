"""uint32 words carried through PyTorch.

PyTorch stores ``torch.uint32`` but implements almost no arithmetic on it
(no shifts on the CPU, few kernels of any kind on CUDA), and ``int32 >>``
is an arithmetic shift.  So LFSR states and spin words are *stored* as
``torch.uint32`` (the reference's dtype, and what the CUDA kernels read as
``uint32_t``) and every plain-PyTorch computation on them runs in int64
masked to 32 bits.  Conversions go through the same-width ``int32`` view,
which every device supports.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MASK32", "u32_to_i64", "i64_to_u32", "i64_to_i32",
           "u32_from_numpy", "u32_to_numpy", "u32_zeros"]

MASK32 = 0xFFFFFFFF


def u32_to_i64(t: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32 bit pattern) -> int64 in [0, 2^32)."""
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.to(torch.int64) & MASK32


def i64_to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    x = t & MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def i64_to_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 -> uint32 keeping the low 32 bits."""
    return i64_to_i32(t).view(torch.uint32)


def u32_from_numpy(a, device) -> torch.Tensor:
    """numpy uint32 array -> torch.uint32 tensor on ``device`` (an owned
    copy: the source may be a read-only buffer)."""
    a = np.array(a, np.uint32, order="C")
    return torch.from_numpy(a.view(np.int32)).to(device).view(torch.uint32)


def u32_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch.uint32 tensor (any device) -> owned numpy uint32 copy."""
    return t.view(torch.int32).cpu().numpy().view(np.uint32).copy()


def u32_zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int32, device=device).view(
        torch.uint32)
