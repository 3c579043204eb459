"""The p-bit update rule, the LFSR, and the fixed-point pipeline's
host-side quantization and threshold LUTs.

Port of ``repro.core.pbit``.  Everything that seeds or shapes the
dynamics — LFSR seeds, coupling quantization, the threshold LUT — is
computed on the host in numpy (f64 for the LUT) with the same operations
as the reference, so the port starts from bit-identical constants on any
device.  The f32 update rule (:func:`pbit_update`) evaluates ``tanh`` at
runtime, in PyTorch's math library: it is not bitwise the reference's
(``jnp.tanh`` differs by a few ulp on some inputs).

The fixed-point pipeline never evaluates tanh at runtime: the accept
test is

    accept(+1)  <=>  u >= T[beta, f] = ceil((1 - tanh(beta*scale*f)) * 2^23)

with u the 24-bit LFSR draw (state >> 8) and f the integer field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .bits import MASK32, i64_to_i32, i64_to_u32, u32_from_numpy, u32_to_i64

__all__ = ["FixedPoint", "S41", "S43", "S46", "LFSR_UNIFORM_BITS",
           "LUT_SELECT_MAX_WIDTH", "quantize", "pbit_update", "lfsr_init",
           "lfsr_next", "lfsr_uniform", "quantize_couplings",
           "field_bound", "threshold_lut", "threshold_lut_cached",
           "bitplane_planes", "flips_publish"]


def flips_publish(flips_i32: torch.Tensor, delta_u32: torch.Tensor):
    """Fold a uint32-modular flip delta into the int32 odometer view.

    Odometers are stored as int32 but their arithmetic is mod 2^32 in the
    unsigned domain: in-range totals equal a plain int32 add, and past
    2^31 the bits keep the exact modular count the recording driver folds
    on the host."""
    return i64_to_i32(u32_to_i64(flips_i32) + u32_to_i64(delta_u32))


@dataclasses.dataclass(frozen=True)
class FixedPoint:
    """Signed fixed point s{int_bits}{frac_bits}: step 2^-frac, saturating."""

    int_bits: int
    frac_bits: int

    @property
    def step(self) -> float:
        return 2.0 ** (-self.frac_bits)

    @property
    def lo(self) -> float:
        return -(2.0 ** self.int_bits)

    @property
    def hi(self) -> float:
        return 2.0 ** self.int_bits - self.step


S41 = FixedPoint(4, 1)  # EA benchmarks
S43 = FixedPoint(4, 3)  # Pegasus / Zephyr / 3SAT
S46 = FixedPoint(4, 6)  # G81 adaptive parallel tempering

LFSR_UNIFORM_BITS = 24  # the draw u = state >> 8 is uniform on [0, 2^24)
_HALF = 1 << (LFSR_UNIFORM_BITS - 1)   # 2^23: u/2^23 - 1 is the (-1,1) map

# Widest LUT row the reference's gather-free rank-count accept handles.
# The bit-plane path keeps the cap (same inputs fail the same way); the
# int8 CUDA kernel looks thresholds up directly and has none.
LUT_SELECT_MAX_WIDTH = 64


def quantize(x: torch.Tensor, fmt: Optional[FixedPoint]) -> torch.Tensor:
    """Round to nearest (half to even, as ``jnp.round``) and saturate to
    the fixed-point grid; the identity when ``fmt`` is None."""
    if fmt is None:
        return x
    return torch.clamp(torch.round(x / fmt.step) * fmt.step, fmt.lo, fmt.hi)


def pbit_update(field: torch.Tensor, beta, rand_u: torch.Tensor,
                fmt: Optional[FixedPoint] = None) -> torch.Tensor:
    """One synchronous p-bit update of an independent (same-color) set.

    ``field`` is the f32 h + sum_j J_ij m_j (before beta); ``beta`` a
    scalar or a tensor that broadcasts against it, taken as f32;
    ``rand_u`` uniform in (-1, 1).  Returns int8 spins in {-1, +1}, the
    tie going to +1."""
    beta = torch.as_tensor(beta, dtype=torch.float32, device=field.device)
    act = quantize(beta * field, fmt)
    return torch.where(torch.tanh(act) + rand_u >= 0, 1, -1).to(torch.int8)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def lfsr_init(n: int, seed: int) -> np.ndarray:
    """Nonzero uint32 states, seeded reproducibly (host-side numpy)."""
    rng = np.random.default_rng(np.uint64(seed) ^ np.uint64(0x9E3779B97F4A7C15))
    return rng.integers(1, 2 ** 32, size=n, dtype=np.uint32)


def lfsr_next(state: torch.Tensor) -> torch.Tensor:
    """xorshift32 step (Marsaglia) on every state.  Takes uint32 states
    and returns uint32, or takes int64-carried ones (``core/bits.py``) and
    returns int64."""
    s = u32_to_i64(state) if state.dtype == torch.uint32 else state
    s = s ^ ((s << 13) & MASK32)
    s = s ^ (s >> 17)
    s = s ^ ((s << 5) & MASK32)
    return i64_to_u32(s) if state.dtype == torch.uint32 else s


def lfsr_uniform(state: torch.Tensor) -> torch.Tensor:
    """uint32 (or int64-carried) state -> f32 uniform in (-1, 1), from the
    top 24 bits; exact in f32."""
    s = u32_to_i64(state) if state.dtype == torch.uint32 else state
    return (s >> 8).to(torch.float32) * (2.0 / 16777216.0) - 1.0


def quantize_couplings(h, w6, bits: int = 8):
    """Quantize biases + the six directional couplings to signed ``bits``.

    One symmetric per-problem scale covers h and all six planes; a common
    integer factor is divided out and folded into the scale, so +-J
    couplings land on +-1.  Returns ``(h_q, w6_q, scale)`` with int8
    numpy arrays and a float scale."""
    qmax = float(2 ** (bits - 1) - 1)
    h = _host(h).astype(np.float64)
    ws = [_host(w).astype(np.float64) for w in w6]
    amax = max([np.abs(h).max()] + [np.abs(w).max() for w in ws])
    scale = (amax / qmax) if amax > 0 else 1.0
    to_int = lambda a: np.clip(np.rint(a / scale), -qmax, qmax).astype(np.int64)  # noqa: E731
    qs = [to_int(h)] + [to_int(w) for w in ws]
    g = int(np.gcd.reduce([np.gcd.reduce(np.abs(q), axis=None) for q in qs]))
    if g > 1:
        qs = [q // g for q in qs]
        scale *= g
    qs = [q.astype(np.int8) for q in qs]
    return qs[0], tuple(qs[1:]), float(scale)


def field_bound(h_q, w6_q) -> int:
    """Tight per-site bound on |h_q + sum_d w_q[d] * m_d| over m in {-1,+1}."""
    b = np.abs(_host(h_q).astype(np.int64))
    for w in w6_q:
        b = b + np.abs(_host(w).astype(np.int64))
    return int(b.max())


def bitplane_planes(h_q, w6_q):
    """Sign-plane quantization: the bit-plane engine's per-site constants.

    With couplings in {-1, 0, +1} the field of lane r is
    ``h_q + 2*c - nnz`` with c the count of +1 contributions
    ``m_bit XOR (w_d < 0)`` over nonzero d, so the LUT column is
    ``base + 2*c`` with ``base = h_q - nnz + f_max``.  Returns
    ``(signs6, nz6, base, f_max)`` as numpy arrays (uint32 all-ones words
    where w_d < 0 / w_d != 0; int32 base).

    Raises ValueError when any |w_q| > 1 — such problems stay on int8.
    """
    ones = np.uint32(0xFFFFFFFF)
    h_q = _host(h_q).astype(np.int64)
    ws = [_host(w).astype(np.int64) for w in w6_q]
    bad = max(int(np.abs(w).max()) for w in ws)
    if bad > 1:
        raise ValueError(
            f"bitplane needs couplings quantized to {{-1, 0, +1}} (one sign "
            f"bit per neighbor); this problem quantizes to |w_q| up to "
            f"{bad}.  Use precision='int8' instead.")
    f_max = field_bound(h_q, ws)
    signs6 = tuple(np.where(w < 0, ones, 0).astype(np.uint32) for w in ws)
    nz6 = tuple(np.where(w != 0, ones, 0).astype(np.uint32) for w in ws)
    nnz = sum((w != 0).astype(np.int64) for w in ws)
    base = (h_q - nnz + f_max).astype(np.int32)
    return signs6, nz6, base, f_max


def threshold_lut(betas, scale: float, f_max: int,
                  fmt: Optional[FixedPoint] = None) -> np.ndarray:
    """(len(betas), 2*f_max+1) uint32 acceptance thresholds (host, f64).

    Row b, column f + f_max: accept +1 iff the 24-bit draw u >= T.  ``fmt``
    folds in (activation rounded and saturated before tanh).  Each row is
    monotone non-increasing in f, so a direct ``u >= T[row][f + f_max]``
    lookup equals the reference's rank-count accept."""
    betas = np.asarray(betas, np.float64).reshape(-1)
    if (betas < 0).any():
        raise ValueError("threshold LUTs need beta >= 0 (rows must be "
                         "monotone in the field for the rank-count accept)")
    f = np.arange(-int(f_max), int(f_max) + 1, dtype=np.float64)
    act = betas[:, None] * (float(scale) * f)[None, :]
    if fmt is not None:
        act = np.clip(np.round(act / fmt.step) * fmt.step, fmt.lo, fmt.hi)
    t = np.ceil((1.0 - np.tanh(act)) * _HALF)
    return np.clip(t, 0, 1 << LFSR_UNIFORM_BITS).astype(np.uint32)


def threshold_lut_cached(cache: dict, table: np.ndarray, scale: float,
                         f_max: int, fmt: Optional[FixedPoint] = None,
                         device="cpu") -> torch.Tensor:
    """Device-resident :func:`threshold_lut` (torch.uint32), memoized in the
    caller-owned ``cache``; the key covers everything that shapes it."""
    key = (table.tobytes(), float(scale), int(f_max), fmt, str(device))
    if key not in cache:
        cache[key] = u32_from_numpy(threshold_lut(table, scale, f_max,
                                                  fmt=fmt), device)
    return cache[key]
