"""1-bit packing of p-bit states; port of ``repro.core.packing``.

* **site packing** (``pack_pm1``/``unpack_pm1``): the spins of one chain
  packed 8 per uint8 along the last axis, least significant bit first
  (1 = +1, 0 = -1): the wire format of the int8 and f32 halo exchange
  with ``bitpack_halos=True``.  A zero byte unpacks to eight -1 spins.
* **lane packing** (``pack_lanes``/``unpack_lanes``): a lane count L
  occupies ``W = ceil(L / 32)`` stacked uint32 word planes: lane ``l``
  lives at word ``l // 32``, bit ``l % 32`` (1 = +1, 0 = -1), and dead
  lanes are confined to the tail of the LAST word.  The bit-plane engine
  (``precision="bitplane"``) keeps its spins in this form, and APT+ICM's
  packed mode its (chains x temperatures) grid, whose replica-exchange
  swaps are lane permutations (``lane_permute``, ``lane_swap``).
"""

from __future__ import annotations

import torch

from .bits import i64_to_u32, u32_to_i64

__all__ = ["pad_to_multiple", "pack_pm1", "unpack_pm1", "LANE_WIDTH",
           "MAX_LANE_WORDS", "lane_words", "lane_shifts", "lane_coords",
           "pack_lanes", "unpack_lanes", "lane_permute", "lane_swap"]


def _pow2(device) -> torch.Tensor:
    return torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                        device=device)


def pad_to_multiple(n: int, k: int = 8) -> int:
    return ((n + k - 1) // k) * k


def pack_pm1(x: torch.Tensor) -> torch.Tensor:
    """Pack +-1 int8 spins (last dim, multiple of 8) into uint8 bitmaps."""
    *lead, n = x.shape
    if n % 8 != 0:
        raise ValueError("last dim must be a multiple of 8")
    bits = (x > 0).to(torch.uint8).reshape(*lead, n // 8, 8)
    return (bits * _pow2(x.device)).sum(dim=-1).to(torch.uint8)


def unpack_pm1(p: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_pm1`; returns +-1 int8 of last-dim size n."""
    *lead, nb = p.shape
    bits = (p[..., :, None] & _pow2(p.device)) > 0
    out = torch.where(bits, 1, -1).to(torch.int8).reshape(*lead, nb * 8)
    return out[..., :n]

LANE_WIDTH = 32       # replica lanes per word — the uint32 word width
MAX_LANE_WORDS = 8    # stacked word planes the packed paths accept (W cap)


def lane_words(n_lanes: int) -> int:
    """Word planes needed for ``n_lanes`` lanes: W = ceil(L / 32)."""
    n = int(n_lanes)
    if not 1 <= n <= MAX_LANE_WORDS * LANE_WIDTH:
        raise ValueError(
            f"n_lanes must be in [1, {MAX_LANE_WORDS * LANE_WIDTH}] "
            f"({MAX_LANE_WORDS} stacked uint32 word planes), got {n}")
    return (n + LANE_WIDTH - 1) // LANE_WIDTH


def lane_shifts(n_lanes: int, ndim: int, device="cpu") -> torch.Tensor:
    """(n_lanes, 1, ..., 1) int64 shift amounts broadcasting against an
    ``ndim``-dimensional word array: the within-word lane axis (<= 32
    lanes; across words pair :func:`lane_coords`)."""
    if not 1 <= n_lanes <= LANE_WIDTH:
        raise ValueError(f"n_lanes must be in [1, {LANE_WIDTH}], "
                         f"got {n_lanes}")
    return torch.arange(n_lanes, device=device).reshape(
        (n_lanes,) + (1,) * ndim)


def lane_coords(n_lanes: int, ndim: int, device="cpu"):
    """Per-lane (word index, bit shift) for extraction from stacked planes:
    ``word_idx`` (L,) int64 and ``bit_shift`` (L, 1, ..., 1) int64
    broadcasting against the ``ndim`` trailing dims of a (W, ...) word
    array, so lane l's bit of every site is
    ``(w[word_idx] >> bit_shift) & 1``, shape (L, ...)."""
    L = int(n_lanes)
    lane_words(L)      # validates the range
    ids = torch.arange(L, device=device)
    return ids // LANE_WIDTH, (ids % LANE_WIDTH).reshape(
        (L,) + (1,) * ndim)


def _scatter_bits(bits: torch.Tensor, W: int) -> torch.Tensor:
    """(L, ...) int64 0/1 lane bits -> (W, ...) uint32 words, the lanes
    >= L of the last word zero."""
    npad = W * LANE_WIDTH - int(bits.shape[0])
    if npad:
        bits = torch.cat([bits, bits.new_zeros((npad,) + bits.shape[1:])])
    bits = bits.reshape((W, LANE_WIDTH) + tuple(bits.shape[1:]))
    sh = torch.arange(LANE_WIDTH, device=bits.device).reshape(
        (1, LANE_WIDTH) + (1,) * (bits.ndim - 2))
    # lane bits are disjoint, so the sum is a bitwise OR
    return i64_to_u32((bits << sh).sum(dim=1))


def pack_lanes(x: torch.Tensor) -> torch.Tensor:
    """(R, ...) +-1 spins -> (W, ...) uint32 word planes, lanes >= R zero."""
    return _scatter_bits((x > 0).to(torch.int64), lane_words(int(x.shape[0])))


def unpack_lanes(w: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """Inverse of :func:`pack_lanes`: (W, ...) words -> (L, ...) int8."""
    L = int(n_lanes)
    W = lane_words(L)
    if int(w.shape[0]) != W:
        raise ValueError(f"{L} lanes need {W} word planes, got "
                         f"leading axis {int(w.shape[0])}")
    wl, sh = lane_coords(L, w.ndim - 1, w.device)
    bits = (u32_to_i64(w)[wl] >> sh) & 1
    return torch.where(bits != 0, 1, -1).to(torch.int8)


def lane_permute(w: torch.Tensor, perm) -> torch.Tensor:
    """Permute the replica lanes of (W, ...) uint32 word planes: out lane
    i = in lane perm[i], for an (L,) integer ``perm`` with L <= 32 W.  One
    bit gather and re-scatter serves any permutation, across word planes
    too; the output's lanes >= L are cleared."""
    perm = torch.as_tensor(perm, device=w.device).long()
    L, W = int(perm.shape[0]), int(w.shape[0])
    if not 1 <= L <= W * LANE_WIDTH:
        raise ValueError(f"perm must have 1..{W * LANE_WIDTH} lanes for "
                         f"{W} word plane(s), got {L}")
    sh = (perm % LANE_WIDTH).reshape((L,) + (1,) * (w.dim() - 1))
    bits = (u32_to_i64(w)[perm // LANE_WIDTH] >> sh) & 1
    return _scatter_bits(bits, W)


def lane_swap(w: torch.Tensor, i: int, j: int, accept=None) -> torch.Tensor:
    """Exchange bit lanes i and j of every site: d = bit_i XOR bit_j is
    XORed back into both lanes (lane l = word l//32, bit l%32).  ``accept``
    (bool, broadcasting against one word plane) gates the swap.  Returns
    new words."""
    wi, bi = divmod(int(i), LANE_WIDTH)
    wj, bj = divmod(int(j), LANE_WIDTH)
    x = u32_to_i64(w)
    d = ((x[wi] >> bi) ^ (x[wj] >> bj)) & 1
    if accept is not None:
        d = torch.where(torch.as_tensor(accept, device=w.device), d, 0)
    x = x.clone()
    x[wi] ^= d << bi
    x[wj] ^= d << bj
    return i64_to_u32(x)
