"""Plain PyTorch versions of the lattice kernels.

Same function as each CUDA kernel, written as whole-tensor PyTorch on any
device: the CPU path of every wrapper, the oracle the tests hold the JAX
kernels' counterparts to, and what ``chip_smoke.py`` compares each kernel
with on the card.  Nothing on the card's main path calls them.

Each accepts one brick ``(X, Y, Z)`` or a leading replica axis
``(R, X, Y, Z)`` (halos then lead with R too); a schedule value (beta or
LUT row) is shared or given per replica.  LFSR states and spin words are
carried as int64 masked to 32 bits (see ``core/bits.py``); results are
stored back as uint32.  Fixed-point accepts look the threshold up
directly, ``u >= lut[row][f + f_off]``: LUT rows are monotone, so this is
the reference's rank-count accept bit for bit.  The f32 accept is
``tanh(act) + r >= 0`` in PyTorch's math library, in the reference's
operation order.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.bits import MASK32, i64_to_i32, i64_to_u32, u32_to_i64
from repro_torch.core.packing import LANE_WIDTH, unpack_lanes
from repro_torch.core.pbit import (FixedPoint, lfsr_next, lfsr_uniform,
                                   pbit_update, quantize)

__all__ = ["neighbor_sums_ref", "int_field_ref", "pbit_brick_update_ref",
           "pbit_brick_sweep_ref", "decision_ulps_ref",
           "pbit_brick_update_int_ref", "pbit_brick_sweep_int_ref",
           "add_phase_flips_ref",
           "bitplane_ones_count_ref", "bitplane_count_planes_ref",
           "bitplane_gather_count_ref", "pbit_bitplane_sweep_ref",
           "brick_energy_sites_ref", "brick_energy_ref",
           "brick_energy_words_ref"]


def _shifted(m, halos):
    """The six neighbor arrays of a brick (trailing dims X, Y, Z) from its
    halo planes (trailing dims (Y, Z), (Y, Z), (X, Z), (X, Z), (X, Y),
    (X, Y))."""
    xlo, xhi, ylo, yhi, zlo, zhi = halos
    xm = torch.cat([xlo.unsqueeze(-3), m[..., :-1, :, :]], dim=-3)
    xp = torch.cat([m[..., 1:, :, :], xhi.unsqueeze(-3)], dim=-3)
    ym = torch.cat([ylo.unsqueeze(-2), m[..., :, :-1, :]], dim=-2)
    yp = torch.cat([m[..., :, 1:, :], yhi.unsqueeze(-2)], dim=-2)
    zm = torch.cat([zlo.unsqueeze(-1), m[..., :-1]], dim=-1)
    zp = torch.cat([m[..., 1:], zhi.unsqueeze(-1)], dim=-1)
    return xm, xp, ym, yp, zm, zp


def _lut_lookup(lut64, rows_t, idx):
    """thr[rows_t[r]][idx[r, ...]] for idx (R, ...) and rows_t (R,)."""
    R = idx.shape[0]
    thr = lut64[rows_t]                                   # (R, lw)
    return torch.gather(thr, 1, idx.reshape(R, -1)).reshape(idx.shape)


def _batched(m, sched, halos, dtype=torch.int64):
    """Promote one-brick inputs to the replica-batched form; the schedule
    (LUT rows or betas), (S,) shared or (S, R) per replica, becomes
    (S, R) of ``dtype``."""
    single = m.dim() == 3
    if single:
        m = m.unsqueeze(0)
        halos = tuple(h.unsqueeze(0) for h in halos)
    sched = torch.as_tensor(sched, dtype=dtype, device=m.device)
    if sched.dim() == 1:
        sched = sched[:, None]
    return single, m, sched.expand(sched.shape[0], m.shape[0]), halos


def _sweeps(phase, m, s, sched, masks):
    """Every color phase of every sweep, in order: ``phase(m, s, sched[t],
    mask) -> (m, s)`` on batched spins and int64-carried states.  Returns
    (m, s, flips) with int64 (R,) flips."""
    flips = torch.zeros(m.shape[0], dtype=torch.int64, device=m.device)
    for t in range(sched.shape[0]):
        for c in range(masks.shape[0]):
            new, s = phase(m, s, sched[t], masks[c])
            add_phase_flips_ref(flips, new, m)
            m = new
    return m, s, flips


def add_phase_flips_ref(flips, new, old):
    """Add each replica's changed sites (``new != old``, (R, X, Y, Z)
    spins) to ``flips`` ((R,), in place): the phase kernels' count."""
    flips += (new != old).flatten(1).sum(1).to(flips.dtype)


def _done(single, m, s, flips=None):
    """Store states back as uint32 (flips as int32) and drop the replica
    axis of a one-brick call."""
    out = (m, i64_to_u32(s)) + (() if flips is None else (i64_to_i32(flips),))
    return tuple(x[0] for x in out) if single else out


def neighbor_sums_ref(m, h, w6, halos):
    """f32 local field ``h + sum_d w_d m_d`` (the reference's op order)."""
    wxm, wxp, wym, wyp, wzm, wzp = w6
    xm, xp, ym, yp, zm, zp = (a.to(torch.float32) for a in
                              _shifted(m, halos))
    return (h + wxm * xm + wxp * xp + wym * ym + wyp * yp
            + wzm * zm + wzp * zp)


def int_field_ref(m, h_q, w6_q, halos):
    """Integer local field ``h_q + sum_d w_q[d] * m_d`` in int32."""
    i32 = torch.int32
    f = h_q.to(i32)
    for w, nb in zip(w6_q, _shifted(m, halos)):
        f = f + w.to(i32) * nb.to(i32)
    return f


# -- f32 pipeline -----------------------------------------------------------------

def _f32_phase(h, w6, halos, fmt):
    """One f32 color phase on batched spins: the field, one LFSR step of
    every site, ``tanh(act) + r >= 0`` and the masked write."""
    def phase(m, s, beta_r, mask):
        field = neighbor_sums_ref(m, h, w6, halos)
        s = lfsr_next(s)
        upd = pbit_update(field, beta_r.reshape(-1, 1, 1, 1),
                          lfsr_uniform(s), fmt)
        return torch.where(mask != 0, upd, m), s
    return phase


def pbit_brick_update_ref(m, s, beta, parity_mask, h, w6, halos,
                          fmt: Optional[FixedPoint] = None):
    """One f32 color phase: ``beta`` a scalar, or (R,) per replica;
    ``fmt`` rounds and saturates the activation.  Returns (m, s)."""
    single, m, b, halos = _batched(
        m, torch.as_tensor(beta).reshape(1, -1), halos, torch.float32)
    m, s = _f32_phase(h, w6, halos, fmt)(m, u32_to_i64(s).reshape(m.shape),
                                         b[0], parity_mask)
    return _done(single, m, s)


def pbit_brick_sweep_ref(m, s, betas, masks, h, w6, halos,
                         fmt: Optional[FixedPoint] = None):
    """``len(betas)`` f32 sweeps (every color phase, in order) against
    fixed halos, one beta per sweep — shared (S,) or per replica (S, R).
    Every site's LFSR advances every phase.  Returns (m, s, flips) as
    :func:`pbit_brick_sweep_int_ref` does."""
    single, m, b, halos = _batched(m, betas, halos, torch.float32)
    m, s, flips = _sweeps(_f32_phase(h, w6, halos, fmt), m,
                          u32_to_i64(s).reshape(m.shape), b, masks)
    return _done(single, m, s, flips)


def decision_ulps_ref(m, s, beta, h, w6, halos,
                      fmt: Optional[FixedPoint] = None):
    """How far each site of one f32 phase lies from its decision boundary:
    ``|tanh(act) + r|`` in units of the ulp of ``tanh(act)`` (inputs as
    :func:`pbit_brick_update_ref`, ``s`` the states before the phase).
    Two tanh implementations within k ulp of each other can decide a site
    differently only where this is at most k."""
    single, m, b, halos = _batched(
        m, torch.as_tensor(beta).reshape(1, -1), halos, torch.float32)
    act = quantize(b[0].reshape(-1, 1, 1, 1)
                   * neighbor_sums_ref(m, h, w6, halos), fmt)
    r = lfsr_uniform(lfsr_next(u32_to_i64(s).reshape(m.shape)))
    th = torch.tanh(act)
    a = th.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    u = (th + r).abs() / ulp
    return u[0] if single else u


# -- fixed-point pipeline ---------------------------------------------------------

def _int_phase(h_q, w6_q, halos, lut):
    """One fixed-point color phase on batched spins: the int32 field, one
    LFSR step of every site, the LUT accept and the masked write."""
    lut64 = u32_to_i64(lut)
    lw = int(lut.shape[1])
    f_off = (lw - 1) // 2

    def phase(m, s, rows_r, mask):
        field = int_field_ref(m, h_q, w6_q, halos)
        s = lfsr_next(s)
        idx = (field.to(torch.int64) + f_off).clamp(0, lw - 1)
        accept = (s >> 8) >= _lut_lookup(lut64, rows_r, idx)
        upd = torch.where(accept, 1, -1).to(torch.int8)
        return torch.where(mask != 0, upd, m), s
    return phase


def pbit_brick_update_int_ref(m, s, row, parity_mask, h_q, w6_q, halos,
                              lut):
    """One fixed-point color phase: ``row`` a LUT row index, or (R,) per
    replica.  Returns (m, s)."""
    single, m, rows, halos = _batched(
        m, torch.as_tensor(row).reshape(1, -1), halos)
    m, s = _int_phase(h_q, w6_q, halos, lut)(
        m, u32_to_i64(s).reshape(m.shape), rows[0], parity_mask)
    return _done(single, m, s)


def pbit_brick_sweep_int_ref(m, s, rows, masks, h_q, w6_q, halos, lut):
    """``len(rows)`` fixed-point sweeps (every color phase, in order)
    against fixed halos, one LUT row per sweep — shared (S,) or per
    replica (S, R).  Every site's LFSR advances every phase.  Returns
    (m, s, flips): int8 spins, uint32 states, int32 flips ((R,), or a
    scalar for one brick)."""
    single, m, rows, halos = _batched(m, rows, halos)
    m, s, flips = _sweeps(_int_phase(h_q, w6_q, halos, lut), m,
                          u32_to_i64(s).reshape(m.shape), rows, masks)
    return _done(single, m, s, flips)


def _full_add(a, b, c):
    """Bit-sliced full adder: per-lane a + b + c as (sum, carry) planes."""
    s = a ^ b
    return s ^ c, (a & b) | (c & s)


def bitplane_ones_count_ref(mw, signs6, nz6, halos_w):
    """Per-lane count of +1 neighbor contributions as 3 bit-slice planes
    (b0, b1, b2), lane r's count ``b0[r] + 2*b1[r] + 4*b2[r]`` in [0, 6]:
    the carry-save adder tree over ``(nb XOR sign) AND nonzero``.  Takes
    and returns int64-carried words."""
    t = [(nb ^ sg) & nz for nb, sg, nz in
         zip(_shifted(mw, halos_w), signs6, nz6)]
    s1, c1 = _full_add(t[0], t[1], t[2])
    s2, c2 = _full_add(t[3], t[4], t[5])
    b0 = s1 ^ s2
    k = s1 & s2
    return b0, c1 ^ c2 ^ k, (c1 & c2) | (k & (c1 ^ c2))


def bitplane_count_planes_ref(planes):
    """Per-lane count of set bits across a list of word planes, as
    bit-slice planes: plane n is ripple-added into the slices, and a new
    slice is appended only when the count can reach the next power of
    two, so D planes give ``ceil(log2(D+1))`` slices; lane r's count is
    ``sum_i 2**i * bit_r(slices[i])``."""
    slices = []
    for n, plane in enumerate(planes, start=1):
        carry = plane
        for i, s in enumerate(slices):
            slices[i] = s ^ carry
            carry = s & carry
        if (1 << len(slices)) <= n:
            slices.append(carry)
    return slices


def bitplane_gather_count_ref(mext_w, idx_c, signs_c, nz_c):
    """Per-lane +1-contribution count of a gather-graph (ELL) site set, for
    K partitions at once: ``mext_w`` (K, W, n_ext) uint32 word pools
    (local words then ghosts), ``idx_c`` (K, nc, D) int32 slots into the
    pool, ``signs_c`` / ``nz_c`` (K, nc, D) uint32 sign and nonzero
    planes.  Gathers word ``mext_w[k, w, idx_c[k, i, d]]``, takes
    ``(word ^ sign) & nz`` per neighbour and ripple-adds the D planes
    (:func:`bitplane_count_planes_ref`).  Returns the ``ceil(log2(D+1))``
    slices, (K, W, nc) uint32 each.  The words are XORed and ANDed as
    their int32 views, which is exact bit for bit."""
    K, W, _ = mext_w.shape
    _, nc, D = idx_c.shape
    nbr = torch.gather(mext_w.view(torch.int32), 2,
                       idx_c.long().reshape(K, 1, nc * D).expand(
                           K, W, nc * D)).reshape(K, W, nc, D)
    sg = signs_c.view(torch.int32)[:, None]
    nz = nz_c.view(torch.int32)[:, None]
    planes = [(nbr[..., d] ^ sg[..., d]) & nz[..., d] for d in range(D)]
    return [p.contiguous().view(torch.uint32)
            for p in bitplane_count_planes_ref(planes)]


def pbit_bitplane_sweep_ref(mw, s, rows, masks_w, signs6, nz6, base,
                            halos_w, lut):
    """Multi-spin-coded sweeps over W stacked word planes.

    mw (W, X, Y, Z) uint32 words (bit b of plane w is lane w*32+b);
    s (R, X, Y, Z) uint32 per-lane LFSR states, R <= 32 W; rows (S,) or
    (S, R) LUT row indices; masks_w (n_colors, W, X, Y, Z) lane-masked
    uint32 color masks; signs6 / nz6 / base from ``bitplane_planes``;
    halos_w six word planes with a leading W axis.  Lane (w, b) is
    bit-identical to replica w*32+b of :func:`pbit_brick_sweep_int_ref`.
    Returns (mw, s, flips) with (R,) int32 per-lane flips.
    """
    R = int(s.shape[0])
    dev = mw.device
    rows = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    if rows.dim() == 1:
        rows = rows[:, None].expand(rows.shape[0], R)
    mw = u32_to_i64(mw)
    s = u32_to_i64(s)
    halos_w = tuple(u32_to_i64(h) for h in halos_w)
    signs6 = tuple(u32_to_i64(x) for x in signs6)
    nz6 = tuple(u32_to_i64(x) for x in nz6)
    masks_w = u32_to_i64(masks_w)
    lut64 = u32_to_i64(lut)
    lw = int(lut.shape[1])
    base = base.to(torch.int64)
    lanes = torch.arange(R, device=dev)
    word = lanes // LANE_WIDTH
    bit = (lanes % LANE_WIDTH).reshape(R, 1, 1, 1)
    W = int(mw.shape[0])
    npad = W * LANE_WIDTH - R
    shifts = torch.arange(LANE_WIDTH, device=dev).reshape(1, LANE_WIDTH, 1,
                                                          1, 1)
    flips = torch.zeros(R, dtype=torch.int64, device=dev)
    for t in range(rows.shape[0]):
        for c in range(masks_w.shape[0]):
            b0, b1, b2 = bitplane_ones_count_ref(mw, signs6, nz6, halos_w)
            s = lfsr_next(s)                # every live lane advances
            cnt = (((b0[word] >> bit) & 1) + 2 * ((b1[word] >> bit) & 1)
                   + 4 * ((b2[word] >> bit) & 1))
            idx = (base + 2 * cnt).clamp(0, lw - 1)
            accept = ((s >> 8) >= _lut_lookup(lut64, rows[t], idx))
            acc = accept.to(torch.int64)
            if npad:
                acc = torch.cat([acc, acc.new_zeros((npad,) + acc.shape[1:])])
            upd = (acc.reshape((W, LANE_WIDTH) + acc.shape[1:])
                   << shifts).sum(dim=1)
            mk = masks_w[c]
            new = (mw & (mk ^ MASK32)) | (upd & mk)
            flips = flips + ((((mw ^ new)[word]) >> bit) & 1).flatten(1).sum(1)
            mw = new
    return i64_to_u32(mw), i64_to_u32(s), i64_to_i32(flips)


def brick_energy_sites_ref(m, active, h, w6, halos):
    """The terms of :func:`brick_energy_ref`, one f32 per site (and
    replica)."""
    field = neighbor_sums_ref(m, h, w6, halos)
    mc = m.to(torch.float32)
    return (-0.5 * mc * (field - h) - h * mc) * active.to(torch.float32)


def brick_energy_ref(m, active, h, w6, halos):
    """Brick Ising energy ``sum active * (-1/2 m sum_d w_d m_d - h m)``
    with f32 h and w6 (the unquantized problem).  Returns an f32 scalar
    for one brick, (R,) for a replica batch."""
    return brick_energy_sites_ref(m, active, h, w6, halos).sum(
        dim=(-3, -2, -1))


def brick_energy_words_ref(mw, n_lanes, active, h, w6, halos_w):
    """:func:`brick_energy_ref` of the ``n_lanes`` replicas held in the bit
    lanes of word planes ``mw`` (W, X, Y, Z), with word halos (W, plane):
    both unpacked to int8 first, as the reference's bit-plane readout does.
    Returns (n_lanes,) f32."""
    return brick_energy_ref(unpack_lanes(mw, n_lanes), active, h, w6,
                            tuple(unpack_lanes(hw, n_lanes)
                                  for hw in halos_w))
