"""The plain reference of the EA3D machine: plain PyTorch and NumPy that
work out from the benchmark's inputs everything the program derives from
them, and run the same anneal.

The instance is the 3D Edwards-Anderson spin glass of the paper's Methods
on an L^3 cubic lattice: J_ij = +-1 i.i.d. uniform on nearest-neighbour
edges, periodic in z, open in x and y, drawn from the instance seed (the
edge order and draw below are those of the paper's reference code).  The
machine is one brick: every p-bit reads its neighbours' current states,
except across the periodic z seam, which the brick reads through its halo
as of the last boundary exchange, run every ``sync_every`` sweeps.  A
sweep updates the checkerboard colours in order (colour 0: x + y + z
even).  Each (lane, site) has its own xorshift32 state, and every state
steps in every colour phase; a colour-c p-bit takes +1 iff its 24-bit
draw ``state >> 8`` is at least the threshold
``T[beta, f] = ceil((1 - tanh(act)) * 2^23)`` of its integer field f,
with act = beta * scale * f rounded to the configuration's fixed point
and the couplings quantised to int8 with one scale.  The LUT is computed
on the host in float64; ``lut_dtype=np.float32`` gives the control, the
same machine one precision lower.

Lanes are independent chains of one instance, so a run may hold any
number of them, of one job or of several.  Spins are int8 (R, X, Y, Z);
xorshift32 states int64 carriers of uint32 values.  Nothing here reads
the program or anything it made.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
DRAW_BITS = 24


# -- the instance ------------------------------------------------------------

def couplings(L: int, seed: int) -> tuple:
    """(Jx, Jy, Jz) float32: Jx[x, y, z] couples (x, y, z)-(x+1, y, z),
    shape (L-1, L, L); Jy likewise (L, L-1, L); Jz[x, y, z] couples
    (x, y, z)-(x, y, (z+1) % L), shape (L, L, L).  The draw: one numpy
    ``default_rng(seed).choice([-1, 1])`` over the +x, then +y, then +z
    edges, each in the x-major order of their lower site."""
    if L <= 2:
        raise ValueError("the z seam needs L > 2")
    nx = ny = (L - 1) * L * L
    nz = L * L * L
    rng = np.random.default_rng(seed)
    ew = rng.choice(np.array([-1.0, 1.0], dtype=np.float32),
                    size=nx + ny + nz)
    return (ew[:nx].reshape(L - 1, L, L), ew[nx:nx + ny].reshape(L, L - 1, L),
            ew[nx + ny:].reshape(L, L, L))


def quantise(J: tuple, bits: int = 8) -> tuple:
    """One symmetric scale for every coupling (the fields are zero), the
    integers' common factor folded into it: (int planes, scale)."""
    qmax = float(2 ** (bits - 1) - 1)
    amax = max(float(np.abs(j).max()) for j in J)
    scale = amax / qmax if amax > 0 else 1.0
    q = [np.clip(np.rint(j.astype(np.float64) / scale), -qmax,
                 qmax).astype(np.int64) for j in J]
    g = int(np.gcd.reduce([int(np.gcd.reduce(np.abs(x), axis=None))
                           for x in q]))
    if g > 1:
        q = [x // g for x in q]
        scale *= g
    return tuple(x.astype(np.int8) for x in q), float(scale)


def six_planes(Jq: tuple, L: int) -> np.ndarray:
    """(6, L, L, L) int8: the coupling of each site to its -x, +x, -y, +y,
    -z, +z neighbour (0 where the open boundary has none)."""
    jx, jy, jz = (j.astype(np.int8) for j in Jq)
    w = np.zeros((6, L, L, L), np.int8)
    w[1, :-1] = jx
    w[0, 1:] = jx
    w[3, :, :-1] = jy
    w[2, :, 1:] = jy
    w[5] = jz
    w[4] = np.roll(jz, 1, axis=2)
    return w


def field_bound(w6: np.ndarray) -> int:
    return int(np.abs(w6.astype(np.int64)).sum(0).max())


# -- the schedule and the thresholds --------------------------------------------

def staircase(levels, sweeps: int) -> np.ndarray:
    """(sweeps,) float32: level s over sweeps [b_s, b_{s+1}) with the
    bounds ``linspace(0, sweeps, len(levels) + 1)`` cast to integers."""
    levels = np.asarray(levels, np.float32)
    b = np.linspace(0, sweeps, len(levels) + 1).astype(np.int64)
    out = np.empty(sweeps, np.float32)
    for s, beta in enumerate(levels):
        out[b[s]:b[s + 1]] = beta
    return out


def thresholds(betas: np.ndarray, scale: float, f_max: int, fmt,
               dtype=np.float64) -> np.ndarray:
    """(len(betas), 2 f_max + 1) int64: T[b, f + f_max] for integer fields
    f; ``fmt`` (int_bits, frac_bits) rounds act half to even and
    saturates; computed in ``dtype``."""
    f = np.arange(-f_max, f_max + 1).astype(dtype)
    act = np.asarray(betas, dtype)[:, None] * (dtype(scale) * f)[None, :]
    ib, fb = fmt
    step = dtype(2.0 ** -fb)
    act = np.clip(np.round(act / step) * step, dtype(-(2.0 ** ib)),
                  dtype(2.0 ** ib) - step)
    half = dtype(2 ** (DRAW_BITS - 1))
    t = np.ceil((dtype(1) - np.tanh(act)) * half)
    return np.clip(t, 0, 2 ** DRAW_BITS).astype(np.int64)


def xorshift32(s: torch.Tensor) -> torch.Tensor:
    """One Marsaglia xorshift32 step on int64-carried uint32 states."""
    s = s ^ ((s << 13) & MASK32)
    s = s ^ (s >> 17)
    return s ^ ((s << 5) & MASK32)


# -- the machine ----------------------------------------------------------------

class Machine:
    """The reference sampler of one configuration: ``L`` its lattice,
    ``seed`` its instance, ``fmt`` (int_bits, frac_bits) its fixed point."""

    def __init__(self, L: int, seed: int, fmt, device,
                 lut_dtype=np.float64):
        self.L, self.device = int(L), torch.device(device)
        Jq, self.scale = quantise(couplings(L, seed))
        w6 = six_planes(Jq, L)
        self.f_max = field_bound(w6)
        self.fmt = tuple(fmt)
        self.lut_dtype = lut_dtype
        # the edges across the periodic z seam: read as of the last
        # exchange (the other wrapping edges, in x and y, have no coupling)
        stale = np.zeros((6, 1, 1, L), bool)
        stale[4, ..., 0] = stale[5, ..., L - 1] = True
        dev = self.device
        self.w_now = torch.from_numpy(np.where(stale, 0, w6)).to(dev)
        self.w_old = torch.from_numpy(np.where(stale, w6, 0)).to(dev)
        # the energy's three forward couplings
        self.w_fwd = torch.from_numpy(w6[1::2].copy()).to(dev)
        x, y, z = np.meshgrid(*(np.arange(L),) * 3, indexing="ij")
        colour = torch.from_numpy(((x + y + z) % 2).astype(np.int8)).to(dev)
        self.colours = [colour == c for c in range(2)]

    def lut(self, levels, sweeps: int) -> tuple:
        """(rows (sweeps,) int64 indices, table (rows, lw) int64) of a
        staircase."""
        betas = staircase(levels, sweeps)
        table = np.unique(betas)
        rows = np.searchsorted(table, betas)
        thr = thresholds(table, self.scale, self.f_max, self.fmt,
                         self.lut_dtype)
        return rows, torch.from_numpy(thr).to(self.device)

    @staticmethod
    def _shift(m: torch.Tensor, d: int) -> torch.Tensor:
        """The neighbour in direction d of every site: (R, X, Y, Z)."""
        a, step = 1 + d // 2, (-1 if d % 2 == 0 else 1)
        return torch.roll(m, -step, dims=a)

    def field(self, now: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """(R, X, Y, Z) int8: sum over d of w[d] times the neighbour in
        direction d."""
        f = torch.zeros_like(now)
        for d in range(6):
            f += w[d] * self._shift(now, d)
        return f

    def energy(self, m: torch.Tensor) -> torch.Tensor:
        """(R,) int64: -sum over edges of J_ij m_i m_j."""
        e = torch.zeros(m.shape[0], dtype=torch.int64, device=m.device)
        for k in range(3):
            prod = self.w_fwd[k] * m * self._shift(m, 2 * k + 1)
            e -= prod.reshape(m.shape[0], -1).sum(1, dtype=torch.int64)
        return e

    def run(self, m: torch.Tensor, s: torch.Tensor, levels, sweeps: int,
            record_points, sync_every: int) -> dict:
        """Anneal spins ``m`` (R, L, L, L) int8 with states ``s`` (the same
        shape, int64) over the staircase of ``levels`` in ``sweeps``
        sweeps, exchanging every ``sync_every`` sweeps.  Returns the
        energies at the record points (P, R), the flips (R,), the final
        spins and states; ``m`` and ``s`` are not modified."""
        rows, thr = self.lut(levels, sweeps)
        m, s = m.clone(), s.clone()
        # the part of the field read across the z seam: as of the last
        # exchange
        f_old = self.field(m, self.w_old)
        flips = torch.zeros(m.shape[0], dtype=torch.int64, device=m.device)
        points, energies = set(int(p) for p in record_points), []
        for t in range(sweeps):
            table = thr[int(rows[t])]
            for c in range(2):
                mask = self.colours[c]
                f = self.field(m, self.w_now) + f_old
                s = xorshift32(s)
                col = (f.to(torch.int64) + self.f_max).clamp_(
                    0, table.shape[0] - 1)
                up = ((s >> 8) >= table[col]).to(torch.int8)
                new = torch.where(mask, 2 * up - 1, m)
                flips += (new != m).reshape(m.shape[0], -1).sum(1)
                m = new
            if (t + 1) % sync_every == 0:
                f_old = self.field(m, self.w_old)
            if t + 1 in points:
                energies.append(self.energy(m))
        return {"energies": torch.stack(energies), "flips": flips, "m": m,
                "s": s}


def lanes_to_spins(words: torch.Tensor, lanes: int) -> torch.Tensor:
    """(W, ...) int32 word planes -> (lanes, ...) int8 spins: bit b of
    plane w is lane 32 w + b, 1 for +1."""
    W = int(words.shape[0])
    if not 0 < lanes <= 32 * W:
        raise ValueError(f"{lanes} lanes do not fit {W} words")
    out = []
    for lane in range(lanes):
        bit = (words[lane // 32] >> (lane % 32)) & 1
        out.append((2 * bit - 1).to(torch.int8))
    return torch.stack(out)


def compare(got: dict, want: dict) -> dict:
    """The numbers compared: the largest gap of the recorded energies and
    of the per-lane flips (infinite where their shapes differ), and how
    many spins and states differ."""
    def gap(a, b):
        if a.shape != b.shape:         # points or lanes missing: no match
            return float("inf")
        return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
    return {"energy_gap": gap(got["energies"], want["energies"]),
            "flips_gap": gap(got["flips"], want["flips"]),
            "spins_differ": int((got["m"] != want["m"]).sum()),
            "states_differ": int((got["s"] != want["s"]).sum())}
