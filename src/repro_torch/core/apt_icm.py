"""Adaptive parallel tempering with isoenergetic cluster moves (APT+ICM);
port of ``repro.core.apt_icm``.

The algorithm of the paper's G81 result (Sec. S9): P chains each hold a
ladder of T inverse temperatures; every sweep, neighbouring-temperature
replicas attempt a Metropolis exchange (acceptance min(1, exp((b2 - b1)
(E2 - E1)))); every ``icm_every`` sweeps, chain pairs (2p, 2p+1) at the
same temperature make a Houdayer isoenergetic cluster move: a connected
cluster of disagreeing spins is flipped in both replicas, which keeps
E1 + E2.  ``adapt_ladder`` spaces the betas so that d_beta * sigma_E is
about constant.

Three modes, as the reference's:

* ``rng="philox"`` (default): f32 fields, ``tanh`` accept against a
  uniform in [-1, 1).
* ``rng="lfsr"``: int8 quantized couplings, integer fields, one xorshift32
  LFSR per (chain, temperature, site), the LUT accept with one row per
  temperature.
* ``packed=True`` (needs ``rng="lfsr"``): the (chains x temperatures) grid
  rides the bit lanes of W = ceil(P*T/32) uint32 word planes, lane
  l = p*T + t at word l // 32, bit l % 32.  A colour phase is one fused
  gather-count and per-lane tail (``kernels.ops.bitplane_phase_apt_op``:
  the CUDA kernel on the card, its plain version on a CPU tensor),
  exchanges are lane permutations
  (``packing.lane_permute``) and the ICM disagreement set is a bit
  extraction per pair.  Packed runs equal unpacked ``rng="lfsr"`` runs
  bitwise.

Randomness.  The reference draws the exchange acceptances, the ICM seed
scores and the f32 sweep's uniforms from a ``jax.random`` key, which
PyTorch cannot reproduce.  The port draws them from one
``torch.Generator`` on the engine's device, whose state bytes are
``APTState.key``, so a snapshot resumes exactly on one device type; or,
given ``draws=``, from that source, called in the engine's draw order as
``draws(shape, low, high, device)``.  :class:`HostDraws` is such a source
on a host numpy stream, which lets another implementation take the same
values.  Both modes draw the same shapes in the same order, which keeps
packed equal to unpacked with the generator too.  The initial spins come
from numpy (or ``m0``); the LFSR states are ``lfsr_init(P*T*N, seed)``
laid out as the reference's.

Two deliberate differences from the reference, neither changing a bit:
the LUT accept looks the threshold up directly (the rows are monotone, so
it equals the reference's rank count), and the ICM cluster is found by
min-label propagation with pointer jumping instead of growing it one
neighbour shell per step: both give the seed's connected component among
the disagreeing sites, the jumps in far fewer steps.  Its fixed point is
checked on the host only every k steps (k doubling from 8 to 64): a step
past it changes nothing, so an ICM costs a few host syncs, not one per
step.  The engine counts them (``icm_calls``, ``icm_syncs``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .bits import i64_to_u32, u32_from_numpy, u32_to_i64
from .coloring import Coloring
from .device import as_numpy, resolve_device
from .energy import energy as direct_energy
from .gibbs import color_fields, init_spins
from .graph import IsingGraph
from .packing import LANE_WIDTH, lane_permute, pack_lanes, unpack_lanes
from .pbit import (FixedPoint, bitplane_planes, field_bound, lfsr_init,
                   lfsr_next, pbit_update, philox_init, quantize_couplings,
                   threshold_lut)
from repro_torch.engines.base import check_lanes
from repro_torch.kernels.bitplane_phase import phase_sites
from repro_torch.kernels.ops import bitplane_phase_apt_op

__all__ = ["APTICM", "APTState", "HostDraws", "adapt_ladder"]

# cluster labelling: steps between fixed-point checks, doubling to the cap
_GROW_FIRST, _GROW_CAP = 8, 64


@dataclasses.dataclass
class APTState:
    m: torch.Tensor       # (P, T, N) int8 — or (W, N) uint32 words packed
    E: torch.Tensor       # (P, T) f32
    key: torch.Tensor     # uint8 state bytes of the draw generator (CPU)
    sweep: torch.Tensor   # () int32
    swaps: torch.Tensor   # () int32 accepted exchanges
    icms: torch.Tensor    # () int32 cluster moves made
    lfsr: Optional[torch.Tensor] = None   # (P, T, N) | (L, N) uint32


class HostDraws:
    """Uniform draws from a host numpy stream ``default_rng(seed)``, f32 in
    [low, high): ``sample(shape, low, high)`` gives the numpy array,
    calling the source gives it as a tensor on ``device``."""

    def __init__(self, seed: int):
        self._rng = np.random.default_rng(seed)

    def sample(self, shape, low: float = 0.0, high: float = 1.0):
        u = self._rng.random(tuple(int(d) for d in shape), dtype=np.float32)
        return (u * np.float32(high - low) + np.float32(low)).astype(
            np.float32)

    def __call__(self, shape, low, high, device) -> torch.Tensor:
        return torch.from_numpy(self.sample(shape, low, high)).to(device)


def _long(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64)).to(device)


class APTICM:
    """APT+ICM on ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, g: IsingGraph, coloring: Coloring, betas,
                 chains: int = 2, fmt: Optional[FixedPoint] = None,
                 rng: str = "philox", packed: bool = False, device=None,
                 draws: Optional[Callable] = None):
        if chains % 2 != 0:
            raise ValueError("chains must be even (ICM pairs)")
        if rng not in ("philox", "lfsr"):
            raise ValueError(f"unknown rng {rng!r}")
        if packed and rng != "lfsr":
            raise ValueError("packed=True runs the fixed-point word "
                             "pipeline; it needs rng='lfsr'")
        dev = self.device = resolve_device(device)
        self.g = g.to(dev)
        self.betas = torch.from_numpy(np.asarray(betas, np.float32)).to(dev)
        self.T = len(betas)
        self.P = chains
        self.L = self.P * self.T          # word lanes of the packed grid
        self.fmt = fmt
        self.rng_kind = rng
        self.packed = bool(packed)
        self.draws = draws
        self.words = check_lanes("bitplane", self.L,
                                 what="chains*temperatures") if packed else 1
        self.n = self.g.n
        self.icm_calls = 0    # ICMs made (each over every pair)
        self.icm_syncs = 0    # host syncs of their cluster growth
        groups = coloring.groups
        self._nodes = [_long(grp, dev) for grp in groups]
        self._idx = [self.g.idx.index_select(0, nd).long()
                     for nd in self._nodes]
        self._w = [self.g.w.index_select(0, nd) for nd in self._nodes]
        self._h = [self.g.h.index_select(0, nd) for nd in self._nodes]
        # the ICM labelling's neighbour columns: (N,) indices and where
        # the coupling is nonzero ((N, 1), None where all are)
        live = self.g.w != 0
        self._nbr_cols = [
            (self.g.idx[:, d].long().contiguous(),
             None if bool(live[:, d].all()) else live[:, d, None])
            for d in range(self.g.max_degree)]
        self._pairs = [torch.arange(o, self.T - 1, 2, device=dev)
                       for o in (0, 1)]
        if rng == "lfsr":
            h_q, (w_q,), self.q_scale = quantize_couplings(
                as_numpy(self.g.h), (as_numpy(self.g.w),))
            dirs = tuple(w_q[:, d] for d in range(w_q.shape[-1]))
            self.f_max = field_bound(h_q, dirs)
            lut = threshold_lut(np.asarray(betas), self.q_scale, self.f_max,
                                fmt=fmt)
            self._lut = _long(lut, dev)                  # (T, 2*f_max+1)
            self._scale = torch.tensor(np.float32(self.q_scale), device=dev)
            self._w_q = [_long(w_q[grp], dev) for grp in groups]
            self._h_q = [_long(h_q[grp], dev) for grp in groups]
            # per-temperature threshold rows against (P, T, nc) fields
            self._thr_T = self._lut[None, :, None, :]
        if packed:
            signs, nz, base, _ = bitplane_planes(h_q, dirs)
            signs_nd, nz_nd = np.stack(signs, -1), np.stack(nz, -1)
            # the fused colour phase's entries at K=1: every node real
            self._sites = [phase_sites(
                nd[None], torch.ones((1, len(nd)), dtype=torch.bool,
                                     device=dev), None,
                self.g.idx.index_select(0, nd)[None],
                u32_from_numpy(signs_nd[grp][None], dev),
                u32_from_numpy(nz_nd[grp][None], dev),
                _long(base[grp][None], dev))
                for nd, grp in zip(self._nodes, groups)]
            # per-lane LUT-row fan: lane l = p*T + t reads row t
            lane_rows = _long(np.tile(np.arange(self.T), self.P), dev)
            self._thr_lanes = self._lut[lane_rows].contiguous()  # (L, lw)
            self._scale_f32 = float(np.float32(self.q_scale))
            # ICM pair anchors lane(2p, t) and lane(2p+1, t) = that + T;
            # a pair may straddle word planes
            even = np.asarray([[2 * p * self.T + t for t in range(self.T)]
                               for p in range(self.P // 2)], np.int64)
            odd = even + self.T
            self._ev_w = _long(even // LANE_WIDTH, dev)
            self._ev_b = _long(even % LANE_WIDTH, dev)[:, :, None]
            self._od_w = _long(odd // LANE_WIDTH, dev)
            self._od_b = _long(odd % LANE_WIDTH, dev)[:, :, None]

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int = 0,
                   m0: Optional[np.ndarray] = None) -> APTState:
        """Fresh state: spins :func:`init_spins` of ``seed`` (or ``m0``,
        (P, T, N) or (N,) for every replica), the same in every mode."""
        dev = self.device
        shape = (self.P, self.T, self.n)
        m = init_spins(seed, shape) if m0 is None else np.broadcast_to(
            np.asarray(m0, np.int8), shape)
        m = torch.from_numpy(np.array(m, np.int8)).to(dev)
        E = direct_energy(self.g, m)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        lfsr = None
        if self.rng_kind == "lfsr":
            lfsr = u32_from_numpy(lfsr_init(self.L * self.n, seed), dev)
            lfsr = lfsr.reshape((self.L, self.n) if self.packed else shape)
        if self.packed:
            m = pack_lanes(m.reshape(self.L, self.n))      # (W, N) words
        return APTState(m=m, E=E, key=philox_init(seed, dev), sweep=zero,
                        swaps=zero.clone(), icms=zero.clone(), lfsr=lfsr)

    def _drawer(self, key):
        """(draw(shape, low, high), generator or None) for one run."""
        dev = self.device
        if self.draws is not None:
            return (lambda shape, lo, hi: self.draws(shape, lo, hi, dev)), \
                None
        gen = torch.Generator(device=dev)
        gen.set_state(key.detach().cpu().clone())

        def draw(shape, lo, hi):
            u = torch.rand(tuple(shape), generator=gen, device=dev)
            return u if (lo, hi) == (0.0, 1.0) else u * (hi - lo) + lo
        return draw, gen

    # -- one sweep of every (chain, temperature) replica -----------------------

    def _gibbs_sweep(self, m, E, draw):
        """f32 sweep, in place on ``m`` (P, T, N)."""
        P, T, N = m.shape
        beta = self.betas[None, :, None]
        for c, nodes in enumerate(self._nodes):
            field = color_fields(m.reshape(P * T, N), self._idx[c],
                                 self._w[c], self._h[c]).reshape(P, T, -1)
            r = draw(field.shape, -1.0, 1.0)
            new = pbit_update(field, beta, r, self.fmt)
            old = m.index_select(2, nodes)
            E = E - ((new - old).to(torch.float32) * field).sum(-1)
            m.index_copy_(2, nodes, new)
        return m, E

    def _accept_rows(self, thr, field, u):
        """LUT accept ``u >= thr[..., clip(field + f_max)]`` with threshold
        rows ``thr`` (..., lw) broadcasting against the fields; the direct
        lookup the reference's rank count equals (the rows are monotone)."""
        lw = int(thr.shape[-1])
        idx = torch.clamp(field + self.f_max, 0, lw - 1)
        rows = thr.expand(*u.shape, lw)
        return u >= torch.gather(rows, -1, idx[..., None].long())[..., 0]

    def _gibbs_sweep_int(self, m, E, lfsr):
        """Fixed-point sweep, in place on ``m`` (P, T, N) int8 and the
        int64-carried LFSR states ``lfsr`` (P, T, N)."""
        P, T, _ = m.shape
        for c, nodes in enumerate(self._nodes):
            idx = self._idx[c]
            nbr = m.index_select(2, idx.reshape(-1)).reshape(
                P, T, *idx.shape).long()
            field = self._h_q[c] + (self._w_q[c] * nbr).sum(-1)
            s = lfsr_next(lfsr.index_select(2, nodes))
            lfsr.index_copy_(2, nodes, s)
            accept = self._accept_rows(self._thr_T, field, s >> 8)
            old = m.index_select(2, nodes)
            new = torch.where(accept, 1, -1).to(torch.int8)
            E = E - ((new - old).to(torch.float32)
                     * field.to(torch.float32)).sum(-1) * self._scale
            m.index_copy_(2, nodes, new)
        return m, E

    def _gibbs_sweep_packed(self, mw, E, lfsr):
        """Word sweep: per colour one fused phase (``ops.
        bitplane_phase_apt_op``: the gather-count's bit-slice planes give
        each lane's field, then the per-lane LFSR, LUT-row fan, accept,
        energy and word write).  ``mw`` (W, N) uint32 and ``E`` (P, T) are
        copied, ``lfsr`` (L, N) int64-carried is updated in place."""
        mw, Ef = mw.clone(), E.reshape(-1).clone()
        for sites in self._sites:
            bitplane_phase_apt_op(mw, lfsr, sites, self._thr_lanes,
                                  self.f_max, Ef, self._scale_f32)
        return mw, Ef.reshape(self.P, self.T)

    # -- replica exchange -------------------------------------------------------

    def _accepted(self, E, t0, swaps, draw):
        b0, b1 = self.betas[t0], self.betas[t0 + 1]
        E0, E1 = E[:, t0], E[:, t0 + 1]                      # (P, |pairs|)
        u = draw(E0.shape, 0.0, 1.0)
        acc = u < torch.exp(torch.clamp((b1 - b0) * (E1 - E0), -50.0, 50.0))
        return acc, swaps + acc.sum().to(torch.int32)

    def _exchange(self, m, E, swaps, draw):
        """Two offset passes of neighbour swaps, in place on ``m``."""
        for t0 in self._pairs:
            acc, swaps = self._accepted(E, t0, swaps, draw)
            accm = acc[:, :, None]
            m0, m1 = m[:, t0], m[:, t0 + 1]
            m[:, t0] = torch.where(accm, m1, m0)
            m[:, t0 + 1] = torch.where(accm, m0, m1)
            E0, E1 = E[:, t0], E[:, t0 + 1]
            E = E.clone()
            E[:, t0] = torch.where(acc, E1, E0)
            E[:, t0 + 1] = torch.where(acc, E0, E1)
        return m, E, swaps

    def _exchange_packed(self, mw, E, swaps, draw):
        """Replica exchange as lane permutations: one pass's accepted swaps
        are one permutation of the word lanes and of the lane energies;
        the LUT rows stay with their lanes' temperatures.  The draws are
        the unpacked pass's (same shapes, same order)."""
        dev = self.device
        for t0 in self._pairs:
            acc, swaps = self._accepted(E, t0, swaps, draw)
            l0 = (torch.arange(self.P, device=dev)[:, None] * self.T
                  + t0[None, :]).reshape(-1)
            accf = acc.reshape(-1)
            perm = torch.arange(self.L, device=dev)
            perm[l0] = torch.where(accf, l0 + 1, l0)
            perm[l0 + 1] = torch.where(accf, l0, l0 + 1)
            mw = lane_permute(mw, perm)
            E = E.reshape(-1)[perm].reshape(self.P, self.T)
        return mw, E, swaps

    # -- isoenergetic cluster move -----------------------------------------------

    def _grow_cluster(self, seed_site, disagree):
        """The cluster the reference grows from the one-hot seed (P/2, T):
        the seed's connected component among the disagreeing sites,
        linked through nonzero couplings (symmetric, as every graph's);
        empty where the seed does not disagree.  Found by labelling: each
        step hooks every site's root under its least neighbouring label
        and jumps each site to its root's label, so a component settles
        on its least index in about log(size) steps, not its diameter.
        Labels are site-major (N, P/2 * T), a gather of whole rows per
        neighbour column."""
        n = self.n
        lead = tuple(disagree.shape[:-1])
        dis = disagree.reshape(-1, n).t().contiguous()        # (N, B)
        dev = dis.device
        sentinel = torch.full((1, dis.shape[1]), n, dtype=torch.int64,
                              device=dev)
        lab = torch.where(dis, torch.arange(n, device=dev)[:, None], n)
        k = _GROW_FIRST
        while True:
            prev = lab
            for _ in range(k):
                nb = None
                for col, live in self._nbr_cols:
                    x = lab.index_select(0, col)
                    if live is not None:
                        x = torch.where(live, x, n)
                    nb = x if nb is None else torch.minimum(nb, x)
                nb = torch.where(dis, nb, n)
                ext = torch.cat([lab, sentinel]).scatter_reduce(
                    0, lab, nb, reduce="amin")
                lab = torch.minimum(torch.minimum(lab, nb),
                                    torch.gather(ext, 0, lab))
                lab = torch.gather(torch.cat([lab, sentinel]), 0, lab)
            self.icm_syncs += 1
            if not bool((lab != prev).any()):
                break
            k = min(2 * k, _GROW_CAP)
        root = torch.gather(torch.cat([lab, sentinel]), 0,
                            seed_site.reshape(1, -1))
        return ((lab == root) & dis).t().reshape(*lead, n)

    def _cluster(self, disagree, draw):
        """(sites to flip (P/2, T, N), pairs with any disagreement)."""
        self.icm_calls += 1
        # a random seed site among the disagreements (site 0 if none)
        scores = draw(disagree.shape, 0.0, 1.0) * disagree
        seed_site = torch.argmax(scores, dim=-1)
        any_dis = disagree.any(-1)
        cluster = self._grow_cluster(seed_site, disagree)
        return cluster & any_dis[:, :, None], any_dis

    def _icm(self, m, E, icms, draw):
        """Houdayer move between chain pairs (2p, 2p+1) at every
        temperature, in place on ``m``."""
        disagree = (m[0::2] * m[1::2]) < 0                   # (P/2, T, N)
        flip, any_dis = self._cluster(disagree, draw)
        fl = torch.where(flip, -1, 1).to(torch.int8)
        m[0::2] *= fl
        m[1::2] *= fl
        return m, direct_energy(self.g, m), \
            icms + any_dis.sum().to(torch.int32)

    def _icm_packed(self, mw, E, icms, draw):
        """Houdayer move on the XOR of each pair's two lane bits, read at
        each lane's own (word, bit); the cluster is XORed back onto both
        lanes (disjoint bits, so the scatter-adds compose)."""
        x = u32_to_i64(mw)
        disagree = (((x[self._ev_w] >> self._ev_b)
                     ^ (x[self._od_w] >> self._od_b)) & 1).bool()
        flip, any_dis = self._cluster(disagree, draw)
        fl = flip.long().reshape(-1, self.n)
        fw = torch.zeros_like(x) \
            .index_add_(0, self._ev_w.reshape(-1),
                        fl << self._ev_b.reshape(-1, 1)) \
            .index_add_(0, self._od_w.reshape(-1),
                        fl << self._od_b.reshape(-1, 1))
        mw = i64_to_u32(x ^ fw)
        spins = unpack_lanes(mw, self.L).reshape(self.P, self.T, self.n)
        return mw, direct_energy(self.g, spins), \
            icms + any_dis.sum().to(torch.int32)

    # -- steps and runs ---------------------------------------------------------

    def _step(self, state: APTState, do_icm: bool, draw) -> APTState:
        """One sweep, both exchange passes and (``do_icm``) one ICM, taking
        uniforms from ``draw``; ``state`` is left as it was."""
        E, icms = state.E, state.icms
        lfsr = None if state.lfsr is None else u32_to_i64(state.lfsr)
        if self.packed:
            m, E = self._gibbs_sweep_packed(state.m, E, lfsr)
            m, E, swaps = self._exchange_packed(m, E, state.swaps, draw)
            if do_icm:
                m, E, icms = self._icm_packed(m, E, icms, draw)
        else:
            m = state.m.clone()
            if self.rng_kind == "lfsr":
                m, E = self._gibbs_sweep_int(m, E, lfsr)
            else:
                m, E = self._gibbs_sweep(m, E, draw)
            m, E, swaps = self._exchange(m, E, state.swaps, draw)
            if do_icm:
                m, E, icms = self._icm(m, E, icms, draw)
        return APTState(m=m, E=E, key=state.key, sweep=state.sweep + 1,
                        swaps=swaps, icms=icms,
                        lfsr=None if lfsr is None else i64_to_u32(lfsr))

    def run(self, state: APTState, sweeps: int, icm_every: int = 10,
            record_every: int = 10):
        """``sweeps`` steps, an ICM every ``icm_every``-th; returns (state,
        (sweep indices, best energy there)), one host read per point."""
        draw, gen = self._drawer(state.key)
        best, ts = [], []
        for t in range(1, sweeps + 1):
            state = self._step(state, icm_every > 0 and t % icm_every == 0,
                               draw)
            if t % record_every == 0 or t == sweeps:
                best.append(float(state.E.min()))
                ts.append(t)
        if gen is not None:
            state = dataclasses.replace(state, key=gen.get_state())
        return state, (np.asarray(ts), np.asarray(best))

    def spins(self, state: APTState) -> torch.Tensor:
        """(P, T, N) int8 spins in every mode (packed states unpack)."""
        if self.packed:
            return unpack_lanes(state.m, self.L).reshape(
                self.P, self.T, self.n)
        return state.m

    def best_config(self, state: APTState) -> Tuple[np.ndarray, float]:
        E = state.E.cpu().numpy()
        p, t = np.unravel_index(np.argmin(E), E.shape)
        return self.spins(state)[p, t].cpu().numpy(), float(E[p, t])


def adapt_ladder(g: IsingGraph, coloring: Coloring, beta_min: float,
                 beta_max: float, n_temps: int, pilot_sweeps: int = 100,
                 seed: int = 0, device=None) -> np.ndarray:
    """Place betas so d_beta * sigma_E(beta) is about constant: pilot
    ``GibbsEngine`` runs at 8 geometric probes estimate sigma_E."""
    from .annealing import constant_schedule
    from .gibbs import GibbsEngine

    probe = np.geomspace(beta_min, beta_max, 8)
    sig = []
    eng = GibbsEngine(g, coloring, device=device)
    for b in probe:
        st = eng.init_state(seed=seed)
        st, (Etr, _) = eng.run_dense(
            st, constant_schedule(float(b), pilot_sweeps).beta_array())
        tail = Etr[pilot_sweeps // 2:].cpu().numpy()
        sig.append(max(float(tail.std()), 1e-6))
    sig = np.asarray(sig)
    # integrate d_beta proportional to 1/sigma between probes
    dens = 1.0 / np.interp(np.linspace(beta_min, beta_max, 512), probe, sig)
    cum = np.concatenate([[0.0], np.cumsum(dens)])
    cum /= cum[-1]
    grid = np.linspace(beta_min, beta_max, 513)
    targets = np.linspace(0, 1, n_temps)
    return np.interp(targets, cum, grid)
