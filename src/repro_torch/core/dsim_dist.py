"""Distributed DSIM: one partition per member of a mesh; port of
``repro.core.dsim_dist``.

Each partition holds its local spins, shadow weights and ghost slots, and
the only collective while sampling is the boundary exchange: every
partition publishes the states of its boundary slots, every ``sync_every``
sweeps (or before every colour phase, or never), and each partition
gathers its ghosts from the pool.  The semantics are the stacked engine's
(:mod:`repro_torch.core.dsim`), on the same :class:`PartitionedProblem`.

Where the partitions live is the mesh's (:func:`repro_torch.core.mesh.
make_mesh` over one axis, ``"data"`` by default, of K = ``prob.K``):

* with no process group (``mesh=None`` builds this mesh), all K partitions
  live in this process, on the engine's device, stacked on the state's
  leading axis; one exchange is one gather over the whole stack, every
  partition at once;
* over a ``torch.distributed`` group of K ranks, rank k holds partition k
  (the state's leading axis is 1) and the boundary travels as the
  reference's wire payload through one ``all_gather``: ``pack_pm1`` bytes
  on f32 with ``bitpack=True``, int8 spins on int8 and f32 without it,
  f32 window means on cmft, and the uint32 words (as their int32 view)
  on the bit-plane path.  Flips are summed with ``all_reduce`` and the
  global state is gathered with ``all_gather``.

The state is the reference's: ``m`` (K, R, n_max) int8, or (K, W, n_max)
uint32 word planes on the bit-plane path (lane l at word l // 32, bit
l % 32); ``ghosts`` (K, R, g_max) f32 or (K, W, g_max) words; ``macc``
(K, R, n_max) f32, or (K, 1) on the word path; ``rng`` (K, R, n_max)
uint32 LFSR states, or (K, R, G) uint8 ``torch.Generator`` state bytes
(philox, on the CPU); ``sweep``; ``flips`` (R,) int32 odometers summed
over every partition.

Precisions: ``"f32"`` (tanh accept; LFSR from one stream
``lfsr_init(K*R*n_max, seed)``, or philox, one generator per partition
and replica), ``"int8"`` (int8 shadow couplings, int32 fields, the LUT
accept of the raw 24-bit LFSR draw; replica r seeded by
``spawn_seeds(seed, R)[r]`` alone, so it is replica r of the stacked int8
engine and prefix-stable in R) and ``"bitplane"`` (the int8 pipeline on
32 lanes per word: the field's +1-contribution count from the ELL word
gather-count kernel, ``kernels/bitplane_gather.py``, then per-lane LFSR
draws and the same LUT accept; lane r is bitwise int8 replica r).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from .bits import i64_to_i32, u32_from_numpy
from .device import as_numpy, resolve_device
from .dsim import ColorPhases, DSIMState, PartitionedProblem, SyncSpec, _Color
from .gibbs import init_spins
from .mesh import make_mesh
from .packing import (LANE_WIDTH, lane_coords, pack_lanes, pack_pm1,
                      pad_to_multiple, unpack_lanes, unpack_pm1)
from .pbit import (FixedPoint, flips_publish, lfsr_init, lfsr_next,
                   lut_accept, philox_init)
from repro_torch.engines.base import check_lanes, spawn_seeds
from repro_torch.kernels.ops import bitplane_gather_count_op

__all__ = ["DistDSIMEngine"]


class DistDSIMEngine(ColorPhases):
    """One partition per member of ``mesh`` along ``axis`` (K = its size),
    on ``device`` (CUDA unless ``device="cpu"``); the colour phases are
    :class:`repro_torch.core.dsim.ColorPhases`' on the (K, R, n_max)
    layout.  Inside the reference's ``shard_map`` the padded colour slots
    behave as in the stacked engine, on the word planes too: slot 0 keeps
    all lanes of its word where the padding rewrites it."""

    _LANE_AXIS = 1

    def __init__(self, prob: PartitionedProblem, mesh=None,
                 axis: Union[str, tuple] = "data", rng: str = "philox",
                 fmt: Optional[FixedPoint] = None, mode: str = "dsim",
                 bitpack: bool = True, replicas: int = 1,
                 precision: str = "f32", degrade=None, device=None):
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if mesh is None:
            mesh = make_mesh((prob.K,) + (1,) * (len(axes) - 1), axes)
        missing = [a for a in axes if a not in mesh.shape]
        if missing:
            raise ValueError(f"mesh has no axis {missing}; its axes are "
                             f"{mesh.axis_names}")
        ndev = int(np.prod([mesh.shape[a] for a in axes]))
        if ndev != prob.K:
            raise ValueError(f"mesh axis size {ndev} != K={prob.K}")
        if mode not in ("dsim", "cmft"):
            raise ValueError(f"unknown mode {mode!r}")
        if rng not in ("philox", "lfsr"):
            raise ValueError(f"unknown rng {rng!r}")
        if precision not in ("f32", "int8", "bitplane"):
            raise ValueError(f"unknown precision {precision!r}")
        if precision != "f32" and (rng != "lfsr" or mode != "dsim"):
            # the fixed-point and word paths are the hardware pipeline:
            # per-p-bit LFSRs and instantaneous +-1 ghosts
            raise ValueError(
                f"precision={precision!r} needs rng='lfsr', mode='dsim'")
        if degrade is not None:
            if mode != "dsim":
                raise ValueError("degrade policies need mode='dsim'")
            raise NotImplementedError(
                "degrade policies come with the degraded mesh: ROADMAP.md "
                "queue A item 9")
        self.words = check_lanes(precision, replicas)
        self.device = resolve_device(device)
        self.p = p = prob.to(self.device)
        self.mesh, self.group = mesh, mesh.group
        self.rng_kind, self.fmt, self.mode = rng, fmt, mode
        self.precision = precision
        self.replicas = int(replicas)
        self.n_sites = p.n
        # the 1-bit wire packs the boundary 8 slots per byte
        self.b_pad = pad_to_multiple(p.b_max, 8)
        self.bitpack = bitpack and mode == "dsim" and precision == "f32"
        # the partitions held here: all, or the rank's own
        self._held = slice(0, p.K)
        if self.group is not None:
            idle = [a for a, k in mesh.shape.items()
                    if a not in axes and k > 1]
            if idle:
                raise ValueError(f"over a process group every mesh axis "
                                 f"must be the partition axis; {idle} are "
                                 f"not")
            import torch.distributed as dist
            rank = dist.get_rank(self.group)
            self._held = slice(rank, rank + 1)
        self._ghost_idx = {}
        self._exchange_only_fn = None
        self._constants()

    # -- constants -------------------------------------------------------------

    def _constants(self):
        p, dev = self.p, self.device
        self._init_colors()
        if self.precision == "bitplane":
            wl, bl = lane_coords(self.replicas, 1, dev)
            self._lane_w, self._lane_b = wl, bl[None]       # (R,), (1, R, 1)
        held = self._held
        bs = torch.zeros((p.K, self.b_pad), dtype=torch.int64, device=dev)
        bs[:, :p.b_max] = p.bnd_slots.long()
        gsp = p.ghost_src_packed.long()
        src_k, src_c = gsp // p.b_max, gsp % p.b_max
        self._bnd_slots = bs[held]
        # ghost j of partition k: pool column (source k') * b_pad + c
        self._ghost_src_pool = (src_k * self.b_pad + src_c)[held]
        # the flat source slot of every ghost, into K * n_max: at
        # init_state ghost_src, in an exchange the pool's column (they
        # differ only at padding ghosts, which no field reads: partition
        # 0's slot 0, then its first boundary slot, as in the reference)
        self._ghost_src = {"init": p.ghost_src.long(),
                           "pool": src_k * p.n_max + bs[src_k, src_c]}
        self._global_ids = p.global_ids.reshape(-1).long()

    # -- state -----------------------------------------------------------------

    def init_state(self, seed: int = 0) -> DSIMState:
        """Fresh state.  Spins are :func:`repro_torch.core.gibbs.
        init_spins` of a numpy generator (the reference draws them with
        ``jax.random``), global spins mapped into the partitions with +1
        in padding slots: on int8 and bit-plane per replica from
        ``spawn_seeds(seed, R)[r]``, with the LFSR column
        ``lfsr_init(K*n_max, s_r)`` (the reference's); on f32 all replicas
        from one stream of ``seed``, with ``lfsr_init(K*R*n_max, seed)``
        (the reference's) or, for philox, one generator per partition and
        replica seeded from ``spawn_seeds(seed, K*R)``."""
        p, R, dev = self.p, self.replicas, self.device
        K, n_max = p.K, p.n_max
        gid = as_numpy(p.global_ids)
        ok = gid < p.n

        def spins(s, lead):                     # (lead, K, n_max) int8
            mg = init_spins(s, (lead, p.n))
            m = np.ones((lead, K, n_max), np.int8)
            m[:, ok] = mg[:, gid[ok]]
            return m

        if self.precision != "f32":
            seeds = spawn_seeds(seed, R)
            m_r = np.concatenate([spins(s, 1) for s in seeds])
            rng = u32_from_numpy(np.stack(
                [lfsr_init(K * n_max, s).reshape(K, n_max) for s in seeds],
                axis=1), dev)
        else:
            m_r = spins(seed, R)
            if self.rng_kind == "lfsr":
                rng = u32_from_numpy(
                    lfsr_init(K * R * n_max, seed).reshape(K, R, n_max), dev)
            else:
                rng = torch.stack([philox_init(s, dev) for s in
                                   spawn_seeds(seed, K * R)]).reshape(
                                       K, R, -1)
        m_r = torch.from_numpy(m_r).to(dev)
        if self.precision == "bitplane":
            m = pack_lanes(m_r).view(torch.int32).transpose(0, 1) \
                .contiguous().view(torch.uint32)               # (K, W, n_max)
            ghosts = self._gather_ghosts(m.view(torch.int32), "init").view(
                torch.uint32)
            macc = torch.zeros((K, 1), dtype=torch.float32, device=dev)
        else:
            m = m_r.transpose(0, 1).contiguous()               # (K, R, n_max)
            ghosts = self._gather_ghosts(m, "init").to(torch.float32)
            macc = torch.zeros((K, R, n_max), dtype=torch.float32,
                               device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return self.shard_state(DSIMState(
            m=m, ghosts=ghosts, macc=macc, rng=rng, sweep=zero,
            flips=torch.zeros((R,), dtype=torch.int32, device=dev)))

    def shard_state(self, st: DSIMState) -> DSIMState:
        """A state in the reference's global shapes -> the engine's: on its
        device (philox bytes stay on the CPU), and over a process group
        only this rank's partition.  Drops the cached exchange closure."""
        self._exchange_only_fn = None

        def mv(t):
            if t.dtype == torch.uint32:   # moved as its int32 view
                return t.view(torch.int32).to(self.device).view(torch.uint32)
            return t.to(self.device)
        part = (lambda t: t) if self.group is None else \
            (lambda t: t[self._held])
        rng = st.rng if st.rng.dtype == torch.uint8 else mv(st.rng)
        return DSIMState(m=part(mv(st.m)), ghosts=part(mv(st.ghosts)),
                         macc=part(mv(st.macc)), rng=part(rng),
                         sweep=mv(st.sweep), flips=mv(st.flips))

    def global_state(self, st: DSIMState) -> DSIMState:
        """The engine's state in the reference's global shapes; over a
        process group every rank calls it and receives every
        partition."""
        if self.group is None:
            return st
        g = self._gather_parts
        return dataclasses.replace(st, m=g(st.m), ghosts=g(st.ghosts),
                                   macc=g(st.macc), rng=g(st.rng))

    def _gather_parts(self, t: torch.Tensor) -> torch.Tensor:
        """(1, ...) of this rank -> (K, ...) of every rank, on t's device
        (uint32 through its int32 view; CPU tensors through the engine's
        device)."""
        import torch.distributed as dist
        x = t.view(torch.int32) if t.dtype == torch.uint32 else t
        x = x.to(self.device).contiguous()
        bufs = [torch.empty_like(x) for _ in range(self.p.K)]
        dist.all_gather(bufs, x, group=self.group)
        y = torch.cat(bufs).to(t.device)
        return y.view(torch.uint32) if t.dtype == torch.uint32 else y

    def _sum_parts(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks of a process group (the reference's
        ``psum``); identity in one process."""
        if self.group is None:
            return t
        import torch.distributed as dist
        dist.all_reduce(t, group=self.group)
        return t

    # -- the boundary exchange ---------------------------------------------------

    def _gather_ghosts(self, x: torch.Tensor, at: str = "pool"
                       ) -> torch.Tensor:
        """Every partition's ghosts from the values of every partition: x
        (K, lead, n_max) -> (K, lead, g_max), one gather (the flat index
        of ghost j of partition k is its source slot's, built once per
        lead; ``at`` "init" or "pool", see ``_ghost_src``)."""
        K, lead, n_max = (int(d) for d in x.shape)
        idx = self._ghost_idx.get((lead, at))
        if idx is None:
            src = self._ghost_src[at]                         # (K, g_max)
            lanes = torch.arange(lead, device=self.device)[None, :, None]
            idx = ((src // n_max)[:, None] * lead + lanes) * n_max \
                + (src % n_max)[:, None]
            idx = self._ghost_idx[lead, at] = idx.reshape(-1)
        return x.reshape(-1).index_select(0, idx).reshape(K, lead, -1)

    def _exchange(self, x: torch.Tensor) -> torch.Tensor:
        """Publish the boundary values x (Kl, lead, n_max) (int8 spins,
        f32 window means or int32-viewed words) and return the ghosts
        (Kl, lead, g_max) in x's dtype."""
        if self.group is None:
            return self._gather_ghosts(x)
        import torch.distributed as dist
        lead = int(x.shape[1])
        bnd = x[0].index_select(1, self._bnd_slots[0])        # (lead, b_pad)
        payload = pack_pm1(bnd) if self.bitpack else bnd.contiguous()
        bufs = [torch.empty_like(payload) for _ in range(self.p.K)]
        dist.all_gather(bufs, payload, group=self.group)
        pool = torch.stack(bufs)                              # (K, lead, .)
        if self.bitpack:
            pool = unpack_pm1(pool, self.b_pad)
        # device-major (K, lead, b_pad) -> per lane (lead, K * b_pad)
        pool = pool.transpose(0, 1).reshape(lead, -1)
        return pool.index_select(1, self._ghost_src_pool[0])[None]

    def boundary_exchange_fn(self):
        """The exchange alone, ``fn(state) -> ghosts`` on live state, every
        p-bit update elided: the measured-eta probe
        (``obs.EtaMeter.measure_exchange`` times it).  Cached, and
        dropped by :meth:`shard_state`."""
        if self._exchange_only_fn is None:
            def fn(st):
                if self.precision == "bitplane":
                    return self._refresh(st.m.view(torch.int32)).view(
                        torch.uint32)
                if self.mode == "cmft":
                    return self._exchange(st.macc)      # macc / 1
                return self._refresh(st.m)
            self._exchange_only_fn = fn
        return self._exchange_only_fn

    # -- one colour phase ----------------------------------------------------------

    def _phase_w(self, col: _Color, mw, ghosts_w, s, thr):
        """One colour phase on word planes, in place: mw (Kl, W, n_max) and
        ghosts_w (Kl, W, g_max) int32 views of the words, s (Kl, R, n_max)
        int64-carried LFSR states, ``thr`` the LUT row.  The field of
        lane l is ``(base - f_max) + 2 * count`` with count read from the
        gather-count planes at word ``l // 32``, bit ``l % 32``; the
        accepted bits go back per word (disjoint bits, so their sum is an
        OR).  Returns the flips (R,)."""
        Kl, W = int(mw.shape[0]), int(mw.shape[1])
        R, nc = self.replicas, int(col.slots.shape[-1])
        mext = torch.cat([mw, ghosts_w], dim=2).view(torch.uint32)
        counts = bitplane_gather_count_op(mext, col.idx, col.signs, col.nz)
        wl, bl = self._lane_w, self._lane_b
        idx = col.slots.expand(Kl, R, nc)
        sc = lfsr_next(torch.gather(s, 2, idx))
        s.scatter_(2, idx, sc)
        cnt = None
        for i, b in enumerate(counts):
            bit = ((b.view(torch.int32).index_select(1, wl) >> bl) & 1) << i
            cnt = bit if cnt is None else cnt + bit
        field = col.base - self.f_max + 2 * cnt               # (Kl, R, nc)
        accept = lut_accept(thr, field, self.f_max, sc >> 8)
        bits = accept.to(torch.int64) << bl
        if W * LANE_WIDTH > R:
            bits = torch.cat([bits, bits.new_zeros(
                (Kl, W * LANE_WIDTH - R, nc))], dim=1)
        upd = i64_to_i32(bits.reshape(Kl, W, LANE_WIDTH, nc).sum(2))
        widx = col.slots.expand(Kl, W, nc)
        old = torch.gather(mw, 2, widx)
        new = torch.where(col.mask, upd, old)
        flips = (((old ^ new).index_select(1, wl) >> bl) & 1).sum((0, 2))
        if col.lost is not None:
            new = torch.where(col.lost, old, new)
        mw.scatter_(2, widx, new)
        return flips

    # -- runners -------------------------------------------------------------------

    def _lanes(self, state: DSIMState) -> int:
        return self.replicas

    def _chunk(self, state: DSIMState, sched2d: np.ndarray, sync: SyncSpec,
               lut=None) -> DSIMState:
        """``iters`` iterations of S sweeps; sched2d (iters, S) f32 betas
        or int32 LUT rows (with ``lut`` the threshold table)."""
        word = self.precision == "bitplane"
        as_i32 = (lambda t: t.view(torch.int32)) if word else (lambda t: t)
        as_u32 = (lambda t: t.view(torch.uint32)) if word else (lambda t: t)
        m, ghosts, macc, rng, flips = self._sweeps(
            as_i32(state.m).clone(), as_i32(state.ghosts), state.macc,
            state.rng, sched2d, sync, lut)
        iters, S = sched2d.shape
        return DSIMState(
            m=as_u32(m), ghosts=as_u32(ghosts), macc=macc, rng=rng,
            sweep=state.sweep + iters * S,
            flips=flips_publish(state.flips, self._sum_parts(flips)))

    # -- observables ---------------------------------------------------------------

    def global_spins(self, state: DSIMState) -> torch.Tensor:
        """(R, N) global spins; (N,) when replicas == 1.  Over a process
        group every rank calls it."""
        p, R = self.p, self.replicas
        m = state.m if self.group is None else self._gather_parts(state.m)
        if self.precision == "bitplane":
            m_r = unpack_lanes(m.transpose(0, 1), R)          # (R, K, n_max)
        else:
            m_r = m.transpose(0, 1)
        buf = torch.ones((R, p.n + 1), dtype=torch.int8, device=m.device)
        buf.index_copy_(1, self._global_ids, m_r.reshape(R, -1))
        spins = buf[:, :p.n]
        return spins[0] if R == 1 else spins

    def boundary_payload(self) -> dict:
        """Wire format of one boundary publication per partition: dtype,
        bytes, and bytes per boundary site over all replicas or lanes."""
        R = self.replicas
        if self.precision == "bitplane":
            W = self.words
            return {"dtype": "uint32", "bytes": 4 * W * self.b_pad,
                    "bytes_per_site_all_chains": 4.0 * W, "chains": R,
                    "word_planes": W, "bytes_per_site_per_word": 4.0,
                    "pack_compute": "none"}
        if self.mode == "cmft":
            return {"dtype": "float32", "bytes": 4 * R * self.b_pad,
                    "bytes_per_site_all_chains": 4.0 * R, "chains": R,
                    "pack_compute": "none"}
        if self.bitpack:
            return {"dtype": "uint8-bitmap", "bytes": R * self.b_pad // 8,
                    "bytes_per_site_all_chains": R / 8.0, "chains": R,
                    "pack_compute": "pack+unpack per exchange"}
        return {"dtype": "int8", "bytes": R * self.b_pad,
                "bytes_per_site_all_chains": float(R), "chains": R,
                "pack_compute": "none"}
