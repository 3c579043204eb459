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
  (the state's leading axis is 1): its device holds that partition's
  coupling and colour tables alone, cut where the caller built the
  problem, and of the whole problem only the index tables the gathers
  need and the graph the energy reads.  The boundary travels as the
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
gather-count, the per-lane LFSR draws and the same LUT accept in one
fused colour phase, ``kernels/bitplane_phase.py``; lane r is bitwise int8
replica r).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from .bits import MASK32, i64_to_i32, u32_from_numpy, u32_to_i64
from .degrade import (DegradePolicy, MeshHealthMonitor, carry_max,
                      carry_to_device, fault_code, health_step,
                      wire_checksum)
from .device import as_numpy, resolve_device
from .dsim import ColorPhases, DSIMState, PartitionedProblem, SyncSpec, _Color
from .gibbs import init_spins
from .mesh import make_mesh
from .packing import (pack_lanes, pack_pm1, pad_to_multiple, unpack_lanes,
                      unpack_pm1)
from .pbit import FixedPoint, flips_publish, lfsr_init, philox_init
from repro_torch.engines.base import check_lanes, spawn_seeds, trace_chunk
from repro_torch.kernels.ops import bitplane_phase_op

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
        self.degrade = DegradePolicy.parse(degrade)
        if self.degrade is not None and mode != "dsim":
            # cmft publishes fractional window means: no wire form to
            # checksum, and held means are no last good value
            raise ValueError("degrade policies need mode='dsim'")
        self.health = MeshHealthMonitor(self.degrade, prob.K,
                                        kind="partitions") \
            if self.degrade is not None else None
        self._fault_codes = None
        self.words = check_lanes(precision, replicas)
        self.device = resolve_device(device)
        self.mesh, self.group = mesh, mesh.group
        # in one process every partition lives on the engine's device; over
        # a process group the caller's problem stays where it was built
        # (the reference's ``self.p = prob``) and only this rank's
        # partition moves (the reference's constants, sharded P(axis))
        self.p = p = prob.to(self.device) if self.group is None else prob
        # where init_state draws and cuts the whole state
        self._host = self.device if self.group is None \
            else torch.device("cpu")
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
        """The colours' constants (``ColorPhases._init_colors``) and the
        exchange's index tables, each built where the problem lies: the
        held partitions' rows move to the device.  Whole, K partitions
        wide: the ghosts' source slots, read by ``init_state`` where it
        draws the state (over a process group on the host), and on the
        device ``global_spins``' slot ids and the graph ``energy``
        reads, as the reference's ``_energy_impl`` reads the whole
        ``self.p.graph``."""
        p, dev = self.p, self.device
        self._init_colors()
        held = self._held
        bs = torch.zeros((p.K, self.b_pad), dtype=torch.int64,
                         device=p.device)
        bs[:, :p.b_max] = p.bnd_slots.long()
        gsp = p.ghost_src_packed.long()
        src_k, src_c = gsp // p.b_max, gsp % p.b_max
        self._bnd_slots = bs[held].to(dev)
        # ghost j of partition k: pool column (source k') * b_pad + c
        self._ghost_src_pool = (src_k * self.b_pad + src_c)[held].to(dev)
        # the flat source slot of every ghost, into K * n_max: at
        # init_state ghost_src, in an exchange the pool's column (they
        # differ only at padding ghosts, which no field reads: partition
        # 0's slot 0, then its first boundary slot, as in the reference)
        self._ghost_src = {"init": p.ghost_src.long().to(self._host),
                           "pool": (src_k * p.n_max + bs[src_k, src_c])
                           .to(self._host)}
        # the source partition of every ghost: the hold mask of the
        # checked exchange
        self._ghost_src_part = src_k[held].to(dev)
        self._global_ids = p.global_ids.reshape(-1).long().to(dev)
        self._graph = p.graph.to(dev)

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
        replica seeded from ``spawn_seeds(seed, K*R)``.  Over a process
        group the whole state is drawn on the host and only this rank's
        partition moves to the device."""
        p, R, dev = self.p, self.replicas, self._host
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
                rng = torch.stack([philox_init(s, self.device) for s in
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
        """A state in the reference's global shapes, on any device -> the
        engine's: on its device (philox bytes stay on the CPU), and over a
        process group only this rank's partition, cut before it moves.
        Drops the cached exchange closure."""
        self._exchange_only_fn = None

        def mv(t):
            if t.dtype == torch.uint32:   # moved as its int32 view
                return t.view(torch.int32).to(self.device).view(torch.uint32)
            return t.to(self.device)
        part = (lambda t: t) if self.group is None else \
            (lambda t: t[self._held])
        rng = part(st.rng)
        return DSIMState(m=mv(part(st.m)), ghosts=mv(part(st.ghosts)),
                         macc=mv(part(st.macc)),
                         rng=rng if rng.dtype == torch.uint8 else mv(rng),
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
            lanes = torch.arange(lead, device=src.device)[None, :, None]
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

    def _wire(self, x: torch.Tensor, seq: torch.Tensor):
        """The checked exchange's wire: every partition's boundary values
        as they arrive, (K, lead, b_pad) (int8 spins; the f32 bits of the
        1-bit wire's +-1, as int32; int32-viewed words), and every
        partition's header [seq, checksum of what it sent], (K, 2)."""
        unpack = self.bitpack
        if self.group is None:
            K, lead = int(x.shape[0]), int(x.shape[1])
            pool = torch.gather(x, 2, self._bnd_slots[:, None, :].expand(
                K, lead, self.b_pad))
            wire = pool.to(torch.float32).view(torch.int32) if unpack \
                else pool
            hdrs = torch.stack([seq.expand(K),
                                wire_checksum(wire, batch_dims=1)], 1)
            return wire, hdrs
        import torch.distributed as dist
        bnd = x[0].index_select(1, self._bnd_slots[0])        # (lead, b_pad)
        sent = bnd.to(torch.float32).view(torch.int32) if unpack else bnd
        # [seq, checksum] as the uint32 pair's int32 view
        hdr = i64_to_i32(torch.stack([seq, wire_checksum(sent)]))
        payload = pack_pm1(bnd) if unpack else bnd.contiguous()
        bufs = [torch.empty_like(payload) for _ in range(self.p.K)]
        hbufs = [torch.empty_like(hdr) for _ in range(self.p.K)]
        dist.all_gather(bufs, payload, group=self.group)
        dist.all_gather(hbufs, hdr, group=self.group)
        pool = torch.stack(bufs)
        if unpack:
            pool = unpack_pm1(pool, self.b_pad).to(torch.float32).view(
                torch.int32)
        return pool, u32_to_i64(torch.stack(hbufs))

    def _exchange_checked(self, x: torch.Tensor, ghosts: torch.Tensor,
                          health: tuple, codes, freeze: bool):
        """The boundary exchange with the integrity layer on (the
        reference's ``_exchange_block_checked``): the receiver checksums
        each source partition's slice of the pool; a source that fails,
        or that an injected code hits (``codes``: the faults on the
        device, or None), has all its ghosts held at ``ghosts``.  Every
        process sees the same pool, so the carry has one holder."""
        seq = health[0]
        wire, hdrs = self._wire(x, seq)
        if codes is not None:
            code = fault_code(codes, seq)
            flip = 2 if wire.dtype == torch.int8 else 0x00400000
            wire = torch.where(code == 2, wire ^ flip, wire)
            wire = torch.where(code == 1, torch.zeros_like(wire), wire)
            hdrs = torch.where(code == 1, MASK32, hdrs)
        ok = (wire_checksum(wire, batch_dims=1) == hdrs[:, 1]) \
            & (hdrs[:, 0] == seq)
        bad, health = health_step(health, ok[None], freeze)
        if wire.dtype == torch.int8:
            vals = wire.to(torch.float32)
        elif self.precision == "bitplane":
            vals = wire
        else:
            vals = wire.view(torch.float32)
        K, lead = int(vals.shape[0]), int(vals.shape[1])
        src = self._ghost_src_pool
        new = vals.transpose(0, 1).reshape(lead, -1).index_select(
            1, src.reshape(-1)).reshape(lead, *src.shape).transpose(0, 1)
        held = bad[0][self._ghost_src_part][:, None, :]
        return torch.where(held, ghosts, new), health

    def set_exchange_faults(self, codes):
        """Schedule exchange faults: ``codes[seq]`` in {0 ok, 1 drop,
        2 corrupt} applied to the received pool of global exchange ``seq``
        of a run (see ``serve.faults.FaultPlan.exchange_codes``); ``None``
        clears.  Needs a degrade policy: an unchecked engine would ingest
        the damage."""
        if codes is None:
            self._fault_codes = None
            return
        if self.degrade is None:
            raise ValueError("set_exchange_faults needs a degrade policy "
                             "(unchecked engines must not ingest damage)")
        self._fault_codes = torch.from_numpy(
            np.asarray(codes, np.int64)).to(self.device)

    def resync(self, state: DSIMState) -> DSIMState:
        """Quarantine exit: every ghost recomputed from the current spins,
        the exchange a run without faults would make here; clears the
        monitor's staleness and freeze."""
        ghosts = self.boundary_exchange_fn()(state)
        if self.health is not None:
            self.health.on_resync()
        return dataclasses.replace(state, ghosts=ghosts)

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

    def _phase_w(self, col: _Color, mw, ghosts_w, s, lut, row: int, flips):
        """One colour phase on word planes, in place: mw (Kl, W, n_max) and
        ghosts_w (Kl, W, g_max) int32 views of the words, s (Kl, R, n_max)
        int64-carried LFSR states, ``lut[row]`` the LUT row; one fused
        launch on the card (``ops.bitplane_phase_op``: the gather-count,
        then per lane the field ``(base - f_max) + 2 * count``, the LFSR
        draw, the accept and the word write).  Adds each lane's flips to
        ``flips`` (R,) int64 (made here when None) and returns it."""
        if flips is None:
            flips = torch.zeros(self.replicas, dtype=torch.int64,
                                device=self.device)
        return bitplane_phase_op(mw, ghosts_w, s, col.sites, lut, row,
                                 self.f_max, flips)

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
        exchange = None
        if self.health is not None:
            carry = [carry_to_device(self.health.carry, 1, self.device)]
            codes = self._fault_codes
            freeze = self.degrade.mode == "freeze_boundary"

            def exchange(m, ghosts):
                ghosts, carry[0] = self._exchange_checked(
                    m, ghosts, carry[0], codes, freeze)
                return ghosts
        m, ghosts, macc, rng, flips = self._sweeps(
            as_i32(state.m).clone(), as_i32(state.ghosts), state.macc,
            state.rng, sched2d, sync, lut, exchange)
        iters, S = sched2d.shape
        st = DSIMState(
            m=as_u32(m), ghosts=as_u32(ghosts), macc=macc, rng=rng,
            sweep=state.sweep + iters * S,
            flips=flips_publish(state.flips, self._sum_parts(flips)))
        if self.health is not None:
            self.health.update(carry_max(carry[0]), exchanges=iters)
        return st

    def trace_chunk(self, iters: int = 4, S: int = 4, sync: SyncSpec = 4, *,
                    state=None, schedule=None, before=None):
        """Run one chunk of ``iters`` iterations of ``S`` sweeps under the
        exchange schedule ``sync`` (``run_recorded``'s ``sync_every``: S
        is 1 for "phase" and None), then the same chunk again recorded:
        its ``ChunkTrace`` (``engines/base.trace_chunk``).  The reference
        traces the chunk's program instead; eager PyTorch has none.
        ``state`` defaults to ``init_state(0)``."""
        return trace_chunk(
            self, self.init_state(seed=0) if state is None else state, iters,
            S, sync_every=sync, schedule=schedule, before=before)

    def lower_chunk(self, iters: int = 4, S: int = 4, sync: SyncSpec = 4):
        """The reference's dry-run hook lowers one chunk without running
        it; eager PyTorch has no program to lower, so this runs the chunk
        and records it: :meth:`trace_chunk` from ``init_state(0)``."""
        return self.trace_chunk(iters, S, sync)

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
