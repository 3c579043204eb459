"""The brick layout of a partitioned lattice and its halo exchange.

Port of the mesh half of ``repro.core.lattice_dsim``.  The global lattice
(X, Y, Z) is cut into nb = (kx, ky, kz) bricks of (bx, by, bz) sites:
brick (i, j, k) holds the sites [i*bx, (i+1)*bx) x [j*by, ...) x
[k*bz, ...), and bricks are numbered row-major over (i, j, k).  A mesh
engine keeps its state brick-major (:class:`BrickState`), each brick's
(lead, bx, by, bz) block contiguous, so every kernel takes its brick as it
lies; :func:`cut` and :func:`join` convert to and from the reference's
global shapes (spins (lead, X, Y, Z); the six halo stacks (lead, kx, Y, Z)
x2, (lead, X, ky, Z) x2, (lead, X, Y, kz) x2).

The halo rule is the reference's ``_halo_shift``: x and y are open chains
and z is a periodic ring.  A brick's low halo along an axis is the high
face of its -1 neighbour and its high halo the low face of its +1
neighbour.  With one brick along an axis, z wraps the brick's own opposite
face and x and y are zero.  With more than one, the outer x and y faces
have no neighbour and hold zero words on the bit-plane path, zero spins
with ``bitpack_halos=False``, and -1 with ``bitpack_halos=True``: there the
reference's 1-bit wire delivers zero bytes, and a zero bit unpacks to -1.
The face couplings are zero, so the sweeps do not see the difference.

Both exchanges also run checked (``checked``), the reference's
``_exchange_block_checked``: every wired face carries a header [seq,
checksum of the face as sent], the receiver checksums what arrived, and a
face that fails, or that an injected fault code hits, is held at its last
good plane (``core/degrade.py``).  The outer faces of an open chain have
no sender and are always accepted, as are the faces of an axis of one
brick, which touch no link.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .bits import i64_to_i32, u32_to_i64
from .degrade import (_mults, fault_code, health_step, mulmod32,
                      wire_checksum, wire_words)
from .packing import pack_pm1, pad_to_multiple, unpack_pm1

__all__ = ["BrickState", "brick_coords", "cut", "join", "GatherExchange",
           "GroupExchange"]

Coord = Tuple[int, int, int]


@dataclasses.dataclass
class BrickState:
    """A mesh engine's state: the K bricks this process holds, in the
    engine's brick order.  ``m`` (K, R, bx, by, bz) int8 spins or
    (K, W, bx, by, bz) uint32 word planes; ``s`` (K, R, bx, by, bz) uint32
    LFSR states; ``halos`` six (K, lead, A, B) planes, each brick's as its
    kernels read them; ``flips`` (R,) int32 odometers summed over every
    brick of the mesh; ``nb`` the mesh's brick counts."""

    m: torch.Tensor
    s: torch.Tensor
    halos: tuple
    sweep: torch.Tensor
    flips: torch.Tensor
    nb: Tuple[int, int, int]

    @property
    def replicas(self) -> int:
        return int(self.s.shape[1])


def brick_coords(nb: Sequence[int]) -> List[Coord]:
    """Every brick's (i, j, k), row-major."""
    return list(itertools.product(*(range(int(k)) for k in nb)))


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _as(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.view(torch.uint32) if dtype == torch.uint32 else t


def _index(brick: Sequence[int], c: Coord, axis) -> tuple:
    """Brick ``c``'s index into a global (lead, X, Y, Z) tensor, or into
    axis ``axis``'s halo stack (the brick's own entry along that axis)."""
    idx = [slice(None)]
    for d in range(3):
        idx.append(c[d] if d == axis else
                   slice(c[d] * brick[d], (c[d] + 1) * brick[d]))
    return tuple(idx)


def cut(t: torch.Tensor, brick: Sequence[int], coords: Sequence[Coord],
        axis=None) -> torch.Tensor:
    """A global tensor -> the (K, lead, ...) blocks of the bricks at
    ``coords``: spins or states (lead, X, Y, Z) -> (K, lead, bx, by, bz);
    with ``axis``, that axis's halo stack -> (K, lead, A, B)."""
    x = _i32(t)
    return _as(torch.stack([x[_index(brick, c, axis)].contiguous()
                            for c in coords]), t.dtype)


def join(b: torch.Tensor, brick: Sequence[int], coords: Sequence[Coord],
         nb: Sequence[int], axis=None) -> torch.Tensor:
    """Inverse of :func:`cut` over a full set of bricks."""
    lead = int(b.shape[1])
    shape = [lead] + [int(k) * int(e) for k, e in zip(nb, brick)]
    if axis is not None:
        shape[axis + 1] = int(nb[axis])
    x = _i32(b)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    for n, c in enumerate(coords):
        out[_index(brick, c, axis)] = x[n]
    return _as(out, b.dtype)


def _plane(brick: Sequence[int], d: int):
    """Direction d's axis, whether it is the low halo, the plane's two
    axes and extents."""
    a, lo = d // 2, d % 2 == 0
    o = [ax for ax in range(3) if ax != a]
    return a, lo, o, (int(brick[o[0]]), int(brick[o[1]]))


class GatherExchange:
    """The halo exchange of every brick of a one-process mesh: index maps
    built once, so one gather over the bricks' spins and one select of
    the outer faces' values fill all 6 x K halo planes of one buffer.

    ``lead`` is R (int8 spins) or W (word planes); ``outer_fill`` the
    value of an outer x or y face along an axis of more than one brick
    (-1 for int8 spins with ``bitpack_halos=True``, else 0).  The buffer
    holds direction d's planes as a (K, lead, A, B) block, so each
    brick's plane is contiguous; :meth:`bricks` and :meth:`planes` view
    it without copying."""

    def __init__(self, nb: Sequence[int], brick: Sequence[int], lead: int,
                 outer_fill: int, dtype, device):
        nb = tuple(int(k) for k in nb)
        coords = brick_coords(nb)
        K, n_b = len(coords), int(np.prod(brick))
        lead_off = (np.arange(lead, dtype=np.int64) * n_b)[:, None, None]
        idx, keep, fill = [], [], []
        blocks, off = [], 0       # each direction's (offset, shape)
        for d in range(6):
            a, lo, o, (A, B) = _plane(brick, d)
            pos = np.zeros((3, A, B), np.int64)
            pos[o[0]] = np.arange(A)[:, None]
            pos[o[1]] = np.arange(B)[None, :]
            pos[a] = brick[a] - 1 if lo else 0     # the source face
            site = (pos[0] * brick[1] + pos[1]) * brick[2] + pos[2]
            for c in coords:
                nc = list(c)
                nc[a] += -1 if lo else 1
                if a == 2:                          # the z ring
                    nc[a] %= nb[a]
                ok = 0 <= nc[a] < nb[a]
                src = coords.index(tuple(nc)) if ok else 0
                idx.append(src * lead * n_b + lead_off + site[None])
                keep.append(np.full((lead, A, B), ok))
                fill.append(np.full((lead, A, B),
                                    outer_fill if nb[a] > 1 else 0))
            blocks.append((off, (K, lead, A, B)))
            off += K * lead * A * B
        # as_strided arguments of each direction's block and of each
        # brick's plane in it
        self._planes = [(sh, _strides(sh), o) for o, sh in blocks]
        self._bricks = [[(sh[1:], _strides(sh[1:]),
                          o + k * int(np.prod(sh[1:])))
                         for o, sh in blocks] for k in range(K)]
        gdt = torch.int32 if dtype == torch.uint32 else dtype
        self.dtype = dtype
        self.idx = torch.from_numpy(
            np.concatenate([x.reshape(-1) for x in idx])).to(device)
        self.keep = torch.from_numpy(
            np.concatenate([x.reshape(-1) for x in keep])).to(device)
        self.fill = torch.from_numpy(
            np.concatenate([x.reshape(-1) for x in fill])).to(
                device=device, dtype=gdt)
        # the checked exchange's constants: each element's plane, brick k
        # and direction d as k * 6 + d, its checksum weight within the
        # plane, and which planes have a sender over a link
        plane, pos, has_src = [], [], np.zeros((K, 6), bool)
        for d in range(6):
            a = d // 2
            n = lead * int(np.prod(blocks[d][1][2:]))
            for k in range(K):
                plane.append(np.full(n, k * 6 + d, np.int64))
                pos.append(np.arange(n))
                has_src[k, d] = nb[a] > 1 and bool(keep[d * K + k].all())
        self.plane = torch.from_numpy(np.concatenate(plane)).to(device)
        n_max = max(len(x) for x in pos)
        self.weight = _mults(n_max, device)[
            torch.from_numpy(np.concatenate(pos)).to(device)]
        self.has_src = torch.from_numpy(has_src).to(device)
        self.n_planes = K * 6

    def __call__(self, m: torch.Tensor) -> torch.Tensor:
        """(K, lead, bx, by, bz) spins or words -> the halo buffer."""
        return _as(torch.where(self.keep,
                               _i32(m).reshape(-1).index_select(0, self.idx),
                               self.fill), self.dtype)

    def _checksums(self, x: torch.Tensor) -> torch.Tensor:
        """(K, 6) checksum of every plane of an int32-viewed buffer."""
        p = mulmod32(wire_words(x), self.weight,
                     narrow=self.dtype == torch.int8)
        ck = torch.zeros(self.n_planes, dtype=torch.int64, device=x.device)
        return (ck.index_add_(0, self.plane, p) & 0xFFFFFFFF).reshape(-1, 6)

    def checked(self, m: torch.Tensor, prev: torch.Tensor, health: tuple,
                codes, freeze: bool):
        """The exchange with the integrity layer on: ``prev`` the halo
        buffer of the last exchange, ``health`` the carry of every brick
        ((K, 6) staleness), ``codes`` the injected fault codes on the
        device or None.  Returns the new buffer and carry."""
        seq = health[0]
        raw = _i32(m).reshape(-1).index_select(0, self.idx)
        rx = torch.where(self.keep, raw, self.fill)
        ck_sent = self._checksums(rx)
        hdr_seq = seq.expand(ck_sent.shape)
        if codes is not None:
            code = fault_code(codes, seq)
            wired = self.has_src.reshape(-1)[self.plane]
            flip = 1 if self.dtype == torch.uint32 else 2
            rx = torch.where(wired & (code == 2), rx ^ flip, rx)
            drop = wired & (code == 1)
            rx = torch.where(drop, torch.zeros_like(rx), rx)
            dropped = self.has_src & (code == 1)
            ck_sent = torch.where(dropped, 0xFFFFFFFF, ck_sent)
            hdr_seq = torch.where(dropped, 0xFFFFFFFF, hdr_seq)
        ok = ((self._checksums(rx) == ck_sent) & (hdr_seq == seq)) \
            | ~self.has_src
        bad, health = health_step(health, ok, freeze)
        held = bad.reshape(-1)[self.plane]
        out = torch.where(held, _i32(prev).reshape(-1), rx)
        return _as(out, self.dtype), health

    def buffer(self, planes) -> torch.Tensor:
        """The six planes of a halo buffer (in the order and shapes of
        :meth:`planes`, or one brick's (lead, 1, Y, Z)-style planes) ->
        the buffer."""
        return _as(torch.cat([_i32(h).reshape(-1) for h in planes]),
                   self.dtype)

    def planes(self, h: torch.Tensor) -> tuple:
        """The six (K, lead, A, B) planes of a halo buffer."""
        return tuple(h.as_strided(*v) for v in self._planes)

    def bricks(self, h: torch.Tensor) -> list:
        """Each brick's six (lead, A, B) planes of a halo buffer."""
        return [tuple(h.as_strided(*v) for v in views)
                for views in self._bricks]


def _strides(shape) -> tuple:
    """Row-major strides of a contiguous ``shape``."""
    out, n = [], 1
    for e in reversed(shape):
        out.append(n)
        n *= int(e)
    return tuple(reversed(out))


class GroupExchange:
    """The halo exchange of one brick per rank over ``torch.distributed``:
    point-to-point messages to the six neighbours, in one batch.  int8 and
    f32 spins travel as :func:`pack_pm1` bytes with ``bitpack_halos=True``
    (padded with +1 to a multiple of 8, as the reference pads them), the
    bit-plane words through their int32 view; a face with no sender is the
    outer face of :class:`GatherExchange`."""

    def __init__(self, group, peers, brick: Sequence[int], lead: int,
                 nb: Sequence[int], bitpack: bool, dtype):
        """``peers[a]`` = (global rank of the -1 neighbour, of the +1
        neighbour) along lattice axis a, None where there is none."""
        self.group, self.peers = group, peers
        self.brick, self.lead = tuple(int(e) for e in brick), int(lead)
        self.nb = tuple(int(k) for k in nb)
        self.dtype = dtype
        self.bitpack = bool(bitpack) and dtype == torch.int8

    def _payload(self, face):
        if self.bitpack:
            flat = face.reshape(-1)
            n = flat.numel()
            pad = pad_to_multiple(n, 8) - n
            if pad:
                flat = torch.cat([flat, flat.new_ones(pad)])
            return pack_pm1(flat)
        return _i32(face).contiguous()

    def _unpayload(self, buf, shape):
        if self.bitpack:
            return unpack_pm1(buf, int(np.prod(shape))).reshape(shape)
        return _as(buf, self.dtype).reshape(shape)

    def __call__(self, m: torch.Tensor) -> tuple:
        """(1, lead, bx, by, bz) -> the brick's six (lead, A, B) planes
        (its halo buffer)."""
        return tuple(self._exchange(m)[0])

    def _exchange(self, m: torch.Tensor, seq=None):
        """The six planes, and with ``seq`` (the checked exchange) each
        wired direction's received header [seq, checksum of the face as
        sent] (zeros where there is no sender)."""
        import torch.distributed as dist
        mb = m[0]
        ops, recvs, out, hdrs = [], {}, [None] * 6, {}
        for d in range(6):
            a, lo, _, (A, B) = _plane(self.brick, d)
            shape = (self.lead, A, B)
            # the face this rank sends for direction d, to the neighbour
            # whose d-halo it is: its high face up for a low halo
            face = _i32(mb).select(a + 1, self.brick[a] - 1 if lo else 0)
            src, dst = (self.peers[a] if lo else self.peers[a][::-1])
            if self.nb[a] == 1:      # the k == 1 rule: wrap z, zero x, y
                out[d] = _as(face.contiguous() if a == 2 else
                             torch.zeros_like(face), self.dtype)
                continue
            payload = self._payload(face)
            if dst is not None:
                ops.append(dist.P2POp(dist.isend, payload, dst, self.group,
                                      tag=d))
            buf = torch.zeros_like(payload)
            if src is not None:
                ops.append(dist.P2POp(dist.irecv, buf, src, self.group,
                                      tag=d))
            recvs[d] = (buf, shape)
            if seq is not None:
                # [seq, checksum] as the uint32 pair's int32 view
                hdr = i64_to_i32(torch.stack([seq, wire_checksum(face)]))
                if dst is not None:
                    ops.append(dist.P2POp(dist.isend, hdr, dst, self.group,
                                          tag=6 + d))
                hdrs[d] = torch.zeros_like(hdr)
                if src is not None:
                    ops.append(dist.P2POp(dist.irecv, hdrs[d], src,
                                          self.group, tag=6 + d))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        for d, (buf, shape) in recvs.items():
            out[d] = self._unpayload(buf, shape)
        return out, {d: u32_to_i64(h) for d, h in hdrs.items()}

    def checked(self, m: torch.Tensor, prev: tuple, health: tuple, codes,
                freeze: bool):
        """:meth:`GatherExchange.checked` for this rank's brick: ``prev``
        its six planes of the last exchange, ``health`` its carry ((1, 6)
        staleness).  Returns the new planes and carry."""
        seq = health[0]
        out, hdrs = self._exchange(m, seq)
        code = None if codes is None else fault_code(codes, seq)
        flip = 1 if self.dtype == torch.uint32 else 2
        oks = []
        for d in range(6):
            a, lo = d // 2, d % 2 == 0
            has_src = d in hdrs and \
                (self.peers[a] if lo else self.peers[a][::-1])[0] is not None
            if not has_src:
                oks.append(torch.ones((), dtype=torch.bool,
                                      device=seq.device))
                continue
            rx, hdr = _i32(out[d]), hdrs[d]
            if code is not None:
                rx = torch.where(code == 2, rx ^ flip, rx)
                rx = torch.where(code == 1, torch.zeros_like(rx), rx)
                hdr = torch.where(code == 1, 0xFFFFFFFF, hdr)
            oks.append((wire_checksum(rx) == hdr[1]) & (hdr[0] == seq))
            out[d] = _as(rx, self.dtype)
        bad, health = health_step(health, torch.stack(oks)[None], freeze)
        return tuple(_as(torch.where(bad[0, d], _i32(prev[d]), _i32(out[d])),
                         self.dtype) for d in range(6)), health

    @staticmethod
    def buffer(planes) -> tuple:
        """The state's (1, lead, A, B) planes -> the brick's six planes."""
        return tuple(h[0] for h in planes)

    @staticmethod
    def planes(h: tuple) -> tuple:
        return tuple(x[None] for x in h)

    @staticmethod
    def bricks(h: tuple) -> list:
        return [h]
