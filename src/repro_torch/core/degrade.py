"""Degraded-mode fabric for the mesh engines: integrity and failover policy.

Port of ``repro.core.degrade``.  Every boundary exchange of a mesh engine
with a :class:`DegradePolicy` carries a wire header ``[seq, checksum]``
beside its payload, so a corrupted, dropped or out-of-order exchange is
detected by the receiver instead of ingested:

* ``fail_fast`` raises :class:`StateCorruption` at the first detection;
* ``stale_hold`` keeps sweeping on the last good boundary values until a
  source has been held for more than its staleness budget of exchanges;
* ``freeze_boundary`` pins every boundary value for good after the first
  detection, and never escalates.

The in-run side lives in the engines (``core/lattice_dsim.py`` with
``core/bricks.py``, ``core/dsim_dist.py``): the health carry (seq,
per-source staleness, frozen flag, detections, held exchanges, worst
staleness) stays on the device through a chunk, a held source is a
``torch.where`` against the carried values, and :class:`MeshHealthMonitor`
reads the carry once per chunk on the host and enforces the policy.  With
no detection the held values are never selected, so a checked run is
bitwise the unchecked one.

The checksum is the reference's: ``sum(w_i * (i * 2654435761 + 1)) mod
2^32`` over the payload viewed as uint32 words (int8 widened through its
uint8 view, f32 through its bit pattern).  PyTorch has almost no uint32
arithmetic, so the words are carried in int64 and each product is formed
from 16-bit halves, exact without relying on signed overflow.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple, Union

import numpy as np
import torch

from .bits import MASK32

__all__ = ["StateCorruption", "DegradePolicy", "MeshHealthMonitor",
           "health_init", "wire_checksum", "wire_words", "DEGRADE_MODES",
           "carry_to_device", "carry_max", "fault_code", "health_step",
           "mulmod32"]

DEGRADE_MODES = ("fail_fast", "stale_hold", "freeze_boundary")

# one odd multiplier per word position (Knuth's 2^32/phi): reordered
# payload words fail the check
_CK_MULT = 2654435761


class StateCorruption(RuntimeError):
    """Engine state failed an integrity check: the serving integrity guard
    (non-finite recorded energies), or a mesh engine whose
    :class:`DegradePolicy` escalated.  Transient for
    ``serve.faults.classify_error``: a retry re-runs from a checkpoint."""


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """What a mesh engine does when a boundary exchange fails integrity
    (see the module docstring).  ``max_staleness`` counts exchanges, per
    source: partition k for ``dsim_dist``, face index for the lattice."""

    mode: str = "stale_hold"
    max_staleness: int = 8

    MODES: ClassVar[Tuple[str, ...]] = DEGRADE_MODES

    def __post_init__(self):
        if self.mode not in DEGRADE_MODES:
            raise ValueError(f"unknown degrade mode {self.mode!r}; "
                             f"expected one of {DEGRADE_MODES}")
        if int(self.max_staleness) < 0:
            raise ValueError("max_staleness must be >= 0")

    @classmethod
    def parse(cls, spec: Union[None, str, "DegradePolicy"]) \
            -> Optional["DegradePolicy"]:
        """None | DegradePolicy | "fail_fast" | "stale_hold[:N]" |
        "freeze_boundary" -> DegradePolicy (or None)."""
        if spec is None or isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            name, _, arg = spec.partition(":")
            if arg and name != "stale_hold":
                raise ValueError(
                    f"degrade policy {spec!r}: only stale_hold takes a "
                    "staleness budget")
            if name == "stale_hold" and arg:
                return cls(name, int(arg))
            return cls(name)
        raise TypeError(f"cannot parse degrade policy from {type(spec)}")

    def key(self) -> str:
        """Canonical string form (hashable, round-trips through parse)."""
        if self.mode == "stale_hold":
            return f"stale_hold:{int(self.max_staleness)}"
        return self.mode


def health_init(n_sources: int) -> tuple:
    """Fresh health carry: (seq, stale[n_sources], frozen, detections,
    held, max_staleness), host numpy values; the engines move it to their
    device for a chunk."""
    return (np.uint32(0), np.zeros(int(n_sources), np.int32), np.int32(0),
            np.int32(0), np.int32(0), np.int32(0))


def wire_words(x) -> torch.Tensor:
    """A payload as its uint32 words, carried in int64: int8 through its
    uint8 view (so -1 is 255), f32 through its bit pattern, uint32 and
    int32 as their bits; numpy arrays are taken as tensors."""
    if isinstance(x, np.ndarray):
        a = np.ascontiguousarray(x)
        x = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                             else a)
    if x.dtype == torch.int8:
        return x.view(torch.uint8).to(torch.int64)
    if x.dtype in (torch.uint32, torch.float32):
        x = x.view(torch.int32)
    return x.to(torch.int64) & MASK32


_MULTS = {}


def _mults(n: int, device) -> torch.Tensor:
    """(i * 2654435761 + 1) mod 2^32 for i < n, int64 on ``device``."""
    key = (int(n), torch.device(device))
    m = _MULTS.get(key)
    if m is None:
        m = torch.from_numpy(
            (np.arange(n, dtype=np.uint64) * np.uint64(_CK_MULT)
             + np.uint64(1)) & np.uint64(MASK32)).to(torch.int64).to(device)
        _MULTS[key] = m
    return m


def mulmod32(w: torch.Tensor, m: torch.Tensor, narrow: bool = False
             ) -> torch.Tensor:
    """(w * m) mod 2^32 for int64 ``w`` and ``m`` in [0, 2^32); ``narrow``
    when every w < 2^8 (the product then fits in int64 directly), else
    from w's 16-bit halves, each partial product < 2^48."""
    if narrow:
        return (w * m) & MASK32
    return ((w & 0xFFFF) * m + (((w >> 16) * m) & 0xFFFF) * 65536) & MASK32


def wire_checksum(x, batch_dims: int = 0) -> torch.Tensor:
    """Position-weighted checksum of a payload, int64 in [0, 2^32):
    over all of ``x`` (a scalar), or over its trailing dims for each
    index of its ``batch_dims`` leading ones."""
    narrow = x.dtype in (torch.int8, torch.uint8, torch.bool)
    w = wire_words(x)
    lead = tuple(w.shape[:batch_dims])
    w = w.reshape(lead + (-1,))
    p = mulmod32(w, _mults(w.shape[-1], w.device), narrow)
    return p.sum(-1) & MASK32


# -- the engines' side: the health carry on the device ------------------------

def carry_to_device(carry, holders: int, device) -> tuple:
    """A host carry -> int64 tensors on ``device``: seq a scalar, the
    others with a leading axis of ``holders`` (the bricks or partitions a
    process holds), each holder starting from the same values."""
    seq, stale, frozen, det, held, maxst = (np.asarray(x, np.int64)
                                            for x in carry)

    def lead(a):
        return torch.from_numpy(np.broadcast_to(
            a, (holders,) + a.shape).copy()).to(device)
    return (torch.tensor(int(seq), dtype=torch.int64, device=device),
            lead(stale), lead(frozen), lead(det), lead(held), lead(maxst))


def carry_max(carry) -> tuple:
    """The carry of every holder -> one carry, the worst of each counter
    (the reference's ``pmax`` over devices)."""
    seq, *rest = carry
    return (seq,) + tuple(x.max(0).values for x in rest)


def fault_code(codes: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """The injected fault of exchange ``seq`` (0 past the end of
    ``codes``), on the device: 0 deliver, 1 drop, 2 corrupt."""
    total = int(codes.shape[0])
    # index_select, not codes[seq]: a 0-d index tensor is read on the host
    c = codes.index_select(0, seq.clamp(0, total - 1).reshape(1))[0]
    return torch.where(seq < total, c, torch.zeros_like(c))


def health_step(health: tuple, ok: torch.Tensor, freeze: bool):
    """One checked exchange's update of the carry; ``ok`` (holders,
    sources) says which sources passed.  Returns the held sources
    (holders, sources) and the new carry."""
    seq, stale, frozen, det, held, maxst = health
    bad = ~ok
    any_bad = bad.any(-1).to(torch.int64)
    if freeze:
        frozen = torch.maximum(frozen, any_bad)
        bad = bad | (frozen > 0)[:, None]
    det = det + any_bad
    held = held + bad.any(-1).to(torch.int64)
    stale = torch.where(bad, stale + 1, torch.zeros_like(stale))
    maxst = torch.maximum(maxst, stale.max(-1).values)
    return bad, ((seq + 1) & MASK32, stale, frozen, det, held, maxst)


class MeshHealthMonitor:
    """Host-side keeper of a mesh engine's exchange-health carry.

    The engine carries it through each chunk on its device and hands the
    result to :meth:`update` (one device-to-host read per chunk), which
    feeds the cumulative totals and enforces the policy.  ``resync()`` on
    the engine calls :meth:`on_resync`.  Counters, cumulative over the
    current run: ``detections`` (exchanges where a source failed the
    check), ``stale_exchanges`` (exchanges where a source was held),
    ``max_staleness_seen`` and ``exchanges_total``.

    :meth:`quiet` is a context in which updates leave the monitor as it
    was and raise nothing: a cursor's ``warm`` runs chunks only to build
    and launch their kernels, and those chunks are not part of the run."""

    def __init__(self, policy: DegradePolicy, n_sources: int,
                 kind: str = "partitions"):
        self.policy = policy
        self.n_sources = int(n_sources)
        self.kind = kind
        self.resyncs = 0
        self._quiet = 0
        self.reset()

    def reset(self):
        """Fresh carry and counters (at the start of every run)."""
        self.carry = health_init(self.n_sources)
        self.exchanges_total = 0
        self.detections = 0
        self.stale_exchanges = 0
        self.max_staleness_seen = 0

    @property
    def suspect(self) -> bool:
        """Quarantine mark: a source failed integrity and no resync has
        cleared the staleness since."""
        return bool(np.asarray(self.carry[1]).max(initial=0) > 0
                    or int(self.carry[2]) > 0)

    @property
    def staleness(self) -> np.ndarray:
        """Per-source consecutive-held exchange counts (copy)."""
        return np.asarray(self.carry[1]).copy()

    @property
    def delivered_fraction(self) -> float:
        """Fraction of exchanges fully ingested (the effective-η
        factor)."""
        if not self.exchanges_total:
            return 1.0
        return max(0.0, 1.0 - self.stale_exchanges / self.exchanges_total)

    def quiet(self):
        return _Quiet(self)

    def update(self, carry, exchanges: int):
        """Absorb a post-chunk carry (host values or device tensors, read
        in one transfer), then enforce the policy: raises
        :class:`StateCorruption` as the policy says."""
        if self._quiet:
            return
        if any(isinstance(x, torch.Tensor) for x in carry):
            flat = torch.cat([torch.as_tensor(x).reshape(-1).to(torch.int64)
                              for x in carry]).cpu().numpy()
            n = self.n_sources
            carry = (np.uint32(flat[0]), flat[1:1 + n].astype(np.int32),
                     *(np.int32(v) for v in flat[1 + n:]))
        self.carry = carry
        _, _, _, det, held, maxst = carry
        self.exchanges_total += int(exchanges)
        self.detections = int(det)
        self.stale_exchanges = int(held)
        self.max_staleness_seen = max(self.max_staleness_seen, int(maxst))
        p = self.policy
        if p.mode == "fail_fast" and self.detections:
            raise StateCorruption(
                f"boundary integrity failure: {self.detections} bad "
                f"exchange(s) detected on the {self.kind} wire "
                "(policy fail_fast)")
        if p.mode == "stale_hold" \
                and self.max_staleness_seen > p.max_staleness:
            raise StateCorruption(
                f"boundary staleness {self.max_staleness_seen} exceeded "
                f"budget {p.max_staleness} exchanges (policy stale_hold; "
                "resync() or retry required)")

    def on_resync(self):
        """Clear staleness and freeze after a full-boundary refresh; the
        cumulative counters are history and stay."""
        seq, _, _, det, held, maxst = self.carry
        self.carry = (seq, np.zeros(self.n_sources, np.int32), np.int32(0),
                      det, held, maxst)
        self.resyncs += 1

    def report(self) -> dict:
        """Provenance dict (JSON-safe) for job results and dashboards."""
        return {
            "policy": self.policy.key(),
            "detections": self.detections,
            "stale_exchanges": self.stale_exchanges,
            "exchanges_total": self.exchanges_total,
            "max_staleness_seen": self.max_staleness_seen,
            "delivered_fraction": self.delivered_fraction,
            "resyncs": self.resyncs,
            "suspect": self.suspect,
            "sources": self.kind,
            "staleness": [int(v) for v in np.asarray(self.carry[1])],
        }


class _Quiet:
    """:meth:`MeshHealthMonitor.quiet`'s context."""

    def __init__(self, mon: MeshHealthMonitor):
        self.mon = mon

    def __enter__(self):
        self.mon._quiet += 1
        return self.mon

    def __exit__(self, *exc):
        self.mon._quiet -= 1
        return False
