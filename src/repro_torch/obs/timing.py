"""Measured η = f_comm / f_pbit — the paper's timing ratio, live.

Port of ``repro.obs.timing``'s ``EtaMeter``, ``exchanges_per_sweep`` and
``dist_eta_meter``.

``core/commcost.py`` *predicts* the clocking bound (Eq. 2: the machine
behaves as an unpartitioned one when f_comm/f_pbit >= 2 * N_color *
C_max).  The :class:`EtaMeter` *measures* the same ratio on a running
engine from two ingredients:

* **per-chunk wall time** from the recorded-cursor chunk hook
  (``cursor.chunk_timer`` — the same per-chunk boundary where
  ``faults.py`` injects): each recorded chunk contributes ``sweeps``
  p-bit sweeps *plus* its share of boundary exchanges (``sweeps / S``
  for iteration-synced runs, ``sweeps * n_color`` for per-phase sync);
* **exchange-only time** from the mesh engine's
  ``boundary_exchange_fn()`` — the halo exchange alone (one gather over
  the bricks of a one-process mesh, the point-to-point messages of a
  process group) with the p-bit update elided, timed on live state via
  :meth:`EtaMeter.measure_exchange`.

From those: ``t_ex`` (s/exchange) gives ``f_comm = 1/t_ex``; the pure
update time ``t_pbit = (chunk_time - exchanges * t_ex) / sweeps`` gives
``f_pbit = 1/t_pbit`` (per-p-bit attempt frequency — every site
attempts once per sweep); measured η is their ratio, and the margin is
η divided by ``commcost.eta_threshold(n_color, c_max)`` for the active
partition — margin >= 1 means the realized exchange cadence clears the
paper's bound.  The reference's degraded-mode accounting
(``note_stale``, ``effective_eta``) comes with the degraded mesh
(ROADMAP.md queue A item 9).

The clock is injectable for tests; all accumulation is lock-guarded so
a dashboard thread can read :meth:`report` while the pump records.  On a
one-process mesh the exchange is a copy on the device, not a link between
devices, so its f_comm is that copy's rate.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Union

import torch

from ..core import commcost

__all__ = ["EtaMeter", "exchanges_per_sweep", "dist_eta_meter"]

SyncSpec = Union[int, str, None]


def exchanges_per_sweep(sync_every: SyncSpec, n_color: int) -> float:
    """Boundary exchanges per sweep implied by the sync policy:
    one per S-sweep iteration block, or one per color phase."""
    if sync_every == "phase":
        return float(n_color)
    if sync_every is None:
        return 1.0
    S = int(sync_every)
    if S < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every!r}")
    return 1.0 / S


def _wait(out) -> None:
    """Wait for the CUDA devices that hold tensors of ``out`` (a tensor or
    a tuple of them); tensors on the CPU are ready when returned."""
    ts = out if isinstance(out, (tuple, list)) else (out,)
    for dev in {t.device for t in ts if isinstance(t, torch.Tensor)
                and t.is_cuda}:
        torch.cuda.synchronize(dev)


class EtaMeter:
    """Accumulates p-bit-update vs boundary-exchange time per chunk."""

    def __init__(self, *, n_color: int, c_max: Optional[float] = None,
                 sync_every: SyncSpec = 1,
                 clock: Callable[[], float] = time.perf_counter):
        if n_color < 1:
            raise ValueError("n_color must be >= 1")
        self.n_color = int(n_color)
        self.c_max = None if c_max is None else float(c_max)
        self.sync_every = sync_every
        self.clock = clock
        self._x_per_sweep = exchanges_per_sweep(sync_every, n_color)
        self._lock = threading.Lock()
        self._chunk_s = 0.0
        self._sweeps = 0
        self._exchanges = 0.0
        self._chunks = 0
        self._ex_s = 0.0
        self._ex_n = 0

    # -- recording ------------------------------------------------------------------

    def record_chunk(self, sweeps: int, seconds: float,
                     exchanges: Optional[float] = None) -> None:
        """One recorded chunk: `sweeps` p-bit sweeps took `seconds` wall
        time *including* its boundary exchanges (derived from the sync
        policy unless given explicitly)."""
        if exchanges is None:
            exchanges = sweeps * self._x_per_sweep
        with self._lock:
            self._chunk_s += float(seconds)
            self._sweeps += int(sweeps)
            self._exchanges += float(exchanges)
            self._chunks += 1

    def on_chunk(self, sweeps: int, seconds: float) -> None:
        """Cursor ``chunk_timer`` signature; see RecordedCursor.advance."""
        self.record_chunk(sweeps, seconds)

    def attach(self, cursor) -> "EtaMeter":
        """Install this meter as the cursor's chunk timer (same hook
        surface the fault plan uses; enables the blocking timestamps)."""
        cursor.chunk_timer = self.on_chunk
        return self

    def record_exchange(self, seconds: float, count: int = 1) -> None:
        """Exchange-only timing: `count` boundary exchanges took
        `seconds` total (from ``measure_exchange`` or an external probe)."""
        with self._lock:
            self._ex_s += float(seconds)
            self._ex_n += int(count)

    def measure_exchange(self, fn: Callable[[], object], *,
                         reps: int = 32, warmup: int = 4) -> float:
        """Time an exchange-only closure (an engine's
        ``boundary_exchange_fn()`` output bound to live state), waiting for
        the device (``torch.cuda.synchronize``) so its time is fully
        attributed; records the measurement and returns mean seconds per
        exchange."""
        for _ in range(max(warmup, 1)):
            _wait(fn())
        t0 = self.clock()
        for _ in range(reps):
            out = fn()
        _wait(out)
        dt = self.clock() - t0
        self.record_exchange(dt, reps)
        return dt / reps

    # -- derived quantities ----------------------------------------------------------

    @property
    def t_exchange_s(self) -> float:
        """Mean seconds per boundary exchange (NaN until measured)."""
        with self._lock:
            return self._ex_s / self._ex_n if self._ex_n else float("nan")

    @property
    def t_pbit_sweep_s(self) -> float:
        """Pure p-bit update seconds per sweep: chunk time minus the
        exchange share, floored at a tenth of the raw per-sweep time so
        a mismeasured t_ex can never produce a negative rate."""
        with self._lock:
            if self._sweeps == 0:
                return float("nan")
            chunk_s, sweeps, exchanges = \
                self._chunk_s, self._sweeps, self._exchanges
            ex_s = self._ex_s / self._ex_n if self._ex_n else 0.0
        raw = chunk_s / sweeps
        t = (chunk_s - exchanges * ex_s) / sweeps
        return max(t, 0.1 * raw)

    @property
    def f_comm_hz(self) -> float:
        t = self.t_exchange_s
        return 1.0 / t if t > 0 else float("nan")

    @property
    def f_pbit_hz(self) -> float:
        t = self.t_pbit_sweep_s
        return 1.0 / t if t > 0 else float("nan")

    @property
    def eta(self) -> float:
        """Measured η = f_comm / f_pbit = t_pbit_sweep / t_exchange."""
        return self.t_pbit_sweep_s / self.t_exchange_s

    @property
    def eta_threshold(self) -> float:
        if self.c_max is None:
            return float("nan")
        return commcost.eta_threshold(self.n_color, self.c_max)

    def report(self) -> dict:
        """JSON-able summary; NaNs where a side hasn't been measured."""
        with self._lock:
            chunks, sweeps = self._chunks, self._sweeps
            chunk_s, exchanges = self._chunk_s, self._exchanges
            ex_n = self._ex_n
        eta = self.eta
        thr = self.eta_threshold
        margin = eta / thr if thr and thr == thr else float("nan")
        return {
            "measured_eta": eta,
            "eta_threshold": thr,
            "margin": margin,
            "behaves_unpartitioned": bool(margin >= 1.0)
            if margin == margin else None,
            "f_comm_hz": self.f_comm_hz,
            "f_pbit_hz": self.f_pbit_hz,
            "t_exchange_s": self.t_exchange_s,
            "t_pbit_sweep_s": self.t_pbit_sweep_s,
            "n_color": self.n_color,
            "c_max": self.c_max,
            "sync_every": self.sync_every,
            "chunks_recorded": chunks,
            "sweeps_recorded": sweeps,
            "chunk_seconds": chunk_s,
            "exchanges_attributed": exchanges,
            "exchanges_timed": ex_n,
        }


def dist_eta_meter(engine, *, sync_every: SyncSpec = 1, topo=None,
                   clock: Callable[[], float] = time.perf_counter
                   ) -> EtaMeter:
    """EtaMeter pre-loaded with the commcost threshold of a partitioned
    mesh engine (``DistDSIMEngine``): n_color from the colouring, C_max
    from the engine's own boundary matrix on ``topo`` (default: a
    unit-pin ring over its K partitions, the conservative all-links-equal
    reading of Eq. S.3)."""
    p = engine.p
    b = commcost.boundary_matrix(p.graph.idx, p.graph.w, p.labels, p.K)
    if topo is None:
        topo = commcost.RingTopology(k=max(p.K, 2), pins_per_link=1)
    c_max = commcost.comm_cost(b, topo).c_max
    return EtaMeter(n_color=len(p.color_slots), c_max=c_max,
                    sync_every=sync_every, clock=clock)
