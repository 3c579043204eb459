"""The roofline of one recorded chunk on an NVIDIA H100; port of
``repro.launch.roofline``.

The reference parses the HLO text of a compiled chunk against TPU
constants.  Eager PyTorch has no program to parse, so the port costs what
one chunk did, as ``analyze/ops_trace.trace_call`` recorded it
(:class:`ChunkTrace`):

  compute term    = the largest of bf16 matrix FLOPs / ``peak_flops``,
                    INT32 operations / ``int32_peak`` and FP32 operations
                    / ``fp32_peak``
  memory term     = bytes / ``hbm_bw``
  collective term = wire bytes per rank / ``link_bw``

Bytes and operations of the hand kernels come from their work model
(``kernels/work.py``), per launch and shape; a launch with no model
raises.  The glue's aten ops count their operand and result bytes, the
reference's HloCostAnalysis convention (views and fresh allocations move
none), and matrix products their FLOPs.  Wire bytes use the reference's
ring accounting per rank over the recorded ``torch.distributed`` calls:

  all_gather          result bytes * (K-1)/K   (K the group's size)
  all_reduce          2 * bytes * (K-1)/K      (reduce-scatter + gather)
  isend / irecv       the received bytes once (``collective-permute``)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.kernels.work import Work

__all__ = ["HW", "collective_bytes", "roofline", "RooflineReport",
           "parse_collectives", "work_bound"]


@dataclasses.dataclass(frozen=True)
class HW:
    """Published figures of one H100 SXM (dense, 700 W).  The operation
    peaks count 64 INT32 and 128 FP32 lane operations per SM per clock
    (no FMA: the kernels build with ``--fmad=false``) at ``sms`` and the
    maximum SM clock ``sm_clock_hz``; a caller on the card passes the
    clock and SM count it reads.  ``link_bw`` (NVLink, each way) is
    assumed for every neighbour: a layout of 256 or 512 cards spans hosts,
    whose network is no fact of the card."""
    peak_flops: float = 989e12       # bf16 matrix products
    hbm_bw: float = 3.35e12          # B/s
    link_bw: float = 450e9           # B/s each way, assumed
    hbm_bytes: float = 80e9
    sms: int = 132
    sm_clock_hz: float = 1.98e9
    int32_per_sm_clock: int = 64
    fp32_per_sm_clock: int = 128

    @property
    def int32_peak(self) -> float:
        return self.sms * self.int32_per_sm_clock * self.sm_clock_hz

    @property
    def fp32_peak(self) -> float:
        return self.sms * self.fp32_per_sm_clock * self.sm_clock_hz


LINK_NOTE = ("link_bw assumed: NVLink's 450 GB/s each way for every "
             "neighbour; a 256- or 512-card layout spans hosts")


def work_bound(work: Work, hw: HW = HW()) -> Tuple[str, float, dict]:
    """(what bounds it, seconds, {bytes, int32, fp32: seconds}): the
    largest of ``work``'s bytes over the HBM bandwidth and its INT32 and
    FP32 operations over their own peaks."""
    times = {"bytes": work.bytes / hw.hbm_bw,
             "int32": work.int32 / hw.int32_peak,
             "fp32": work.fp32 / hw.fp32_peak}
    by = max(times, key=times.get)
    return by, times[by], times


# aten ops that move no bytes: views, and allocations never written
_VIEW_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "as_strided", "select",
    "slice", "unsqueeze", "squeeze", "t", "transpose", "permute", "unbind",
    "split", "split_with_sizes", "chunk", "detach", "alias", "lift_fresh",
    "unfold", "diagonal", "view_as_real", "view_as_complex", "narrow",
    "empty", "empty_like", "empty_strided", "new_empty", "set",
})

# the reference's collective kinds of the port's calls
_KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
          "irecv": "collective-permute"}


def parse_collectives(calls) -> List[dict]:
    """Per-collective records of ``ops_trace.CommRecord`` s in the
    reference's form ({kind, bytes, group, mult}), bytes those of the
    result: an ``all_gather`` records the tensor each rank gives, so its
    result is that times the group.  A point-to-point message counts once,
    where it is received; ``batch_isend_irecv`` (the batch itself) and
    ``isend`` carry no bytes of their own."""
    out = []
    for c in calls:
        kind = _KINDS.get(c.op)
        if kind is not None:
            k = int(c.group)
            byts = int(c.nbytes) * (k if c.op == "all_gather" else 1)
            out.append({"kind": kind, "bytes": byts, "group": k, "mult": 1})
    return out


def collective_bytes(calls) -> Tuple[float, dict]:
    """Wire bytes per rank (ring accounting) + per-kind breakdown, keyed
    as the reference's."""
    per_kind: Dict[str, float] = {}
    total = 0.0
    for rec in parse_collectives(calls):
        k = max(rec["group"], 1)
        ring = (k - 1) / k if k > 1 else 0.0
        if rec["kind"] == "all-reduce":
            b = 2.0 * rec["bytes"] * ring
        elif rec["kind"] == "collective-permute":
            b = float(rec["bytes"])
        else:
            b = rec["bytes"] * ring
        b *= rec["mult"]
        per_kind[rec["kind"]] = per_kind.get(rec["kind"], 0.0) + b
        total += b
    return total, per_kind


@dataclasses.dataclass
class RooflineReport:
    flops: float               # bf16 matrix-product FLOPs of the glue
    bytes_accessed: float
    wire_bytes: float
    per_kind: dict
    chips: int
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: Optional[float] = None
    int32_ops: float = 0.0     # of the hand kernels
    fp32_ops: float = 0.0
    kernel_bytes: float = 0.0  # the hand kernels' share of bytes_accessed
    note: str = LINK_NOTE

    @property
    def useful_ratio(self) -> Optional[float]:
        if self.model_flops is None or self.flops == 0:
            return None
        return self.model_flops / self.flops

    @property
    def bound_s(self) -> float:
        """The least time the card could take: the largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self),
                "useful_ratio": self.useful_ratio}


def roofline(trace, chips: int, hw: HW = HW(),
             model_flops: Optional[float] = None) -> RooflineReport:
    """The roofline of one rank's recorded chunk (an
    ``ops_trace.ChunkTrace``) on a mesh of ``chips``."""
    kernels = Work(0)
    for rec in trace.launches:
        kernels = kernels + Work(rec.bytes, rec.int32, rec.fp32)
    glue = sum(o.nbytes for o in trace.ops if o.name not in _VIEW_OPS)
    flops = float(sum(o.flops for o in trace.ops))
    byts = float(glue + kernels.bytes)
    wire, per_kind = collective_bytes(trace.comms)
    t_c = max(flops / hw.peak_flops, kernels.int32 / hw.int32_peak,
              kernels.fp32 / hw.fp32_peak)
    t_m = byts / hw.hbm_bw
    t_x = wire / hw.link_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    return RooflineReport(
        flops=flops, bytes_accessed=byts, wire_bytes=wire, per_kind=per_kind,
        chips=chips, t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=max(terms, key=terms.get), model_flops=model_flops,
        int32_ops=float(kernels.int32), fp32_ops=float(kernels.fp32),
        kernel_bytes=float(kernels.bytes))
