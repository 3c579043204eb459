"""Contract rules over one recorded chunk; port of
``repro.analyze.ir_rules``.

Each rule takes a :class:`ChunkAudit` (one engine x precision x variant
configuration, one chunk run under ``ops_trace``'s recorders) and returns
findings:

  IR-A  no float arithmetic in int8 and bit-plane chunk bodies
  IR-B  the wire: payload collectives carry only the declared dtypes and
        bytes; a bit-plane chunk ships uint32 words or their int32 views
        only; headers are [seq, checksum] uint32 pairs (or their int32
        view, which the gloo backend carries)
  IR-C  collective calls per chunk == the ``sync_every`` prediction
  IR-D  host syncs per chunk == the declared count: no hidden ``.item()``
        or ``.cpu()`` in a chunk
  IR-E  the flip counter is published through ``flips_publish``
        (uint32-modular, int32 the storage view), and the exchange
        ``seq`` counts mod 2^32

IR-F, the reference's fused working set against a 16 MiB VMEM model, is
not ported: VMEM is a TPU fact, and the port's kernels have no such
budget.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

from .findings import Finding
from .ops_trace import FLOAT_ARITH_OPS, CommRecord, OpRecord, is_float

__all__ = ["ChunkAudit", "audit_chunk", "IR_RULES", "PAYLOAD_OPS"]

# collectives that move boundary values (and headers); the rest reduce
PAYLOAD_OPS = ("all_gather", "isend", "irecv")
_WORD_DTYPES = ("uint32", "int32")


@dataclasses.dataclass
class ChunkAudit:
    """One recorded chunk plus its declared contracts."""

    engine: str
    precision: str
    variant: str                          # "sync=4" | "degrade" | ...
    ops: List[OpRecord]                   # the chunk's aten ops
    syncs: List[str]                      # its host reads
    comms: List[CommRecord]               # its torch.distributed calls
    predicted: Dict[str, int]             # collective op -> calls
    declared_syncs: int = 0
    payload_dtypes: Tuple[str, ...] = ()  # allowed payload dtypes
    payload_bytes: Tuple[int, ...] = ()   # allowed payload bytes per call
    # "flips": (dtype, published by flips_publish); "seq": (got, want)
    counters: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    @property
    def loc(self) -> str:
        return f"ir:{self.engine}/{self.precision}/{self.variant}"

    @property
    def integer_body(self) -> bool:
        return self.precision in ("int8", "bitplane")


def _is_header(c: CommRecord) -> bool:
    return c.shape == (2,) and c.op in PAYLOAD_OPS


def rule_a_no_float_in_integer_body(audit: ChunkAudit) -> List[Finding]:
    if not audit.integer_body:
        return []
    for op in audit.ops:
        if op.name in FLOAT_ARITH_OPS and any(is_float(d)
                                             for d in op.dtypes):
            return [Finding(
                "IR-A", audit.loc,
                f"float arithmetic `{op.name}` ({', '.join(op.dtypes)}) "
                f"inside the {audit.precision} chunk body",
                "keep the integer inner loop float-free: move the work to "
                "LUT build time or to the record point")]
    return []


def rule_b_wire_format(audit: ChunkAudit) -> List[Finding]:
    out: List[Finding] = []
    for c in audit.comms:
        if c.op not in PAYLOAD_OPS:
            continue
        if _is_header(c):
            if c.dtype not in _WORD_DTYPES:
                out.append(Finding(
                    "IR-B", audit.loc,
                    f"integrity header via `{c.op}` is {c.dtype}{c.shape}, "
                    f"not uint32",
                    "headers are [seq, checksum] uint32 pairs (the int32 "
                    "view on the wire)"))
            continue
        if audit.precision == "bitplane" and c.dtype not in _WORD_DTYPES:
            out.append(Finding(
                "IR-B", audit.loc,
                f"{c.dtype}{c.shape} on the wire in a bit-plane chunk via "
                f"`{c.op}`",
                "bit-plane chunks ship uint32 word planes (their int32 "
                "views) only"))
            continue
        if audit.payload_dtypes and c.dtype not in audit.payload_dtypes:
            out.append(Finding(
                "IR-B", audit.loc,
                f"`{c.op}` puts {c.dtype}{c.shape} on the wire; this "
                f"configuration declares {'/'.join(audit.payload_dtypes)}",
                "publish the declared wire format and convert after the "
                "collective (see boundary_payload())"))
            continue
        if audit.payload_bytes and c.nbytes not in audit.payload_bytes:
            out.append(Finding(
                "IR-B", audit.loc,
                f"`{c.op}` ships {c.nbytes} B but the declared boundary "
                f"payload is {sorted(set(audit.payload_bytes))} B",
                "the collective operand must be exactly the declared "
                "boundary slice: no widened or duplicated tensors"))
    return out


def _counts(comms: List[CommRecord]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for c in comms:
        out[c.op] = out.get(c.op, 0) + 1
    return out


def rule_c_collective_count(audit: ChunkAudit) -> List[Finding]:
    got = _counts(audit.comms)
    if got == audit.predicted:
        return []
    return [Finding(
        "IR-C", audit.loc,
        f"collective calls per chunk {got} != sync_every prediction "
        f"{audit.predicted}",
        "an exchange was added or removed without updating the staleness "
        "schedule (or the prediction in analyze/configs.py)")]


def rule_d_host_syncs(audit: ChunkAudit) -> List[Finding]:
    if len(audit.syncs) == audit.declared_syncs:
        return []
    seen = sorted(set(audit.syncs))
    return [Finding(
        "IR-D", audit.loc,
        f"{len(audit.syncs)} host sync(s) {seen} in the chunk, "
        f"{audit.declared_syncs} declared",
        "keep chunks on the device: no .item(), .cpu(), .tolist() or "
        "0-d index tensors; host work goes to the recording driver")]


def rule_e_modular_counters(audit: ChunkAudit) -> List[Finding]:
    out: List[Finding] = []
    flips = audit.counters.get("flips")
    if flips is not None:
        dtype, published = flips
        if dtype != "int32" or not published:
            how = "published by flips_publish" if published else \
                "not published by flips_publish"
            out.append(Finding(
                "IR-E", audit.loc,
                f"flip counter is {dtype}, {how}: not the uint32-modular "
                f"accumulate and publish pattern",
                "accumulate flip deltas mod 2^32 and publish through "
                "core.pbit.flips_publish (int32 is only the storage "
                "view)"))
    seq = audit.counters.get("seq")
    if seq is not None:
        got, want = seq
        if got != want or not 0 <= got < 1 << 32:
            out.append(Finding(
                "IR-E", audit.loc,
                f"exchange counter `seq` reads {got} after the chunk, "
                f"{want} expected (uint32-modular)",
                "sequence counters advance mod 2^32"))
    return out


IR_RULES: Tuple[Callable[[ChunkAudit], List[Finding]], ...] = (
    rule_a_no_float_in_integer_body,
    rule_b_wire_format,
    rule_c_collective_count,
    rule_d_host_syncs,
    rule_e_modular_counters,
)


def audit_chunk(audit: ChunkAudit) -> List[Finding]:
    out: List[Finding] = []
    for rule in IR_RULES:
        out.extend(rule(audit))
    return out
