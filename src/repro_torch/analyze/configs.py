"""The audit list: every engine x precision x variant, one chunk each;
port of ``repro.analyze.configs``.

Coverage follows ``ENGINE_PRECISIONS``, with the reference's variants:
``sync`` (4, "phase", None), ``degrade`` and ``degrade+codes`` on both
mesh engines, and ``philox``, ``cmft`` and ``nobitpack`` on the
distributed DSIM's f32.  Each configuration is built on small fixed
problems, one warm chunk is run, and the next is recorded
(``ops_trace``) beside its declared contracts:

* the collective calls per chunk its ``sync_every`` predicts (IR-C);
* the wire payload: ``boundary_payload()`` of the distributed DSIM, the
  brick's face planes of the lattice (IR-B);
* the host syncs per chunk it declares (IR-D): none, except the degraded
  engines' one read of the health carry, through which the host-side
  monitor enforces the policy;
* the flip counter's publication and, on the degraded engines, the
  exchange ``seq`` started 3 below 2^32 so that the chunk wraps it (IR-E).

The mesh engines run twice: with every brick or partition in one process
(on the audit's device, no collectives), and one per rank of a gloo group
of ``_K`` CPU ranks started as ``python -m repro_torch.analyze.configs``
processes that meet in a rendezvous file (as ``tests/test_torch_dist.py``
starts them); each rank records its chunks and writes them as JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

from .ir_rules import ChunkAudit
from .ops_trace import CommRecord, OpRecord

__all__ = ["build_audits", "trace_failures", "audit_specs"]

# partitions / bricks of the mesh engines (and gloo ranks)
_K = 2
# sweeps per audited chunk: per-iteration, per-sweep and per-colour
# exchange schedules give distinct counts
_SWEEPS = 16
_LATTICE_SYNC = 4
# the degraded runs' exchange seq before the audited chunk: it wraps
_SEQ0 = (1 << 32) - 3
_POLICY = "stale_hold:8"


def audit_specs() -> Iterator[tuple]:
    """(engine, precision, variant, build kwargs, run kwargs)."""
    from repro_torch.engines.base import ENGINE_PRECISIONS

    for engine, precisions in ENGINE_PRECISIONS.items():
        for prec in precisions:
            R = 32 if prec == "bitplane" else 1
            base = {"precision": prec, "replicas": R}
            if engine == "gibbs":
                yield engine, prec, "plain", dict(base, rng="lfsr"), {}
            elif engine in ("dsim", "dsim_dist"):
                for sync in (4, "phase", None):
                    yield (engine, prec, f"sync={sync}",
                           dict(base, rng="lfsr"), {"sync": sync})
                if engine == "dsim":
                    continue
                yield (engine, prec, "degrade", dict(base, rng="lfsr"),
                       {"sync": 4, "degrade": True})
                yield (engine, prec, "degrade+codes", dict(base, rng="lfsr"),
                       {"sync": 4, "degrade": True, "has_codes": True})
                if prec == "f32":
                    yield (engine, prec, "philox/phase",
                           dict(base, rng="philox"), {"sync": "phase"})
                    yield (engine, prec, "cmft",
                           dict(base, rng="lfsr", mode="cmft"), {"sync": 4})
                    yield (engine, prec, "nobitpack/sync=None",
                           dict(base, rng="lfsr", bitpack=False),
                           {"sync": None})
            else:  # lattice
                yield engine, prec, "plain", dict(base), {}
                yield engine, prec, "degrade", dict(base), {"degrade": True}
                yield (engine, prec, "degrade+codes", dict(base),
                       {"degrade": True, "has_codes": True})


def _problems(device):
    from repro_torch.core.coloring import greedy_coloring
    from repro_torch.core.dsim import build_partitioned
    from repro_torch.core.graph import random_regular
    from repro_torch.core.partition import greedy_partition

    g = random_regular(24, 3, seed=0, device=device)
    col = greedy_coloring(g.idx, g.w)
    labels = greedy_partition(g.idx, g.w, _K, seed=0)
    return g, col, build_partitioned(g, col, labels, _K)


def _handle(engine, mk_kw, run_kw, problems, device, group):
    from repro_torch import make_engine
    from repro_torch.core.mesh import make_mesh
    g, col, prob = problems
    degrade = _POLICY if run_kw.get("degrade") else None
    if engine == "gibbs":
        return make_engine("gibbs", g, coloring=col, device=device, **mk_kw)
    if engine == "dsim":
        return make_engine("dsim", prob, device=device, **mk_kw)
    if engine == "dsim_dist":
        return make_engine("dsim_dist", prob, device=device, degrade=degrade,
                           mesh=make_mesh((_K,), ("data",), group=group),
                           **mk_kw)
    return make_engine("lattice", L=8, seed=5, device=device,
                       degrade=degrade, dim_axes=("x", None, None),
                       mesh=make_mesh((_K,), ("x",), group=group), **mk_kw)


def _payload(h, engine, group) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(allowed payload dtypes, allowed bytes per call) of a rank case."""
    if group is None or engine not in ("dsim_dist", "lattice"):
        return (), ()
    eng = h.eng
    if engine == "dsim_dist":
        p = eng.boundary_payload()
        dt = {"uint32": "int32", "float32": "float32",
              "uint8-bitmap": "uint8", "int8": "int8"}[p["dtype"]]
        return (dt,), (int(p["bytes"]),)
    from repro_torch.core.packing import pad_to_multiple
    bx, by, bz = eng.brick
    face = by * bz                      # the wired x faces
    if eng.precision == "bitplane":
        return ("int32",), (4 * eng.words * face,)
    if eng.bitpack_halos:
        return ("uint8",), (pad_to_multiple(eng.replicas * face, 8) // 8,)
    return ("int8",), (eng.replicas * face,)


def _predict(h, engine, run_kw, iters, group) -> dict:
    """Collective calls per chunk: none in one process; over a group the
    sync_every schedule's exchanges and the chunk's reductions."""
    if group is None or engine not in ("dsim_dist", "lattice"):
        return {}
    degrade = bool(run_kw.get("degrade"))
    if engine == "dsim_dist":
        sync = run_kw.get("sync")
        if sync == "phase":
            gathers = _SWEEPS * len(h.eng._colors)
        else:
            gathers = 0 if sync is None else iters
        out = {"all_reduce": 1}       # the chunk's flips, summed once
        if gathers:
            # a header gather beside every payload gather when checked
            out["all_gather"] = gathers * (2 if degrade else 1)
        return out
    # one exchange per iteration: x is open, so a rank sends its face to
    # and receives a halo from each neighbour along it (a header beside
    # each when checked)
    import torch.distributed as dist
    c = h.eng.mesh.coords(dist.get_rank(group))["x"]
    per = ((c > 0) + (c < _K - 1)) * (2 if degrade else 1)
    out = {"batch_isend_irecv": iters, "isend": iters * per,
           "irecv": iters * per, "all_reduce": 1}
    if degrade:
        out["all_reduce"] += 1        # the health carry's MAX over ranks
    return out


def record_chunk(h, engine, run_kw, group=None) -> dict:
    """Run one warm chunk, then record the next (the handle's
    ``trace_chunk``): the chunk's ops, syncs, collectives and counters (a
    JSON-ready dict)."""
    from repro_torch.core.annealing import ea_schedule
    eng = h.eng
    sync = run_kw.get("sync", _LATTICE_SYNC if engine == "lattice" else 1)
    S = sync if isinstance(sync, int) else 1
    iters = _SWEEPS // S
    st = h.init_state(seed=0)
    if run_kw.get("has_codes"):
        eng.set_exchange_faults([0, 1, 0, 2])
    degrade = getattr(eng, "health", None) is not None

    def wrap_seq(_):
        if degrade:
            eng.health.carry = (np.int64(_SEQ0),) + \
                tuple(eng.health.carry[1:])
    kw = {} if engine == "lattice" else {"sync": sync}
    tr = h.trace_chunk(iters, S, state=st, schedule=ea_schedule(_SWEEPS),
                       before=wrap_seq, **kw)
    st = tr.out
    counters = {"flips": (str(st.flips.dtype).replace("torch.", ""),
                          any(p is st.flips for p in tr.published))}
    if degrade:
        counters["seq"] = (int(eng.health.carry[0]),
                           (_SEQ0 + iters) % (1 << 32))
    dts, sizes = _payload(h, engine, group)
    return dict(
        ops=[(o.name, list(o.dtypes)) for o in tr.ops],
        syncs=list(tr.syncs),
        comms=[(c.op, c.dtype, list(c.shape), c.nbytes) for c in tr.comms],
        predicted=_predict(h, engine, run_kw, iters, group),
        declared_syncs=1 if degrade else 0,
        payload_dtypes=list(dts), payload_bytes=list(sizes),
        counters={k: list(v) for k, v in counters.items()})


def _audit(engine, prec, variant, rec: dict) -> ChunkAudit:
    return ChunkAudit(
        engine=engine, precision=prec, variant=variant,
        ops=[OpRecord(n, tuple(d)) for n, d in rec["ops"]],
        syncs=list(rec["syncs"]),
        comms=[CommRecord(op, dt, tuple(sh), nb)
               for op, dt, sh, nb in rec["comms"]],
        predicted=dict(rec["predicted"]),
        declared_syncs=int(rec["declared_syncs"]),
        payload_dtypes=tuple(rec["payload_dtypes"]),
        payload_bytes=tuple(rec["payload_bytes"]),
        counters={k: tuple(v) for k, v in rec["counters"].items()})


def _run_specs(device, group, mesh_only: bool):
    """[(engine, precision, variant, record or error string)]."""
    problems = _problems(device)
    out = []
    for engine, prec, variant, mk_kw, run_kw in audit_specs():
        if mesh_only and engine not in ("dsim_dist", "lattice"):
            continue
        try:
            h = _handle(engine, mk_kw, run_kw, problems, device, group)
            rec = record_chunk(h, engine, run_kw, group)
        except Exception as e:  # noqa: BLE001 — reported, not swallowed
            rec = f"{type(e).__name__}: {e}"
        out.append((engine, prec, variant, rec))
    return out


def _rank_main(rank: int, world: int, rdv: str, out: str) -> int:
    """One gloo rank: record every mesh-engine configuration over the
    group and write them to ``out`` as JSON."""
    import gc

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        recs = _run_specs("cpu", dist.group.WORLD, mesh_only=True)
        with open(out, "w") as f:
            json.dump(recs, f)
    finally:
        gc.collect()
        dist.barrier()
        dist.destroy_process_group()
    return 0


def _rank_records(timeout: float = 300.0):
    """Start the _K gloo ranks together and read their records."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH",
                                                           ""))
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(_K)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.analyze.configs", str(r),
             str(_K), os.path.join(tmp, "rendezvous"), outs[r]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(_K)]
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        recs = []
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                return None, f"gloo rank {r} exited {p.returncode}: " \
                    f"{log[-1500:]}"
            with open(outs[r]) as f:
                recs.append(json.load(f))
    return recs, None


def build_audits(device=None, ranks: bool = True
                 ) -> Tuple[List[ChunkAudit], List[Tuple[str, str]]]:
    """Record every configuration on ``device`` (``None``: the CUDA
    device, as ``resolve_device``); returns (audits, failures).  The mesh
    engines' one-process cases carry the variant suffix ``/one-process``;
    with ``ranks`` their gloo rank cases follow (rank r > 0 as
    ``@rank<r>``).  A configuration that fails to build or run is itself
    a finding (IR-TRACE)."""
    from repro_torch.core.device import resolve_device
    audits: List[ChunkAudit] = []
    failures: List[Tuple[str, str]] = []

    def take(engine, prec, variant, rec):
        if isinstance(rec, str):
            failures.append((f"ir:{engine}/{prec}/{variant}", rec))
        else:
            audits.append(_audit(engine, prec, variant, rec))

    for engine, prec, variant, rec in _run_specs(resolve_device(device),
                                                 None, mesh_only=False):
        if engine in ("dsim_dist", "lattice"):
            variant += "/one-process"
        take(engine, prec, variant, rec)
    if ranks:
        recs, err = _rank_records()
        if err is not None:
            failures.append(("ir:ranks", err))
        else:
            for r, per_rank in enumerate(recs):
                for engine, prec, variant, rec in per_rank:
                    take(engine, prec,
                         variant + (f"@rank{r}" if r else ""), rec)
    return audits, failures


def trace_failures(failures) -> list:
    from .findings import Finding
    return [Finding(
        "IR-TRACE", loc,
        f"configuration failed to build or run: {msg}",
        "every registered configuration must run one recorded chunk: fix "
        "the engine or the audit list") for loc, msg in failures]


if __name__ == "__main__":
    sys.exit(_rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                        sys.argv[4]))
