"""The port's spans on the profiler's clock (``repro_torch.obs.trace.region``),
on the CPU.

A small bit-plane lattice job (L=8, 64 lanes in two word planes, an
exchange every 8 sweeps, three record points over three chunks) runs
through ``make_engine(...).run_recorded`` under ``torch.profiler`` and
leaves its spans: each count follows from the cursor's own plan, the spans
nest entry > driver > engine and wrapper, and a run with no profiler is
bitwise the profiled run.  The cursor's lazy flip reads at the benchmark
cell's size (10^6 sites, 64 lanes, 8192 sweeps) are counted on a stand-in
chunk, the driver's waits on a stand-in state on the card, and the other
precisions and engines leave their entry, driver and sync spans.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import make_engine
from repro_torch.core.annealing import constant_schedule, ea_schedule
from repro_torch.core.coloring import lattice3d_coloring
from repro_torch.core.dsim import build_partitioned
from repro_torch.core.graph import ea3d
from repro_torch.engines.base import RecordedCursor
from repro_torch.kernels import _build
from repro_torch.engines import base as B
from repro_torch.obs import Tracer
from repro_torch.obs import trace as T

PREFIX = "repro_torch."
L, R, S = 8, 64, 8
POINTS = [16, 48, 64]          # sweeps: chunks of 2, 4 and 2 iterations


def spans(prof) -> list:
    """(name, start, end) of the program's ranges in a finished profile."""
    return sorted(((e.name, float(e.time_range.start),
                    float(e.time_range.end)) for e in prof.events()
                   if e.name.startswith(PREFIX)), key=lambda x: x[1])


def named(sp, name) -> list:
    return [x for x in sp if x[0] == PREFIX + name]


def inside(inner, outers) -> bool:
    return any(a <= inner[1] and inner[2] <= b for _, a, b in outers)


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans(prof)


def planned_reads(plan, S, flips_per_sweep, records) -> int:
    """The flip counter reads the cursor's rule makes over ``plan``: one
    when it is built, one before a chunk whose worst case could carry the
    unread count to 2**31, one at each record point."""
    reads, pending = 1, 0
    for c in plan:
        worst = c * S * flips_per_sweep
        if pending + worst >= 1 << 31:
            reads, pending = reads + 1, 0
        pending += worst
    return reads + records


# -- the switch ---------------------------------------------------------------

def test_region_is_the_shared_null_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    a, b = T.region("repro_torch.a"), T.region("repro_torch.b")
    assert a is b is T._NULL
    with a:
        with b:
            pass


def test_region_is_a_profiler_range_while_one_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = T.region("repro_torch.x")
        assert isinstance(r, T._range) and r is not T._NULL
        with r:
            torch.zeros(2).add_(1)
    assert [s[0] for s in spans(prof)] == ["repro_torch.x"]


def test_tracer_span_stays_off_the_profiler():
    tr = Tracer(block=lambda v: None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("pump.chunk", job=1):
            with tr.span("pump.inner"):
                pass
    names = {e.name for e in prof.events()}
    assert not {"pump.chunk", "pump.inner"} & names
    # the ring and its nesting are as without a profiler
    by = {s["name"]: s for s in tr.spans()}
    assert by["pump.inner"]["parent_id"] == by["pump.chunk"]["span_id"]


# -- one lattice job ----------------------------------------------------------

@pytest.fixture(scope="module")
def job():
    """The engine, its plan, and a job run twice from one drawn state: with
    the profiler (its spans) and without."""
    h = make_engine("lattice", L=L, seed=3, replicas=R,
                    precision="bitplane", device="cpu")
    st0 = h.init_state(seed=11)
    sched = constant_schedule(3.0, POINTS[-1])
    cur = h.eng.run_recorded_full(st0, sched, POINTS, sync_every=S,
                                  cursor=True)

    def run():
        st = h.eng.shard_state(st0)
        return h.run_recorded(st, sched, POINTS, sync_every=S)

    (st_p, rec_p), sp = profiled(run)
    st_n, rec_n = run()
    return dict(h=h, plan=list(cur._plan), fps=cur._flips_per_sweep, sp=sp,
                profiled=(st_p, rec_p), plain=(st_n, rec_n))


def test_span_counts_follow_the_plan(job):
    sp, plan = job["sp"], job["plan"]
    iters, records = sum(plan), len(POINTS)
    assert plan == [2, 4, 2]
    want = {
        "entry.run_recorded": 1,
        "entry.shard_state": 1,
        "driver.chunk": len(plan),
        "driver.record": records,
        "engine.exchange": iters + records,
        "wrapper.pbit_bitplane_sweep": iters * len(job["h"].eng._bricks),
        "sync.schedule_upload": len(plan),
        "sync.flips_read": planned_reads(plan, S, job["fps"], records),
    }
    got = {n[len(PREFIX):]: 0 for n, _, _ in sp}
    for n, _, _ in sp:
        got[n[len(PREFIX):]] += 1
    assert got == want


def test_spans_nest_entry_driver_engine(job):
    sp = job["sp"]
    entry = named(sp, "entry.run_recorded")
    chunks, records = named(sp, "driver.chunk"), named(sp, "driver.record")
    assert all(inside(c, entry) for c in chunks + records)
    for x in named(sp, "wrapper.pbit_bitplane_sweep") + \
            named(sp, "sync.schedule_upload"):
        assert inside(x, chunks)
    # one exchange ends each iteration of a chunk, one opens each record
    ex = named(sp, "engine.exchange")
    assert sum(inside(x, chunks) for x in ex) == sum(job["plan"])
    assert sum(inside(x, records) for x in ex) == len(POINTS)
    assert all(inside(x, entry) for x in named(sp, "sync.flips_read"))
    # the hand-over comes before the run, not inside it
    assert not inside(named(sp, "entry.shard_state")[0], entry)


def test_no_profiler_run_is_bitwise_the_profiled_run(job):
    (st_p, rec_p), (st_n, rec_n) = job["profiled"], job["plain"]
    assert torch.equal(rec_p.energies, rec_n.energies)
    assert rec_p.flips == rec_n.flips
    assert list(rec_p.times) == list(rec_n.times) == POINTS
    for f in dataclasses.fields(st_p):
        a, b = getattr(st_p, f.name), getattr(st_n, f.name)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x.view(torch.int32) if x.dtype == torch.uint32
                               else x,
                               y.view(torch.int32) if y.dtype == torch.uint32
                               else y)


# -- the benchmark cell's plan ------------------------------------------------

@dataclasses.dataclass
class _State:
    m: torch.Tensor
    flips: torch.Tensor


@pytest.mark.parametrize("sweeps,chunks,reads", [
    (8192, 512, 257),      # the cell: 1024 iterations, two a chunk
    (64, 4, 3),
    (32, 2, 2),
])
def test_cell_plan_gives_its_flip_reads(sweeps, chunks, reads):
    """At 10^6 sites x 64 lanes and an exchange every 8 sweeps a chunk may
    hold two iterations (1.024e9 flips at worst), and the counter is read
    when the cursor is built, before every second chunk from the third on,
    and at the record point."""
    st = _State(m=torch.zeros(1), flips=torch.zeros(64, dtype=torch.int32))
    cur, sp = profiled(lambda: RecordedCursor(
        state=st, schedule=constant_schedule(3.0, sweeps),
        record_points=[sweeps], chunk_fn=lambda s, b, c, S: s,
        record_fn=lambda s: torch.zeros(64), sync_every=8,
        flips_of=lambda s: s.flips,
        flips_per_sweep=10 ** 6 * 64).run_to_completion())
    assert len(cur._plan) == chunks
    assert len(named(sp, "driver.chunk")) == chunks
    assert len(named(sp, "sync.flips_read")) == reads == planned_reads(
        cur._plan, 8, 10 ** 6 * 64, 1)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so that the driver
    waits for it (``torch.cuda.synchronize`` stood in)."""
    is_cuda = True


@pytest.mark.parametrize("on_card", [True, False])
def test_wait_span_brackets_the_warm_and_timed_chunks(monkeypatch, on_card):
    waits = []
    monkeypatch.setattr(torch.cuda, "synchronize", waits.append)
    m = torch.zeros(4)
    st = _State(m=m.as_subclass(_OnCard) if on_card else m,
                flips=torch.zeros(2, dtype=torch.int32))
    assert B._device_of(st) == m.device
    cur = RecordedCursor(
        state=st, schedule=ea_schedule(16), record_points=[16],
        chunk_fn=lambda s, b, c, S: s, record_fn=lambda s: torch.zeros(2),
        sync_every=4)
    cur.chunk_timer = lambda sweeps, s: None
    _, sp = profiled(lambda: (cur.warm(), cur.advance(1)))
    chunks = named(sp, "driver.chunk")
    assert len(chunks) == 1
    # warm: one per distinct chunk and one after the record read; timed:
    # one before and one after each chunk; a state on the host: none
    want = 2 + 2 * len(chunks) if on_card else 0
    assert len(named(sp, "sync.wait")) == len(waits) == want


def test_flips_read_span_is_a_tensor_read():
    _, sp = profiled(lambda: (B._flips_read(np.arange(3)),
                              B._flips_read(7),
                              B._flips_read(torch.arange(3))))
    assert [n for n, _, _ in sp] == [PREFIX + "sync.flips_read"]


# -- the wrapper span and the other paths -------------------------------------

def test_the_bitplane_wrapper_span_is_named_by_its_launch_key(job):
    # the one wrapper span, the one a metric reads
    keys = {n[len(PREFIX + "wrapper."):] for n, _, _ in job["sp"]
            if n.startswith(PREFIX + "wrapper.")}
    assert keys == {"pbit_bitplane_sweep"}
    assert keys <= set(_build.launch_counts)


@pytest.mark.parametrize("precision,fused", [
    ("int8", True), ("f32", True), ("int8", False), ("f32", False)])
def test_lattice_spans_in_every_precision(precision, fused):
    h = make_engine("lattice", L=4, seed=1, replicas=2, precision=precision,
                    fused=fused, device="cpu")
    st = h.init_state(seed=3)
    _, sp = profiled(lambda: h.run_recorded(st, ea_schedule(8), [8],
                                            sync_every=4))
    chunks = named(sp, "driver.chunk")
    assert len(chunks) == 1 and len(named(sp, "driver.record")) == 1
    assert len(named(sp, "sync.schedule_upload")) == 1
    # two iterations of 4 sweeps and the record point's energy
    assert len(named(sp, "engine.exchange")) == 3
    assert not [x for x in sp if x[0].startswith(PREFIX + "wrapper.")]
    entry = named(sp, "entry.run_recorded")
    assert len(entry) == 1 and all(inside(c, entry) for c in chunks)


def test_dsim_dist_run_has_entry_and_driver_spans():
    g = ea3d(4, seed=7, device="cpu")
    prob = build_partitioned(g, lattice3d_coloring(4),
                             np.zeros(g.n, np.int32), 1)
    h = make_engine("dsim_dist", prob, rng="lfsr", precision="bitplane",
                    replicas=32, device="cpu")
    st = h.init_state(seed=5)
    _, sp = profiled(lambda: h.run_recorded(st, ea_schedule(4), [4],
                                            sync_every=2))
    entry = named(sp, "entry.run_recorded")
    chunks = named(sp, "driver.chunk") + named(sp, "driver.record")
    assert len(entry) == 1 and len(named(sp, "driver.record")) == 1
    assert chunks and all(inside(c, entry) for c in chunks)
    assert not [x for x in sp if x[0].startswith(PREFIX + "wrapper.")]
