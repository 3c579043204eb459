"""Telemetry on the port (``repro_torch.obs``), on the CPU.

The reference's ``tests/test_obs.py`` re-run against the port (registry
under concurrency, span tracing, the EtaMeter against commcost and on a
recorded cursor; its 2-device ``dsim_dist`` run here on the port's
one-process mesh), the degraded-mode accounting of ``tests/
test_degrade.py``, then the port held to the reference with a fake clock:
the same operations give the same metric snapshots and exposition text,
the same spans, and the same EtaMeter reports, stale accounting included.
"""

import json
import re
import threading

import numpy as np
import pytest
import torch

from repro.obs import EtaMeter as RefEtaMeter
from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import Tracer as RefTracer
from repro_torch.core import commcost
from repro_torch.core.coloring import lattice3d_coloring
from repro_torch.core.graph import ea3d
from repro_torch.obs import (DEFAULT_TIME_BUCKETS, EtaMeter, MetricsRegistry,
                             Tracer, exchanges_per_sweep)
from repro_torch.obs.trace import device_sync

# -- metrics registry ---------------------------------------------------------

# Prometheus text exposition: every sample line is name{labels} value
_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_]\w*="[^"]*"'
    r'(,[a-zA-Z_]\w*="[^"]*")*\})? \S+$')


def _assert_exposition_parses(text: str):
    assert text.endswith("\n")
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        assert _SAMPLE_RE.match(line), f"unparseable sample line: {line!r}"


def test_registry_concurrent_writers_exact_totals():
    """>= 8 writer threads hammer one counter family (labeled + no-label)
    and one histogram while a reader renders snapshots and text; no
    increment is lost and every exposition parses."""
    reg = MetricsRegistry()
    c = reg.counter("hits_total", "hammered counter")
    h = reg.histogram("lat_seconds", "hammered histogram")
    writers, per_writer = 8, 2000
    stop = threading.Event()
    reader_errors = []

    def write(i):
        child = c.labels(worker=str(i % 4))
        for k in range(per_writer):
            c.inc()
            child.inc(2.0)
            h.observe(1e-4 * (k % 50))

    def read():
        while not stop.is_set():
            try:
                snap = reg.snapshot()
                json.dumps(snap)                 # JSON-able mid-write
                _assert_exposition_parses(reg.render_text())
            except Exception as e:              # noqa: BLE001
                reader_errors.append(e)
                return

    rt = threading.Thread(target=read)
    rt.start()
    ts = [threading.Thread(target=write, args=(i,)) for i in range(writers)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    stop.set()
    rt.join(timeout=120)
    assert not any(t.is_alive() for t in (*ts, rt))
    assert not reader_errors
    assert c.value == writers * per_writer       # no-label child exact
    total_labeled = sum(child.value for key, child in c.series()
                        if dict(key).get("worker") is not None)
    assert total_labeled == writers * per_writer * 2.0
    assert h.count == writers * per_writer
    # final exposition carries the exact totals
    text = reg.render_text()
    assert f"lat_seconds_count {writers * per_writer}" in text
    _assert_exposition_parses(text)


def test_registry_kinds_and_snapshot_shape():
    reg = MetricsRegistry()
    g = reg.gauge("depth", "queue depth")
    g.set(3)
    g.labels(engine="dsim").set(7)
    reg.counter("depth2")                        # distinct name ok
    with pytest.raises(ValueError):
        reg.counter("depth")                     # kind clash
    with pytest.raises(ValueError):
        reg.counter("c").inc(-1)                 # counters only go up
    h = reg.histogram("h", buckets=(1.0, 2.0))
    h.observe(0.5)
    h.observe(5.0)                               # lands in +Inf bucket
    snap = reg.snapshot()
    assert snap["depth"]["type"] == "gauge"
    assert {"labels": {}, "value": 3.0} in snap["depth"]["series"]
    hs = snap["h"]["series"][0]
    assert hs["count"] == 2 and hs["buckets"][-1] == ["+Inf", 2]
    # +Inf observations clamp percentiles to the last finite bound
    assert h.quantile(0.99) == 2.0
    assert np.isnan(reg.histogram("h2").quantile(0.5))


def test_histogram_percentiles_interpolate():
    reg = MetricsRegistry()
    h = reg.histogram("t", buckets=DEFAULT_TIME_BUCKETS)
    for v in np.linspace(1e-4, 9e-4, 200):
        h.observe(float(v))
    # true p50 = 5e-4; bucket interpolation stays within the owning
    # bucket (2.5e-4, 5e-4] .. (5e-4, 1e-3] span
    assert 2.5e-4 <= h.quantile(0.5) <= 1e-3
    assert h.quantile(0.99) <= 1e-3
    assert h.quantile(0.0) <= h.quantile(0.5) <= h.quantile(1.0)


# -- tracer -------------------------------------------------------------------

def test_tracer_spans_nest_and_export(tmp_path):
    clk = iter(np.arange(0.0, 100.0, 0.5))
    synced = []
    tr = Tracer(clock=lambda: float(next(clk)), capacity=8,
                block=synced.append)
    with tr.span("outer", job="j1") as outer:
        with tr.span("inner") as inner:
            inner.set(chunk=3)
            inner.sync({"state": 1})
    spans = tr.spans()
    assert [s["name"] for s in spans] == ["inner", "outer"]
    by = {s["name"]: s for s in spans}
    assert by["inner"]["parent_id"] == by["outer"]["span_id"]
    assert by["inner"]["attrs"] == {"chunk": 3}
    assert by["outer"]["attrs"] == {"job": "j1"}
    assert by["inner"]["duration_s"] == pytest.approx(0.5)  # one tick
    assert synced == [{"state": 1}]             # block ran before t1
    assert tr.durations("outer") == [pytest.approx(1.5)]
    p = tmp_path / "spans.jsonl"
    assert tr.export_jsonl(str(p)) == 2
    rows = [json.loads(line) for line in p.read_text().splitlines()]
    assert {r["name"] for r in rows} == {"inner", "outer"}
    # bounded ring: old spans evicted
    for i in range(20):
        with tr.span(f"s{i}"):
            pass
    assert len(tr.spans()) == 8


# -- EtaMeter vs commcost -----------------------------------------------------

def test_exchanges_per_sweep():
    assert exchanges_per_sweep("phase", 3) == 3.0
    assert exchanges_per_sweep(None, 3) == 1.0
    assert exchanges_per_sweep(4, 3) == 0.25
    with pytest.raises(ValueError):
        exchanges_per_sweep(0, 3)


def test_eta_meter_fake_clock_vs_commcost():
    """Hand-computable accounting: t_ex = 0.02 s, chunk of 8 sweeps in
    0.84 s at sync_every=4 -> 2 exchanges -> t_pbit = (0.84 - 0.04)/8 =
    0.1 s, η = 5.0, threshold = 2 * n_color * c_max = 16 (commcost),
    margin = 0.3125."""
    m = EtaMeter(n_color=2, c_max=4, sync_every=4)
    assert np.isnan(m.t_exchange_s) and np.isnan(m.eta)
    m.record_exchange(0.2, count=10)
    m.record_chunk(sweeps=8, seconds=0.84)
    assert m.t_exchange_s == pytest.approx(0.02)
    assert m.t_pbit_sweep_s == pytest.approx(0.1)
    assert m.f_comm_hz == pytest.approx(50.0)
    assert m.f_pbit_hz == pytest.approx(10.0)
    assert m.eta == pytest.approx(5.0)
    assert m.eta_threshold == commcost.eta_threshold(2, 4) == 16.0
    r = m.report()
    assert r["measured_eta"] == pytest.approx(5.0)
    assert r["margin"] == pytest.approx(5.0 / 16.0)
    assert r["behaves_unpartitioned"] is False
    assert r["chunks_recorded"] == 1 and r["sweeps_recorded"] == 8
    assert r["exchanges_attributed"] == pytest.approx(2.0)

    # a fast enough exchange clears the bound: margin >= 1
    fast = EtaMeter(n_color=2, c_max=4, sync_every=4)
    fast.record_exchange(0.2, count=10000)       # t_ex = 2e-5
    fast.record_chunk(sweeps=8, seconds=0.84)
    rf = fast.report()
    assert rf["margin"] >= 1.0 and rf["behaves_unpartitioned"] is True

    # the floor: a mismeasured (too large) t_ex can never produce a
    # negative p-bit time — floored at a tenth of the raw per-sweep time
    bad = EtaMeter(n_color=2, c_max=4, sync_every=1)
    bad.record_exchange(10.0, count=10)
    bad.record_chunk(sweeps=8, seconds=0.8)
    assert bad.t_pbit_sweep_s == pytest.approx(0.1 * 0.8 / 8)


def test_eta_meter_hooks_into_cursor():
    """attach() installs the meter on the recorded cursor's chunk_timer
    (the same hook surface fault injection uses) and accumulates every
    recorded chunk of a real anneal."""
    from repro_torch.core.annealing import constant_schedule
    from repro_torch.engines import make_engine

    h = make_engine("gibbs", ea3d(3, seed=0, device="cpu"),
                    coloring=lattice3d_coloring(3), rng="lfsr",
                    device="cpu")
    sch = constant_schedule(2.0, 64)
    cur = h.start_recorded(h.init_state(seed=0), sch, [8, 16], sync_every=1)
    m = EtaMeter(n_color=2, sync_every=1).attach(cur)
    assert cur.chunk_timer == m.on_chunk
    while not cur.done:
        cur.advance(1)
    r = m.report()
    assert r["chunks_recorded"] == 2 and r["sweeps_recorded"] == 16
    assert r["chunk_seconds"] > 0
    assert np.isfinite(r["f_pbit_hz"])           # no exchange side needed



def test_eta_meter_effective_eta_accounting():
    from repro_torch.obs import EtaMeter

    m = EtaMeter(n_color=1, c_max=0.045, sync_every=10)
    m.record_chunk(100, 1.0, exchanges=10)
    m.record_exchange(0.5, 10)            # t_ex = 0.05 s
    # t_pbit = (1.0 - 10 * 0.05) / 100 = 0.005 -> eta = 0.1
    assert m.eta == pytest.approx(0.1)
    assert m.effective_eta == pytest.approx(0.1)      # healthy: equal
    rep = m.report()
    assert rep["margin"] > 1.0 and rep["degraded_below_threshold"] is False
    m.note_stale(3, 10, max_staleness=2)
    assert m.stale_exchanges == 3
    assert m.max_staleness_seen == 2
    assert m.delivered_fraction == pytest.approx(0.7)
    assert m.effective_eta == pytest.approx(0.07)
    rep = m.report()
    # threshold 2 * 1 * 0.045 = 0.09: clean margin >= 1, effective below
    assert rep["effective_eta"] < rep["eta_threshold"] <= rep["measured_eta"]
    assert rep["degraded_below_threshold"] is True
    assert rep["stale_exchanges"] == 3
    assert rep["max_staleness_seen"] == 2


def test_eta_meter_dsim_dist_on_the_one_process_mesh():
    """The reference's 2-device acceptance run, on the port's K=2
    one-process mesh: measured η, f_comm, f_pbit and the margin against
    ``commcost.eta_threshold`` all finite and self-consistent."""
    from repro_torch.core.annealing import constant_schedule
    from repro_torch.core.partition import slab_partition
    from repro_torch.engines import make_engine
    from repro_torch.obs import dist_eta_meter

    L = 4
    g = ea3d(L, seed=7, device="cpu")
    h = make_engine("dsim_dist", g, coloring=lattice3d_coloring(L), K=2,
                    labels=slab_partition(L, 2), rng="lfsr", replicas=4,
                    device="cpu")
    meter = dist_eta_meter(h.eng, sync_every=8)
    sch = constant_schedule(3.0, 8 * 64)
    st = h.init_state(seed=0)
    meter.measure_exchange(lambda: h.eng.boundary_exchange_fn()(st),
                           reps=16)
    cur = h.start_recorded(st, sch, [32, 64], sync_every=8)
    meter.attach(cur)
    while not cur.done:
        cur.advance(1)
    r = meter.report()
    for f in ("measured_eta", "eta_threshold", "margin", "f_comm_hz",
              "f_pbit_hz", "t_exchange_s", "t_pbit_sweep_s",
              "effective_eta"):
        assert np.isfinite(r[f]) and r[f] > 0, (f, r)
    b = commcost.boundary_matrix(g.idx, g.w, slab_partition(4, 2), 2)
    cc = commcost.comm_cost(b, commcost.RingTopology(k=2, pins_per_link=1))
    assert r["eta_threshold"] == pytest.approx(
        commcost.eta_threshold(r["n_color"], cc.c_max))
    assert r["margin"] == pytest.approx(
        r["measured_eta"] / r["eta_threshold"])
    assert r["effective_eta"] == r["measured_eta"]
    assert r["sweeps_recorded"] == 64 and r["chunks_recorded"] == 2


# -- the port against the reference, with a fake clock -----------------------

class FakeClock:
    def __init__(self, step=0.25):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def _drive_registry(reg):
    c = reg.counter("jobs_total", "jobs")
    c.inc()
    c.labels(engine="lattice").inc(3)
    g = reg.gauge("depth", "queue depth")
    g.set(4)
    g.labels(pool="a").set(2.5)
    h = reg.histogram("lat_seconds", "latency")
    for v in (1e-5, 3e-3, 0.2, 0.2, 7.0, 100.0):
        h.labels(engine="dsim").observe(v)
    h2 = reg.histogram("rate", "flips/s",
                       buckets=tuple(10.0 ** e for e in range(3, 13)))
    h2.observe(4.2e9)
    return reg


def test_registry_snapshot_and_text_match_reference():
    got = _drive_registry(MetricsRegistry())
    want = _drive_registry(RefRegistry())
    assert got.snapshot() == want.snapshot()
    assert got.render_text() == want.render_text()
    assert DEFAULT_TIME_BUCKETS == __import__(
        "repro.obs", fromlist=["DEFAULT_TIME_BUCKETS"]).DEFAULT_TIME_BUCKETS


def _drive_tracer(tr):
    with tr.span("outer", job="j1") as sp:
        with tr.span("inner", chunk=0) as sp2:
            sp2.sync(np.zeros(3))
        sp.set(done=True)
    with tr.span("outer", job="j2"):
        pass
    return [{k: v for k, v in s.items() if k != "thread"}
            for s in tr.spans()]


def test_tracer_spans_match_reference():
    blocked = [[], []]
    got = _drive_tracer(Tracer(clock=FakeClock(), block=blocked[0].append))
    want = _drive_tracer(RefTracer(clock=FakeClock(),
                                   block=blocked[1].append))
    assert got == want
    assert len(blocked[0]) == len(blocked[1]) == 1


def test_device_sync_waits_only_for_cuda_tensors():
    # CPU tensors, numpy arrays and plain values need no wait
    device_sync({"a": torch.zeros(2), "b": (np.zeros(1), 3)})
    tr = Tracer(clock=FakeClock())
    with tr.span("s", sync=torch.ones(2)):
        pass
    assert tr.durations("s") == [0.25]


@pytest.mark.parametrize("stale", [None, (3, 10, 2), (10, 10, 9),
                                   (0, 5, 0)])
def test_eta_meter_report_matches_reference(stale):
    reports = []
    for cls in (EtaMeter, RefEtaMeter):
        m = cls(n_color=2, c_max=0.045, sync_every=4, clock=FakeClock())
        m.record_exchange(0.2, count=10)
        m.record_chunk(sweeps=8, seconds=0.84)
        m.on_chunk(4, 0.5)
        m.measure_exchange(lambda: None, reps=4, warmup=1)
        if stale is not None:
            m.note_stale(stale[0], stale[1], max_staleness=stale[2])
        reports.append(m.report())
    assert reports[0].keys() == reports[1].keys()
    for k, v in reports[1].items():
        if isinstance(v, float) and v != v:
            assert reports[0][k] != reports[0][k], k
        else:
            assert reports[0][k] == v, k
    assert json.dumps(reports[0], default=str)
