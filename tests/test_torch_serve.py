"""The sampling server on the port (``repro_torch.serve``), on the CPU.

The reference's server tests re-run against the port: ``tests/
test_serve.py`` whole (queue lifecycle, replica packing, engine pool,
streaming, preemption, cancellation, admission control), the degrade
provenance tests of ``tests/test_degrade.py`` and the server-surface tests
of ``tests/test_obs.py``, each with its imports taken from
``repro_torch`` and its graphs and servers on ``device="cpu"``.  Then a
job through the port's server against the same job through the
reference's server (int8 bitwise), the device rule, and the error
taxonomy of the card.
"""

import re
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.coloring import lattice3d_coloring
from repro_torch.core.graph import ea3d
from repro_torch.serve import EnginePool, QueueFull, SampleServer
from repro_torch.serve.jobs import problem_fingerprint, schedule_fingerprint
from repro_torch.core.annealing import constant_schedule, ea_schedule
from repro_torch.serve.faults import FaultPlan, FaultRule

L_A, L_B = 5, 6
SW = 64


@pytest.fixture(scope="module")
def problems():
    return {
        "pa": (ea3d(L_A, seed=1, device="cpu"), lattice3d_coloring(L_A)),
        "pb": (ea3d(L_B, seed=2, device="cpu"), lattice3d_coloring(L_B)),
    }


def _server(problems, **kw):
    srv = SampleServer(device="cpu", **kw)
    for name, (g, col) in problems.items():
        srv.register_problem(name, graph=g, coloring=col, rng="lfsr")
    srv.register_problem("lat", L=L_B, seed=3)
    return srv


def _check_payload(r, g_n, replicas):
    assert r["status"] == "done"
    e = r["energies"]
    assert e.ndim == 2 and e.shape[1] == replicas and len(e) >= 1
    assert np.isfinite(e).all()
    assert r["best_energy"] == pytest.approx(float(e.min()))
    assert r["best_spins"] is not None and r["best_spins"].shape == (g_n,)
    assert set(np.unique(r["best_spins"])) <= {-1, 1}
    assert r["flips"] > 0 and r["wall_s"] >= 0 and r["device_s"] > 0
    assert r["sweeps_done"] == r["total_sweeps"]


# -- the acceptance workload: concurrent mixed jobs, packing observable -------

def test_mixed_concurrent_workload_packs(problems):
    """>= 8 in-flight jobs across 2 problems and 2 engines: all complete,
    payloads validate, and compatible requests shared engine calls."""
    srv = _server(problems, max_replicas_per_call=16)
    ids = []
    for k in range(4):
        ids.append(srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2,
                              seed=k))
    for k in range(2):
        ids.append(srv.submit("pb", engine="gibbs", sweeps=SW, replicas=2,
                              seed=k))
    for k in range(2):
        ids.append(srv.submit("pa", engine="dsim", sweeps=SW, replicas=2,
                              seed=k, sync_every=4))
    assert srv.stats()["queue_depth"] == 8          # all in flight
    srv.drain()
    for jid, name in zip(ids, ["pa"] * 4 + ["pb"] * 2 + ["pa"] * 2):
        _check_payload(srv.result(jid), problems[name][0].n, 2)
    s = srv.stats()
    assert s["completed"] == 8
    # the packing claim: batched engine calls < submitted jobs
    assert s["engine_calls"] == 3 < s["submitted"]
    assert s["scheduler"]["jobs_packed"] == 8


def test_packed_job_bitwise_equals_solo(problems):
    """A tenant's trajectory is independent of its batch-mates: the same
    job packed with strangers reproduces its solo run bitwise."""
    packed = _server(problems, max_replicas_per_call=16)
    ids = [packed.submit("pa", engine="gibbs", sweeps=SW, replicas=2,
                         seed=s) for s in (9, 10, 11)]
    packed.drain()
    assert packed.stats()["engine_calls"] == 1
    solo = _server(problems, pack=False)
    sid = solo.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=9)
    solo.drain()
    rp, rs = packed.result(ids[0]), solo.result(sid)
    assert np.array_equal(rp["energies"], rs["energies"])
    assert np.array_equal(rp["best_spins"], rs["best_spins"])
    assert rp["flips"] == rs["flips"]


def test_packed_trace_isolated_from_batch_mates(problems):
    """A tenant only gets its own record points: packing with a mate that
    requested different points must not change the tenant's trace."""
    packed = _server(problems, max_replicas_per_call=16)
    a = packed.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=9,
                      record_points=[SW // 2, SW])
    packed.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=10,
                  record_points=[SW // 4])
    packed.drain()
    assert packed.stats()["engine_calls"] == 1
    solo = _server(problems, pack=False)
    s = solo.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=9,
                    record_points=[SW // 2, SW])
    solo.drain()
    rp, rs = packed.result(a), solo.result(s)
    assert np.array_equal(rp["times"], rs["times"])
    assert np.array_equal(rp["energies"], rs["energies"])


def test_pow2_padding_respects_replica_cap(problems):
    """Padding never pushes the executed width past max_replicas_per_call
    (the cap is sized to the device, e.g. memory)."""
    srv = _server(problems, max_replicas_per_call=12)
    for s in range(6):
        srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=s)
    assert srv.pump()                        # forms + starts the batch
    batches = srv._batches
    assert len(batches) == 1 and batches[0].r_exec == 12  # not padded to 16
    srv.drain()
    assert srv.stats()["completed"] == 6


def test_terminal_jobs_evicted_beyond_retention(problems):
    srv = _server(problems, retain_jobs=2)
    ids = [srv.submit("pa", engine="gibbs", sweeps=SW, seed=s)
           for s in range(3)]
    srv.drain()
    assert srv.result(ids[-1])["status"] == "done"
    with pytest.raises(KeyError):
        srv.poll(ids[0])                     # oldest terminal job evicted


def test_sync_every_validated_at_submit(problems):
    srv = _server(problems)
    with pytest.raises(ValueError, match="sync_every"):
        srv.submit("pa", engine="dsim", sweeps=SW, sync_every=0)
    with pytest.raises(ValueError, match="sync_every"):
        srv.submit("pa", engine="dsim", sweeps=4, sync_every=8)


def test_prewarm_wait_surfaces_build_errors(problems):
    srv = SampleServer(device="cpu")
    g, col = problems["pa"]
    srv.register_problem("bad", graph=g, coloring=col, rng="not-an-rng")
    with pytest.raises(ValueError):
        srv.prewarm("bad", engine="gibbs", replicas=2, sweeps=SW, wait=True)


def test_lattice_packs_through_server(problems):
    srv = _server(problems, max_replicas_per_call=8)
    ids = [srv.submit("lat", engine="lattice", sweeps=SW, replicas=2,
                      seed=s, sync_every=4) for s in range(3)]
    srv.drain()
    n = L_B ** 3
    for jid in ids:
        _check_payload(srv.result(jid), n, 2)
    assert srv.stats()["engine_calls"] == 1


# -- streaming / preemption / cancel ------------------------------------------

def test_streaming_partial_results(problems):
    srv = _server(problems, stream_chunks=8)
    jid = srv.submit("pa", engine="gibbs", sweeps=512, replicas=2, seed=0)
    srv.pump(); srv.pump()
    p = srv.poll(jid)
    assert p["status"] == "running"
    assert 0 < p["sweeps_done"] < 512
    assert len(p["times"]) >= 1 and p["times"][-1] <= p["sweeps_done"]
    assert p["energies"].shape == (len(p["times"]), 2)
    assert p["flips"] > 0                    # exact mid-anneal flip count
    assert p["best_spins"] is not None       # best-so-far configuration
    before = p["sweeps_done"]
    srv.drain()
    r = srv.result(jid)
    assert r["status"] == "done" and r["sweeps_done"] == 512
    assert r["flips"] > p["flips"] and before < r["sweeps_done"]


def test_priority_preempts_running_batch(problems):
    srv = _server(problems)
    lo = srv.submit("pa", engine="gibbs", sweeps=1024, replicas=1, seed=1)
    srv.pump()                               # lo is mid-anneal
    hi = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=1, seed=2,
                    priority=5)
    while srv.poll(hi)["status"] != "done":
        assert srv.pump()
    assert srv.poll(lo)["status"] == "running"   # parked, not lost
    assert srv.stats()["preemptions"] >= 1
    srv.drain()
    assert srv.poll(lo)["status"] == "done"


def test_cancel_queued_and_running(problems):
    srv = _server(problems)
    q = srv.submit("pa", engine="gibbs", sweeps=SW)
    assert srv.cancel(q) and srv.poll(q)["status"] == "cancelled"
    assert not srv.cancel(q)                 # already terminal
    run = srv.submit("pa", engine="gibbs", sweeps=512, seed=3)
    mate = srv.submit("pa", engine="gibbs", sweeps=512, seed=4)
    srv.pump()
    assert srv.cancel(run)
    srv.drain()
    r = srv.result(run)
    assert r["status"] == "cancelled" and 0 < r["sweeps_done"] < 512
    _check_payload(srv.result(mate), ea3d(L_A, seed=1, device="cpu").n, 1)  # unharmed
    assert srv.stats()["cancelled"] == 2


# -- admission control / validation -------------------------------------------

def test_admission_control(problems):
    srv = _server(problems, max_queue_depth=2)
    srv.submit("pa", sweeps=SW)
    srv.submit("pa", sweeps=SW)
    with pytest.raises(QueueFull):
        srv.submit("pa", sweeps=SW)
    assert srv.stats()["rejected"] == 1
    srv.drain()                              # draining reopens admission
    srv.submit("pa", sweeps=SW)
    srv.drain()


def test_submit_validation(problems):
    srv = _server(problems, max_replicas_per_call=4)
    with pytest.raises(ValueError):
        srv.submit("nope", sweeps=SW)
    with pytest.raises(ValueError):
        srv.submit("pa", engine="lattice", sweeps=SW)     # graph problem
    with pytest.raises(ValueError):
        srv.submit("lat", engine="gibbs", sweeps=SW)      # lattice problem
    with pytest.raises(ValueError):
        srv.submit("pa", engine="gibbs", precision="int8", sweeps=SW)
    with pytest.raises(ValueError):
        srv.submit("pa", replicas=5, sweeps=SW)           # > max per call
    with pytest.raises(ValueError):
        srv.submit("pa", sweeps=SW, record_points=[SW + 1])
    with pytest.raises(KeyError):
        srv.poll("job-999999")


def test_gibbs_sync_every_keeps_all_points(problems):
    """Gibbs has no boundaries, so its cursor records at S=1 whatever
    sync_every says — the harvest filter must use the cursor's actual
    quantum or requested points silently vanish."""
    srv = _server(problems)
    jid = srv.submit("pa", engine="gibbs", sweeps=SW, sync_every=4,
                     record_points=[13, SW // 2, SW])
    srv.drain()
    r = srv.result(jid)
    assert {13, SW // 2, SW} <= set(r["times"].tolist())
    assert r["energies"].shape[0] == len(r["times"])


def test_dsim_points_quantized_to_exchange_period(problems):
    srv = _server(problems)
    jid = srv.submit("pa", engine="dsim", sweeps=SW, sync_every=4,
                     record_points=[14])
    srv.drain()
    times = set(srv.result(jid)["times"].tolist())
    assert 16 in times                       # 14 snapped to a boundary
    assert all(t % 4 == 0 for t in times)
    assert {8, 16, 24, 32, 40, 48, 56, 64} <= times   # stream points intact


def test_awkward_sync_period_near_schedule_end(problems):
    """sweeps not a multiple of sync_every: stream points that round past
    the schedule clamp to the last reachable boundary instead of failing
    the whole batch."""
    srv = _server(problems)
    jid = srv.submit("pa", engine="dsim", sweeps=SW, sync_every=7)
    srv.drain()
    r = srv.result(jid)
    assert r["status"] == "done"
    assert len(r["times"]) >= 1 and r["times"][-1] == (SW // 7) * 7


def test_result_timeout_honored_inline(problems):
    srv = _server(problems)           # no background thread
    jid = srv.submit("pa", sweeps=SW)
    with pytest.raises(TimeoutError):
        srv.result(jid, timeout=0.0)
    assert srv.result(jid)["status"] == "done"


def test_incompatible_schedules_do_not_pack(problems):
    """Same problem/engine but different staircases -> separate batches."""
    srv = _server(problems)
    a = srv.submit("pa", engine="gibbs", sweeps=SW,
                   schedule=ea_schedule(SW))
    b = srv.submit("pa", engine="gibbs", sweeps=SW,
                   schedule=constant_schedule(2.0, SW))
    srv.drain()
    assert srv.stats()["engine_calls"] == 2
    assert srv.result(a)["status"] == srv.result(b)["status"] == "done"


# -- engine pool ---------------------------------------------------------------

def test_pool_lru_hit_and_evict(problems):
    srv = _server(problems, pool_capacity=1)
    srv.submit("pa", engine="gibbs", sweeps=SW); srv.drain()
    srv.submit("pb", engine="gibbs", sweeps=SW); srv.drain()  # evicts pa
    srv.submit("pb", engine="gibbs", sweeps=SW); srv.drain()  # hit
    s = srv.stats()["pool"]
    assert s["size"] == 1 and s["evictions"] >= 1 and s["hits"] >= 1
    # hit/miss is reported on the job payload as cold_start
    jid = srv.submit("pb", engine="gibbs", sweeps=SW); srv.drain()
    assert srv.result(jid)["cold_start"] is False


def test_pool_single_flight_builds():
    pool = EnginePool(capacity=4)
    built = []

    def builder():
        built.append(1)
        return object()

    outs = []
    ts = [threading.Thread(
        target=lambda: outs.append(pool.get(("k",), builder)))
        for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert len(built) == 1                   # concurrent gets build once
    assert len({id(h) for h, _ in outs}) == 1
    assert pool.stats()["hits"] == 3 and pool.stats()["misses"] == 1


def test_pool_waiter_on_inflight_build_not_a_hit():
    """A caller that waited on another thread's build gets was_hit=False:
    that handle is freshly built and possibly unwarmed."""
    import time as _time
    pool = EnginePool(capacity=4)
    gate = threading.Event()

    def slow_builder():
        gate.wait(10)
        return object()

    t1 = threading.Thread(target=lambda: pool.get(("k",), slow_builder))
    t1.start()
    _time.sleep(0.05)                        # t1 is mid-build
    out = {}
    t2 = threading.Thread(
        target=lambda: out.update(r=pool.get(("k",), slow_builder)))
    t2.start()
    _time.sleep(0.05)
    gate.set()
    t1.join(timeout=120)
    t2.join(timeout=120)
    assert not t1.is_alive() and not t2.is_alive()
    assert out["r"][1] is False              # waited -> not a warm hit
    _, hit = pool.get(("k",), slow_builder)  # genuinely cached now
    assert hit is True


def test_prewarm_moves_compile_off_path(problems):
    srv = _server(problems)
    srv.prewarm("pa", engine="gibbs", replicas=2, sweeps=SW, wait=True)
    jid = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2)
    srv.drain()
    r = srv.result(jid)
    assert r["pool_hit"] is True and r["cold_start"] is False
    assert srv.stats()["pool"]["hits"] >= 1


# -- background serving thread -------------------------------------------------

def test_threaded_serving_concurrent_submitters(problems):
    """Submissions race in from several threads while the serving loop
    runs; everything completes and validates (the CI smoke contract)."""
    srv = _server(problems).start()
    ids, errs = [], []
    lock = threading.Lock()

    def client(k):
        try:
            eng = ("gibbs", "dsim")[k % 2]
            jid = srv.submit("pa", engine=eng, sweeps=SW, replicas=2,
                             seed=k, sync_every=4 if eng == "dsim" else 1)
            r = srv.result(jid, timeout=300)
            with lock:
                ids.append((jid, r))
        except Exception as e:               # noqa: BLE001
            with lock:
                errs.append(e)

    ts = [threading.Thread(target=client, args=(k,)) for k in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=400)
    srv.stop()
    assert not any(t.is_alive() for t in ts)
    assert not errs
    assert len(ids) == 8
    g_n = ea3d(L_A, seed=1, device="cpu").n
    for _, r in ids:
        _check_payload(r, g_n, 2)
    assert srv.stats()["completed"] == 8


def test_result_after_stop_falls_back_inline(problems):
    srv = _server(problems).start()
    srv.stop()
    jid = srv.submit("pa", sweeps=SW)
    assert srv.result(jid, timeout=120)["status"] == "done"


def test_result_survives_stop_mid_wait(problems):
    """A waiter must not hang when the serving thread is stopped under
    it — it takes over pumping instead."""
    srv = _server(problems).start()
    jid = srv.submit("pa", sweeps=256, replicas=1)
    out = {}
    t = threading.Thread(
        target=lambda: out.update(r=srv.result(jid, timeout=120)))
    t.start()
    srv.stop()
    t.join(timeout=120)
    assert not t.is_alive()
    assert out["r"]["status"] == "done"


# -- fingerprints --------------------------------------------------------------

def test_fingerprints_discriminate(problems):
    (ga, _), (gb, _) = problems["pa"], problems["pb"]
    assert problem_fingerprint(graph=ga) == problem_fingerprint(graph=ga)
    assert problem_fingerprint(graph=ga) != problem_fingerprint(graph=gb)
    assert problem_fingerprint(L=8, seed=0) != problem_fingerprint(L=8,
                                                                   seed=1)
    assert schedule_fingerprint(ea_schedule(SW)) == \
        schedule_fingerprint(ea_schedule(SW))
    assert schedule_fingerprint(ea_schedule(SW)) != \
        schedule_fingerprint(constant_schedule(1.0, SW))


# -- degrade provenance through the server (tests/test_degrade.py) -----------

def _graph_server(**kw):
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.coloring import lattice3d_coloring
    from repro_torch.core.graph import ea3d
    from repro_torch.serve.server import SampleServer

    g = ea3d(4, seed=11, device="cpu")
    srv = SampleServer(device="cpu", warm_compile=False, retry_backoff_s=0.0, **kw)
    srv.register_problem("ea4", graph=g,
                         coloring=lattice3d_coloring(4), K=1,
                         labels=np.zeros(g.n, np.int32),
                         mesh=make_mesh((1,), ("data",)),
                         rng="lfsr")
    return srv


def test_submit_degrade_policy_validation():
    srv = _graph_server()
    with pytest.raises(ValueError, match="mesh engines"):
        srv.submit("ea4", engine="gibbs", degrade_policy="stale_hold")
    with pytest.raises(ValueError, match="integer sync_every"):
        srv.submit("ea4", engine="dsim_dist", degrade_policy="stale_hold",
                   sync_every="phase")
    with pytest.raises(ValueError, match="degrade"):
        srv.submit("ea4", engine="dsim_dist", degrade_policy="best_effort",
                   sync_every=4)


def test_serve_degrade_provenance_clean():
    srv = _graph_server()
    jid = srv.submit("ea4", engine="dsim_dist", precision="int8", sweeps=32,
                     sync_every=4, seed=3, degrade_policy="stale_hold:8")
    out = srv.drain().result(jid)
    assert out["status"] == "done"
    deg = out["degrade"]
    assert deg is not None
    assert deg["policy"] == "stale_hold:8"
    assert deg["detections"] == 0
    assert deg["delivered_fraction"] == 1.0
    assert not deg["suspect"]
    st = srv.stats()
    assert st["exchange_integrity_failures"] == 0
    assert st["stale_exchanges"] == 0
    # a policy-free job on the same problem carries no provenance (and
    # compiles under a DIFFERENT pool key — the clean executable)
    jid2 = srv.submit("ea4", engine="dsim_dist", precision="int8",
                      sweeps=32, sync_every=4, seed=3)
    out2 = srv.drain().result(jid2)
    assert out2["status"] == "done" and out2["degrade"] is None
    assert srv.stats()["pool"]["size"] == 2


def test_serve_degrade_provenance_with_injected_drops():
    # poison the LAST of the 8 exchanges (sweeps=32, sync_every=4), so
    # the quarantine mark is still up when the batch retires — staleness
    # is *consecutive*, so a mid-run drop heals by run end
    plan = FaultPlan([FaultRule(site="exchange_drop", index=7)], seed=4)
    srv = _graph_server(fault_plan=plan)
    jid = srv.submit("ea4", engine="dsim_dist", precision="int8", sweeps=32,
                     sync_every=4, seed=3, degrade_policy="stale_hold:8")
    out = srv.drain().result(jid)
    assert out["status"] == "done"
    deg = out["degrade"]
    assert deg["detections"] == 1
    assert deg["stale_exchanges"] == 1
    assert deg["max_staleness_seen"] == 1
    assert deg["suspect"]
    assert 0.0 < deg["delivered_fraction"] < 1.0
    st = srv.stats()
    assert st["exchange_integrity_failures"] == 1
    assert st["stale_exchanges"] == 1


def test_serve_fail_fast_fails_job():
    plan = FaultPlan([FaultRule(site="exchange_corrupt", index=1)], seed=4)
    srv = _graph_server(fault_plan=plan, max_retries=0)
    jid = srv.submit("ea4", engine="dsim_dist", precision="int8", sweeps=32,
                     sync_every=4, seed=3, degrade_policy="fail_fast")
    out = srv.drain().result(jid)
    assert out["status"] == "failed"
    assert "StateCorruption" in out["error"]
    assert srv.stats()["exchange_integrity_failures"] >= 1



# -- the server's metrics surface (tests/test_obs.py) ------------------------

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


@pytest.fixture(scope="module")
def served():
    """One tiny mixed workload; the metrics surface is inspected by
    several tests."""
    g = ea3d(4, seed=3, device="cpu")
    srv = SampleServer(device="cpu", max_replicas_per_call=8)
    srv.register_problem("p", graph=g, coloring=lattice3d_coloring(4),
                         rng="lfsr")
    ids = [srv.submit("p", engine="gibbs", sweeps=32, replicas=2, seed=s)
           for s in (0, 1)]
    ids.append(srv.submit("p", engine="dsim", sweeps=32, replicas=2,
                          seed=2, sync_every=4))
    srv.drain()
    results = [srv.result(j) for j in ids]
    return srv, results


def test_server_metrics_surface(served):
    """stats() is a registry view; the snapshot and Prometheus text cover
    queue wait, pump latency, goodput, retries/breaker, per-engine
    flips/s."""
    srv, results = served
    assert all(r["status"] == "done" for r in results)
    s = srv.stats()
    snap = srv.metrics_snapshot()
    # counters migrated onto the registry: stats() mirrors family values
    assert s["completed"] == 3
    assert snap["serve_jobs_completed_total"]["series"][0]["value"] == 3
    assert s["submitted"] == sum(
        e["value"] for e in snap["serve_jobs_submitted_total"]["series"])
    # latency/goodput histograms observed per engine
    for fam in ("serve_queue_wait_seconds", "serve_pump_chunk_seconds",
                "serve_job_total_seconds", "serve_job_flips_per_s"):
        engines = {e["labels"].get("engine") for e in snap[fam]["series"]}
        assert {"gibbs", "dsim"} <= engines, fam
        assert sum(e["count"] for e in snap[fam]["series"]) >= 2, fam
        assert all("p50" in e and "p99" in e for e in snap[fam]["series"])
    # per-engine flips/s gauge
    rates = {(e["labels"]["engine"], e["labels"]["precision"]): e["value"]
             for e in snap["engine_flips_per_s"]["series"]}
    assert all(v > 0 for v in rates.values()) and len(rates) >= 2
    # pool + scheduler instrumentation share the registry
    assert sum(e["value"] for e in snap["pool_misses_total"]["series"]) \
        == s["pool"]["misses"]
    assert sum(e["count"] for e in snap["pool_build_seconds"]["series"]) \
        == s["pool"]["misses"]
    assert sum(e["count"]
               for e in snap["sched_pack_width_replicas"]["series"]) \
        == s["scheduler"]["batches_formed"]
    assert s["scheduler"]["padding_replicas"] >= 0
    # Prometheus text: parseable, and the catalogue is present
    text = srv.render_metrics()
    _assert_exposition_parses(text)
    for name in ("serve_jobs_completed_total", "serve_queue_wait_seconds_bucket",
                 "serve_pump_chunk_seconds_count", "serve_job_flips_per_s_sum",
                 "engine_flips_per_s", "pool_hits_total",
                 "sched_pack_width_replicas_bucket", "serve_queue_depth",
                 "serve_retries_total", "pool_open_circuits"):
        assert name in text, name
    # pump.chunk spans recorded with engine attribution
    chunk_spans = srv.tracer.spans("pump.chunk")
    assert len(chunk_spans) >= 2
    assert all(sp["duration_s"] > 0 and "engine" in sp["attrs"]
               for sp in chunk_spans)


def test_server_stats_snapshot_is_isolated(served):
    """Satellite regression: mutating the returned stats() dict (top
    level and nested pool/scheduler/spool views) cannot corrupt server
    state."""
    srv, _ = served
    before = srv.stats()
    victim = srv.stats()
    victim["completed"] = 10 ** 9
    victim["pool"].clear()
    victim["scheduler"]["batches_formed"] = -1
    if isinstance(victim["spool"], dict):
        victim["spool"].clear()
    victim.clear()
    after = srv.stats()
    assert after == before
    assert after["pool"]["misses"] == before["pool"]["misses"]
    # the counters really live on the registry, not the mutated dict
    assert srv.completed == before["completed"]


def test_legacy_counter_attributes_still_read(served):
    srv, _ = served
    assert srv.completed == 3 and srv.failed == 0 and srv.retries == 0
    with pytest.raises(AttributeError):
        srv.not_a_counter


# -- port only: the reference's server, the device rule, the taxonomy --------

def _lattice_jobs(srv, precision, seeds, replicas):
    srv.register_problem("lat6", L=6, seed=3)
    ids = [srv.submit("lat6", engine="lattice", precision=precision,
                      sweeps=32, replicas=replicas, seed=s, sync_every=1,
                      record_points=(8, 32)) for s in seeds]
    srv.drain()
    return [srv.result(j) for j in ids]


@pytest.mark.parametrize("precision,replicas", [("int8", 2),
                                                ("bitplane", 5)])
def test_lattice_jobs_equal_the_reference_server(precision, replicas):
    from repro.serve import SampleServer as RefServer
    got = _lattice_jobs(SampleServer(device="cpu", warm_compile=False),
                        precision, (0, 1), replicas)
    want = _lattice_jobs(RefServer(warm_compile=False), precision, (0, 1),
                         replicas)
    for g, w in zip(got, want):
        assert g["status"] == w["status"] == "done"
        assert g["packed_with"] == w["packed_with"] == 1
        np.testing.assert_array_equal(g["times"], w["times"])
        np.testing.assert_array_equal(g["energies"], w["energies"])
        np.testing.assert_array_equal(g["best_spins"], w["best_spins"])
        assert (g["best_energy"], g["best_replica"], g["flips"]) == \
            (w["best_energy"], w["best_replica"], w["flips"])


def test_degraded_mesh_jobs_through_the_server():
    """The card's phase-8 path at L=6: a lattice mesh job under
    stale_hold with a drop, and a dsim_dist job under fail_fast with a
    corrupt, which fails with StateCorruption."""
    from repro_torch.core.dsim import build_partitioned
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.partition import slab_partition
    axes = ("x", "y", "z")
    plan = FaultPlan([FaultRule(site="exchange_drop", index=3),
                      FaultRule(site="exchange_corrupt", index=1)], seed=1)
    srv = SampleServer(device="cpu", fault_plan=plan, max_retries=0)
    srv.register_problem("mesh", L=6, seed=3,
                         mesh=make_mesh((2, 2, 2), axes), dim_axes=axes)
    g = ea3d(6, seed=3, device="cpu")
    srv.register_problem("graph", graph=g, coloring=lattice3d_coloring(6),
                         K=2, labels=slab_partition(6, 2), rng="lfsr")
    j1 = srv.submit("mesh", engine="lattice", precision="int8", sweeps=16,
                    replicas=2, seed=4, sync_every=2,
                    degrade_policy="stale_hold:8")
    j2 = srv.submit("graph", engine="dsim_dist", precision="int8",
                    sweeps=16, replicas=2, seed=4, sync_every=2,
                    degrade_policy="fail_fast")
    srv.drain()
    r1, r2 = srv.result(j1), srv.result(j2)
    assert r1["status"] == "done"
    # exchanges 1 (corrupt) and 3 (drop) of 8 held; 4-7 healthy
    assert (r1["degrade"]["detections"], r1["degrade"]["stale_exchanges"],
            r1["degrade"]["exchanges_total"]) == (2, 2, 8)
    assert not r1["degrade"]["suspect"]
    assert r2["status"] == "failed" and "StateCorruption" in r2["error"]
    assert r2["degrade"]["detections"] == 1
    # the mesh job equals the engine run directly with the same codes
    from repro_torch import make_engine
    from repro_torch.engines.base import spawn_seeds
    h = make_engine("lattice", L=6, seed=3, replicas=2, precision="int8",
                    mesh=make_mesh((2, 2, 2), axes), dim_axes=axes,
                    degrade="stale_hold:8", device="cpu")
    h.eng.set_exchange_faults(plan.exchange_codes(8))
    _, rec = h.run_recorded(h.init_state_packed(spawn_seeds(4, 2)),
                            ea_schedule(16), [2, 4, 6, 8, 10, 12, 14, 16],
                            sync_every=2)
    np.testing.assert_array_equal(r1["energies"], rec.energies.numpy())
    assert r1["flips"] == rec.flips
    assert h.eng.health.report() == r1["degrade"]


def test_server_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SampleServer()
    assert SampleServer(device="cpu").device == torch.device("cpu")


def test_classify_error_on_device_errors():
    from repro_torch.kernels._build import KernelError
    from repro_torch.serve.faults import classify_error
    assert classify_error(KernelError("nvcc failed on [x.cu]")) == \
        "permanent"
    assert classify_error(KernelError("CUDA launch of k failed")) == \
        "permanent"
    assert classify_error(RuntimeError(
        "CUDA error: an illegal memory access was encountered")) == \
        "permanent"
    assert classify_error(torch.cuda.OutOfMemoryError("out of memory")) \
        == "transient"
    assert classify_error(RuntimeError("something else")) == "transient"


def test_corrupt_pytree_on_tensors():
    from repro_torch.core.lattice_dsim import LatticeState
    from repro_torch.serve.faults import corrupt_pytree
    st = LatticeState(
        m=torch.tensor([[1, -1]], dtype=torch.int8),
        s=torch.tensor([1, 2], dtype=torch.int32).view(torch.uint32),
        halos=(torch.tensor([True, False]),),
        sweep=torch.tensor(3, dtype=torch.int32),
        flips=torch.tensor([0.5]))
    bad = corrupt_pytree(st)
    assert bad.m.tolist() == [[1 ^ 0x55, -1 ^ 0x55]]
    assert bad.s.view(torch.int32).tolist() == [1 ^ 0x55555555,
                                                2 ^ 0x55555555]
    assert bad.halos[0].tolist() == [False, True]
    assert int(bad.sweep) == 3 ^ 0x55555555
    assert torch.isnan(bad.flips).all()
