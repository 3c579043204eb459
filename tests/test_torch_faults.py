"""Fault tolerance of the port's server (``repro_torch.serve``), on the
CPU: the reference's ``tests/test_faults.py`` re-run against the port,
its imports taken from ``repro_torch`` and its graphs, engines and
servers on ``device="cpu"``.  Deterministic fault injection, poison-batch
bisection, retry/backoff, checkpoint resume, crash recovery, deadlines,
watchdog, and the engine-pool circuit breaker.

Every recovery path here is driven by a :class:`FaultPlan` — chosen chunk
indices, build steps, or boundary exchanges fail on command, so the tests
assert exact outcomes (which job failed, how many retries, bitwise-equal
traces) instead of sleeping and hoping."""

import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from repro_torch.core.coloring import lattice3d_coloring
from repro_torch.core.graph import ea3d
from repro_torch.engines import make_engine
from repro_torch.serve import (CheckpointSpool, CircuitOpen, EnginePool,
                         FaultPlan, FaultRule, PermanentFault, SampleServer,
                         StateCorruption, TransientFault, classify_error,
                         compute_backoff)

L = 5
SW = 64


@pytest.fixture(scope="module")
def problem():
    return ea3d(L, seed=1, device="cpu"), lattice3d_coloring(L)


def _server(problem, **kw):
    g, col = problem
    srv = SampleServer(device="cpu", **kw)
    srv.register_problem("pa", graph=g, coloring=col, rng="lfsr")
    return srv


def _reference(problem, seeds):
    """No-fault runs at the given seeds: the bitwise ground truth."""
    srv = _server(problem)
    ids = [srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=s)
           for s in seeds]
    srv.drain()
    return [srv.result(i) for i in ids]


def _assert_bitwise(r0, r):
    assert np.array_equal(r0["energies"], r["energies"])
    assert r0["flips"] == r["flips"]
    assert np.array_equal(r0["best_spins"], r["best_spins"])
    assert r0["best_energy"] == r["best_energy"]


# -- the harness itself --------------------------------------------------------

def test_fault_rule_validates():
    with pytest.raises(ValueError):
        FaultRule(site="nope")
    with pytest.raises(ValueError):
        FaultRule(site="chunk", action="explode")
    with pytest.raises(ValueError):
        FaultRule(site="chunk", kind="sideways")


def test_fault_plan_matching_and_budget():
    plan = FaultPlan([
        FaultRule(site="chunk", index=3, job="j1", times=2),
        FaultRule(site="build", key="gibbs", times=1),
    ])
    assert plan.fire("chunk", index=2, jobs=("j1",)) is None   # wrong index
    assert plan.fire("chunk", index=3, jobs=("j2",)) is None   # wrong job
    assert plan.fire("build", key=("pa", "dsim")) is None      # wrong key
    assert plan.fire("chunk", index=3, jobs=("j1",)) is not None
    assert plan.fire("build", key=("pa", "gibbs", 8)) is not None
    assert plan.fire("build", key=("pa", "gibbs", 8)) is None  # budget spent
    assert plan.fire("chunk", index=3, jobs=("j1", "j3")) is not None
    assert plan.fire("chunk", index=3, jobs=("j1",)) is None   # budget spent
    assert plan.fired == 3
    assert [e[0] for e in plan.events] == ["chunk", "build", "chunk"]


def test_fault_plan_after_and_apply_kinds():
    plan = FaultPlan([FaultRule(site="exchange", after=5, kind="permanent")])
    assert plan.fire("exchange", index=4) is None
    with pytest.raises(PermanentFault):
        plan.apply("exchange", index=7)
    plan2 = FaultPlan([FaultRule(site="chunk")])
    with pytest.raises(TransientFault):
        plan2.apply("chunk", index=0)


def test_fault_plan_rate_is_seeded_and_replayable():
    rules = [FaultRule(site="chunk", rate=0.3, times=None)]
    draws = []
    for plan in (FaultPlan(rules, seed=42), FaultPlan(rules, seed=42)):
        draws.append([plan.fire("chunk", index=i) is not None
                      for i in range(64)])
    assert draws[0] == draws[1]                 # same seed, same decisions
    assert 0 < sum(draws[0]) < 64               # actually probabilistic
    replay = FaultPlan(rules, seed=42).replay()
    assert [replay.fire("chunk", index=i) is not None
            for i in range(64)] == draws[0]


def test_classify_error_split():
    assert classify_error(TransientFault("x")) == "transient"
    assert classify_error(StateCorruption("x")) == "transient"
    assert classify_error(TimeoutError()) == "transient"
    assert classify_error(CircuitOpen("x")) == "transient"
    assert classify_error(ConnectionError()) == "transient"
    assert classify_error(PermanentFault("x")) == "permanent"
    assert classify_error(ValueError("x")) == "permanent"
    assert classify_error(TypeError("x")) == "permanent"
    assert classify_error(RuntimeError("x")) == "transient"   # unknown


def test_compute_backoff():
    assert compute_backoff(0, base=0.0) == 0.0          # disabled
    assert compute_backoff(5, base=0.0, jitter=1.0) == 0.0
    seq = [compute_backoff(k, base=0.1, cap=1.0, jitter=0.0)
           for k in range(6)]
    assert seq == [pytest.approx(v)
                   for v in (0.1, 0.2, 0.4, 0.8, 1.0, 1.0)]   # capped
    a = compute_backoff(2, base=0.1, jitter=0.5, seed=7)
    assert a == compute_backoff(2, base=0.1, jitter=0.5, seed=7)
    assert a != compute_backoff(2, base=0.1, jitter=0.5, seed=8)
    assert 0.4 <= a <= 0.6 * (1 + 1e-9)


# -- checkpoint spool ----------------------------------------------------------

def test_spool_put_load_supersede(tmp_path):
    sp = CheckpointSpool(str(tmp_path))
    d1 = sp.put({"token": ("t",), "sweeps_done": 8})
    assert sp.load(d1) == {"token": ("t",), "sweeps_done": 8}
    assert d1 == sp.put({"token": ("t",), "sweeps_done": 8})  # idempotent
    assert len(sp) == 1
    d2 = sp.put({"token": ("t",), "sweeps_done": 16}, replaces=d1)
    assert len(sp) == 1 and d2 != d1
    assert [d for d, _ in sp.records()] == [d2]


def test_spool_cap_evicts_oldest(tmp_path):
    blob = os.urandom(2048)
    sp = CheckpointSpool(str(tmp_path), max_bytes=5000)
    digests = []
    for i in range(4):
        digests.append(sp.put({"i": i, "blob": blob}))
        os.utime(sp._path(digests[-1]), (i, i))   # deterministic age order
    assert sp.evictions > 0 and sp.nbytes() <= 5000 + 3000
    kept = {d for d, _ in sp.records()}
    assert digests[-1] in kept                    # newest never evicted
    assert digests[0] not in kept


def test_spool_skips_unreadable(tmp_path):
    sp = CheckpointSpool(str(tmp_path))
    d = sp.put({"ok": True})
    with open(os.path.join(str(tmp_path), "garbage.ck"), "wb") as f:
        f.write(b"\x80\x05not a pickle")
    (tmp_path / "litter.tmp").write_bytes(b"x")
    assert [dd for dd, _ in sp.records()] == [d]


# -- cursor checkpoint/restore (engine layer) ---------------------------------

def test_cursor_checkpoint_restore_bitwise(problem):
    g, col = problem
    from repro_torch.core.annealing import ea_schedule
    sched, pts = ea_schedule(SW), [16, 32, 48, SW]
    h = make_engine("gibbs", g, coloring=col, replicas=2, rng="lfsr", device="cpu")
    cur = h.start_recorded(h.init_state(seed=3), sched, pts)
    while cur.sweeps_done < SW // 2:
        cur.advance(1)
    ck = pickle.loads(pickle.dumps(cur.checkpoint()))   # survives pickling
    while not cur.done:
        cur.advance(1)
    ref = cur.record()

    h2 = make_engine("gibbs", g, coloring=col, replicas=2, rng="lfsr", device="cpu")
    cur2 = h2.start_recorded(h2.init_state(seed=999), sched, pts)
    cur2.restore_checkpoint(ck)
    assert cur2.sweeps_done == ck["pos"]
    while not cur2.done:
        cur2.advance(1)
    got = cur2.record()
    assert np.array_equal(ref.times, got.times)
    assert np.array_equal(np.asarray(ref.energies), np.asarray(got.energies))
    assert ref.flips == got.flips
    # mismatched plan refuses to resume
    h3 = make_engine("gibbs", g, coloring=col, replicas=2, rng="lfsr", device="cpu")
    cur3 = h3.start_recorded(h3.init_state(seed=0), ea_schedule(SW * 2),
                             [SW * 2])
    with pytest.raises(ValueError):
        cur3.restore_checkpoint(ck)


# -- engine-pool circuit breaker ----------------------------------------------

def test_breaker_opens_fast_fails_and_half_opens():
    clk = [0.0]
    pool = EnginePool(4, breaker_threshold=2, breaker_cooldown_s=10.0,
                      clock=lambda: clk[0])
    calls = [0]

    def bad():
        calls[0] += 1
        raise RuntimeError("compile died")

    for _ in range(2):
        with pytest.raises(RuntimeError):
            pool.get(("k",), bad)
    assert calls[0] == 2
    with pytest.raises(CircuitOpen) as ei:
        pool.get(("k",), bad)
    assert calls[0] == 2                 # fast-fail: builder not called
    assert "compile died" in str(ei.value)
    s = pool.stats()
    assert s["failed_builds"] == 2 and s["fast_fails"] == 1
    assert s["open_circuits"] == 1 and "compile died" in s["last_error"]
    assert pool.breaker_state(("k",))["fails"] == 2
    clk[0] = 11.0                        # cooldown elapsed: half-open probe
    handle, hit = pool.get(("k",), lambda: "fresh")
    assert handle == "fresh" and not hit
    assert pool.breaker_state(("k",)) is None   # success closed it
    assert pool.stats()["open_circuits"] == 0


def test_prewarm_async_failure_surfaced_in_stats(problem):
    pool = EnginePool(4)

    def bad():
        raise RuntimeError("prewarm build exploded")

    t = pool.prewarm_async(("pk",), bad)
    t.join(timeout=120)
    assert not t.is_alive()
    assert t.error is not None
    s = pool.stats()
    assert s["failed_builds"] == 1
    assert "prewarm build exploded" in s["last_error"]
    # end-to-end: an injected build fault in SampleServer.prewarm shows in
    # SampleServer.stats() even when nobody joins the thread
    plan = FaultPlan([FaultRule(site="build", kind="permanent", times=2)])
    srv = _server(problem, fault_plan=plan)
    th = srv.prewarm("pa", engine="gibbs", replicas=2, sweeps=SW)
    th.join(timeout=120)
    assert not th.is_alive()
    ps = srv.stats()["pool"]
    assert ps["failed_builds"] >= 1 and "injected" in ps["last_error"]
    with pytest.raises(PermanentFault):
        srv.prewarm("pa", engine="gibbs", replicas=2, sweeps=SW, wait=True)


# -- poison-batch isolation ----------------------------------------------------

def test_poison_batch_bisect_isolates_culprit(problem):
    """The acceptance scenario: 8 packed jobs, one poisoned — exactly the
    poison job fails; the 7 innocents finish DONE, bitwise-equal to the
    no-fault run."""
    refs = _reference(problem, range(8))
    plan = FaultPlan([FaultRule(site="chunk", job="job-000003",
                                kind="permanent", times=None)])
    srv = _server(problem, max_replicas_per_call=16, fault_plan=plan)
    ids = [srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=s)
           for s in range(8)]
    srv.drain()
    assert [srv.poll(i)["status"] for i in ids] == \
        ["done"] * 3 + ["failed"] + ["done"] * 4
    assert "PermanentFault" in srv.poll(ids[3])["error"]
    for k, (jid, r0) in enumerate(zip(ids, refs)):
        if k != 3:
            _assert_bitwise(r0, srv.result(jid))
    s = srv.stats()
    assert s["completed"] == 7 and s["failed"] == 1
    assert s["quarantined_batches"] >= 1 and s["bisect_requeues"] >= 2
    assert s["bisect_calls_left"] >= 0
    assert s["queue_depth"] == 0 and s["inflight_batches"] == 0


def test_bisect_isolated_transient_culprit_retries(problem):
    """Bisection narrows to the culprit; if its fault was transient with
    budget left, the culprit itself retries solo and completes too."""
    refs = _reference(problem, range(4))
    plan = FaultPlan([FaultRule(site="chunk", job="job-000002",
                                kind="transient", times=3)])
    srv = _server(problem, max_replicas_per_call=16, fault_plan=plan,
                  max_retries=3)
    ids = [srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=s)
           for s in range(4)]
    srv.drain()
    assert all(srv.poll(i)["status"] == "done" for i in ids)
    for jid, r0 in zip(ids, refs):
        _assert_bitwise(r0, srv.result(jid))
    assert srv.poll(ids[2])["retries"] >= 1


def test_fail_batch_accounting_when_bisect_disabled(problem):
    """_fail_batch direct coverage: with no bisect budget a poisoned
    packed batch fails every tenant — per-job error strings, correct
    stats, clean queue/_batches bookkeeping, and the server still serves
    afterwards."""
    plan = FaultPlan([FaultRule(site="chunk", kind="permanent")])
    srv = _server(problem, max_replicas_per_call=16, fault_plan=plan,
                  max_bisect_calls=0, max_retries=0)
    ids = [srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=s)
           for s in range(3)]
    srv.drain()
    for jid in ids:
        p = srv.poll(jid)
        assert p["status"] == "failed"
        assert p["error"] == ("PermanentFault: injected permanent fault "
                              "at chunk[0]")
    s = srv.stats()
    assert s["failed"] == 3 and s["completed"] == 0
    assert s["queue_depth"] == 0 and s["inflight_batches"] == 0
    assert len(srv._batches) == 0 and len(srv._queue) == 0
    # the server is not wedged: later work completes normally
    jid = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=9)
    srv.drain()
    assert srv.result(jid)["status"] == "done"
    assert srv.stats()["failed"] == 3 and srv.stats()["completed"] == 1


# -- retry policy --------------------------------------------------------------

def test_transient_retry_resumes_from_checkpoint(problem):
    [r0] = _reference(problem, [7])
    plan = FaultPlan([FaultRule(site="chunk", index=3)])
    srv = _server(problem, fault_plan=plan, checkpoint_every=SW // 8)
    jid = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=7)
    srv.drain()
    r = srv.result(jid)
    assert r["status"] == "done" and r["retries"] == 1
    assert r["resumed_sweeps"] > 0 and r["restarted_sweeps"] == 0
    _assert_bitwise(r0, r)
    s = srv.stats()
    assert s["retries"] == 1 and s["checkpoints_resumed"] == 1
    assert s["checkpoints_written"] >= 1 and s["faults_injected"] == 1


def test_transient_retry_without_checkpoint_restarts(problem):
    [r0] = _reference(problem, [7])
    plan = FaultPlan([FaultRule(site="chunk", index=3)])
    srv = _server(problem, fault_plan=plan)      # checkpointing off
    jid = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=7)
    srv.drain()
    r = srv.result(jid)
    assert r["status"] == "done" and r["retries"] == 1
    assert r["restarted_sweeps"] > 0 and r["resumed_sweeps"] == 0
    _assert_bitwise(r0, r)


def test_permanent_fault_never_retries(problem):
    plan = FaultPlan([FaultRule(site="chunk", kind="permanent")])
    srv = _server(problem, fault_plan=plan, max_retries=5)
    jid = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=7)
    srv.drain()
    p = srv.poll(jid)
    assert p["status"] == "failed" and p["retries"] == 0
    assert "PermanentFault" in p["error"]
    assert srv.stats()["retries"] == 0


def test_retry_budget_exhausts(problem):
    plan = FaultPlan([FaultRule(site="chunk", times=None)])  # always fails
    srv = _server(problem, fault_plan=plan)
    jid = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=7,
                     max_retries=2)
    srv.drain()
    p = srv.poll(jid)
    assert p["status"] == "failed" and p["retries"] == 2
    assert "TransientFault" in p["error"]
    assert srv.stats()["retries"] == 2


def test_backoff_gates_retry_and_pump_stays_live(problem):
    plan = FaultPlan([FaultRule(site="chunk", index=1)])
    srv = _server(problem, fault_plan=plan, retry_backoff_s=0.03,
                  retry_jitter=0.0)
    jid = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=7)
    # drive manually: after the injected failure the job is queued but
    # gated; pump() must keep returning True (runnable work exists) until
    # the gate opens, never False (which would end drain() early)
    while srv.poll(jid)["retries"] == 0:
        assert srv.pump()
    job = srv._jobs[jid]
    assert job.next_eligible_at > 0.0
    srv.drain()
    assert srv.result(jid)["status"] == "done"


def test_injected_build_fault_trips_pool_breaker(problem):
    plan = FaultPlan([FaultRule(site="build", times=None)])
    srv = _server(problem, fault_plan=plan, max_retries=1,
                  breaker_threshold=2, breaker_cooldown_s=3600.0)
    jid = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=7)
    srv.drain()
    p = srv.poll(jid)
    assert p["status"] == "failed" and p["retries"] == 1
    s = srv.stats()["pool"]
    assert s["failed_builds"] == 2 and "injected" in s["last_error"]
    # the circuit is now open: the next submit fast-fails without a build
    j2 = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=8,
                    max_retries=0)
    srv.drain()
    assert "CircuitOpen" in srv.poll(j2)["error"]
    assert srv.stats()["pool"]["fast_fails"] >= 1


# -- deadlines and watchdog ----------------------------------------------------

def test_running_deadline_fails_job_spares_packmates(problem):
    refs = _reference(problem, [0, 1])
    srv = _server(problem, max_replicas_per_call=16)
    a = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=0)
    b = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=1,
                   deadline_s=0.0)
    srv.pump()                    # starts the packed batch, first chunk
    srv.drain()
    pb = srv.poll(b)
    assert pb["status"] == "failed" and "DeadlineExceeded" in pb["error"]
    assert pb["sweeps_done"] < SW
    ra = srv.result(a)            # packmate unharmed, still bitwise-clean
    assert ra["status"] == "done"
    _assert_bitwise(refs[0], ra)
    assert srv.stats()["deadline_failures"] == 1


def test_queued_deadline_expires_before_running(problem):
    srv = _server(problem)
    jid = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=0,
                     deadline_s=0.0)
    # the expiry happens inside the scheduling step; with nothing left to
    # run afterwards, that same pump reports no runnable work
    assert srv.pump() is False
    p = srv.poll(jid)
    assert p["status"] == "failed" and "DeadlineExceeded" in p["error"]
    assert p["sweeps_done"] == 0
    assert srv.stats()["deadline_failures"] == 1
    with pytest.raises(ValueError):
        srv.submit("pa", sweeps=SW, deadline_s=-1.0)


def test_watchdog_marks_stuck_chunk_suspect(problem):
    plan = FaultPlan([FaultRule(site="chunk", action="hang", index=2,
                                hang_s=0.05)])
    srv = _server(problem, fault_plan=plan, chunk_timeout_s=0.02)
    jid = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=7)
    srv.drain()
    assert srv.result(jid)["status"] == "done"   # slow, not failed
    s = srv.stats()
    assert s["stuck_chunks"] >= 1
    assert s["pool"]["suspect_keys"] == 1
    key, reason = next(iter(srv.pool.suspects().items()))
    assert "chunk_timeout_s" in reason
    assert srv.pool.clear_suspect(key)
    assert srv.stats()["pool"]["suspect_keys"] == 0


# -- corruption ----------------------------------------------------------------

def test_corruption_detected_and_repaired_from_checkpoint(problem):
    [r0] = _reference(problem, [7])
    plan = FaultPlan([FaultRule(site="chunk", action="corrupt", index=4)])
    srv = _server(problem, fault_plan=plan, checkpoint_every=SW // 8)
    jid = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=7)
    srv.drain()
    r = srv.result(jid)
    assert r["status"] == "done" and r["retries"] == 1
    _assert_bitwise(r0, r)
    s = srv.stats()
    assert s["corrupted_chunks"] == 1 and s["checkpoints_resumed"] == 1


# -- crash recovery ------------------------------------------------------------

_CHILD = """
import os, sys
sys.path.insert(0, {src!r})
from repro_torch.core.coloring import lattice3d_coloring
from repro_torch.core.graph import ea3d
from repro_torch.serve import SampleServer
g, col = ea3d({L}, seed=1, device="cpu"), lattice3d_coloring({L})
srv = SampleServer(device="cpu", spool_dir={spool!r}, checkpoint_every={ck})
srv.register_problem("pa", graph=g, coloring=col, rng="lfsr")
for s in (7, 8):
    print(srv.submit("pa", engine="gibbs", sweeps={SW}, replicas=2, seed=s),
          flush=True)
while srv.stats()["checkpoints_written"] < 3:
    srv.pump()
os.kill(os.getpid(), 9)      # no atexit, no cleanup: a real crash
"""


def test_kill9_recover_resumes_bitwise(problem, tmp_path):
    """The acceptance scenario: kill -9 a serving process mid-anneal;
    recover() re-admits every in-flight job from its last checkpoint and
    the finished results are bitwise-identical to an uninterrupted run."""
    spool = str(tmp_path / "spool")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    child = _CHILD.format(src=os.path.abspath(src), L=L, SW=SW,
                          spool=spool, ck=SW // 8)
    p = subprocess.run([sys.executable, "-c", child], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == -9, p.stderr
    ids = p.stdout.split()
    assert len(ids) == 2
    assert len(CheckpointSpool(spool)) >= 1      # durable checkpoints exist

    refs = _reference(problem, [7, 8])
    srv = _server(problem, spool_dir=spool, checkpoint_every=SW // 8)
    got = srv.recover()
    assert sorted(got) == sorted(ids)
    for jid in got:                       # partial progress was recovered
        assert srv.poll(jid)["sweeps_done"] > 0
    srv.drain()
    for jid, r0 in zip(ids, refs):
        r = srv.result(jid)
        assert r["status"] == "done" and r["resumed_sweeps"] > 0
        _assert_bitwise(r0, r)
    s = srv.stats()
    assert s["recovered_jobs"] == 2 and s["checkpoints_resumed"] >= 1
    assert len(CheckpointSpool(spool)) == 0      # done jobs left no litter
    assert srv.recover() == []                   # idempotent


def test_recover_refuses_unregistered_or_mismatched_problem(problem,
                                                            tmp_path):
    spool = str(tmp_path / "spool")
    srv = _server(problem, spool_dir=spool, checkpoint_every=SW // 8)
    jid = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=7)
    while srv.stats()["checkpoints_written"] < 1:
        srv.pump()
    del jid

    fresh = SampleServer(device="cpu", spool_dir=spool)
    with pytest.raises(RuntimeError, match="not registered"):
        fresh.recover()
    g2, col2 = ea3d(L, seed=99, device="cpu"), lattice3d_coloring(L)   # different instance
    fresh.register_problem("pa", graph=g2, coloring=col2, rng="lfsr")
    with pytest.raises(RuntimeError, match="fingerprint"):
        fresh.recover()


# -- result(timeout=) ----------------------------------------------------------

def test_result_timeout_default_leaves_job_running(problem):
    srv = _server(problem)
    jid = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=7)
    with pytest.raises(TimeoutError):
        srv.result(jid, timeout=0.0)
    assert srv.poll(jid)["status"] == "queued"   # untouched by default
    srv.drain()
    assert srv.result(jid)["status"] == "done"


def test_result_cancel_on_timeout_cancels(problem):
    srv = _server(problem)
    jid = srv.submit("pa", engine="gibbs", sweeps=SW, replicas=2, seed=7)
    with pytest.raises(TimeoutError):
        srv.result(jid, timeout=0.0, cancel_on_timeout=True)
    srv.drain()
    assert srv.poll(jid)["status"] == "cancelled"
    assert srv.stats()["cancelled"] == 1
