"""Serving walkthrough on the PyTorch/CUDA port: the async sampling server
end to end.

The port of ``examples/serve_sampling.py``, with
``repro_torch.serve.SampleServer`` building its engines on the card:

  1. register problems, prewarm the engine pool (cold starts off the
     serving path),
  2. submit a burst of concurrent jobs across two problems and two engines
     — compatible requests coalesce into batched replica-packed engine
     calls (watch ``engine_calls`` vs jobs submitted),
  3. stream a long-running anneal with ``poll`` (partial energy trace,
     best-so-far configuration, exact flips, mid-anneal),
  4. preempt it with a high-priority job, cancel a queued one,
  5. read the final payloads and the scheduler/pool counters,
  6. crash mid-anneal and recover: a checkpointing server is abandoned
     between chunks, a fresh server adopts its spool with ``recover()``,
     and the resumed results come out bitwise-identical to a run that
     was never interrupted.

  PYTHONPATH=src python examples/torch_serve_sampling.py [--device cpu]
"""

import argparse
import shutil
import tempfile
import time

import numpy as np

from repro_torch.core.coloring import lattice3d_coloring
from repro_torch.core.device import resolve_device
from repro_torch.core.graph import ea3d
from repro_torch.serve import SampleServer


def run(device="cuda", sweeps=512, long_sweeps=8192, stream_at=1024):
    """The reference's walkthrough on ``device``; returns the burst's
    jobs/s, the counters it printed and the crash/recover verdict."""
    device = resolve_device(device)
    srv = SampleServer(pool_capacity=8, max_replicas_per_call=16,
                       device=device)

    # -- 1. problems + prewarm ------------------------------------------------
    for name, L, seed in (("glass_a", 6, 1), ("glass_b", 7, 2)):
        g = ea3d(L, seed=seed, device=device)
        fp = srv.register_problem(name, graph=g,
                                  coloring=lattice3d_coloring(L), rng="lfsr")
        print(f"registered {name}: N={g.n}, fingerprint {fp}")
    srv.prewarm("glass_a", engine="gibbs", replicas=8, sweeps=sweeps,
                wait=True)  # the cold start lands before any request
    srv.start()             # serve on a background thread

    # -- 2. a burst of concurrent tenants ------------------------------------
    t0 = time.perf_counter()
    jobs = []
    for k in range(4):      # 4 compatible requests -> ONE batched call
        jobs.append(srv.submit("glass_a", engine="gibbs", sweeps=sweeps,
                               replicas=2, seed=k))
    for k in range(2):      # different problem+engine -> their own batch
        jobs.append(srv.submit("glass_b", engine="dsim", sweeps=sweeps,
                               replicas=2, seed=k, sync_every=4))
    for jid in jobs:
        r = srv.result(jid, timeout=300)
        print(f"{jid}: {r['status']}  best E = {r['best_energy']:9.1f}  "
              f"{r['flips']:,} flips  packed with {r['packed_with']} "
              f"co-tenants  (pool {'hit' if r['pool_hit'] else 'miss'})")
    burst_s = time.perf_counter() - t0
    s = srv.stats()
    print(f"--> {s['submitted']} jobs served by {s['engine_calls']} engine "
          f"calls (replica packing); pool {s['pool']['hits']} hits / "
          f"{s['pool']['misses']} misses")
    out = {"burst_jobs": len(jobs), "burst_seconds": burst_s,
           "jobs_per_s": len(jobs) / burst_s,
           "engine_calls": s["engine_calls"]}

    # -- 3./4. streaming, priorities, cancel ----------------------------------
    long_id = srv.submit("glass_a", engine="gibbs", sweeps=long_sweeps,
                         replicas=2, seed=77)
    victim = srv.submit("glass_b", engine="dsim", sweeps=long_sweeps // 2,
                        seed=78, sync_every=4)
    srv.cancel(victim)      # still queued -> cancelled immediately
    while True:
        p = srv.poll(long_id)
        if p["status"] != "queued" and (p["status"] != "running"
                                        or p["sweeps_done"] >= stream_at):
            break
        time.sleep(0.01)
    print(f"streaming {long_id}: {p['sweeps_done']}/{p['total_sweeps']} "
          f"sweeps, {len(p['times'])} trace points, best so far "
          f"{p['best_energy']:.1f}, {p['flips']:,} exact flips")
    hi = srv.submit("glass_a", engine="gibbs", sweeps=sweeps, replicas=2,
                    seed=79, priority=10)
    r = srv.result(hi, timeout=300)   # overtakes the long anneal
    print(f"high-priority {hi} finished ({r['status']}) while {long_id} at "
          f"{srv.poll(long_id)['sweeps_done']} sweeps; preemptions: "
          f"{srv.stats()['preemptions']}")
    r = srv.result(long_id, timeout=600)
    trace = r["energies"].min(axis=1)
    print(f"{long_id} done: E trace {np.round(trace[:4], 1)} ... "
          f"-> {trace[-1]:.1f}")
    print(f"cancelled {victim}: {srv.poll(victim)['status']}")
    out["preemptions"] = srv.stats()["preemptions"]
    out["victim"] = srv.poll(victim)["status"]

    srv.stop()
    final = {k: v for k, v in srv.stats().items() if not isinstance(v, dict)}
    print("\nfinal stats:", final)
    out["final"] = final

    # -- 6. crash, recover, resume -------------------------------------------
    out["recovered_bitwise"] = crash_recover_demo(device)
    return out


def crash_recover_demo(device):
    """Kill a checkpointing server mid-anneal; a fresh one resumes it.
    Returns whether every resumed job equals its uninterrupted run."""
    print("\n--- crash / recover / resume ---")
    g = ea3d(5, seed=3, device=device)
    col = lattice3d_coloring(5)

    def fresh(spool):
        s = SampleServer(pool_capacity=4, max_replicas_per_call=8,
                         spool_dir=spool, checkpoint_every=128,
                         device=device)
        s.register_problem("glass_c", graph=g, coloring=col, rng="lfsr")
        return s

    # the ground truth: the same two jobs on a server nobody crashes
    ref_srv = fresh(None)
    ref = {}
    for k in range(2):
        jid = ref_srv.submit("glass_c", engine="gibbs", sweeps=1024,
                             replicas=2, seed=40 + k)
        ref[k] = ref_srv.result(jid, timeout=300)
    ref_srv.drain()

    spool = tempfile.mkdtemp(prefix="serve_spool_")
    every = True
    try:
        # server A checkpoints every 128 sweeps... and "crashes" (it is
        # abandoned between pumps — a kill -9 lands in the same place,
        # see tests/test_torch_faults.py for the real-subprocess version)
        a = fresh(spool)
        for k in range(2):
            a.submit("glass_c", engine="gibbs", sweeps=1024, replicas=2,
                     seed=40 + k)
        while a.stats()["checkpoints_written"] < 2:
            a.pump()
        sa = a.stats()
        print(f"server A crashed with {sa['checkpoints_written']} "
              f"checkpoints spooled ({sa['spool']['nbytes']:,} bytes), "
              f"0/{sa['submitted']} jobs finished")
        del a

        # server B: re-register the problem, adopt the spool, drain
        b = fresh(spool)
        readmitted = b.recover()
        print(f"server B re-admitted {len(readmitted)} in-flight jobs")
        b.drain()
        for k, jid in enumerate(readmitted):
            r = b.poll(jid)
            same = (r["best_energy"] == ref[k]["best_energy"]
                    and np.array_equal(r["energies"], ref[k]["energies"])
                    and r["flips"] == ref[k]["flips"])
            print(f"{jid}: {r['status']}, resumed {r['resumed_sweeps']} "
                  f"sweeps from checkpoint, bitwise == uninterrupted run: "
                  f"{same}")
            assert same
            every = every and same
        print("spool after drain:", b.stats()["spool"])
    finally:
        shutil.rmtree(spool, ignore_errors=True)
    return every and len(readmitted) == 2


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    out = run(args.device)
    return out


if __name__ == "__main__":
    main()
