"""Live serving dashboard on the PyTorch/CUDA port: goodput, latency
percentiles, and measured η.

The port of ``examples/serve_dashboard.py`` (``repro_torch.obs``): a
background thread keeps submitting mixed gibbs/dsim jobs to a
:class:`repro_torch.serve.SampleServer` on the card while the foreground
loop prints, once a second, what the machine says about itself —

  * goodput (completed jobs and the per-engine flips/s gauges),
  * queue depth and queue-wait / pump-chunk p50/p99 from the registry's
    fixed-bucket histograms,
  * retry / bisect / breaker counters,
  * measured η = f_comm/f_pbit from :func:`repro_torch.obs.eta_probe`
    (a bit-plane ``dsim_dist`` run, the ELL word gather-count kernel)
    against the commcost threshold.

Ends with the degraded-mode stanza — a mesh job under
``degrade_policy="stale_hold:8"`` with an injected boundary-exchange
drop, its ``degrade`` provenance and the integrity counters — and the
Prometheus text exposition head.

  PYTHONPATH=src python examples/torch_serve_dashboard.py [--device cpu]
"""

import argparse
import threading
import time

import numpy as np

from repro_torch.core.coloring import lattice3d_coloring
from repro_torch.core.device import resolve_device
from repro_torch.core.graph import ea3d
from repro_torch.core.mesh import make_mesh
from repro_torch.obs import eta_probe
from repro_torch.serve import SampleServer
from repro_torch.serve.faults import FaultPlan, FaultRule

TICKS = 8          # dashboard refreshes
JOBS_PER_TICK = 4
ETA_PROBE = dict(L=4, sweeps=32)   # the measured-eta probe's size


def _hist_line(snap: dict, family: str) -> str:
    """One-line p50/p99 summary over every labeled series of a family."""
    out = []
    for s in snap.get(family, {}).get("series", []):
        if not s.get("count"):
            continue
        eng = s["labels"].get("engine", "all")
        out.append(f"{eng} p50={s['p50'] * 1e3:.1f}ms "
                   f"p99={s['p99'] * 1e3:.1f}ms (n={s['count']})")
    return "; ".join(out) or "no samples yet"


def run(device="cuda", ticks=TICKS, jobs_per_tick=JOBS_PER_TICK,
        tick_s=1.0):
    """The reference's dashboard on ``device``; returns the last goodput,
    the measured η and the degraded job's provenance."""
    device = resolve_device(device)
    srv = SampleServer(pool_capacity=8, max_replicas_per_call=16,
                       device=device)
    g = ea3d(5, seed=4, device=device)
    srv.register_problem("glass", graph=g,
                         coloring=lattice3d_coloring(5), rng="lfsr")
    srv.prewarm("glass", engine="gibbs", replicas=4, sweeps=256, wait=True)
    srv.start()

    # measured η rides alongside: a one-partition dsim_dist probe with the
    # EtaMeter attached (per-chunk wall time + exchange-only time),
    # margin vs the commcost threshold of a reference 2-way slab cut
    eta = eta_probe(**ETA_PROBE, device=device)

    stop = threading.Event()

    def offer():
        seed = 0
        while not stop.is_set():
            for _ in range(jobs_per_tick):
                eng, sync = (("gibbs", 1) if seed % 2 else ("dsim", 4))
                srv.submit("glass", engine=eng, sweeps=128, replicas=2,
                           seed=seed, sync_every=sync)
                seed += 1
            time.sleep(0.3 * tick_s)

    t = threading.Thread(target=offer, daemon=True)
    t.start()

    done0, t0 = srv.completed, time.perf_counter()
    goodput = 0.0
    for tick in range(ticks):
        time.sleep(tick_s)
        s = srv.stats()
        snap = srv.metrics_snapshot()
        goodput = (s["completed"] - done0) / (time.perf_counter() - t0)
        flips = {f"{e['labels']['engine']}": e["value"]
                 for e in snap.get("engine_flips_per_s", {}).get(
                     "series", [])}
        print(f"[tick {tick}] goodput {goodput:6.2f} done-jobs/s | "
              f"queue {s['queue_depth']:3d} | "
              f"retries {s['retries']} bisects {s['bisect_requeues']} "
              f"open-circuits {s['pool']['open_circuits']}")
        print(f"   queue-wait: {_hist_line(snap, 'serve_queue_wait_seconds')}")
        print(f"   pump-chunk: {_hist_line(snap, 'serve_pump_chunk_seconds')}")
        print(f"   flips/s: " + (", ".join(
            f"{k}={v:.3g}" for k, v in flips.items()) or "warming"))
        print(f"   measured η {eta['measured_eta']:.1f} "
              f"(f_comm {eta['f_comm_hz']:.3g} Hz, "
              f"f_pbit {eta['f_pbit_hz']:.3g} Hz) vs threshold "
              f"{eta['eta_threshold']:.0f} -> margin {eta['margin']:.3f}")

    stop.set()
    t.join()
    srv.drain()
    srv.stop()

    # -- degraded mode: a mesh job surviving a dropped boundary exchange --
    # A fresh K=1 dsim_dist server with a deterministic fault plan that
    # drops the last of the job's 8 exchanges; stale_hold keeps annealing
    # on the held ghost region and the result carries the quarantine mark.
    print("\n-- degraded-mode mesh (stale_hold vs a dropped exchange) --")
    plan = FaultPlan([FaultRule(site="exchange_drop", index=7)], seed=4)
    dsrv = SampleServer(warm_compile=False, fault_plan=plan, device=device)
    dsrv.register_problem("glass1", graph=g,
                          coloring=lattice3d_coloring(5), K=1,
                          labels=np.zeros(g.n, np.int32),
                          mesh=make_mesh((1,), ("data",)), rng="lfsr")
    jid = dsrv.submit("glass1", engine="dsim_dist", precision="int8",
                      sweeps=32, sync_every=4, seed=3,
                      degrade_policy="stale_hold:8")
    out = dsrv.drain().result(jid)
    deg = out["degrade"]
    ds = dsrv.stats()
    print(f"   job {out['status']} under {deg['policy']}: "
          f"{deg['detections']} detection(s), "
          f"{deg['stale_exchanges']}/{deg['exchanges_total']} held, "
          f"delivered {deg['delivered_fraction']:.3f}, "
          f"suspect={deg['suspect']}")
    print(f"   counters: integrity-failures "
          f"{ds['exchange_integrity_failures']}, "
          f"stale {ds['stale_exchanges']}, resyncs {ds['mesh_resyncs']}")
    dsrv.stop()

    print("\n-- Prometheus exposition (head) --")
    head = srv.render_metrics().splitlines()[:20]
    print("\n".join(head))
    return {"jobs_per_s": goodput, "completed": srv.completed,
            "eta": {k: eta[k] for k in ("measured_eta", "f_comm_hz",
                                        "f_pbit_hz", "eta_threshold",
                                        "margin")},
            "degrade": {k: deg[k] for k in ("policy", "detections",
                                            "stale_exchanges",
                                            "exchanges_total",
                                            "delivered_fraction",
                                            "suspect")},
            "job_status": out["status"], "prometheus_head": len(head)}


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
