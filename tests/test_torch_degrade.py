"""The degraded mesh: both mesh engines with a degrade policy, against the
JAX reference on forced host devices.

One reference subprocess (``XLA_FLAGS`` forcing 8 host devices, a plain
``jax.sharding.Mesh`` as in ``tests/test_torch_mesh.py``) runs every case
of ``LATTICE`` and ``DIST`` chunk by chunk through the reference's
recorded cursor, with the case's fault codes armed through
``set_exchange_faults``, and writes the state (after the last chunk, or
before the chunk whose health check raised ``StateCorruption``), the
record-point energies, the flips, the sweep it stopped at and the health
monitor's report.  ``dsim_dist`` starts from the port's initial state (the
reference draws its spins with ``jax.random``).  The port runs each case
on the CPU, every brick or partition in one process, and is held to it:
on int8 and bit-plane bitwise (spins, LFSR states, halos or ghosts,
flips, energies, the report, where it raised); on f32 the LFSR states,
the report and where it raised.

In-process checks follow: the checksum against the reference's on int8,
f32 and uint32 payloads, the policy vocabulary, the monitor's report and
escalations, checked runs without faults bitwise the unchecked ones,
``resync``, the exchange closure dropped on restore, and the guards.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.core import degrade as j_deg
from repro_torch import make_engine as t_make
from repro_torch.core import degrade as t_deg
from repro_torch.core import graph as t_graph
from repro_torch.core.annealing import ea_schedule
from repro_torch.core.coloring import lattice3d_coloring
from repro_torch.core.dsim import build_partitioned
from repro_torch.core.mesh import make_mesh
from repro_torch.core.partition import slab_partition
from repro_torch.interop import state_to_numpy
from repro_torch.serve.faults import (FaultPlan, FaultRule, StateCorruption,
                                      classify_error)
from test_torch_mesh import run_reference

CPU = dict(device="cpu")
AXES = ("x", "y", "z")
SWEEPS, POINTS, SEED, INIT_SEED = 16, [8, 16], 1, 3

# name: (L, mesh shape, precision, R, sync_every, policy, codes, bitpack)
LATTICE = {
    "x2-int8-hold-clean": (4, (2, 1, 1), "int8", 3, 2, "stale_hold:4",
                           None, True),
    "x2-int8-hold-codes": (4, (2, 1, 1), "int8", 3, 2, "stale_hold:4",
                           [0, 0, 1, 0, 2, 0, 0, 0], True),
    "xyz-int8-freeze-codes": (6, (2, 2, 2), "int8", 2, 2, "freeze_boundary",
                              [0, 0, 2], True),
    "xyz-int8-hold-unpacked": (6, (2, 2, 2), "int8", 2, 2, "stale_hold:4",
                               [0, 2, 0, 1], False),
    "y2-int8-failfast": (6, (1, 2, 1), "int8", 2, 2, "fail_fast",
                         [0, 0, 0, 0, 0, 2], True),
    "y2-int8-hold-budget": (6, (1, 2, 1), "int8", 2, 1, "stale_hold:1",
                            [0, 0, 1, 1, 1], True),
    "z2-bitplane40-hold-codes": (6, (1, 1, 2), "bitplane", 40, 2,
                                 "stale_hold:8", [0, 1, 0, 2, 2, 0], True),
    "xyz-bitplane5-freeze": (6, (2, 2, 2), "bitplane", 5, 4,
                             "freeze_boundary", [0, 2], True),
    "x2-bitplane5-failfast": (4, (2, 1, 1), "bitplane", 5, 2, "fail_fast",
                              [0, 1], True),
    "x2-f32-hold-codes": (6, (2, 1, 1), "f32", 2, 2, "stale_hold:4",
                          [0, 1, 2], True),
}
# name: (K, precision, R, sync_every, policy, codes, bitpack)
DIST = {
    "slab2-int8-hold-clean": (2, "int8", 3, 4, "stale_hold:4", None, True),
    "slab2-int8-freeze-codes": (2, "int8", 3, 2, "freeze_boundary",
                                [0, 0, 2], True),
    "slab4-int8-hold-codes": (4, "int8", 2, 2, "stale_hold:4",
                              [0, 2, 1, 0, 0, 2], True),
    "slab2-int8-failfast": (2, "int8", 2, 2, "fail_fast",
                            [0, 0, 0, 0, 0, 2], True),
    "slab2-bitplane40-hold-codes": (2, "bitplane", 40, 2, "stale_hold:8",
                                    [0, 1, 0, 2], True),
    "slab4-bitplane5-freeze": (4, "bitplane", 5, 4, "freeze_boundary",
                               [0, 1], True),
    "slab2-f32-hold-codes": (2, "f32", 3, 2, "stale_hold:4", [0, 2, 0, 1],
                             True),
    "slab2-f32-unpacked-budget": (2, "f32", 2, 2, "stale_hold:1",
                                  [0, 1, 2, 0], False),
}

REFERENCE = """
import json, sys, warnings
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import graph as jg
from repro.core.annealing import ea_schedule
from repro.core.coloring import lattice3d_coloring
from repro.core.degrade import StateCorruption
from repro.core.dsim import DSIMState, build_partitioned
from repro.core.partition import slab_partition
from repro.engines.registry import make_engine

out, lattice, dist = sys.argv[1], json.loads(sys.argv[2]), \\
    json.loads(sys.argv[3])
devs = jax.devices()

def drive(name, h, st, sync, codes):
    h.eng.set_exchange_faults(codes)
    cur = h.start_recorded(st, ea_schedule(%(sweeps)d), %(points)r,
                           sync_every=sync)
    raised = False
    while not cur.done:
        try:
            cur.advance(1)
        except StateCorruption:
            raised = True
            break
    st = cur._c.state
    rec = cur.record()
    d = {f: np.asarray(getattr(st, f)) for f in ("m", "s", "ghosts",
         "macc", "rng", "sweep", "flips") if hasattr(st, f)}
    for i, hh in enumerate(getattr(st, "halos", ())):
        d[f"halo{i}"] = np.asarray(hh)
    e = np.asarray(rec.energies) if len(rec.times) else np.zeros((0,))
    np.savez(f"{out}/{name}-out.npz", energies=e, total_flips=rec.flips,
             sweeps_done=cur.sweeps_done, **d)
    return dict(raised=raised, report=h.eng.health.report())

meta = {}
for name, (L, shape, prec, R, sync, pol, codes, bp) in lattice.items():
    n = int(np.prod(shape))
    mesh = Mesh(np.asarray(devs[:n]).reshape(shape), ("x", "y", "z"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        h = make_engine("lattice", L=L, seed=%(seed)d, replicas=R,
                        precision=prec, impl="ref", mesh=mesh,
                        dim_axes=("x", "y", "z"), bitpack_halos=bp,
                        degrade=pol)
    meta[name] = drive(name, h, h.init_state(seed=%(init_seed)d), sync,
                       codes)

for name, (K, prec, R, sync, pol, codes, bp) in dist.items():
    mesh = Mesh(np.asarray(devs[:K]), ("data",))
    prob = build_partitioned(jg.ea3d(4, seed=7), lattice3d_coloring(4),
                             slab_partition(4, K), K)
    h = make_engine("dsim_dist", prob, mesh=mesh, rng="lfsr", bitpack=bp,
                    replicas=R, precision=prec, degrade=pol)
    z = np.load(f"{out}/{name}-in.npz")
    st = h.eng.shard_state(DSIMState(**{f: jnp.asarray(z[f]) for f in
                                        ("m", "ghosts", "macc", "rng",
                                         "sweep", "flips")}))
    meta[name] = drive(name, h, st, sync, codes)

with open(f"{out}/meta.json", "w") as f:
    json.dump(meta, f)
""" % dict(sweeps=SWEEPS, points=POINTS, seed=SEED, init_seed=INIT_SEED)


def lattice_handle(name, policy=None, **kw):
    L, shape, prec, R, sync, pol, codes, bp = LATTICE[name]
    return t_make("lattice", L=L, seed=SEED, replicas=R, precision=prec,
                  mesh=make_mesh(shape, AXES), dim_axes=AXES,
                  bitpack_halos=bp, degrade=policy, **CPU, **kw)


def dist_handle(name, policy=None):
    K, prec, R, sync, pol, codes, bp = DIST[name]
    prob = build_partitioned(t_graph.ea3d(4, seed=7, **CPU),
                             lattice3d_coloring(4), slab_partition(4, K), K)
    return t_make("dsim_dist", prob, rng="lfsr", bitpack=bp, replicas=R,
                  precision=prec, degrade=policy, **CPU)


def drive(h, st, sync, codes):
    """The reference script's ``drive`` on the port: chunk by chunk, the
    state after the last chunk or before the one that raised."""
    h.eng.set_exchange_faults(codes)
    cur = h.start_recorded(st, ea_schedule(SWEEPS), POINTS,
                           sync_every=sync)
    raised = False
    while not cur.done:
        try:
            cur.advance(1)
        except t_deg.StateCorruption:
            raised = True
            break
    return cur, raised


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("degrade_ref")
    for name in DIST:
        h = dist_handle(name)
        np.savez(out / f"{name}-in.npz",
                 **state_to_numpy(h.init_state(seed=INIT_SEED)))
    run_reference(REFERENCE, [str(out), json.dumps(LATTICE),
                              json.dumps(DIST)])
    return out, json.loads((out / "meta.json").read_text())


def _check(reference, name, h, cur, raised, fields, f32):
    out, meta = reference
    ref = np.load(out / f"{name}-out.npz")
    assert raised == meta[name]["raised"]
    assert cur.sweeps_done == int(ref["sweeps_done"])
    assert h.eng.health.report() == meta[name]["report"]
    got = state_to_numpy(h.eng.global_state(cur.state))
    for f in (("s", "rng", "sweep") if f32 else fields):
        if f not in got or f not in ref:
            continue
        assert got[f].dtype == ref[f].dtype, f
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    if f32:
        return
    for i, hh in enumerate(got.get("halos", ())):
        np.testing.assert_array_equal(hh, ref[f"halo{i}"],
                                      err_msg=f"halo {i}")
    rec = cur.record()
    if len(rec.times):
        np.testing.assert_array_equal(rec.energies.numpy(),
                                      ref["energies"])
    assert rec.flips == int(ref["total_flips"])


@pytest.mark.parametrize("name", list(LATTICE))
def test_lattice_degraded_matches_reference(reference, name):
    L, shape, prec, R, sync, pol, codes, bp = LATTICE[name]
    h = lattice_handle(name, pol)
    cur, raised = drive(h, h.init_state(seed=INIT_SEED), sync, codes)
    _check(reference, name, h, cur, raised, ("m", "s", "sweep", "flips"),
           prec == "f32")
    if codes is not None:
        assert h.eng.health.detections > 0


@pytest.mark.parametrize("name", list(DIST))
def test_dist_degraded_matches_reference(reference, name):
    K, prec, R, sync, pol, codes, bp = DIST[name]
    h = dist_handle(name, pol)
    cur, raised = drive(h, h.init_state(seed=INIT_SEED), sync, codes)
    _check(reference, name, h, cur, raised,
           ("m", "ghosts", "macc", "rng", "sweep", "flips"), prec == "f32")
    if codes is not None:
        assert h.eng.health.detections > 0


def test_degraded_reports_name_the_injected_faults(reference):
    _, meta = reference
    rep = meta["slab2-int8-freeze-codes"]["report"]
    # a corrupt at exchange 2 of 8, then frozen: 6 held exchanges
    assert (rep["detections"], rep["stale_exchanges"],
            rep["staleness"], rep["suspect"]) == (1, 6, [6, 6], True)
    assert meta["y2-int8-failfast"]["raised"]
    assert meta["y2-int8-hold-budget"]["raised"]
    assert not meta["x2-int8-hold-codes"]["raised"]
    rep = meta["x2-int8-hold-codes"]["report"]
    assert (rep["detections"], rep["stale_exchanges"]) == (2, 2)
    assert rep["delivered_fraction"] == 0.75


# -- the checksum, the policy and the monitor, in process -------------------

def _payloads():
    rng = np.random.default_rng(0)
    return [rng.integers(-128, 128, (3, 40), dtype=np.int8),
            rng.standard_normal((4, 33)).astype(np.float32),
            rng.integers(0, 2 ** 32, (2, 70), dtype=np.uint64).astype(
                np.uint32),
            np.arange(64, dtype=np.int8) - 32]


def _tensor(a):
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).view(torch.uint32)
    return torch.from_numpy(a)


@pytest.mark.parametrize("i", range(4))
def test_wire_checksum_matches_reference(i):
    a = _payloads()[i]
    want = int(j_deg.wire_checksum(a))
    assert int(t_deg.wire_checksum(_tensor(a))) == want
    assert int(t_deg.wire_checksum(a)) == want           # numpy taken too
    rows = t_deg.wire_checksum(_tensor(a), batch_dims=1)
    assert rows.tolist() == [int(j_deg.wire_checksum(r)) for r in a]
    assert (np.asarray(t_deg.wire_words(_tensor(a)))
            == np.asarray(j_deg.wire_words(a)).astype(np.int64)).all()


def test_wire_checksum_detects_damage_and_reorder():
    a = np.arange(64, dtype=np.int8) - 32
    ck = int(t_deg.wire_checksum(torch.from_numpy(a)))
    flipped = a.copy()
    flipped[17] ^= 2
    perm = a.copy()
    perm[0], perm[1] = a[1], a[0]
    for b in (flipped, perm):
        got = int(t_deg.wire_checksum(torch.from_numpy(b)))
        assert got != ck and got == int(j_deg.wire_checksum(b))


@pytest.mark.parametrize("spec", ["stale_hold", "stale_hold:0",
                                  "stale_hold:12", "fail_fast",
                                  "freeze_boundary", None])
def test_policy_parse_and_key_match_reference(spec):
    t, j = t_deg.DegradePolicy.parse(spec), j_deg.DegradePolicy.parse(spec)
    if spec is None:
        assert t is None and j is None
        return
    assert (t.mode, t.max_staleness, t.key()) == \
        (j.mode, j.max_staleness, j.key())
    assert t_deg.DegradePolicy.parse(t.key()) == t
    assert t_deg.DegradePolicy.parse(t) is t


@pytest.mark.parametrize("spec,exc", [("best_effort", ValueError),
                                      ("stale_hold:nope", ValueError),
                                      ("fail_fast:3", ValueError),
                                      (3, TypeError)])
def test_policy_parse_rejects_like_reference(spec, exc):
    for mod in (t_deg, j_deg):
        with pytest.raises(exc):
            mod.DegradePolicy.parse(spec)
    with pytest.raises(ValueError):
        t_deg.DegradePolicy(mode="gibberish")
    with pytest.raises(ValueError):
        t_deg.DegradePolicy(max_staleness=-1)


# per policy: carries fed to both monitors in turn (seq, stale, frozen,
# det, held, maxst), with the exchanges of each chunk
_CARRIES = [
    ((4, [0, 0, 0], 0, 0, 0, 0), 4),
    ((8, [0, 2, 0], 0, 1, 2, 2), 4),
    ((12, [0, 0, 0], 0, 1, 2, 2), 4),
    ((16, [3, 0, 1], 1, 2, 5, 3), 4),
]


@pytest.mark.parametrize("policy", ["stale_hold:2", "stale_hold:8",
                                    "fail_fast", "freeze_boundary"])
def test_monitor_matches_reference(policy):
    mons = [mod.MeshHealthMonitor(mod.DegradePolicy.parse(policy), 3,
                                  kind="faces") for mod in (t_deg, j_deg)]
    for carry, ex in _CARRIES:
        seq, stale, *rest = carry
        host = (np.uint32(seq), np.asarray(stale, np.int32),
                *(np.int32(v) for v in rest))
        dev = (torch.tensor(seq), torch.tensor(stale),
               *(torch.tensor(v) for v in rest))
        errs = []
        for mon, c in zip(mons, (dev, host)):
            try:
                mon.update(c, exchanges=ex)
                errs.append(None)
            except Exception as e:          # noqa: BLE001
                errs.append(type(e).__name__)
        assert errs[0] == errs[1]
        assert mons[0].report() == mons[1].report()
        assert mons[0].suspect == mons[1].suspect
    for mon in mons:
        mon.on_resync()
    assert mons[0].report() == mons[1].report()
    assert not mons[0].suspect and mons[0].resyncs == 1
    fresh = t_deg.MeshHealthMonitor(t_deg.DegradePolicy(), 6, kind="faces")
    assert fresh.report() == j_deg.MeshHealthMonitor(
        j_deg.DegradePolicy(), 6, kind="faces").report()


def test_monitor_quiet_leaves_it_as_it_was():
    mon = t_deg.MeshHealthMonitor(t_deg.DegradePolicy("fail_fast"), 2)
    before = mon.report()
    with mon.quiet():
        mon.update((np.uint32(3), np.asarray([1, 0], np.int32),
                    np.int32(0), np.int32(1), np.int32(1), np.int32(1)), 3)
    assert mon.report() == before
    with pytest.raises(t_deg.StateCorruption):
        mon.update((np.uint32(3), np.asarray([1, 0], np.int32),
                    np.int32(0), np.int32(1), np.int32(1), np.int32(1)), 3)


# -- port-only: checked without faults is the unchecked run -----------------

def _lattice_run(prec, R, policy, fused=True, shape=(2, 1, 2), codes=None,
                 sync=2):
    h = t_make("lattice", L=6, seed=2, replicas=R, precision=prec,
               mesh=make_mesh(shape, AXES), dim_axes=AXES, fused=fused,
               degrade=policy, **CPU)
    if codes is not None:
        h.eng.set_exchange_faults(codes)
    st, rec = h.run_recorded(h.init_state(seed=5), ea_schedule(SWEEPS),
                             POINTS, sync_every=sync)
    return h, state_to_numpy(h.eng.global_state(st)), rec


def _same(a, b):
    for k in ("m", "s", "flips", "sweep"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for x, y in zip(a["halos"], b["halos"]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("prec,R,fused", [("int8", 3, True),
                                          ("int8", 2, False),
                                          ("bitplane", 40, True),
                                          ("f32", 2, True)])
@pytest.mark.parametrize("policy", ["stale_hold:2", "freeze_boundary",
                                    "fail_fast"])
def test_lattice_checked_without_faults_is_unchecked(prec, R, fused,
                                                     policy):
    _, base, rb = _lattice_run(prec, R, None, fused)
    h, got, rg = _lattice_run(prec, R, policy, fused)
    _same(base, got)
    np.testing.assert_array_equal(rb.energies.numpy(), rg.energies.numpy())
    rep = h.eng.health.report()
    assert rep["detections"] == 0 and rep["exchanges_total"] == SWEEPS // 2


@pytest.mark.parametrize("prec,R", [("int8", 3), ("bitplane", 40),
                                    ("f32", 3)])
def test_dist_checked_without_faults_is_unchecked(prec, R):
    outs = []
    for policy in (None, "freeze_boundary"):
        h = dist_handle("slab2-int8-hold-clean", policy)
        h = t_make("dsim_dist", h.eng.p, rng="lfsr", replicas=R,
                   precision=prec, degrade=policy, **CPU)
        st, rec = h.run_recorded(h.init_state(seed=2), ea_schedule(SWEEPS),
                                 POINTS, sync_every=4)
        outs.append((state_to_numpy(st), rec.energies.numpy()))
    for f in ("m", "ghosts", "rng", "flips"):
        np.testing.assert_array_equal(outs[0][0][f], outs[1][0][f])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert h.eng.health.report()["exchanges_total"] == SWEEPS // 4


def test_lattice_one_brick_accepts_every_face():
    h = t_make("lattice", L=4, seed=3, precision="int8", replicas=2,
               degrade="freeze_boundary", **CPU)
    h.eng.set_exchange_faults([2, 1, 2, 1])
    h.run_recorded(h.init_state(seed=1), ea_schedule(8), [8], sync_every=1)
    rep = h.eng.health.report()
    assert rep["detections"] == 0 and rep["exchanges_total"] == 8


# -- resync, the exchange closure, warm, the guards --------------------------

def test_lattice_resync_refreshes_halos_and_clears_staleness():
    h, _, _ = _lattice_run("int8", 2, "freeze_boundary",
                           codes=[0, 2, 0, 0, 0, 0, 0, 0])
    eng = h.eng
    assert eng.health.suspect
    st = eng.shard_state(eng.global_state(
        h.restore(h.snapshot(h.init_state(seed=5)))))
    st, _ = h.run_recorded(st, ea_schedule(4), [4], sync_every=1)
    st2 = eng.resync(st)
    fresh = eng._refresh_halos(st)
    for a, b in zip(st2.halos, fresh.halos):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not eng.health.suspect and eng.health.resyncs == 1
    assert eng.health.report()["staleness"] == [0] * 6


def test_dist_resync_is_the_fault_free_exchange():
    h = dist_handle("slab2-int8-freeze-codes", "stale_hold:8")
    eng = h.eng
    eng.set_exchange_faults([1, 1, 1, 1])
    st, _ = h.run_recorded(h.init_state(seed=4), ea_schedule(8), [8],
                           sync_every=2)
    assert eng.health.suspect
    st2 = eng.resync(st)
    np.testing.assert_array_equal(st2.ghosts.numpy(),
                                  eng.boundary_exchange_fn()(st).numpy())
    assert not eng.health.suspect and eng.health.staleness.tolist() == [0, 0]


@pytest.mark.parametrize("engine", ["lattice", "dsim_dist"])
def test_exchange_fn_cache_dropped_on_restore(engine):
    h = lattice_handle("x2-int8-hold-clean") if engine == "lattice" else \
        dist_handle("slab2-int8-hold-clean", "stale_hold:4")
    st = h.init_state(seed=5)
    fn1 = h.eng.boundary_exchange_fn()
    assert h.eng.boundary_exchange_fn() is fn1
    st2 = h.restore(h.snapshot(st))
    assert h.eng._exchange_only_fn is None
    fn2 = h.eng.boundary_exchange_fn()
    assert fn2 is not fn1
    a, b = fn2(st2), fn2(st2)
    for x, y in zip(a if engine == "lattice" else (a,),
                    b if engine == "lattice" else (b,)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_warm_does_not_touch_the_monitor():
    h = lattice_handle("y2-int8-failfast", "fail_fast")
    h.eng.set_exchange_faults([2])
    cur = h.start_recorded(h.init_state(seed=1), ea_schedule(SWEEPS),
                           POINTS, sync_every=2)
    cur.warm()                       # would detect, and raise, if counted
    assert h.eng.health.report()["exchanges_total"] == 0
    with pytest.raises(t_deg.StateCorruption):
        cur.advance(1)


def test_guards():
    with pytest.raises(ValueError, match="degrade policy"):
        lattice_handle("x2-int8-hold-clean").eng.set_exchange_faults([1])
    with pytest.raises(ValueError, match="mesh engines"):
        t_make("gibbs", t_graph.ea3d(4, seed=1, **CPU), degrade="fail_fast",
               **CPU)
    h = dist_handle("slab2-int8-hold-clean")
    with pytest.raises(ValueError, match="mode='dsim'"):
        t_make("dsim_dist", h.eng.p, mode="cmft", degrade="fail_fast",
               **CPU)
    hd = dist_handle("slab2-int8-hold-clean", "stale_hold")
    with pytest.raises(ValueError, match="integer sync_every"):
        hd.run_recorded(hd.init_state(seed=1), ea_schedule(8), [8],
                        sync_every="phase")
    assert hd.eng.set_exchange_faults(None) is None


# -- the reference's in-process degrade tests, on the port ------------------

def test_classify_error_taxonomy_unchanged():
    assert classify_error(StateCorruption("mesh")) == "transient"
    assert classify_error(ValueError("bad")) == "permanent"
    assert classify_error(TimeoutError("slow")) == "transient"
    assert classify_error(RuntimeError("????")) == "transient"


def test_exchange_codes_compile_and_replay():
    plan = FaultPlan([FaultRule(site="exchange_drop", rate=0.5)], seed=9)
    codes = plan.exchange_codes(64)
    assert codes is not None and codes.dtype == np.int32
    assert set(np.unique(codes)) <= {0, 1}
    assert 0 < int((codes == 1).sum()) < 64
    # deterministic: replay() and a second compile agree bitwise
    np.testing.assert_array_equal(codes, plan.replay().exchange_codes(64))
    np.testing.assert_array_equal(codes, plan.exchange_codes(64))


def test_exchange_codes_index_after_and_overlap():
    plan = FaultPlan([FaultRule(site="exchange_drop", index=3),
                      FaultRule(site="exchange_corrupt", index=3),
                      FaultRule(site="exchange_drop", after=8)], seed=0)
    codes = plan.exchange_codes(12)
    assert codes[3] == 2                  # corrupt wins the overlap
    assert (codes[8:] == 1).all() and (codes[:3] == 0).all()
    # no engine-site rules -> None (host-site rules don't leak in)
    assert FaultPlan([FaultRule(site="chunk")]).exchange_codes(8) is None


def test_spool_rejects_bit_flipped_checkpoint(tmp_path):
    from repro_torch.serve.spool import CheckpointSpool

    spool = CheckpointSpool(str(tmp_path))
    digest = spool.put({"token": ("batch", "job-1"), "sweeps_done": 128})
    path = os.path.join(str(tmp_path), digest + ".ck")
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0x40                  # one flipped bit
    open(path, "wb").write(bytes(blob))
    with pytest.raises(FileNotFoundError, match="content-hash"):
        spool.load(digest)
    assert spool.corrupt_checkpoints == 1
    assert not os.path.exists(path)               # treated as missing
    assert spool.stats()["corrupt_checkpoints"] == 1
    # records() scan skips (and clears) corruption instead of raising
    d2 = spool.put({"token": ("batch", "job-2"), "sweeps_done": 64})
    p2 = os.path.join(str(tmp_path), d2 + ".ck")
    open(p2, "ab").write(b"\x00tail")             # appended garbage
    assert spool.records() == []
    assert spool.corrupt_checkpoints == 2


def test_spool_truncated_checkpoint(tmp_path):
    from repro_torch.serve.spool import CheckpointSpool

    spool = CheckpointSpool(str(tmp_path))
    digest = spool.put({"token": ("batch", "job-1"), "sweeps_done": 7})
    path = os.path.join(str(tmp_path), digest + ".ck")
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:len(blob) // 2])
    with pytest.raises(FileNotFoundError):
        spool.load(digest)
    assert spool.corrupt_checkpoints == 1
