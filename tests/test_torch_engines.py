"""The port's unified engine layer: registry round-trip, replica axis,
fused sweep, shared recording driver, exact flip accounting.

The port of ``tests/test_engines.py``, case by case, on the CPU.  Left
out: ``test_fused_sweep_matches_per_phase_bitwise[interpret]`` (the
reference's Pallas interpreter; the port's plain path is the ``ref``
case).  ``test_lattice_r1_matches_direct_engine`` builds the port's
``LatticeDSIM`` with no mesh (one brick), where the reference needs
``repro.compat``'s.  Where the reference case compares numbers, the
port is also held to the reference's engine started from the port's
state (``interop.state_to_numpy``; ``rng="lfsr"``: LFSR states bitwise,
int8 bitwise, f32 spins equal unless a decision lies at a tanh tie).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.annealing import ea_schedule as j_ea
from repro.core.graph import ea3d as j_ea3d
from repro.engines import make_engine as j_make
from repro_torch.core.annealing import (constant_schedule, ea_schedule,
                                        replica_beta_arrays)
from repro_torch.core.coloring import lattice3d_coloring
from repro_torch.core.dsim import DSIMEngine, build_partitioned
from repro_torch.core.gibbs import GibbsEngine
from repro_torch.core.graph import ea3d
from repro_torch.core.partition import slab_partition
from repro_torch.engines import (Engine, RunRecord, chunk_plan, make_engine,
                                 run_recorded_driver, spawn_seeds)
from repro_torch.engines.base import flips_chunk_cap
from repro_torch.interop import state_to_numpy

L = 6
SW = 48
CPU = dict(device="cpu")


def ref_state(template, port_state):
    """The reference's state with the port's field values."""
    import jax.numpy as jnp
    return dataclasses.replace(template, **{
        k: tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
        else jnp.asarray(v) for k, v in state_to_numpy(port_state).items()})


@pytest.fixture(scope="module")
def setup():
    g = ea3d(L, seed=7, **CPU)
    col = lattice3d_coloring(L)
    labels = slab_partition(L, 2)
    return g, col, labels


def _mk(name, setup, replicas=1, maker=make_engine, g=None, **kw):
    gp, col, labels = setup
    g = gp if g is None else g
    if maker is make_engine:
        kw.update(CPU)
    if name == "gibbs":
        return maker("gibbs", g, coloring=col, rng="lfsr",
                     replicas=replicas, **kw)
    if name == "dsim":
        return maker("dsim", g, coloring=col, K=2, labels=labels,
                     rng="lfsr", replicas=replicas, **kw)
    if name == "dsim_dist":
        # K=1: one partition, in this process
        return maker("dsim_dist", g, coloring=col, K=1,
                     labels=np.zeros(g.n, np.int32), rng="lfsr",
                     replicas=replicas, **kw)
    return maker("lattice", L=L, seed=7, replicas=replicas, **kw)


def _ref(name, setup, replicas=1):
    return _mk(name, setup, replicas, maker=j_make, g=j_ea3d(L, seed=7))


# -- registry round-trip ------------------------------------------------------

@pytest.mark.parametrize("name", ["gibbs", "dsim", "dsim_dist", "lattice"])
def test_registry_round_trip(name, setup):
    g, col, labels = setup
    h = _mk(name, setup, replicas=2)
    assert isinstance(h, Engine)
    assert h.replicas == 2 and h.n_sites == g.n
    st = h.init_state(seed=0)
    st0 = st
    st, rec = h.run_recorded(st, ea_schedule(SW), [SW // 2, SW],
                             sync_every=4)
    assert isinstance(rec, RunRecord)
    assert rec.energies.shape == (2, 2)            # (points, R)
    assert rec.flips > 0
    e = h.energy(st).cpu().numpy()
    assert e.shape == (2,)
    np.testing.assert_allclose(e, rec.energies[-1].cpu().numpy(), atol=1e-3)
    spins = h.global_spins(st).cpu().numpy()
    assert spins.shape == (2, g.n)
    assert set(np.unique(spins)) <= {-1, 1}
    # annealing actually anneals
    assert float(rec.energies[-1].min()) < 0
    # the reference's engine from the same state: the same trajectory.
    # The LFSR streams advance whatever is decided, so they agree
    # bitwise; f32 spins agree except where a decision lies at a tanh
    # tie, and where they all agree so do the energies and flips.
    jh = _ref(name, setup, replicas=2)
    js, jrec = jh.run_recorded(ref_state(jh.init_state(seed=0), st0),
                               j_ea(SW), [SW // 2, SW], sync_every=4)
    np.testing.assert_array_equal(rec.times, np.asarray(jrec.times))
    key = "s" if name == "lattice" else "rng"
    np.testing.assert_array_equal(state_to_numpy(st)[key],
                                  np.asarray(getattr(js, key)))
    differ = int((spins != np.asarray(jh.global_spins(js))).sum())
    assert differ <= 2, differ
    if differ == 0:
        np.testing.assert_array_equal(rec.energies.cpu().numpy(),
                                      np.asarray(jrec.energies))
        assert rec.flips == jrec.flips


def test_unknown_engine_rejected(setup):
    with pytest.raises(ValueError):
        make_engine("does-not-exist")


# -- replica axis -------------------------------------------------------------

@pytest.mark.parametrize("name", ["gibbs", "dsim"])
def test_replica_r1_matches_legacy_bitwise(name, setup):
    """The registry at R=1 reproduces the legacy class exactly."""
    g, col, labels = setup
    h = _mk(name, setup, replicas=1)
    if name == "gibbs":
        legacy = GibbsEngine(g, col, rng="lfsr", **CPU)
    else:
        legacy = DSIMEngine(build_partitioned(g, col, labels, 2),
                            rng="lfsr", **CPU)
    sh = h.init_state(seed=3)
    sl = legacy.init_state(seed=3)
    sh, rec = h.run_recorded(sh, ea_schedule(SW), [SW], sync_every=4)
    if name == "gibbs":
        sl, _ = legacy.run_recorded(sl, ea_schedule(SW), [SW])
        ml = sl.m.numpy()
    else:
        sl, _ = legacy.run_recorded(sl, ea_schedule(SW), [SW], sync_every=4)
        ml = legacy.global_spins(sl).numpy()
    mh = h.global_spins(sh).numpy()[0]
    assert (mh == ml).all()


def test_lattice_r1_matches_direct_engine(setup):
    from repro_torch.core.lattice import build_ea3d_lattice
    from repro_torch.core.lattice_dsim import LatticeDSIM
    h = _mk("lattice", setup, replicas=1)
    direct = LatticeDSIM(build_ea3d_lattice(L, seed=7, **CPU), **CPU)
    sh, sd = h.init_state(seed=3), direct.init_state(seed=3)
    sh, _ = h.run_recorded(sh, ea_schedule(SW), [SW], sync_every=4)
    sd, _ = direct.run_recorded(sd, ea_schedule(SW), [SW], sync_every=4)
    assert torch.equal(sh.m, sd.m)
    np.testing.assert_array_equal(state_to_numpy(sh)["s"],
                                  state_to_numpy(sd)["s"])


@pytest.mark.parametrize("name", ["gibbs", "dsim", "dsim_dist", "lattice"])
def test_replicas_mutually_independent(name, setup):
    """R=4 chains diverge: pairwise-distinct spins and decorrelated signs."""
    h = _mk(name, setup, replicas=4)
    st = h.init_state(seed=0)
    st, rec = h.run_recorded(st, constant_schedule(0.8, SW), [SW],
                             sync_every=4)
    spins = h.global_spins(st).cpu().numpy().astype(np.float64)
    for a in range(4):
        for b in range(a + 1, 4):
            assert (spins[a] != spins[b]).any()
            # at beta below the glass transition, independent chains show
            # only weak overlap: |q_ab| far from 1
            q = abs(float((spins[a] * spins[b]).mean()))
            assert q < 0.6, (a, b, q)


def test_replica_prefix_stability(setup):
    """Replica r of an R=2 batch equals replica r of an R=4 batch (seed
    spawning is prefix-stable), so growing the batch never reshuffles."""
    h2 = _mk("gibbs", setup, replicas=2)
    h4 = _mk("gibbs", setup, replicas=4)
    s2, s4 = h2.init_state(seed=9), h4.init_state(seed=9)
    s2, _ = h2.run_recorded(s2, ea_schedule(SW), [SW])
    s4, _ = h4.run_recorded(s4, ea_schedule(SW), [SW])
    m2 = h2.global_spins(s2).numpy()
    m4 = h4.global_spins(s4).numpy()
    assert (m2 == m4[:2]).all()


def test_per_replica_beta_arrays(setup):
    g, col, labels = setup
    sch = ea_schedule(SW)
    bR = replica_beta_arrays(sch, 3, spread=0.2)
    assert bR.shape == (SW, 3)
    assert (bR[:, 0] < bR[:, 2]).all()
    from repro.core.annealing import replica_beta_arrays as j_rba
    np.testing.assert_array_equal(bR, j_rba(j_ea(SW), 3, spread=0.2))
    eng = GibbsEngine(g, col, rng="lfsr", **CPU)
    st = eng.init_state(seed=0, replicas=3)
    st, rec = eng.run_recorded_full(st, sch, [SW], betas_R=bR)
    assert rec.energies.shape == (1, 3)
    # identical spread=0 arrays reproduce the shared-schedule run bitwise
    st1 = eng.init_state(seed=0, replicas=3)
    st1, rec1 = eng.run_recorded_full(st1, sch, [SW])
    st2 = eng.init_state(seed=0, replicas=3)
    st2, rec2 = eng.run_recorded_full(st2, sch, [SW],
                                      betas_R=replica_beta_arrays(sch, 3))
    assert torch.equal(st1.m, st2.m)


# -- fused multi-phase sweep --------------------------------------------------

def test_fused_sweep_matches_per_phase_bitwise():
    """Fused sweep == per-phase path on an (8,8,8) brick, bitwise,
    through the full engine (halo exchange included), and both equal the
    reference's fused run (``impl="ref"``) from the same state."""
    hf = make_engine("lattice", L=8, seed=5, replicas=2, fused=True,
                     impl="ref", **CPU)
    hp = make_engine("lattice", L=8, seed=5, replicas=2, fused=False,
                     impl="ref", **CPU)
    sf, sp = hf.init_state(seed=0), hp.init_state(seed=0)
    s0 = sf
    sf, rf = hf.run_recorded(sf, ea_schedule(16), [16], sync_every=4)
    sp, rp = hp.run_recorded(sp, ea_schedule(16), [16], sync_every=4)
    assert torch.equal(sf.m, sp.m)
    assert torch.equal(sf.s.view(torch.int32), sp.s.view(torch.int32))
    assert rf.flips == rp.flips > 0
    jh = j_make("lattice", L=8, seed=5, replicas=2, fused=True, impl="ref")
    js, jr = jh.run_recorded(ref_state(jh.init_state(seed=0), s0),
                             j_ea(16), [16], sync_every=4)
    np.testing.assert_array_equal(np.asarray(js.s), state_to_numpy(sf)["s"])
    # f32: a decision at a tanh tie may go the other way
    assert abs(jr.flips - rf.flips) <= 2


def test_fused_kernel_op_level_bitwise():
    from repro.kernels.ops import pbit_sweep_op as j_sweep
    from repro_torch.core.bits import u32_from_numpy, u32_to_numpy
    from repro_torch.kernels.ops import pbit_sweep_op, pbit_update_op
    rng = np.random.default_rng(0)
    shape = (8, 8, 8)
    m_np = rng.choice([-1, 1], size=shape).astype(np.int8)
    s_np = rng.integers(1, 2 ** 32, size=shape, dtype=np.uint32)
    h_np = rng.normal(0, 0.1, shape).astype(np.float32)
    w6_np = tuple(rng.choice([-1.0, 0.0, 1.0], size=shape)
                  .astype(np.float32) for _ in range(6))
    halos_np = tuple(rng.choice([-1, 1], sh).astype(np.int8)
                     for sh in [(8, 8)] * 6)
    par = ((np.indices(shape).sum(axis=0)) % 2).astype(np.int8)
    masks_np = np.stack([par, 1 - par])
    betas_np = np.asarray([1.0, 2.0, 3.0], np.float32)
    m, s = torch.from_numpy(m_np), u32_from_numpy(s_np, "cpu")
    h = torch.from_numpy(h_np)
    w6 = tuple(torch.from_numpy(w) for w in w6_np)
    halos = tuple(torch.from_numpy(x) for x in halos_np)
    masks = torch.from_numpy(masks_np)
    betas = torch.from_numpy(betas_np)
    mm, ss, fl = m, s, 0
    for t in range(3):
        for c in range(2):
            m2, ss = pbit_update_op(mm, ss, betas[t], masks[c], h, w6, halos)
            fl += int((m2 != mm).sum())
            mm = m2
    mf, sf, flf = pbit_sweep_op(m, s, betas, masks, h, w6, halos)
    assert torch.equal(mf, mm)
    assert torch.equal(sf.view(torch.int32), ss.view(torch.int32))
    assert int(flf) == fl
    # the reference's plain sweep on the same inputs
    jm, js, jfl = j_sweep(m_np, s_np, betas_np, masks_np, h_np, w6_np,
                          halos_np, impl="ref")
    np.testing.assert_array_equal(u32_to_numpy(sf), np.asarray(js))
    assert (np.asarray(jm) != mf.numpy()).sum() <= 2   # tanh ties
    assert abs(int(jfl) - int(flf)) <= 2


# -- shared driver / exact flip accounting ------------------------------------

def test_chunk_plan_max_chunk():
    from repro.engines import chunk_plan as j_chunk_plan
    plan = chunk_plan([5, 9, 64], max_chunk=8)
    assert plan == j_chunk_plan([5, 9, 64], max_chunk=8)
    acc, seen = 0, []
    for c in plan:
        assert c & (c - 1) == 0 and c <= 8
        acc += c
        seen.append(acc)
    for p in (5, 9, 64):
        assert p in seen
    with pytest.raises(ValueError):
        chunk_plan([4], max_chunk=3)


def test_flip_total_exact_beyond_int32():
    """>2**31 flips accumulate exactly: the device counter is a wrapping
    int32 odometer, the driver's host-side total is an exact Python int."""
    FLIPS_PER_SWEEP = 1 << 24
    TOTAL = 512                                   # 512 * 2^24 = 2^33 flips
    cap = flips_chunk_cap(FLIPS_PER_SWEEP, 1)
    assert cap * FLIPS_PER_SWEEP < (1 << 31)      # per-chunk delta unambiguous

    class FakeState(dict):
        pass

    def chunk_fn(state, betas2d, iters, S):
        d = int(betas2d.shape[0]) * int(betas2d.shape[1]) * FLIPS_PER_SWEEP
        # int32 odometer semantics: wraps mod 2^32 (carried as uint32)
        wrapped = np.uint32((int(state["flips"]) + d) & 0xFFFFFFFF)
        return FakeState(flips=wrapped, E=state["E"])

    state = FakeState(flips=np.uint32(0), E=torch.zeros(()))
    state, rec = run_recorded_driver(
        state=state, schedule=constant_schedule(1.0, TOTAL),
        record_points=[TOTAL], chunk_fn=chunk_fn,
        record_fn=lambda st: st["E"], sync_every=1,
        flips_of=lambda st: st["flips"],
        flips_per_sweep=FLIPS_PER_SWEEP)
    exact = TOTAL * FLIPS_PER_SWEEP
    assert exact > (1 << 31)
    assert rec.flips == exact                      # wrapped twice, still exact


def test_engine_flip_totals_consistent(setup):
    """Engine-reported exact totals equal the device odometer when small."""
    h = _mk("gibbs", setup, replicas=1)
    st = h.init_state(seed=0)
    st, rec = h.run_recorded(st, ea_schedule(SW), [SW])
    assert rec.flips == int(np.uint32(st.flips.numpy()))


def test_spawn_seeds_distinct_and_stable():
    from repro.engines import spawn_seeds as j_spawn
    a = spawn_seeds(0, 8)
    b = spawn_seeds(0, 4)
    assert a[:4] == b
    assert len(set(a)) == 8
    assert spawn_seeds(1, 4) != spawn_seeds(0, 4)
    assert a == j_spawn(0, 8)


# -- serve path ---------------------------------------------------------------

def test_sample_service_round_trip(setup):
    from repro_torch.serve.sample_service import SampleService
    g, col, labels = setup
    svc = SampleService(graph=g, coloring=col, rng="lfsr", **CPU)
    out = svc.submit(engine="gibbs", sweeps=SW, replicas=3, seed=1)
    assert out["energies"].shape == (1, 3)
    assert out["best_spins"].shape == (g.n,)
    assert out["best_energy"] == float(out["energies"][-1].min())
    assert out["flips"] > 0 and out["wall_s"] > 0
    # second submit reuses the cached handle
    out2 = svc.submit(engine="gibbs", sweeps=SW, replicas=3, seed=1)
    assert out2["best_energy"] == out["best_energy"]
