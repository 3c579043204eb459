"""The port's monolithic Gibbs engine against the JAX package.

``rng="lfsr"`` f32: the LFSR states are held bitwise.  The accept takes
``tanh`` from PyTorch here and from XLA there, which differ by a few ulp
on some inputs, so spins are held equal except where a decision lies
within a few ulp of its boundary: at most 1% of the spins may differ, and
where none does, every energy and flip count must be bitwise the
reference's.  On +-J couplings every partial sum of the fields and of
the incremental energy is an exact integer in f32, so the tracked energy
equals the direct one exactly.  On Gaussian couplings the summation
orders differ: the energies are held to 1e-5 of their scale (the sum of
|J| and |h|).  ``rng="philox"`` draws from a ``torch.Generator``, not
``jax.random``: it is held statistically, as the reference holds its
LFSR against its philox (mean annealed energy within 10%).

Initial spins without ``m0`` come from numpy in the port and from
``jax.random`` in the reference, so the reference's state is built from
the port's spins; every other field of ``init_state`` must be equal.
"""

import numpy as np
import pytest
import torch

from repro.core import graph as j_graph
from repro.core.annealing import ea_schedule as j_ea
from repro.core.coloring import greedy_coloring as j_greedy
from repro.core.coloring import lattice3d_coloring as j_lat_col
from repro.core.gibbs import GibbsEngine as JGibbs
from repro.core.pbit import S41 as J_S41
from repro.engines.base import spawn_seeds, stack_states
from repro.engines.registry import make_engine as j_make
from repro_torch import S41, make_engine as t_make
from repro_torch.core import graph as t_graph
from repro_torch.core.annealing import ea_schedule
from repro_torch.core.coloring import Coloring
from repro_torch.core.energy import energy as t_energy
from repro_torch.core.gibbs import GibbsEngine, GibbsState
from repro_torch.core.snapshot import restore_state, snapshot_state
from repro_torch.interop import state_from_numpy, state_to_numpy

CPU = dict(device="cpu")
FIELDS = ("m", "rng", "E", "sweep", "flips")
FMTS = {None: (None, None), "S41": (J_S41, S41)}


def gaussian_graph(mod, **kw):
    rng = np.random.default_rng(9)
    ei, ej = np.triu_indices(24, 1)
    keep = rng.random(len(ei)) < 0.15
    ew = rng.normal(size=keep.sum()).astype(np.float32)
    h = rng.normal(0, 0.3, size=24).astype(np.float32)
    return mod.from_edges(24, ei[keep], ej[keep], ew, h=h, **kw)


GRAPHS = {
    "ea3d L=4": lambda mod, **kw: mod.ea3d(4, seed=1, **kw),
    "ea3d L=5": lambda mod, **kw: mod.ea3d(5, seed=2, **kw),
    "ea3d L=6": lambda mod, **kw: mod.ea3d(6, seed=3, **kw),
    "toroidal 6x8": lambda mod, **kw: mod.toroidal_grid(6, 8, seed=4, **kw),
    "random regular 40x3": lambda mod, **kw: mod.random_regular(40, 3, seed=5,
                                                                **kw),
    "gaussian": gaussian_graph,
}


def build(name, rng="lfsr", fmt=None):
    jg = GRAPHS[name](j_graph)
    tg = GRAPHS[name](t_graph, **CPU)
    if name.startswith("ea3d"):
        col = j_lat_col(jg.meta["L"])
    else:
        col = j_greedy(np.asarray(jg.idx), np.asarray(jg.w))
    jf, tf = FMTS[fmt]
    return (JGibbs(jg, col, rng=rng, fmt=jf),
            GibbsEngine(tg, Coloring(col.colors), rng=rng, fmt=tf, **CPU))


def numpy_state(st):
    return state_to_numpy(st)


def assert_init_equal(js, ts, scale=None):
    """Every field equal; on Gaussian couplings the energy within 1e-5 of
    ``scale``."""
    t = numpy_state(ts)
    for f in FIELDS:
        a = np.asarray(getattr(js, f))
        assert a.dtype == t[f].dtype and a.shape == t[f].shape, f
        if f == "E" and scale is not None:
            np.testing.assert_allclose(t[f], a, rtol=0, atol=1e-5 * scale)
        else:
            np.testing.assert_array_equal(a, t[f], err_msg=f)


def assert_f32_trajectory(js, ts, jtr=None, ttr=None, scale=None):
    """LFSR bitwise; at most 1% of the spins differ (tanh ties); with none
    differing every energy and flip count equal (bitwise, or on Gaussian
    couplings within 1e-5 of ``scale``)."""
    t = numpy_state(ts)
    np.testing.assert_array_equal(np.asarray(js.rng), t["rng"])
    np.testing.assert_array_equal(np.asarray(js.sweep), t["sweep"])
    differ = np.asarray(js.m) != t["m"]
    assert differ.mean() <= 0.01
    if differ.any():
        return
    pairs = [(np.asarray(js.E), t["E"])]
    if jtr is not None:
        pairs += [(np.asarray(jtr[0]), ttr[0].numpy())]
        np.testing.assert_array_equal(np.asarray(jtr[1]), ttr[1].numpy())
    np.testing.assert_array_equal(np.asarray(js.flips), t["flips"])
    for a, b in pairs:
        assert a.shape == b.shape
        if scale is None:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("fmt", [None, "S41"])
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_gibbs_lfsr_matches_jax(name, R, fmt):
    je, te = build(name, fmt=fmt)
    m0 = np.random.default_rng(7).choice(np.array([-1, 1], np.int8),
                                         size=te.n)
    reps = None if R == 1 else R
    js, ts = je.init_state(seed=3, m0=m0, replicas=reps), \
        te.init_state(seed=3, m0=m0, replicas=reps)
    pm_j = name != "gaussian"
    scale = None if pm_j else float(
        np.abs(np.asarray(je.g.w)).sum() + np.abs(np.asarray(je.g.h)).sum())
    assert_init_equal(js, ts, scale)
    betas = ea_schedule(24).beta_array()
    js, jtr = je.run_dense(js, betas)
    ts, ttr = te.run_dense(ts, betas)
    assert_f32_trajectory(js, ts, jtr, ttr, scale)
    if pm_j:
        # the tracked energy is exact on +-J
        assert torch.equal(ts.E, te.energy(ts))
    # the recorded driver from there: record points and exact flip totals
    js, jrec = je.run_recorded_full(js, j_ea(16), [4, 16])
    ts, trec = te.run_recorded_full(ts, ea_schedule(16), [4, 16])
    assert_f32_trajectory(js, ts, scale=scale)
    np.testing.assert_array_equal(jrec.times, trec.times)
    if (np.asarray(js.m) == numpy_state(ts)["m"]).all() and pm_j:
        np.testing.assert_array_equal(np.asarray(jrec.energies),
                                      trec.energies.numpy())
        assert jrec.flips == trec.flips


@pytest.mark.parametrize("R", [1, 3])
def test_gibbs_init_without_m0_equals_jax_built_from_the_port_spins(R):
    """The port's spins come from numpy; everything else about its
    init_state equals the reference's built from those spins (replica r
    from spawn_seeds(seed, R)[r])."""
    je, te = build("ea3d L=5")
    if R == 1:
        ts = te.init_state(seed=11)
        js = je.init_state(seed=11, m0=ts.m.numpy())
    else:
        ts = te.init_state(seed=11, replicas=R)
        js = stack_states([je.init_state(s, m0=ts.m[r].numpy())
                           for r, s in enumerate(spawn_seeds(11, R))])
        assert len({bytes(ts.m[r].numpy()) for r in range(R)}) == R
    assert_init_equal(js, ts)
    seeds = [5, 9, 2]
    ts = te.init_state(seeds=seeds)
    js = stack_states([je.init_state(s, m0=ts.m[r].numpy())
                       for r, s in enumerate(seeds)])
    assert_init_equal(js, ts)


def test_gibbs_sweep_and_per_replica_betas_match_jax():
    je, te = build("toroidal 6x8")
    m0 = np.ones(te.n, np.int8)
    # the reference's sweep takes an unbatched state
    js, ts = je.init_state(seed=1, m0=m0), te.init_state(seed=1, m0=m0)
    js, ts = je.sweep(js, 0.7), te.sweep(ts, 0.7)
    assert_f32_trajectory(js, ts)
    js, ts = je.init_state(seed=1, m0=m0, replicas=2), \
        te.init_state(seed=1, m0=m0, replicas=2)
    fan = np.linspace(0.5, 1.5, 2, dtype=np.float32)[None] * \
        ea_schedule(12).beta_array()[:, None]
    js, _ = je.run_recorded_full(js, j_ea(12), [6, 12], betas_R=fan)
    ts, _ = te.run_recorded_full(ts, ea_schedule(12), [6, 12], betas_R=fan)
    assert_f32_trajectory(js, ts)
    with pytest.raises(ValueError, match="batched"):
        te.run_recorded_full(te.init_state(seed=1), ea_schedule(12), [12],
                             betas_R=fan)


def test_gibbs_philox_statistics_match_jax_and_lfsr():
    """As the reference's test_gibbs_lfsr_vs_philox_statistics: the mean
    energy after ea_schedule(300) at L=6 over three chains, port philox
    against the reference's philox and the port's LFSR, within 10%."""
    g = t_graph.ea3d(6, seed=5, **CPU)
    col = Coloring(j_lat_col(6).colors)
    out = {}
    for kind in ("philox", "lfsr"):
        eng = GibbsEngine(g, col, rng=kind, **CPU)
        st, (Etr, _) = eng.run_dense(eng.init_state(seed=0, replicas=3),
                                     ea_schedule(300).beta_array())
        out[kind] = float(Etr[-1].mean())
        assert torch.equal(st.E, eng.energy(st))
    je = JGibbs(j_graph.ea3d(6, seed=5), j_lat_col(6), rng="philox")
    vals = []
    for s in range(3):
        _, (Etr, _) = je.run_dense(je.init_state(seed=s),
                                   j_ea(300).beta_array())
        vals.append(float(Etr[-1]))
    out["jax philox"] = np.mean(vals)
    for other in ("lfsr", "jax philox"):
        assert abs(out["philox"] - out[other]) / abs(out[other]) < 0.1


@pytest.mark.parametrize("rng", ["lfsr", "philox"])
def test_gibbs_handle_packed_snapshot_and_checkpoint_resume(rng):
    """The registry handle: energies (P, R), init_state_packed replica r
    from seeds[r] alone, a snapshot restored and a mid-run checkpoint
    resumed in a fresh cursor give the uninterrupted run bitwise (philox
    too: its stream's position is in the state)."""
    g = t_graph.ea3d(4, seed=0, **CPU)
    h = t_make("gibbs", g, rng=rng, replicas=3, **CPU)
    assert h.name == "gibbs" and h.precision == "f32" and \
        h.kernel_path is None
    st0 = h.init_state(seed=2)
    ref_state, ref = h.run_recorded(st0, ea_schedule(32), [8, 16, 32])
    assert ref.energies.shape == (3, 3) and ref.flips > 0
    assert h.energy(ref_state).shape == (3,) and \
        h.global_spins(ref_state).shape == (3, 64)
    # snapshot and restore: the same continuation
    snap = h.snapshot(st0)
    assert isinstance(snap.m, np.ndarray)
    st1, rec1 = h.run_recorded(h.restore(snap), ea_schedule(32), [8, 16, 32])
    assert torch.equal(rec1.energies, ref.energies) and \
        rec1.flips == ref.flips
    # a checkpoint mid-run, resumed in a fresh cursor
    cur = h.start_recorded(st0, ea_schedule(32), [8, 16, 32])
    cur.advance(2)
    ck = cur.checkpoint()
    fresh = h.start_recorded(h.init_state(seed=99), ea_schedule(32),
                             [8, 16, 32])
    fresh.restore_checkpoint(ck)
    while not fresh.done:
        fresh.advance(1)
    rec2 = fresh.record()
    assert torch.equal(rec2.energies, ref.energies) and \
        rec2.flips == ref.flips
    np.testing.assert_array_equal(fresh.flips_per_replica(),
                                  ref_state.flips.numpy())
    for f in ("m", "E", "sweep", "flips"):
        assert torch.equal(getattr(fresh.state, f), getattr(ref_state, f))
    # packing: replica r depends only on seeds[r]
    a = h.init_state_packed([4, 5, 6])
    b = h.init_state_packed([7, 5, 8])
    a, _ = h.run_recorded(a, ea_schedule(8), [8])
    b, _ = h.run_recorded(b, ea_schedule(8), [8])
    assert torch.equal(a.m[1], b.m[1]) and not torch.equal(a.m[0], b.m[0])
    with pytest.raises(ValueError, match="exactly R=3"):
        h.init_state_packed([1, 2])
    # the module-level pair round-trips the unbatched state too
    one = t_make("gibbs", g, rng=rng, **CPU)
    s1 = one.init_state(seed=1)
    s2 = restore_state(snapshot_state(s1), "cpu")
    assert torch.equal(s1.m, s2.m) and torch.equal(s1.rng, s2.rng)


def test_gibbs_interop_crosses_lfsr_and_refuses_philox():
    je, te = build("ea3d L=4")
    js, _ = je.run_dense(je.init_state(seed=1), j_ea(8).beta_array())
    ts = state_from_numpy(**{f: np.asarray(getattr(js, f)) for f in FIELDS},
                          **CPU)
    assert isinstance(ts, GibbsState)
    assert_init_equal(js, ts)
    js, _ = je.run_dense(js, j_ea(8).beta_array())
    ts, _ = te.run_dense(ts, ea_schedule(8).beta_array())
    assert_f32_trajectory(js, ts)
    pj = JGibbs(je.g, je.coloring, rng="philox")
    with pytest.raises(ValueError, match="philox"):
        state_from_numpy(**{f: np.asarray(getattr(pj.init_state(seed=1), f))
                            for f in FIELDS}, **CPU)
    pt = GibbsEngine(te.g, te.coloring, rng="philox", **CPU)
    with pytest.raises(ValueError, match="philox"):
        state_to_numpy(pt.init_state(seed=1))


def test_gibbs_flip_odometer_wraps_like_jax():
    """The int32 odometers are uint32-modular: started just below 2^31,
    both packages wrap to the same int32 bits, and the recording driver's
    exact total is the sum of the per-sweep counts."""
    je, te = build("ea3d L=6")
    m0 = np.ones(te.n, np.int8)
    start = np.int32(2 ** 31 - 40)
    js = je.init_state(seed=2, m0=m0)
    ts = te.init_state(seed=2, m0=m0)
    js.flips = np.asarray(start)
    ts.flips = torch.tensor(int(start), dtype=torch.int32)
    js, jrec = je.run_recorded_full(js, j_ea(8), [8])
    ts, trec = te.run_recorded_full(ts, ea_schedule(8), [8])
    assert int(ts.flips) < 0
    np.testing.assert_array_equal(np.asarray(js.flips), ts.flips.numpy())
    assert jrec.flips == trec.flips == \
        (int(ts.flips) - int(start)) % (1 << 32)


def test_gibbs_energy_matches_direct_on_a_maxcut_graph():
    """The G81 family (toroidal, +-1) as Max-Cut: J = -w; the tracked
    energy and the cut agree with the direct ones exactly."""
    from repro_torch.problems.maxcut import (cut_of, gset_like_toroidal,
                                             maxcut_to_ising)
    g = gset_like_toroidal(8, 16, seed=1, **CPU)
    h = t_make("gibbs", maxcut_to_ising(g), rng="lfsr", replicas=2, **CPU)
    st, rec = h.run_recorded(h.init_state(seed=0), ea_schedule(64), [64])
    assert torch.equal(rec.energies[-1], h.energy(st))
    assert torch.equal(rec.energies[-1], t_energy(h.eng.g, st.m))
    w_tot = float(g.w.sum()) / 2
    for r in range(2):
        # cut = (W - sum_ij w_ij m_i m_j) / 2 and E = sum_ij w_ij m_i m_j
        assert cut_of(g, st.m[r]) == (w_tot - float(h.energy(st)[r])) / 2
