"""The port's core Ising library: graphs, colouring, energies, the p-bit
and its LFSR, the monolithic Gibbs engine.

The port of ``tests/test_core.py``, case by case, on the CPU.  Where the
reference case compares numbers, the port's are also held to the
reference's on the same inputs (numpy, from a seed): graphs, colourings,
energies, fields, the fixed-point grid, the p-bit and the LFSR stream
bitwise; the annealed Gibbs energies of ``rng="lfsr"`` to the
reference's run from the port's initial spins.
"""

import numpy as np
import pytest
import torch

from repro.core import coloring as jcol, energy as jen, graph as jgraph
from repro.core import pbit as jpbit
from repro.core.annealing import ea_schedule as j_ea, sat_schedule as j_sat
from repro.core.gibbs import GibbsEngine as JGibbs
from repro_torch.core.annealing import ea_schedule, sat_schedule
from repro_torch.core.bits import u32_from_numpy, u32_to_numpy
from repro_torch.core.coloring import (greedy_coloring, lattice3d_coloring,
                                       validate_coloring)
from repro_torch.core.energy import energy, local_fields
from repro_torch.core.gibbs import GibbsEngine, chunk_plan
from repro_torch.core.graph import (edges_from_ell, ea3d, from_edges,
                                    random_regular)
from repro_torch.core.pbit import (S41, FixedPoint, lfsr_init, lfsr_next,
                                   lfsr_uniform, pbit_update, quantize)

CPU = dict(device="cpu")


def same_graph(g, jg):
    for f in ("idx", "w", "h"):
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(jg, f)))


def test_ea3d_structure():
    L = 6
    g = ea3d(L, seed=0, **CPU)
    same_graph(g, jgraph.ea3d(L, seed=0))
    assert g.n == L ** 3
    # interior degree 6; open x/y boundaries reduce it
    deg = (g.w.numpy() != 0).sum(axis=1)
    assert deg.max() == 6
    assert deg.min() == 4
    # periodic z: every site has both z neighbors
    assert g.num_edges == 3 * L ** 3 - 2 * L * L  # 2 open faces x,y

    ei, ej, ew = edges_from_ell(g)
    assert set(np.unique(ew)) <= {-1.0, 1.0}
    # rebuild and compare energies on a random config
    g2 = from_edges(g.n, ei, ej, ew, **CPU)
    m = np.random.default_rng(0).choice([-1, 1], g.n).astype(np.int8)
    e = float(energy(g, torch.from_numpy(m)))
    assert e == float(energy(g2, torch.from_numpy(m)))
    assert e == float(jen.energy(jgraph.ea3d(L, seed=0), m))


def test_ea3d_deterministic_by_seed():
    a, b = ea3d(5, seed=3, **CPU), ea3d(5, seed=3, **CPU)
    c = ea3d(5, seed=4, **CPU)
    assert (a.w.numpy() == b.w.numpy()).all()
    assert not (a.w.numpy() == c.w.numpy()).all()
    same_graph(c, jgraph.ea3d(5, seed=4))


@pytest.mark.parametrize("L,expected", [(4, 2), (6, 2), (5, 3), (7, 3)])
def test_lattice_coloring(L, expected):
    g = ea3d(L, seed=0, **CPU)
    col = lattice3d_coloring(L)
    assert col.n_colors == expected
    np.testing.assert_array_equal(col.colors,
                                  jcol.lattice3d_coloring(L).colors)
    assert validate_coloring(g.idx, g.w, col.colors)
    assert sum(len(grp) for grp in col.groups) == L ** 3


def test_greedy_coloring_valid():
    g = random_regular(120, 4, seed=1, **CPU)
    col = greedy_coloring(g.idx, g.w)
    assert validate_coloring(g.idx, g.w, col.colors)
    assert col.n_colors <= 5  # greedy <= max_degree + 1
    jg = jgraph.random_regular(120, 4, seed=1)
    same_graph(g, jg)
    np.testing.assert_array_equal(
        col.colors, jcol.greedy_coloring(np.asarray(jg.idx),
                                         np.asarray(jg.w)).colors)


def test_energy_matches_brute_force():
    g = random_regular(10, 3, seed=0, **CPU)
    jg = jgraph.random_regular(10, 3, seed=0)
    ei, ej, ew = edges_from_ell(g)
    rng = np.random.default_rng(1)
    for _ in range(5):
        m = rng.choice([-1, 1], g.n).astype(np.int8)
        brute = -(ew * m[ei] * m[ej]).sum()
        e = float(energy(g, torch.from_numpy(m)))
        assert abs(e - brute) < 1e-5
        assert e == float(jen.energy(jg, m))


def test_local_fields_definition():
    g = random_regular(12, 3, seed=2, **CPU)
    m = torch.ones((g.n,), dtype=torch.int8)
    f = local_fields(g, m).numpy()
    # all spins up: field_i = sum_j J_ij
    expect = g.w.numpy().sum(axis=1)
    np.testing.assert_allclose(f, expect, atol=1e-6)
    np.testing.assert_array_equal(
        f, np.asarray(jen.local_fields(jgraph.random_regular(12, 3, seed=2),
                                       np.ones(g.n, np.int8))))


def test_fixed_point_quantize():
    fmt = FixedPoint(4, 1)
    xs = np.asarray([0.24, 0.26, -20.0, 20.0, 3.3], np.float32)
    q = quantize(torch.from_numpy(xs), fmt).numpy()
    assert q[0] == 0.0 and q[1] == 0.5
    assert q[2] == fmt.lo and q[3] == fmt.hi
    assert q[4] == 3.5
    # idempotent
    assert (quantize(torch.from_numpy(q), fmt).numpy() == q).all()
    # the same grid as the reference's, ties to even included
    grid = np.linspace(-9, 9, 145).astype(np.float32)
    np.testing.assert_array_equal(
        quantize(torch.from_numpy(grid), fmt).numpy(),
        np.asarray(jpbit.quantize(grid, jpbit.FixedPoint(4, 1))))


def test_pbit_update_limits():
    # beta -> inf: deterministic sign of field
    field = torch.tensor([3.0, -3.0])
    r = torch.tensor([0.3, -0.3])
    out = pbit_update(field, 100.0, r)
    assert out.tolist() == [1, -1]
    # beta = 0: sign of r
    out = pbit_update(field, 0.0, r)
    assert out.tolist() == [1, -1]
    # random fields and draws: the reference's decisions
    rng = np.random.default_rng(3)
    f = rng.normal(0, 2, 256).astype(np.float32)
    u = rng.uniform(-1, 1, 256).astype(np.float32)
    for beta in (0.0, 0.5, 2.0):
        np.testing.assert_array_equal(
            pbit_update(torch.from_numpy(f), beta, torch.from_numpy(u)).numpy(),
            np.asarray(jpbit.pbit_update(f, beta, u)))


def test_lfsr_period_and_range():
    s = lfsr_init(64, seed=0)
    js = jpbit.lfsr_init(64, seed=0)
    np.testing.assert_array_equal(s, np.asarray(js))
    seen = set()
    x = u32_from_numpy(s, "cpu")
    for _ in range(100):
        x = lfsr_next(x)
        js = jpbit.lfsr_next(js)
        u = lfsr_uniform(x).numpy()
        np.testing.assert_array_equal(u32_to_numpy(x), np.asarray(js))
        np.testing.assert_array_equal(u, np.asarray(jpbit.lfsr_uniform(js)))
        assert (u > -1).all() and (u < 1).all()
        seen.add(int(u32_to_numpy(x)[0]))
    assert len(seen) == 100  # no short cycles
    assert (u32_to_numpy(x) != 0).all()


def test_gibbs_energy_tracking_exact():
    g = ea3d(5, seed=2, **CPU)
    eng = GibbsEngine(g, lattice3d_coloring(5), rng="philox", fmt=S41, **CPU)
    st = eng.init_state(seed=0)
    st, _ = eng.run_dense(st, ea_schedule(128).beta_array())
    assert abs(float(st.E) - float(eng.direct_energy(st))) < 1e-3


def test_gibbs_anneals_to_low_energy():
    g = ea3d(6, seed=1, **CPU)
    eng = GibbsEngine(g, lattice3d_coloring(6), **CPU)
    st = eng.init_state(seed=0)
    E0 = float(st.E)
    st, (Etr, flips) = eng.run_dense(st, ea_schedule(400).beta_array())
    assert float(Etr[-1]) < 0.6 * E0 if E0 < 0 else float(Etr[-1]) < E0
    # a sweep updates every p-bit once: attempted-update count = N per sweep
    assert int(flips.max()) <= g.n


def test_gibbs_lfsr_vs_philox_statistics():
    """Paper: LFSR and Philox give slightly different but comparable
    dynamics; final energies should agree within a few percent.  The
    port's LFSR runs also land where the reference's do from the same
    initial spins."""
    g = ea3d(6, seed=5, **CPU)
    col = lattice3d_coloring(6)
    ref = JGibbs(jgraph.ea3d(6, seed=5), jcol.lattice3d_coloring(6),
                 rng="lfsr")
    outs = {}
    for kind in ("philox", "lfsr"):
        vals = []
        for s in range(3):
            eng = GibbsEngine(g, col, rng=kind, **CPU)
            st = eng.init_state(seed=s)
            if kind == "lfsr":
                js = ref.init_state(seed=s, m0=st.m.numpy())
                js, (jtr, _) = ref.run_dense(js, j_ea(300).beta_array())
            st, (Etr, _) = eng.run_dense(st, ea_schedule(300).beta_array())
            vals.append(float(Etr[-1]))
            if kind == "lfsr":
                # the same LFSR stream bitwise; f32 spins equal unless a
                # decision lies at a tanh tie, and then the energy trace
                # too
                np.testing.assert_array_equal(u32_to_numpy(st.rng),
                                              np.asarray(js.rng))
                differ = int((st.m.numpy() != np.asarray(js.m)).sum())
                assert differ <= 2, differ
                if differ == 0:
                    np.testing.assert_array_equal(Etr.numpy(),
                                                  np.asarray(jtr))
        outs[kind] = np.mean(vals)
    assert abs(outs["philox"] - outs["lfsr"]) / abs(outs["philox"]) < 0.1


def test_chunk_plan():
    from repro.core.gibbs import chunk_plan as j_chunk_plan
    pts = [1, 2, 4, 8, 100]
    plan = chunk_plan(pts)
    assert plan == j_chunk_plan(pts)
    acc, seen = 0, []
    for c in plan:
        assert c & (c - 1) == 0  # power of two
        acc += c
        seen.append(acc)
    for p in pts:
        assert p in seen


def test_schedules():
    s = ea_schedule(1000)
    arr = s.beta_array()
    assert arr[0] == 0.5 and arr[-1] == 5.0 and len(arr) == 1000
    np.testing.assert_array_equal(arr, j_ea(1000).beta_array())
    assert float(s.beta_at(0)) == 0.5
    s2 = sat_schedule(77)
    assert s2.betas[-1] == 10.0
    np.testing.assert_array_equal(s2.beta_array(), j_sat(77).beta_array())
